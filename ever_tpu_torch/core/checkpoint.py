"""Checkpoint save and resume with a JSON index (counterpart of
``ever_tpu/core/checkpoint.py``).

A checkpoint holds the JAX package's three keys: ``model`` (the model's
``state_dict``, BatchNorm buffers included), ``opt`` (the optimizer's state;
for a GAN each role's under ``'G'`` and ``'D'``) and ``global_step``.
``checkpoint_info.json`` maps each saved step to its checkpoint and records
the ``last`` one, so a crashed run finds where to resume.

Backends, by the JAX package's names:

- ``'msgpack'`` (the default): one ``torch.save`` file,
  ``checkpoint-{step}.ckpt``, written by rank 0;
- ``'orbax'``: a directory, ``checkpoint-{step}``, in the format of
  ``torch.distributed.checkpoint`` (DCP), not orbax's (``ROADMAP.md`` §C).
  Every rank writes its own shards of a ZeRO state (``parallel/zero.py``),
  under tensor parallel (``parallel/tp.py``) its shards over both axes, and
  a replicated tensor is written once; a resume reads each rank's shards
  straight into its placement, and nothing is gathered either way.  Every
  rank must call ``save``;
- ``'orbax_async'``: the same directory, written by ``dcp.async_save``: the
  state is copied to host memory and written on a background thread while
  training goes on.  The step is recorded in ``checkpoint_info.json`` only
  once the write is done: at the next save, at :meth:`CheckPoint.wait`, or
  at exit.

The directory holds one flat dict: ``model/<name>``, ``opt/<name>/<key>``
(``opt/<role>/<name>/<key>`` for a GAN) with each optimizer's group
hyperparameters under ``opt_groups``, and ``global_step``.  A
tensor-parallel leaf is written as a reshape of its whole tensor in which
each rank's shard is one block (the packed qkv weight's ``[3D, in]`` as
``[3, k, D/k, in]``: a rank holds its heads' rows of q, k and v), a
``DTensor`` over the data and model axes, and its model shape is listed
under ``tp_shapes``.  :meth:`CheckPoint.load` of a directory returns it
nested as a file's (whole tensors in the model's shapes, optimizer state
by parameter name).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import torch

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.dist import get_world_size, is_main_process

__all__ = ['CheckPoint', 'is_checkpoint', 'load_model_state_from_ckpt',
           'load_model_state_dict_from_ckpt', 'remove_module_prefix', 'remove_optimizer_in_ckpt',
           'optimizer_state_dict']

MODEL = 'model'
OPTIMIZER = 'opt'
GLOBALSTEP = 'global_step'
LASTCHECKPOINT = 'last'
CHECKPOINT_NAME = 'checkpoint_info.json'
_GROUPS = 'opt_groups'
_SHAPES = 'tp_shapes'
_BACKENDS = ('msgpack', 'orbax', 'orbax_async')


def optimizer_state_dict(optimizer) -> dict:
    """The optimizer's ``state_dict``, or each role's under its name for a
    ``{'G': ..., 'D': ...}`` dict of optimizers (a GAN)."""
    if isinstance(optimizer, dict):
        return {role: opt.state_dict() for role, opt in optimizer.items()}
    return optimizer.state_dict()


def is_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and all(k in obj for k in (MODEL, OPTIMIZER, GLOBALSTEP))


# -- the directory format --------------------------------------------------------

def _roles(state) -> Dict[str, Any]:
    """``{prefix: optimizer}``: ``''`` for one optimizer, ``'G/'`` and
    ``'D/'`` for a GAN's."""
    opt = state.optimizer
    return {f'{r}/': o for r, o in opt.items()} if isinstance(opt, dict) else {'': opt}


def _slots(state, optimizer) -> Dict[str, tuple]:
    """``{name: (parameter the optimizer steps, split dim of its state or
    None, whole shape, split dim of the parameter or None)}``."""
    from ever_tpu_torch.parallel.zero import ZeroOptimizer
    if isinstance(optimizer, ZeroOptimizer):
        return {n: (s.shard, s.odim, s.shape, s.pdim) for n, s in optimizer.slots.items()
                if s.shard is not None or s.pdim is not None}
    stepped = {id(p) for g in optimizer.param_groups for p in g['params']}
    return {n: (p, None, p.shape, None) for n, p in state.model.named_parameters()
            if id(p) in stepped}


def _inner(optimizer):
    from ever_tpu_torch.parallel.zero import ZeroOptimizer
    return optimizer.optimizer if isinstance(optimizer, ZeroOptimizer) else optimizer


def _placed(t: torch.Tensor, dim: Optional[int], shape, mesh):
    """``t`` itself, or (``dim`` set) a ``DTensor`` whose local tensor is
    ``t``, this rank's shard of a ``shape`` tensor split on ``dim``."""
    if dim is None:
        return t
    from torch.distributed.tensor import Shard
    return _dtensor(t, mesh.device_mesh(t.device.type), [Shard(dim)], shape)


def _dtensor(local: torch.Tensor, device_mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, device_mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device='meta').stride())


def _mesh(state):
    sh = getattr(state, 'shardings', None)
    return None if sh is None else sh.mesh


class _Writer:
    """Each leaf of a train state as the directory holds it: a replicated
    tensor as it is, a ZeRO shard as a ``DTensor`` over the data axis, and
    a tensor-parallel leaf as a ``DTensor`` over the data and model axes of
    a reshape of the whole tensor in which the rank's shard is one block
    (``parallel.tp.tp_view``), its model shape noted under ``tp_shapes``."""

    def __init__(self, state):
        from ever_tpu_torch.parallel.tp import tp_plan
        self.mesh, self.plan = _mesh(state), tp_plan(state.model)
        if self.plan is not None and self.mesh is None:
            raise ValueError('a tensor-parallel state is written through its placements: '
                             'build it with parallel.sharded.create_train_state_sharded')
        self.shapes: Dict[str, list] = {}

    def leaf(self, key: str, name: str, t: torch.Tensor, shape, zdim: Optional[int]):
        """``t``, the rank's part of parameter ``name``'s tensor (a ZeRO
        shard of the ``shape`` tensor split on ``zdim``, or ``shape``
        itself), as the directory writes it under ``key``."""
        if self.plan is None or name not in self.plan.sharded or not t.dim():
            return _placed(t, zdim, shape, self.mesh)
        from torch.distributed.tensor import Replicate, Shard
        from ever_tpu_torch.parallel.tp import tp_view
        dim, k = self.plan.sharded[name][0], self.plan.size
        n = self.mesh.size()
        view, mdim, ddim = tp_view(name, shape, dim, k, zdim, n)
        local = list(view)
        local[mdim] = 1
        if ddim is not None:
            local[ddim] //= n
        whole = list(shape)
        whole[dim] *= k
        self.shapes[key] = whole
        placements = [Shard(ddim) if ddim is not None else Replicate(), Shard(mdim)]
        return _dtensor(t.view(local), self.mesh.device_mesh_with(t.device.type, self.plan.axis),
                        placements, view)


def _dcp_dict(state, global_step: int) -> Dict[str, Any]:
    """The flat dict of a train state (module docstring) over its own
    tensors: a sharded leaf is a ``DTensor`` of this rank's shard."""
    writer = _Writer(state)
    out: Dict[str, Any] = {GLOBALSTEP: int(global_step)}
    sd = state.model.state_dict(keep_vars=False)
    groups = {}
    for prefix, opt in _roles(state).items():
        slots = _slots(state, opt)
        for n, (shard, _, shape, pdim) in slots.items():
            if pdim is not None:
                sd[n] = shard.detach()
        names = {id(p): n for n, (p, *_) in slots.items() if p is not None}
        inner = _inner(opt)
        for p, st in inner.state.items():
            n = names[id(p)]
            _, odim, shape, _ = slots[n]
            for k, v in st.items():
                if torch.is_tensor(v):
                    key = f'{OPTIMIZER}/{prefix}{n}/{k}'
                    out[key] = writer.leaf(key, n, v, shape, odim if v.dim() else None)
        groups[prefix] = [dict({k: v for k, v in g.items() if k != 'params'},
                               params=[names[id(p)] for p in g['params']])
                          for g in inner.param_groups]
    pdims = {n: (shape, pdim) for opt in _roles(state).values()
             for n, (_, _, shape, pdim) in _slots(state, opt).items()}
    for n, v in sd.items():
        shape, pdim = pdims.get(n, (v.shape, None))
        out[f'{MODEL}/{n}'] = writer.leaf(f'{MODEL}/{n}', n, v, shape, pdim)
    out[_GROUPS] = _group_leaf(groups)
    if writer.shapes:
        out[_SHAPES] = sorted([k, s] for k, s in writer.shapes.items())
    return out


def _group_leaf(groups: Dict[str, list]) -> list:
    # a list holding no tensor is one leaf of DCP's dict, stored whole
    return [[prefix, g] for prefix, g in groups.items()]


def _target(state, metadata) -> Dict[str, Any]:
    """The dict to load a directory into: the state's own tensors, and for
    optimizer state the run has not made yet (a fresh optimizer), new ones
    in the checkpoint's shapes, each placed as its parameter's state is."""
    out = _dcp_dict(state, 0)
    writer = _Writer(state)
    for key, md in metadata.state_dict_metadata.items():
        if key in out or not key.startswith(f'{OPTIMIZER}/'):
            continue
        rest = key[len(OPTIMIZER) + 1:]
        prefix = ''
        if isinstance(state.optimizer, dict):
            role, rest = rest.split('/', 1)
            prefix = f'{role}/'
        name, k = rest.rsplit('/', 1)
        shard, odim, shape, _ = _slots(state, _roles(state)[prefix])[name]
        size = tuple(md.size)
        leaf = None
        if size:
            local = torch.zeros_like(shard.detach(), dtype=md.properties.dtype,
                                     memory_format=torch.contiguous_format)
            leaf = writer.leaf(key, name, local, shape, odim)
        if leaf is None or tuple(leaf.shape) != size:
            dev = 'cpu' if not size else shard.device
            leaf = torch.zeros(size, dtype=md.properties.dtype, device=dev)
        out[key] = leaf
    return out


def _apply_loaded(state, loaded: Dict[str, Any]) -> None:
    """Put a loaded dict's optimizer state and group hyperparameters into
    the state's optimizers (the model's tensors were loaded in place)."""
    from torch.distributed.tensor import DTensor
    for prefix, opt in _roles(state).items():
        slots = _slots(state, opt)
        inner = _inner(opt)
        head = f'{OPTIMIZER}/{prefix}'
        for key, v in loaded.items():
            if not key.startswith(head):
                continue
            name, k = key[len(head):].rsplit('/', 1)
            if name not in slots:
                continue
            p = slots[name][0]
            v = v.to_local() if isinstance(v, DTensor) else v
            inner.state[p][k] = v.view(p.shape) if v.dim() and v.shape != p.shape else v
        for group, saved in zip(inner.param_groups, dict(loaded[_GROUPS])[prefix]):
            group.update({k: v for k, v in saved.items() if k != 'params'})


def _nested(flat: Dict[str, Any]) -> dict:
    """A directory's flat dict as a file's nesting: ``model`` a state
    dict, ``opt`` ``{'state': {name: {key: tensor}}, 'param_groups'}`` (a
    GAN's a role each)."""
    out = {MODEL: {}, OPTIMIZER: {}, GLOBALSTEP: int(flat.get(GLOBALSTEP, 0))}
    groups = dict(flat.get(_GROUPS, []))
    gan = any(p for p in groups)
    for prefix, g in groups.items():
        dst = out[OPTIMIZER].setdefault(prefix[:-1], {}) if gan else out[OPTIMIZER]
        dst.update(state={}, param_groups=g)
    shapes = {k: tuple(s) for k, s in flat.get(_SHAPES, [])}
    for key, v in flat.items():
        if key in shapes:
            v = v.reshape(shapes[key])
        if key.startswith(f'{MODEL}/'):
            out[MODEL][key[len(MODEL) + 1:]] = v
        elif key.startswith(f'{OPTIMIZER}/'):
            rest = key[len(OPTIMIZER) + 1:]
            dst = out[OPTIMIZER]
            if gan:
                role, rest = rest.split('/', 1)
                dst = dst.setdefault(role, dict(state={}, param_groups=[]))
            name, k = rest.rsplit('/', 1)
            dst.setdefault('state', {}).setdefault(name, {})[k] = v
    if not groups and not out[OPTIMIZER]:
        del out[OPTIMIZER]
    return out


def _flat(ckpt: dict) -> Dict[str, Any]:
    """The inverse of :func:`_nested`, for a checkpoint read whole."""
    out = {GLOBALSTEP: int(ckpt.get(GLOBALSTEP, 0))}
    out.update({f'{MODEL}/{n}': v for n, v in ckpt.get(MODEL, {}).items()})
    opt = ckpt.get(OPTIMIZER)
    if opt is not None:
        roles = {f'{r}/': o for r, o in opt.items()} if 'state' not in opt else {'': opt}
        out[_GROUPS] = _group_leaf({p: o.get('param_groups', []) for p, o in roles.items()})
        for p, o in roles.items():
            for n, st in o.get('state', {}).items():
                out.update({f'{OPTIMIZER}/{p}{n}/{k}': v for k, v in st.items()})
    return out


def _read_dir(path: str) -> Dict[str, Any]:
    """A directory's whole flat dict on the host, read by this process
    alone (each sharded tensor whole)."""
    # what torch.distributed.checkpoint.format_utils.dcp_to_torch_save reads
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
    from torch.distributed.checkpoint.state_dict_loader import _load_state_dict
    flat: Dict[str, Any] = {}
    _load_state_dict(flat, storage_reader=FileSystemReader(path),
                     planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return flat


class CheckPoint:
    MODEL = MODEL
    OPTIMIZER = OPTIMIZER
    GLOBALSTEP = GLOBALSTEP
    LASTCHECKPOINT = LASTCHECKPOINT
    CHECKPOINT_NAME = CHECKPOINT_NAME

    def __init__(self, launcher=None, backend: str = 'msgpack'):
        if backend not in _BACKENDS:
            raise ValueError(f'unknown checkpoint backend: {backend!r}')
        self.backend = backend
        self._launcher = launcher
        self._global_step = 0
        self._pending = None           # (future, step, name) of an async write
        self._async_group = None
        self._json_log: Dict[str, Any] = {LASTCHECKPOINT: dict(step=0, name='')}
        self.init_checkpoint_info_from_launcher()

    # -- global step ---------------------------------------------------------
    def set_global_step(self, value: int) -> None:
        if value < 0:
            raise ValueError('The global step must be larger than zero.')
        self._global_step = int(value)

    @property
    def global_step(self) -> int:
        return self._global_step

    def step(self) -> None:
        self._global_step += 1

    # -- wiring --------------------------------------------------------------
    def set_launcher(self, launcher) -> None:
        self._launcher = launcher
        self.init_checkpoint_info_from_launcher()

    def init_checkpoint_info_from_launcher(self) -> None:
        if self._launcher is None:
            return
        info = self.load_checkpoint_info(self._launcher.model_dir)
        if info is not None:
            self._json_log = info

    # -- save ----------------------------------------------------------------
    def save(self, filename: Optional[str] = None) -> None:
        """Write the launcher's model, optimizer(s) and step and record
        them in ``checkpoint_info.json``.  The model is the unwrapped one
        (``TrainState.model``, never its ``DistributedDataParallel``
        wrapper), so a data-parallel run's checkpoint has a one-process
        run's keys.  ``msgpack``: rank 0 writes and no collective runs (a
        crashed rank saves alone); the ``orbax`` backends are collectives
        of every rank (module docstring)."""
        if filename is None:
            filename = self.get_checkpoint_name(self.global_step, self.backend)
        path = os.path.join(self._launcher.model_dir, filename)
        state = self._launcher.state
        if self.backend != 'msgpack':
            self._save_dir(path, state)
        elif is_main_process():
            if getattr(state, 'shardings', None) is not None:
                raise ValueError("a ZeRO state is sharded over the ranks: save it with "
                                 "checkpoint_backend='orbax' or 'orbax_async'")
            torch.save({MODEL: state.model.state_dict(),
                        OPTIMIZER: optimizer_state_dict(state.optimizer),
                        GLOBALSTEP: self.global_step}, path)
        if self.backend != 'orbax_async':
            self._record_saved(self.global_step, filename)
        if self._launcher.logger is not None:
            self._launcher.logger.save_log(filename)

    def _save_dir(self, path: str, state) -> None:
        import torch.distributed.checkpoint as dcp
        sd = _dcp_dict(state, self.global_step)
        if self.backend == 'orbax':
            dcp.save(sd, checkpoint_id=path)
            return
        self.wait()                   # the previous write is on disk: record it
        group = None
        if get_world_size() > 1:
            import torch.distributed as tdist
            if self._async_group is None:
                # the background write's collectives stay off the step's group
                self._async_group = tdist.new_group(backend='gloo')
                import atexit
                atexit.register(self.wait)
            group = self._async_group
        future = dcp.async_save(sd, checkpoint_id=path, process_group=group)
        self._pending = (future, self.global_step, os.path.basename(path))

    def wait(self) -> None:
        """Wait for an ``orbax_async`` write in flight, then record it
        (a no-op otherwise)."""
        if self._pending is not None:
            future, step, name = self._pending
            self._pending = None
            future.result()
            self._record_saved(step, name)

    def _record_saved(self, step: int, filename: str) -> None:
        self._json_log[str(step)] = filename
        if step >= self._json_log[LASTCHECKPOINT]['step']:
            self._json_log[LASTCHECKPOINT] = dict(step=step, name=filename)
        self.save_checkpoint_info(self._launcher.model_dir)

    def save_checkpoint_info(self, model_dir: str) -> None:
        if not is_main_process():
            return
        with open(os.path.join(model_dir, CHECKPOINT_NAME), 'w') as f:
            json.dump(self._json_log, f)

    # -- sharded save and restore (states too large for one card) ------------
    @staticmethod
    def save_sharded(dirpath: str, state) -> None:
        """Write ``state`` (a train state, ZeRO-sharded or not) and its step
        as a directory: each rank its own shards, nothing gathered.  A
        collective of every rank."""
        import torch.distributed.checkpoint as dcp
        dcp.save(_dcp_dict(state, state.step), checkpoint_id=dirpath)

    @staticmethod
    def restore_sharded(dirpath: str, state, shardings=None):
        """Load a directory into ``state`` in place, each rank its shards
        straight into its placement (a ZeRO state from ``zero_init`` or
        ``create_train_state_sharded``; the placements are the state's,
        ``shardings`` is accepted for the JAX signature).  Returns the state
        with its step set to the saved one."""
        del shardings
        import torch.distributed.checkpoint as dcp
        target = _target(state, dcp.FileSystemReader(dirpath).read_metadata())
        dcp.load(target, checkpoint_id=dirpath)
        _apply_loaded(state, target)
        state.step = int(target[GLOBALSTEP])
        return state

    # -- load ----------------------------------------------------------------
    @staticmethod
    def load(filepath: str, device: Optional[Union[str, torch.device]] = None) -> dict:
        """Read a checkpoint file or directory onto ``device`` (the GPU
        unless ``device='cpu'``), whole, in this process alone.  The file
        is one this program wrote."""
        dev = get_device(device)
        if os.path.isdir(filepath):
            flat = _read_dir(filepath)
            return _nested({k: v.to(dev) if torch.is_tensor(v) and v.dim() else v
                            for k, v in flat.items()})
        return torch.load(filepath, map_location=dev, weights_only=True)

    def try_resume(self) -> bool:
        """Restore the launcher's model, optimizer(s) and step from the last
        checkpoint of its model dir; False when there is none.  A directory
        is read into the state's placements (every rank calls this)."""
        if self._launcher is None:
            return False
        info = self.load_checkpoint_info(self._launcher.model_dir)
        if info is None or not info[LASTCHECKPOINT]['name']:
            return False
        last_path = os.path.join(self._launcher.model_dir, info[LASTCHECKPOINT]['name'])
        if not os.path.exists(last_path):
            return False
        if os.path.isdir(last_path):
            state = self.restore_sharded(last_path, self._launcher.state)
            step = state.step
            self._launcher.restore_state(None, None, step)
        else:
            ckpt = self.load(last_path, self._launcher.device)
            step = int(ckpt[GLOBALSTEP])
            self._launcher.restore_state(model_state=ckpt[MODEL], opt_state=ckpt[OPTIMIZER],
                                         global_step=step)
        self.set_global_step(step)
        if self._launcher.logger is not None:
            self._launcher.logger.restore_log(last_path)
        return True

    @staticmethod
    def load_checkpoint_info(model_dir: str) -> Optional[dict]:
        json_path = os.path.join(model_dir, CHECKPOINT_NAME)
        if not os.path.exists(json_path):
            return None
        with open(json_path) as f:
            return json.load(f)

    @staticmethod
    def get_checkpoint_name(global_step: int, backend: str = 'msgpack') -> str:
        if backend.startswith('orbax'):
            return f'checkpoint-{global_step}'
        return f'checkpoint-{global_step}.ckpt'


def load_model_state_from_ckpt(filepath: str,
                               device: Optional[Union[str, torch.device]] = None) -> dict:
    """The model's ``state_dict`` of a checkpoint file or directory (or the
    file itself when it holds a bare ``state_dict``)."""
    ckpt = CheckPoint.load(filepath, device)
    return ckpt[MODEL] if is_checkpoint(ckpt) or os.path.isdir(filepath) else ckpt


def load_model_state_dict_from_ckpt(filepath: str,
                                    device: Optional[Union[str, torch.device]] = None) -> dict:
    """The reference's spelling of :func:`load_model_state_from_ckpt`."""
    return load_model_state_from_ckpt(filepath, device)


def remove_module_prefix(state_dict: dict, prefix: str = 'module.') -> dict:
    """``state_dict`` with ``prefix`` (DDP's ``module.``) stripped from the
    keys that start with it."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def remove_optimizer_in_ckpt(fp: str, new_fp: Optional[str] = None,
                             device: Optional[Union[str, torch.device]] = None) -> None:
    """Rewrite a checkpoint without its optimizer state (to ``new_fp``, or
    in place), a directory as a directory, by this process alone."""
    ckpt = CheckPoint.load(fp, device)
    ckpt.pop(OPTIMIZER, None)
    if os.path.isdir(fp):
        import shutil
        import torch.distributed.checkpoint as dcp
        out = new_fp or fp
        if out == fp:
            shutil.rmtree(fp)
        dcp.save(_flat(ckpt), checkpoint_id=out, no_dist=True)
        return
    torch.save(ckpt, new_fp or fp)
