"""Abstract and sharded train states: states too large for one card
(counterpart of ``ever_tpu/parallel/sharded.py``).

``vit7b16_sat493m`` under AdamW is about 27 GB of float32 parameters and 54
GB of moments: it must never exist whole on one card.  The recipe is the
JAX package's:

1. :func:`abstract_train_state`: the model's parameters and buffers and the
   optimizer's state as tensors on the ``meta`` device (shapes and dtypes;
   no memory, no FLOPs), the optimizer's leaves read from the update rule's
   own optimizer class.
2. :func:`sharded_state_shardings`: a placement for each leaf, the JAX
   package's ``_leaf_spec`` rule over the data axis: leaves under
   ``min_shard_bytes`` (1 MiB), scalars, BatchNorm's running statistics and
   the step stay replicated; the optimizer state is split at level 1 and 3,
   the parameters at level 3, each on its largest dimension the axis size
   divides.  With ``tp_axis`` the tensor-parallel leaves (``parallel/tp.py``)
   and their moments are split over that axis first, and the ZeRO fill
   takes the largest other dimension.
3. :func:`create_train_state_sharded`: the state placed so, leaf by leaf
   (with ``tp_axis``, the model put in the Megatron layout by
   ``tp.apply_tp`` first; ZeRO then shards each rank's tensor-parallel
   shard over the data axis and gathers it back over that axis alone).
   A PyTorch module draws its weights when it is built, so the model is
   built on the host (its weights are those ``create_train_state`` gets for
   the same seed) and each sharded leaf reaches the device as the rank's
   shard alone; the optimizer state is made on the device at the shards'
   size.  The host holds the whole parameters once, the device never
   (``ROADMAP.md`` §C).
4. Save and restore without gathering: ``CheckPoint.save_sharded`` and
   ``restore_sharded`` (``core/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ever_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from ever_tpu_torch.parallel.spmd import TrainState
from ever_tpu_torch.parallel.tp import apply_tp, tp_plan, tp_split_dim
from ever_tpu_torch.parallel.zero import StateShardings, ZeroOptimizer, _check_level

__all__ = ['abstract_train_state', 'sharded_state_shardings', 'create_train_state_sharded',
           'assert_sharded_below', 'AbstractTrainState']

# leaves smaller than this stay replicated: sharding a 16 KB LayerScale
# vector buys nothing and costs collective latency
_MIN_SHARD_BYTES = 1 << 20


@dataclass
class AbstractTrainState:
    """A train state's leaves on the ``meta`` device: ``params`` and
    ``batch_stats`` (buffers) by name, ``opt_state`` by parameter name and
    state key, ``step``."""
    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Dict[str, Dict[str, torch.Tensor]]

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every leaf under its path: ``'params/<name>'``,
        ``'batch_stats/<name>'``, ``'opt_state/<name>/<key>'``, ``'step'``."""
        out = {'step': self.step}
        out.update({f'params/{n}': t for n, t in self.params.items()})
        out.update({f'batch_stats/{n}': t for n, t in self.batch_stats.items()})
        out.update({f'opt_state/{n}/{k}': t for n, st in self.opt_state.items()
                    for k, t in st.items()})
        return out


def _optimizer_leaves(tx) -> List[Tuple[str, bool, torch.dtype]]:
    """``(key, parameter-shaped, dtype)`` of each tensor an optimizer of the
    update rule ``tx`` keeps for a float32 parameter, read from one step of
    that optimizer on a 3-element parameter."""
    p = nn.Parameter(torch.zeros(3))
    opt = tx._make([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    return [(k, v.shape == p.shape, v.dtype) for k, v in opt.state[p].items()
            if torch.is_tensor(v)]


def _meta(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(t.shape, dtype=dtype or t.dtype, device='meta')


def abstract_train_state(model, tx, sample_batch=None, rng=None) -> AbstractTrainState:
    """The whole train state of ``model`` under the update rule ``tx`` as
    ``meta`` tensors.  ``model`` is a module (on any device, ``meta``
    included) or a ``{'type', 'params'}`` config, then built on ``meta``:
    no parameter is ever allocated.  ``sample_batch`` and ``rng`` are the
    JAX signature's, unused (a module's shapes do not depend on a batch)."""
    del sample_batch, rng
    if isinstance(model, dict):
        from ever_tpu_torch.core import builder
        with torch.device('meta'):
            model = builder.make_model(model, device='meta')
    leaves = _optimizer_leaves(tx)
    frozen = tx.frozen or (lambda n: False)
    params = dict(model.named_parameters())
    return AbstractTrainState(
        step=torch.empty((), dtype=torch.int64, device='meta'),
        params={n: _meta(p) for n, p in params.items()},
        batch_stats={n: _meta(b) for n, b in model.named_buffers()},
        opt_state={n: {k: _meta(p, dtype) if shaped else torch.empty((), dtype=dtype,
                                                                      device='meta')
                       for k, shaped, dtype in leaves}
                   for n, p in params.items() if p.requires_grad and not frozen(n)})


def _param_name(path: str) -> Optional[str]:
    """The parameter a ``params/<name>`` or ``opt_state/<name>/<key>`` leaf
    belongs to."""
    if path.startswith('params/'):
        return path[len('params/'):]
    if path.startswith('opt_state/'):
        return path[len('opt_state/'):].rsplit('/', 1)[0]
    return None


def _leaf_spec(path: str, shape, mesh: Mesh, level: int, data_axis: str,
               tp_axis: Optional[str], min_shard_bytes: int, nbytes: int) -> P:
    """One leaf's spec: replicated under ``min_shard_bytes``, for scalars,
    buffers and the step; else the tensor-parallel split of its parameter
    over ``tp_axis`` (``parallel/tp.py``'s suffix rule, which a moment
    follows as its parameter does), then the data axis on its largest free
    divisible dimension where ZeRO applies (the optimizer state from level
    1, the parameters at level 3)."""
    if path.startswith('batch_stats/') or path == 'step':
        return P()
    if nbytes < min_shard_bytes or not shape:
        return P()
    spec = [None] * len(shape)
    name = _param_name(path)
    if tp_axis is not None and tp_axis in mesh.shape and name is not None:
        dim = tp_split_dim(name, shape, mesh.shape[tp_axis])
        if dim is not None:
            spec[dim] = tp_axis
    applies = path.startswith('opt_state/') or (path.startswith('params/') and level >= 3)
    n = mesh.shape[data_axis]
    if applies and n > 1:
        free = [d for d in range(len(shape))
                if spec[d] is None and shape[d] % n == 0 and shape[d] >= n]
        if free:
            spec[max(free, key=lambda d: shape[d])] = data_axis
    return P(*spec)


def sharded_state_shardings(abstract_state: AbstractTrainState, mesh: Mesh, *,
                            level: int = 3, data_axis: str = 'data',
                            tp_axis: Optional[str] = None,
                            min_shard_bytes: int = _MIN_SHARD_BYTES) -> StateShardings:
    """Each leaf's placement (module docstring, step 2), as the
    :class:`~ever_tpu_torch.parallel.zero.StateShardings` a ZeRO state
    takes: a parameter's ``opt_state`` placement is that of its
    parameter-shaped leaves.  ``leaf_shardings`` gives every leaf's."""
    _check_level(level)
    if data_axis not in mesh.shape:
        raise ValueError(f'mesh has no axis {data_axis!r}: {dict(mesh.shape)}')
    specs = leaf_shardings(abstract_state, mesh, level=level, data_axis=data_axis,
                           tp_axis=tp_axis, min_shard_bytes=min_shard_bytes)
    opt = {}
    for n, st in abstract_state.opt_state.items():
        shaped = [k for k, t in st.items() if t.shape == abstract_state.params[n].shape]
        opt[n] = specs[f'opt_state/{n}/{shaped[0]}'] if shaped else NamedSharding(mesh, P())
    return StateShardings(
        mesh=mesh, level=level, step=specs['step'],
        params={n: specs[f'params/{n}'] for n in abstract_state.params},
        batch_stats={n: specs[f'batch_stats/{n}'] for n in abstract_state.batch_stats},
        opt_state=opt)


def leaf_shardings(abstract_state: AbstractTrainState, mesh: Mesh, *, level: int = 3,
                   data_axis: str = 'data', tp_axis: Optional[str] = None,
                   min_shard_bytes: int = _MIN_SHARD_BYTES) -> Dict[str, NamedSharding]:
    """The placement of every leaf of :meth:`AbstractTrainState.leaves`,
    under the same paths."""
    return {path: NamedSharding(mesh, _leaf_spec(path, tuple(t.shape), mesh, level,
                                                 data_axis, tp_axis, min_shard_bytes,
                                                 t.numel() * t.element_size()))
            for path, t in abstract_state.leaves().items()}


def create_train_state_sharded(model: nn.Module, tx, sample_batch=None, mesh: Mesh = None, *,
                               level: int = 3, data_axis: str = 'data',
                               tp_axis: Optional[str] = None, rng=None,
                               min_shard_bytes: int = _MIN_SHARD_BYTES,
                               device=None) -> Tuple[TrainState, StateShardings]:
    """The train state of ``model`` (built on the host) placed over
    ``mesh`` leaf by leaf onto ``device`` (the GPU unless given; module
    docstring, step 3).  Returns ``(state, shardings)``; pass
    ``shardings`` as ``state_shardings=`` to ``build_train_step`` and to
    ``CheckPoint.restore_sharded``."""
    from ever_tpu_torch.core.device import get_device

    del sample_batch, rng
    if mesh is None:
        raise ValueError('create_train_state_sharded needs mesh=')
    shardings = sharded_state_shardings(
        abstract_train_state(model, tx), mesh, level=level, data_axis=data_axis,
        tp_axis=tp_axis, min_shard_bytes=min_shard_bytes)
    if tp_axis is not None and tp_axis in mesh.shape:
        apply_tp(model, mesh, tp_axis, shardings=shardings.params,
                 device=next(model.parameters()).device)
    optimizer = tx.init((n, p) for n, p in model.named_parameters() if p.requires_grad)
    zo = ZeroOptimizer(model, optimizer, shardings, device=get_device(device))
    return TrainState(step=0, model=model, optimizer=zo, shardings=shardings), shardings


def assert_sharded_below(state, max_replicated_bytes: int) -> None:
    """Raise ``AssertionError`` when a leaf of the train state ``state``
    larger than ``max_replicated_bytes`` is held whole by every rank (the
    7B invariant)."""
    offenders = [(path, tuple(shape), nbytes) for path, shape, nbytes, sharded
                 in _leaf_report(state) if nbytes > max_replicated_bytes and not sharded]
    if offenders:
        raise AssertionError(f'{len(offenders)} leaves above {max_replicated_bytes} bytes are '
                             f'fully replicated: {offenders[:5]}')


def _leaf_report(state):
    """(path, whole shape, whole bytes, sharded) of every tensor leaf."""
    opt = state.optimizer if isinstance(state, TrainState) else None
    zo = opt if isinstance(opt, ZeroOptimizer) else None
    tp = tp_plan(state.model)
    out = []
    for n, p in state.model.named_parameters():
        slot = zo.slots[n] if zo else None
        shape = slot.shape if slot else p.shape
        split = tp is not None and n in tp.sharded
        if split:                        # the whole tensor of a tensor-parallel shard
            dim = tp.sharded[n][0]
            shape = torch.Size(s * tp.size if d == dim else s for d, s in enumerate(shape))
        nbytes = shape.numel() * p.element_size()
        out.append((f'params/{n}', shape, nbytes, split or bool(slot and slot.pdim is not None)))
        inner = zo.optimizer.state.get(slot.shard, {}) if slot and slot.shard is not None \
            else (opt.state.get(p, {}) if opt is not None and not zo else {})
        sharded = split or bool(slot and slot.odim is not None)
        for k, v in inner.items():
            if torch.is_tensor(v) and v.dim():
                out.append((f'opt_state/{n}/{k}', shape, shape.numel() * v.element_size(),
                            sharded))
    out += [(f'batch_stats/{n}', b.shape, b.nbytes, False)
            for n, b in state.model.named_buffers()]
    return out
