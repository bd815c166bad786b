"""ZeRO-1/3: the train state sharded over the data axis (counterpart of
``ever_tpu/parallel/zero.py``).

The placement rule is the JAX package's: a leaf is split on its largest
dimension that the axis size divides and that is at least that size;
scalars and leaves with no such dimension stay replicated.  ``level=1``
shards the optimizer state (each parameter's moments or momentum; the
scalar ``step`` counters stay replicated), ``level=3`` the parameters as
well; BatchNorm's running statistics (the model's buffers) and the step
count stay replicated.  :func:`zero_init` places an existing
:class:`~ever_tpu_torch.parallel.spmd.TrainState` so and returns the
placements, which ``build_train_step(..., mesh=, state_shardings=)``
takes.

In JAX the placements are annotations and XLA inserts the collectives; here
:class:`ZeroOptimizer` runs them, and holds the state:

- each rank's optimizer is a ``torch.optim`` optimizer of the same class
  and hyperparameters over the rank's **shards**, so its state tensors are
  made at the shards' size;
- level 1 keeps every parameter whole on every rank; a sharded parameter's
  shard is a view of the rank's slice of it, so the update writes the slice
  in place and the other ranks' slices are then copied in;
- level 3 keeps only the shard of a sharded parameter between steps (the
  parameter's own storage is freed) and gathers the parameters one unit at
  a time (:func:`zero_units`: each block of a ViT trunk, each child of an
  ``nn.ModuleList``, and a root unit for the rest, which stays gathered
  for the whole step).  A unit is gathered before its forward and freed
  after it, gathered again when the gradient of its output arrives in the
  backward, and once all its gradients have arrived they are averaged over
  the data axis, each tensor's norm is taken from its whole averaged
  gradient, the rank keeps its slice, and the whole gradients and
  parameters are freed.  So a rank holds at most two units' whole
  parameters and gradients at a time (the root and one block).  A freed
  parameter keeps its tensor, with its storage resized to nothing, so that
  what autograd saved of it reads the refilled storage in the backward;
  a cast of it that autograd would keep (the compute-dtype copy of a
  weight, or the transposed view a matrix product saves) is kept as the
  parameter and cast again in the backward.
  A unit whose backward does not run (its output unused, or nothing in it
  trained) reduces zeros after the backward, in unit order, so every rank
  reaches every unit's collectives in one order.

The gradients are averaged over the ranks by all-reduces of flattened
gradients (each divided by the rank count first, as
``DistributedDataParallel`` divides), and each rank reads its shard from
the result: the reduce-scatter as an all-reduce and a slice.  Level 1 does
this once for the whole model, level 3 once a unit.  The parameters are
gathered by one broadcast of each rank's flattened shards.  All-reduce and
broadcast run on every backend the port uses (gloo on CPU and CUDA
tensors, NCCL).  The gradients' global norm (the recorded ``grad_norm``
and the clip) is taken from each tensor's norm over its whole averaged
gradient, stacked in the optimizer's parameter order, as the replicated
step takes it, so a ZeRO step computes what the replicated step computes,
element by element (a reduce-scatter would leave each rank its shard's sum
of squares, added over the ranks in another order).  With
``forward_times > 1`` a level-3 unit is reduced after each microbatch's
backward and its slices are summed over the microbatches, so each
tensor's norm is the square root of its shards' squares summed over the
data axis: the same values up to the rounding of those sums
(``tests/test_torch_zero.py``: two SGD steps of a float32 ViT, the metrics
within 1e-6 and the parameters within 1e-7 of the replicated step's).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn as nn
from torch.utils._pytree import tree_leaves

from ever_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from ever_tpu_torch.parallel.tp import gather_tp

__all__ = ['shard_leaf_sharding', 'zero_shardings', 'zero_init', 'StateShardings',
           'ZeroOptimizer', 'zero_units', 'full_state_dict', 'local_bytes']


def shard_leaf_sharding(leaf, mesh: Mesh, axis: str = 'data') -> NamedSharding:
    """The placement of one tensor (or anything with a ``shape``): split on
    its largest dimension that the ``axis`` size divides, else replicated."""
    n = mesh.shape[axis]
    shape = tuple(leaf.shape)
    if n <= 1 or not shape:
        return NamedSharding(mesh, P())
    dims = [d for d in range(len(shape)) if shape[d] % n == 0 and shape[d] >= n]
    if not dims:
        return NamedSharding(mesh, P())
    best = max(dims, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[best] = axis
    return NamedSharding(mesh, P(*spec))


@dataclass
class StateShardings:
    """The placements of a train state, leaf by leaf: ``params`` and
    ``batch_stats`` (the model's buffers) by their ``state_dict`` names;
    ``opt_state`` by the name of the parameter whose state it is (its
    parameter-shaped leaves; scalar counters are replicated); ``step``."""
    mesh: Mesh
    level: int
    step: NamedSharding
    params: Dict[str, NamedSharding]
    batch_stats: Dict[str, NamedSharding]
    opt_state: Dict[str, NamedSharding] = field(default_factory=dict)

    def leaves(self) -> Dict[str, NamedSharding]:
        """Every placement under a ``'params/<name>'``, ``'batch_stats/<name>'``,
        ``'opt_state/<name>'`` or ``'step'`` path."""
        out = {'step': self.step}
        for what in ('params', 'batch_stats', 'opt_state'):
            out.update({f'{what}/{n}': s for n, s in getattr(self, what).items()})
        return out


def _check_level(level: int) -> None:
    if level not in (1, 3):
        raise ValueError('ZeRO level must be 1 or 3')


def zero_shardings(state, mesh: Mesh, level: int = 1, axis: str = 'data') -> StateShardings:
    """The placements of a :class:`~ever_tpu_torch.parallel.spmd.TrainState`:
    ``level=1`` shards the optimizer state of each optimized parameter,
    ``level=3`` the parameters too; buffers and ``step`` replicated."""
    _check_level(level)
    rep = NamedSharding(mesh, P())
    model = state.model
    optimized = {id(p) for g in _optimizer(state).param_groups for p in g['params']}
    params = dict(model.named_parameters())
    return StateShardings(
        mesh=mesh, level=level, step=rep,
        params={n: shard_leaf_sharding(p, mesh, axis) if level == 3 else rep
                for n, p in params.items()},
        batch_stats={n: rep for n, _ in model.named_buffers()},
        opt_state={n: shard_leaf_sharding(p, mesh, axis) for n, p in params.items()
                   if id(p) in optimized})


def _optimizer(state):
    opt = state.optimizer
    return opt.optimizer if isinstance(opt, ZeroOptimizer) else opt


def zero_init(state, mesh: Mesh, level: int = 1, axis: str = 'data', device=None):
    """Place an existing (replicated) train state with ZeRO placements on
    ``device`` (the GPU unless ``device='cpu'``).  Returns ``(state,
    shardings)``: the state's optimizer becomes a :class:`ZeroOptimizer`
    (any optimizer state it had is sliced into the shards); pass
    ``shardings`` as ``state_shardings=`` to ``build_train_step`` or
    ``build_train_loop``."""
    from ever_tpu_torch.core.device import get_device

    dev = get_device(device)
    shardings = zero_shardings(state, mesh, level, axis)
    state.optimizer = ZeroOptimizer(state.model, state.optimizer, shardings, device=dev)
    state.shardings = shardings
    return state, shardings


def _chunk(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


@dataclass
class _Slot:
    """One parameter under ZeRO: its placement's split dimension for the
    parameter (``pdim``, level 3) and for its optimizer state (``odim``),
    and the tensor the rank's optimizer updates (``shard``: the parameter
    itself when its state is replicated).  During a level-3 step ``whole``
    is the parameter's gathered tensor (its storage emptied while the unit
    is freed) and ``acc`` the rank's part of its averaged gradient."""
    name: str
    param: nn.Parameter
    shape: torch.Size
    pdim: Optional[int]
    odim: Optional[int]
    shard: Optional[torch.Tensor]
    optimized: bool = False
    whole: Optional[torch.Tensor] = None
    acc: Optional[torch.Tensor] = None


@dataclass
class _Unit:
    """The parameters a level-3 step gathers together (``module`` None: the
    root unit) and their state in the step."""
    name: str
    module: Optional[nn.Module]
    slots: List[_Slot]
    nbytes: int = 0                 # the whole sharded parameters' bytes
    gathered: bool = False
    armed: bool = False             # its backward has begun
    reduced: bool = False
    pending: set = field(default_factory=set)
    grad_bytes: int = 0
    ids: frozenset = frozenset()    # its sharded parameters
    saving: object = None           # the saved-tensor hooks of its forward


def zero_units(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The modules a level-3 step gathers one at a time, by name, in module
    order: each ``SelfAttentionBlock`` (a ViT trunk's block, under tensor
    parallel too) and each child of an ``nn.ModuleList`` (a child that is a
    bare ``nn.ModuleList`` is looked into), outermost first.  The
    parameters outside them form the root unit."""
    from ever_tpu_torch.module.vit import SelfAttentionBlock

    units = []

    def walk(prefix: str, module: nn.Module) -> None:
        listed = isinstance(module, nn.ModuleList)
        for name, child in module.named_children():
            bare = isinstance(child, nn.ModuleList) and type(child).forward is nn.Module.forward
            if isinstance(child, SelfAttentionBlock) or (listed and not bare):
                units.append((prefix + name, child))
            else:
                walk(f'{prefix}{name}.', child)

    walk('', model)
    return units


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _hooks_open() -> bool:
    """Whether saved-tensor hooks are open already (a checkpointed block
    under remat discards what it saves; the unit's hooks stay out)."""
    top = getattr(torch._C._autograd, '_top_saved_tensors_default_hooks', None)
    return top is not None and top(False) is not None


def _unpack_cast(saved):
    if not isinstance(saved, tuple):
        return saved
    param, dtype, size, stride, offset = saved
    return param.to(dtype).as_strided(size, stride, offset)


def _will_get_grad(p: torch.Tensor) -> bool:
    """Whether the running backward accumulates a gradient into ``p``."""
    from torch.autograd.graph import get_gradient_edge
    return torch._C._will_engine_execute_node(get_gradient_edge(p).node)


class ZeroOptimizer:
    """The optimizer of a ZeRO train state (module docstring).

    ``optimizer`` is the replicated state's optimizer: its class, groups
    and hyperparameters are kept, over this rank's shards.  The parameters
    move to ``device`` (their own unless given), a level-3 sharded one as
    its shard alone, so that a state built on the host reaches the card
    shard by shard (``parallel/sharded.py``).

    A step calls :meth:`begin_step`, runs each microbatch's forward and
    backward followed by :meth:`end_backward`, then :meth:`step` and
    :meth:`end_step` (``parallel/spmd.py``).  ``stats`` holds the last
    step's ``peak_bytes`` (the most whole parameter and gradient bytes of
    sharded leaves held at once) and ``casts_recast`` (the weight casts
    autograd kept as their parameters), ``unit_log`` its gathers and
    reductions in order."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 shardings: StateShardings, device=None):
        self.model = model
        self.shardings = shardings
        self.level = shardings.level
        mesh = shardings.mesh
        self.group = mesh.group
        self.rank, self.size = mesh.rank(), mesh.size()
        if mesh.abstract:
            raise ValueError('an abstract mesh runs no step: ZeRO needs the mesh of a '
                             'process group (parallel.mesh.make_mesh)')
        names = {id(p): n for n, p in model.named_parameters()}
        optimized = {id(p) for g in optimizer.param_groups for p in g['params']}
        dev = torch.device(device) if device is not None else next(model.parameters()).device
        self.slots: Dict[str, _Slot] = {}
        for n, p in model.named_parameters():
            shape = p.shape
            pdim = shardings.params[n].shard_dim if self.size > 1 else None
            odim = (shardings.opt_state[n].shard_dim
                    if self.size > 1 and id(p) in optimized else None)
            if pdim is not None:            # level 3: the shard is the storage
                shard = _chunk(p.detach(), pdim, self.rank, self.size).to(dev, copy=True)
                shard = nn.Parameter(shard, requires_grad=p.requires_grad)
                p.data = p.data.new_empty(0, device=dev)
            else:
                p.data = p.data.to(dev)
                shard = (None if id(p) not in optimized else p if odim is None
                         else nn.Parameter(_chunk(p.data, odim, self.rank, self.size)))
            self.slots[n] = _Slot(n, p, shape, pdim, odim, shard, id(p) in optimized)
        model.to(dev)
        # the same optimizer over the shards: its own __init__ would re-validate
        # the hyperparameters it already holds
        groups = [dict(g, params=[self.slots[names[id(p)]].shard for p in g['params']])
                  for g in optimizer.param_groups]
        self.optimizer = type(optimizer).__new__(type(optimizer))
        torch.optim.Optimizer.__init__(self.optimizer, groups, optimizer.defaults)
        for p, st in optimizer.state.items():
            slot = self.slots[names[id(p)]]
            self.optimizer.state[slot.shard] = {
                k: (_chunk(v, slot.odim, self.rank, self.size).to(slot.shard.device, copy=True)
                    if torch.is_tensor(v) and slot.odim is not None and v.shape == slot.shape
                    else v) for k, v in st.items()}
        # the optimized slots in the optimizer's order: the norm's order
        self._ordered = [self.slots[names[id(p)]] for g in optimizer.param_groups
                         for p in g['params']]
        self.units: List[_Unit] = []
        if any(s.pdim is not None for s in self.slots.values()):
            self._plan_units()
        self._active, self._micro, self._norms = False, 1, {}
        self._held = 0
        self.stats = dict(peak_bytes=0, casts_recast=0)
        self.unit_log: List[Tuple[str, str]] = []

    # -- collectives ---------------------------------------------------------
    def _gather(self, slots: List[_Slot], dim_of) -> List[torch.Tensor]:
        """The whole tensors of ``slots``' shards (split on ``dim_of(slot)``):
        each rank broadcasts its shards flattened into one buffer."""
        if not slots:
            return []
        mine = [s.shard.detach().contiguous().reshape(-1) for s in slots]
        flat = torch.cat(mine)
        parts = []
        for r in range(self.size):
            buf = flat if r == self.rank else torch.empty_like(flat)
            tdist.broadcast(buf, src=tdist.get_global_rank(self.group, r), group=self.group)
            parts.append(buf.split([m.numel() for m in mine]))
        return [torch.cat([parts[r][i].view(s.shard.shape) for r in range(self.size)],
                          dim=dim_of(s)) for i, s in enumerate(slots)]

    def _average(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """``grads`` averaged over the ranks: one all-reduce a dtype of the
        flattened tensors, each divided by the rank count first."""
        if self.size == 1:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx]).div_(self.size)
            tdist.all_reduce(flat, group=self.group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def reduce_grads(self) -> None:
        """Average the optimized parameters' gradients over the ranks, the
        whole model at once (level 1; a missing gradient counts as
        zeros)."""
        params = [s.param for s in self.slots.values() if s.shard is not None]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for p, g in zip(params, self._average([p.grad for p in params])):
            if g is not p.grad:
                p.grad.copy_(g)

    # -- level 3: the units --------------------------------------------------
    def _plan_units(self) -> None:
        found = zero_units(self.model)
        owner: Dict[str, int] = {}
        for i, (name, _) in enumerate(found):
            for n in self.slots:
                if n.startswith(name + '.'):
                    owner[n] = i
        units = [_Unit(name, m, [s for n, s in self.slots.items() if owner.get(n) == i])
                 for i, (name, m) in enumerate(found)]
        units = [u for u in units if u.slots]
        units.append(_Unit('', None, [s for n, s in self.slots.items() if n not in owner]))
        for u in units:
            u.nbytes = sum(s.shape.numel() * s.shard.element_size() for s in u.slots
                           if s.pdim is not None)
            u.ids = frozenset(id(s.param) for s in u.slots if s.pdim is not None)
            if u.module is not None:
                u.module.register_forward_pre_hook(functools.partial(self._pre_forward, u))
                u.module.register_forward_hook(functools.partial(self._post_forward, u))
            for s in u.slots:
                if s.param.requires_grad:
                    s.param.register_post_accumulate_grad_hook(
                        functools.partial(self._grad_arrived, u))
        self.units = units

    def unit_budget(self) -> int:
        """Two units' whole parameters and gradients: the two largest
        units' sharded parameter bytes, twice."""
        sizes = sorted((u.nbytes for u in self.units), reverse=True)
        return 2 * sum(sizes[:2])

    def _hold(self, nbytes: int) -> None:
        self._held += nbytes
        self.stats['peak_bytes'] = max(self.stats['peak_bytes'], self._held)

    def _gather_unit(self, u: _Unit) -> None:
        if u.gathered:
            return
        sharded = [s for s in u.slots if s.pdim is not None]
        for s, whole in zip(sharded, self._gather(sharded, lambda s: s.pdim)):
            if s.whole is None:
                s.whole = whole
                s.param.data = whole
            else:                       # refill the storage autograd's saved tensors read
                s.whole.untyped_storage().resize_(whole.numel() * whole.element_size())
                s.whole.copy_(whole)
        u.gathered = True
        self._hold(u.nbytes)
        self.unit_log.append(('gather', u.name))

    def _free_unit(self, u: _Unit) -> None:
        if u.gathered:
            for s in u.slots:
                if s.whole is not None:
                    s.whole.untyped_storage().resize_(0)
            u.gathered = False
            self._hold(-u.nbytes)

    def _pre_forward(self, u: _Unit, module, args) -> None:
        if self._active:
            self._gather_unit(u)
            if torch.is_grad_enabled() and not _in_backward() and not _hooks_open():
                u.saving = torch.autograd.graph.saved_tensors_hooks(
                    functools.partial(self._pack_cast, u), _unpack_cast)
                u.saving.__enter__()

    def _pack_cast(self, u: _Unit, t: torch.Tensor):
        """What autograd keeps of a tensor the unit's forward saves: for a
        cast of one of its sharded parameters (a bf16 copy of a float32
        weight), or a view of one (the transposed weight a matrix product
        saves), the parameter and how to cast and view it again from the
        refilled parameter in the backward; anything else as it is."""
        fn = (t if t._base is None else t._base).grad_fn
        if fn is not None and type(fn).__name__ == 'ToCopyBackward0':
            src = getattr(fn.next_functions[0][0], 'variable', None)
            if src is not None and id(src) in u.ids:
                self.stats['casts_recast'] += 1
                return src, t.dtype, t.size(), t.stride(), t.storage_offset()
        return t

    def _post_forward(self, u: _Unit, module, args, output) -> None:
        if u.saving is not None:
            u.saving.__exit__(None, None, None)
            u.saving = None
        # a recomputation inside the backward (remat) keeps the unit gathered
        if not self._active or _in_backward():
            return
        if torch.is_grad_enabled():
            for t in tree_leaves(output):
                if torch.is_tensor(t) and t.requires_grad:
                    t.register_hook(functools.partial(self._pre_backward, u))
        self._free_unit(u)

    def _pre_backward(self, u: _Unit, grad) -> None:
        """The gradient of a unit's output arrived: gather it again and
        note which of its gradients this backward will bring."""
        self._gather_unit(u)
        if not u.armed:
            u.armed = True
            u.pending = {id(s.param) for s in u.slots
                         if s.optimized and s.param.requires_grad and _will_get_grad(s.param)}

    def _grad_arrived(self, u: _Unit, param) -> None:
        if not self._active:
            return
        if param.grad is not None and id(param) in u.ids:
            nbytes = param.grad.numel() * param.grad.element_size()
            u.grad_bytes += nbytes
            self._hold(nbytes)
        if u.armed and id(param) in u.pending:
            u.pending.discard(id(param))
            if not u.pending:
                self._reduce_unit(u)

    def _reduce_unit(self, u: _Unit) -> None:
        """Average the unit's gradients over the data axis (missing ones
        count as zeros), note each tensor's norm, keep the rank's slices,
        free the whole gradients and (but the root) the parameters."""
        opt = [s for s in u.slots if s.optimized]
        grads = [s.param.grad if s.param.grad is not None
                 else torch.zeros(s.shape, dtype=s.shard.dtype, device=s.shard.device)
                 for s in opt]
        avgs = self._average(grads)
        if self._micro == 1 and avgs:
            self._norms.update(zip([s.name for s in opt], torch._foreach_norm(avgs, 2)))
        for s, avg in zip(opt, avgs):
            part = avg if s.pdim is None else _chunk(avg, s.pdim, self.rank, self.size)
            s.acc = part.clone(memory_format=torch.contiguous_format) if s.acc is None \
                else s.acc.add_(part)
        for s in u.slots:
            s.param.grad = None
        del grads, avgs
        self._hold(-u.grad_bytes)
        u.grad_bytes = 0
        if u.module is not None:
            self._free_unit(u)
        u.reduced = True
        self.unit_log.append(('reduce', u.name))

    # -- the step ------------------------------------------------------------
    def begin_step(self, forward_times: int = 1) -> None:
        """Arm the step: at level 3 gather the root unit (the others gather
        as their forwards run)."""
        self.model.zero_grad(set_to_none=True)
        self._micro, self._norms = forward_times, {}
        self._held = 0
        self.stats.update(peak_bytes=0, casts_recast=0)
        self.unit_log = []
        if self.units:
            self._active = True
            self._gather_unit(self.units[-1])

    def end_backward(self) -> None:
        """After a microbatch's backward (level 3): every unit not yet
        reduced reduces, in unit order (the root last), and frees."""
        for u in self.units:
            if not u.reduced:
                self._reduce_unit(u)
            u.reduced = u.armed = False
            u.pending = set()

    def end_step(self) -> None:
        """Level 3: free every whole parameter; the shards remain."""
        for s in self.slots.values():
            if s.pdim is not None:
                s.param.data = s.param.data.new_empty(0)
                s.whole = None
            s.param.grad = s.acc = None
        for u in self.units:
            if u.saving is not None:        # a forward that raised
                u.saving.__exit__(None, None, None)
                u.saving = None
            u.gathered = u.armed = u.reduced = False
            u.pending, u.grad_bytes = set(), 0
        self._active = False

    def step(self, tx, step: int) -> torch.Tensor:
        """One update at count ``step`` with the update rule ``tx``: the
        recorded (and clipped) norm of the averaged gradients (each tensor's
        norm over its whole gradient, in the optimizer's order), each
        shard's gradient, the optimizer's step on the shards, then at level
        1 the other ranks' slices copied in.  Returns the pre-clip norm."""
        from ever_tpu_torch.opt.optimizer import (clip_by_global_norm_recording, clip_scale,
                                                  global_norm)

        slots = self._ordered
        if self.units:
            if self._micro > 1:
                for s in slots:
                    s.acc.div_(self._micro)
            norms = self._acc_norms(slots) if self._micro > 1 else \
                [self._norms[s.name] for s in slots]
            if not slots:
                norm = torch.zeros(())
            else:
                norm = global_norm(norms, [getattr(s.param, '_tp_group', None) for s in slots])
                if tx.max_norm is not None:
                    torch._foreach_mul_([s.acc for s in slots], clip_scale(norm, tx.max_norm))
            for s in slots:
                s.shard.grad, s.acc = s.acc, None
        else:
            if self._micro > 1:
                for s in self.slots.values():
                    if s.param.grad is not None:
                        s.param.grad.div_(self._micro)
            self.reduce_grads()
            norm = clip_by_global_norm_recording([s.param for s in slots], tx.max_norm)
            for s in slots:
                if s.shard is not s.param:
                    dim = s.pdim if s.pdim is not None else s.odim
                    s.shard.grad = _chunk(s.param.grad, dim, self.rank, self.size).contiguous()
        tx.step(self.optimizer, step)
        level1 = [s for s in slots if s.pdim is None and s.odim is not None]
        for s, whole in zip(level1, self._gather(level1, lambda s: s.odim)):
            s.param.data.copy_(whole)
        for s in slots:
            if s.shard is not s.param:
                s.shard.grad = None
        return norm

    def _acc_norms(self, slots: List[_Slot]) -> List[torch.Tensor]:
        """Each tensor's norm over its whole gradient from the ranks'
        slices: the slices' squares summed over the data axis."""
        local = list(torch._foreach_norm([s.acc for s in slots], 2))
        split = [i for i, s in enumerate(slots) if s.pdim is not None]
        if split and self.size > 1:
            sq = torch.stack([local[i] for i in split]).square()
            tdist.all_reduce(sq, group=self.group)
            for i, n in zip(split, sq.sqrt()):
                local[i] = n
        return local


def full_state_dict(state) -> Dict[str, torch.Tensor]:
    """The model's whole ``state_dict`` on every rank (a collective under
    ZeRO-3, which gathers the sharded parameters over the data axis, and
    under tensor parallel, which gathers the shards over its axis; the
    state stays as it is)."""
    opt = state.optimizer
    sd = state.model.state_dict()
    if isinstance(opt, ZeroOptimizer) and opt.level == 3:
        slots = [s for s in opt.slots.values() if s.pdim is not None]
        sd.update(zip([s.name for s in slots], opt._gather(slots, lambda s: s.pdim)))
    return {k: v.clone() for k, v in gather_tp(state.model, sd).items()}


def local_bytes(state) -> Dict[str, int]:
    """The bytes this rank holds of the train state: the parameters
    (whole, or their shards under ZeRO-3), the optimizer state, the
    buffers."""
    opt = state.optimizer
    if isinstance(opt, ZeroOptimizer):
        params = sum((s.shard if s.pdim is not None else s.param).nbytes
                     for s in opt.slots.values())
        inner = opt.optimizer
    else:
        params = sum(p.nbytes for p in state.model.parameters())
        inner = opt
    opt_bytes = sum(v.nbytes for st in inner.state.values() for v in st.values()
                    if torch.is_tensor(v))
    return dict(params=params, opt_state=opt_bytes,
                buffers=sum(b.nbytes for b in state.model.buffers()))
