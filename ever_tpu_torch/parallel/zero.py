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
  parameter's own storage is freed); the step gathers the whole parameters
  before the forward and frees them after the update.  The whole model is
  gathered for the step, not block by block: the state at rest is 1/N a
  rank, the step's peak is not (``ROADMAP.md`` §C).

The gradients are averaged over the ranks by one all-reduce of the
flattened gradients (each divided by the rank count first, as
``DistributedDataParallel`` divides), and each rank reads its shard from
the result: the reduce-scatter as an all-reduce and a slice.  The
parameters are gathered by one broadcast of each rank's flattened shards.
All-reduce and broadcast run on every backend the port uses (gloo on CPU
and CUDA tensors, NCCL).  The gradients' global norm (the recorded
``grad_norm`` and the clip) is taken over the whole averaged gradients, as
the replicated step takes it, so a ZeRO step computes what the replicated
step computes, element by element (a reduce-scatter would leave each rank
its shard's sum of squares, added over the ranks in another order).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as tdist
import torch.nn as nn

from ever_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from ever_tpu_torch.parallel.tp import gather_tp

__all__ = ['shard_leaf_sharding', 'zero_shardings', 'zero_init', 'StateShardings',
           'ZeroOptimizer', 'full_state_dict', 'local_bytes']


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
    itself when its state is replicated)."""
    name: str
    param: nn.Parameter
    shape: torch.Size
    pdim: Optional[int]
    odim: Optional[int]
    shard: Optional[torch.Tensor]


class ZeroOptimizer:
    """The optimizer of a ZeRO train state (module docstring).

    ``optimizer`` is the replicated state's optimizer: its class, groups
    and hyperparameters are kept, over this rank's shards.  The parameters
    move to ``device`` (their own unless given), a level-3 sharded one as
    its shard alone, so that a state built on the host reaches the card
    shard by shard (``parallel/sharded.py``)."""

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
            self.slots[n] = _Slot(n, p, shape, pdim, odim, shard)
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

    def gather_params(self) -> None:
        """Level 3: the whole parameters into the model for a step."""
        slots = [s for s in self.slots.values() if s.pdim is not None]
        for s, whole in zip(slots, self._gather(slots, lambda s: s.pdim)):
            s.param.data = whole

    def release_params(self) -> None:
        """Level 3: free the whole parameters after a step."""
        for s in self.slots.values():
            if s.pdim is not None:
                s.param.data = s.param.data.new_empty(0)
                s.param.grad = None

    def reduce_grads(self) -> None:
        """Average the optimized parameters' gradients over the ranks (one
        all-reduce a dtype; a missing gradient counts as zeros)."""
        params = [s.param for s in self.slots.values() if s.shard is not None]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.size == 1:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads]).div_(self.size)
            tdist.all_reduce(flat, group=self.group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def step(self, tx, step: int) -> torch.Tensor:
        """One update at count ``step`` with the update rule ``tx``: the
        recorded (and clipped) norm of the whole averaged gradients, each
        shard's gradient sliced from them, the optimizer's step on the
        shards, then the other ranks' slices copied in (level 1).  Returns
        the pre-clip norm."""
        from ever_tpu_torch.opt.optimizer import clip_by_global_norm_recording

        slots = [s for s in self.slots.values() if s.shard is not None]
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
