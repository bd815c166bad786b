"""Tensor parallel for the ViT blocks (counterpart of
``ever_tpu/parallel/tp.py``).

The placement rule is the JAX package's, by parameter-name suffix: the
fused qkv projection and the MLP's up-projections (``fc1``; the SwiGLU's
``w1`` and ``w2``, which the JAX package fuses into one ``w12``) are
column parallel, the attention's output projection and the MLP's
down-projection (``proj``, ``fc2``, ``w3``) row parallel, and every other
leaf, biases included, is replicated.  A leaf the axis does not divide
stays replicated.  The port's weights are ``[out, in]``, so a column-
parallel leaf is split on dimension 0 (``P('model', None)``) and a
row-parallel one on dimension 1 (``P(None, 'model')``); the JAX kernels
are ``[in, out]`` with the opposite specs, and the split dimensions have
the same sizes.

In JAX the placement is all: GSPMD rewrites the blocks' compute around it.
Here :func:`apply_tp` also makes each block compute in the Megatron layout
over the axis's process group:

- a column-parallel layer's input passes an operator that is the identity
  forward and an all-reduce backward (each rank's input gradient is a
  partial sum over its columns);
- a row-parallel layer's output is all-reduced forward (each rank holds a
  partial sum over its rows) and passed through backward unchanged, and
  its bias is added once, after the all-reduce;
- a column-parallel layer's bias stays whole on every rank (the JAX rule
  matches kernels only); each rank adds its own slice of it, so the slice's
  gradient is scattered into a whole-size gradient and all-reduced, which
  gives every rank the whole bias's gradient.

So every replicated parameter ends a backward with its whole gradient on
every rank of the axis, and every split one with its shard's.  The
attention is split by heads: rank ``r`` of ``k`` holds heads ``[r·H/k,
(r+1)·H/k)``, which in the packed qkv projection are the rows of those
heads in each of q, k and v.  So the qkv weight's shard is those rows
(``ROADMAP.md`` §C: JAX's contiguous split of the packed columns gives
rank 0 all of q and half of k, which GSPMD then regroups), and a split qkv
whose heads the axis does not divide raises.

The global gradient norm (the recorded ``grad_norm`` and the clip) counts
each shard once and each replicated leaf once: :func:`apply_tp` marks
every split parameter with its group, and
``opt.optimizer.clip_by_global_norm_recording`` sums the squares of the
marked ones over it.  :func:`gather_tp` puts the shards of a rank's tensors
(parameters, gradients) back together, on every rank of the axis.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.parallel.mesh import Mesh, NamedSharding, P

__all__ = ['vit_tp_shardings', 'apply_tp']

_COLUMN_SUFFIXES = ('attn.qkv.weight', 'mlp.w1.weight', 'mlp.w2.weight', 'mlp.fc1.weight')
_ROW_SUFFIXES = ('attn.proj.weight', 'mlp.w3.weight', 'mlp.fc2.weight')


def tp_split_dim(name: str, shape, k: int) -> Optional[int]:
    """The dimension of the ``[out, in]`` leaf ``name`` that tensor parallel
    over ``k`` ranks splits (0 column parallel, 1 row parallel), or None:
    not a TP leaf, or the axis does not divide it."""
    if len(shape) < 2:
        return None
    if any(name.endswith(s) for s in _COLUMN_SUFFIXES):
        dim = 0
    elif any(name.endswith(s) for s in _ROW_SUFFIXES):
        dim = 1
    else:
        return None
    return dim if shape[dim] % k == 0 else None


def vit_tp_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh,
                     axis: str = 'model') -> Dict[str, NamedSharding]:
    """Each parameter's placement in the Megatron layout (module docstring):
    ``{name: NamedSharding}`` for ``params``, ``{name: tensor}`` (a
    ``state_dict``, or ``dict(model.named_parameters())``)."""
    k = mesh.axis_size(axis)
    out = {}
    for name, leaf in params.items():
        dim = tp_split_dim(name, tuple(leaf.shape), k)
        spec = [None] * len(leaf.shape)
        if dim is not None:
            spec[dim] = axis
        out[name] = NamedSharding(mesh, P(*spec) if dim is not None else P())
    return out


def tp_view(name: str, shape, dim: int, k: int, zdim: Optional[int] = None,
            n: int = 1) -> Tuple[Tuple[int, ...], int, Optional[int]]:
    """How a directory checkpoint writes the tensor-parallel leaf ``name``:
    ``(whole view shape, model-axis dimension, data-axis dimension)``, a
    reshape of the whole tensor in which this rank's shard is one block.
    ``shape`` is the rank's shard (split on ``dim`` over ``k`` ranks),
    further split by ZeRO on its ``zdim`` over ``n`` data ranks.  The split
    dimension becomes ``(3, k, rows)`` for the packed qkv weight (each rank
    holds its heads' rows of q, k and v) and ``(1, k, rows)`` otherwise;
    when ZeRO splits that dimension too, ``(k, n, rows)``."""
    shape = tuple(shape)
    g = 3 if name.endswith('attn.qkv.weight') else 1
    before, after, rows = shape[:dim], shape[dim + 1:], shape[dim] // g
    if zdim is not None and n > 1 and zdim == dim:
        if g != 1:
            raise ValueError(f'{name}: ZeRO splits the packed qkv rows that tensor parallel '
                             f'splits by head; no directory layout holds both')
        return before + (k, n, rows // n) + after, dim, dim + 1
    data = None if zdim is None or n == 1 else zdim if zdim < dim else zdim + 2
    return before + (g, k, rows) + after, dim + 1, data


@dataclass
class TPPlan:
    """What :func:`apply_tp` made of a model: the axis's group, its global
    ranks, this rank's coordinate, and for each split parameter its split
    dimension and the whole tensor's indices on it that each rank holds."""
    group: object
    ranks: Tuple[int, ...]
    rank: int
    sharded: Dict[str, Tuple[int, List[torch.Tensor]]] = field(default_factory=dict)
    axis: str = 'model'

    @property
    def size(self) -> int:
        return len(self.ranks)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over the axis forward; the gradient unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SliceOfReplicated(torch.autograd.Function):
    """``whole[index]`` of a replicated tensor; backward, the slice's
    gradient in a whole-size zero tensor, all-reduced over the axis: every
    rank gets the whole tensor's gradient."""

    @staticmethod
    def forward(ctx, whole, index, group):
        ctx.save_for_backward(index)
        ctx.group, ctx.shape = group, whole.shape
        return whole.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        out.index_copy_(0, index, grad)
        tdist.all_reduce(out, group=ctx.group)
        return out, None, None


def _bias(linear: nn.Linear, index: Optional[torch.Tensor], group, dtype):
    if linear.bias is None:
        return None
    bias = linear.bias if index is None else _SliceOfReplicated.apply(linear.bias, index, group)
    return bias.to(dtype)


def _row_out(y: torch.Tensor, linear: nn.Linear, group) -> torch.Tensor:
    y = _ReduceFromTP.apply(y, group)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


def _chunk(n: int, rank: int, k: int) -> torch.Tensor:
    return torch.arange(rank * n // k, (rank + 1) * n // k)


def _qkv_rows(dim: int, rank: int, k: int) -> torch.Tensor:
    """The packed qkv rows of rank ``rank``'s heads: in each of q, k and v,
    the rows of heads ``[rank·H/k, (rank+1)·H/k)``."""
    return torch.cat([j * dim + _chunk(dim, rank, k) for j in range(3)])


class _TPModule(nn.Module):
    """A block's sublayer in the Megatron layout: ``_split`` replaces a
    Linear's weight by this rank's rows or columns and records the split in
    the plan; column-parallel biases are sliced by index buffers."""

    def _setup(self, plan: TPPlan, prefix: str):
        self.group = plan.group
        self._plan, self._prefix = plan, prefix

    def _split(self, name: str, linear: nn.Linear, dim: int,
               indices: List[torch.Tensor]) -> None:
        w = linear.weight
        local = w.detach().index_select(dim, indices[self._plan.rank].to(w.device)).clone()
        p = nn.Parameter(local, requires_grad=w.requires_grad)
        p._tp_group = self.group
        linear.weight = p
        self._plan.sharded[f'{self._prefix}{name}.weight'] = (dim, indices)

    def _index(self, buffer: str, index: torch.Tensor, device) -> None:
        self.register_buffer(buffer, index.to(device), persistent=False)


@functools.lru_cache(maxsize=None)
def _tp_attention_cls():
    from ever_tpu_torch.module.vit import SelfAttention

    class TPSelfAttention(_TPModule, SelfAttention):
        """``SelfAttention`` over this rank's heads (module docstring)."""

        def __init__(self, attn, plan: TPPlan, prefix: str):
            nn.Module.__init__(self)
            self._setup(plan, prefix)
            h, k = attn.num_heads, plan.size
            dim = attn.qkv.in_features
            if h % k:
                raise ValueError(f'{prefix}qkv: {h} heads do not split over {k} tensor-parallel '
                                 f'ranks (the port splits attention by heads)')
            self.num_heads, self.attn_impl = h // k, attn.attn_impl
            self.qkv, self.proj = attn.qkv, attn.proj
            dev = attn.qkv.weight.device
            rows = [_qkv_rows(dim, r, k) for r in range(k)]
            self._split('qkv', self.qkv, 0, rows)
            self._split('proj', self.proj, 1, [_chunk(dim, r, k) for r in range(k)])
            self._index('qkv_rows', rows[plan.rank], dev)

        def forward(self, x, rope=None, n_valid=None):
            x = _CopyToTP.apply(x, self.group)
            qkv = F.linear(x, self.qkv.weight.to(x.dtype),
                           _bias(self.qkv, self.qkv_rows, self.group, x.dtype))
            out = self._attend(qkv, rope, n_valid)
            return _row_out(F.linear(out, self.proj.weight.to(out.dtype)), self.proj, self.group)

    return TPSelfAttention


@functools.lru_cache(maxsize=None)
def _tp_mlp_cls():
    from ever_tpu_torch.module.vit import Mlp

    class TPMlp(_TPModule, Mlp):
        """``Mlp`` over this rank's hidden units: ``fc1`` by rows, ``fc2`` by
        columns."""

        def __init__(self, mlp, plan: TPPlan, prefix: str):
            nn.Module.__init__(self)
            self._setup(plan, prefix)
            self.fc1, self.fc2 = mlp.fc1, mlp.fc2
            k, hidden = plan.size, mlp.fc1.out_features
            chunks = [_chunk(hidden, r, k) for r in range(k)]
            self._split('fc1', self.fc1, 0, chunks)
            self._split('fc2', self.fc2, 1, chunks)
            self._index('hidden_rows', chunks[plan.rank], mlp.fc1.weight.device)

        def forward(self, x):
            x = _CopyToTP.apply(x, self.group)
            h = F.linear(x, self.fc1.weight.to(x.dtype),
                         _bias(self.fc1, self.hidden_rows, self.group, x.dtype))
            h = F.gelu(h, approximate='tanh')
            return _row_out(F.linear(h, self.fc2.weight.to(h.dtype)), self.fc2, self.group)

    return TPMlp


@functools.lru_cache(maxsize=None)
def _tp_swiglu_cls():
    from ever_tpu_torch.module.vit import SwiGLUFFN

    class TPSwiGLUFFN(_TPModule, SwiGLUFFN):
        """``SwiGLUFFN`` over this rank's gate units: ``w1`` and ``w2`` by
        rows, ``w3`` by columns."""

        def __init__(self, mlp, plan: TPPlan, prefix: str):
            nn.Module.__init__(self)
            self._setup(plan, prefix)
            self.w1, self.w2, self.w3 = mlp.w1, mlp.w2, mlp.w3
            k, gate = plan.size, mlp.w1.out_features
            chunks = [_chunk(gate, r, k) for r in range(k)]
            self._split('w1', self.w1, 0, chunks)
            self._split('w2', self.w2, 0, chunks)
            self._split('w3', self.w3, 1, chunks)
            self._index('gate_rows', chunks[plan.rank], mlp.w1.weight.device)

        def forward(self, x):
            x = _CopyToTP.apply(x, self.group)
            a = F.linear(x, self.w1.weight.to(x.dtype),
                         _bias(self.w1, self.gate_rows, self.group, x.dtype))
            b = F.linear(x, self.w2.weight.to(x.dtype),
                         _bias(self.w2, self.gate_rows, self.group, x.dtype))
            h = F.silu(a) * b
            return _row_out(F.linear(h, self.w3.weight.to(h.dtype)), self.w3, self.group)

    return TPSwiGLUFFN


def _splits(sharding: Optional[NamedSharding], axis: str) -> bool:
    return sharding is not None and any(
        a == axis or (isinstance(a, tuple) and axis in a) for a in sharding.spec)


def apply_tp(model: nn.Module, mesh: Mesh, axis: str = 'model',
             shardings: Optional[Mapping[str, NamedSharding]] = None,
             device=None) -> nn.Module:
    """Put ``model`` (whole on every rank, the same weights, on any device)
    in the Megatron layout over ``mesh``'s ``axis`` on ``device`` (the GPU
    unless given), in place, and return it: every attention, MLP and
    SwiGLU sublayer whose split leaves ``shardings`` (default
    :func:`vit_tp_shardings`) place on ``axis`` keeps this rank's shard of
    them and computes in the layout of the module docstring; the others
    stay whole.  The shards are cut where the model is, then moved, so a
    model built on the host never reaches the card whole.  Parameter names
    are unchanged.  A collective call: every rank of the mesh applies
    it."""
    from ever_tpu_torch.core.device import get_device
    from ever_tpu_torch.module.vit import Mlp, SelfAttention, SwiGLUFFN

    dev = get_device(device)
    if mesh.abstract:
        raise ValueError('an abstract mesh runs no step: tensor parallel needs the mesh of a '
                         'process group (parallel.mesh.make_mesh)')
    if getattr(model, '_ever_tp', None) is not None:
        raise ValueError('the model is tensor parallel already')
    if shardings is None:
        shardings = vit_tp_shardings(dict(model.named_parameters()), mesh, axis)
    k = mesh.axis_size(axis)
    if k == 1:
        return model.to(dev)
    plan = TPPlan(mesh.axis_group(axis), mesh.axis_ranks(axis), mesh.rank(axis), axis=axis)
    layers = ((SelfAttention, ('qkv', 'proj'), _tp_attention_cls),
              (SwiGLUFFN, ('w1', 'w2', 'w3'), _tp_swiglu_cls),
              (Mlp, ('fc1', 'fc2'), _tp_mlp_cls))
    for name, module in list(model.named_modules()):
        for cls, leaves, make in layers:
            if type(module) is cls:
                prefix = f'{name}.' if name else ''
                split = [_splits(shardings.get(f'{prefix}{leaf}.weight'), axis)
                         for leaf in leaves]
                if all(split):
                    parent, _, child = name.rpartition('.')
                    setattr(model.get_submodule(parent), child, make()(module, plan, prefix))
                elif any(split):
                    raise ValueError(f'{name}: the placements split {leaves} only in part '
                                     f'({split})')
    model._ever_tp = plan
    return model.to(dev)


def tp_plan(model: nn.Module) -> Optional[TPPlan]:
    """The model's :class:`TPPlan`, or None when it is not tensor parallel."""
    return getattr(model, '_ever_tp', None)


def gather_tp(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (this rank's, by parameter name: parameters, gradients)
    with every tensor-parallel shard among them put back whole, on every
    rank of the axis (one broadcast a rank a leaf; a collective call, with
    the same names on every rank).  Other entries are returned as they
    are."""
    plan = tp_plan(model)
    out = dict(tensors)
    if plan is None:
        return out
    for name, (dim, indices) in plan.sharded.items():
        if name not in tensors:
            continue
        local = tensors[name].detach().contiguous()
        shape = list(local.shape)
        shape[dim] *= plan.size
        whole = local.new_empty(shape)
        for r, src in enumerate(plan.ranks):
            part = local if r == plan.rank else torch.empty_like(local)
            tdist.broadcast(part, src=src, group=plan.group)
            whole.index_copy_(dim, indices[r].to(whole.device), part)
        out[name] = whole
    return out
