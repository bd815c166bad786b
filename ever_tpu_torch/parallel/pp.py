"""Pipeline parallel (GPipe) over a ``'pipe'`` mesh axis (counterpart of
``ever_tpu/parallel/pp.py``).

Stage ``s`` of ``S`` (the rank's coordinate on the axis) holds layers
``[s·L/S, (s+1)·L/S)``; ``M`` microbatches stream through them.  The JAX
package runs the classic schedule as one SPMD program: ``M + S − 1`` ticks,
every stage computing at every tick (the bubble's ticks on garbage that
the masks discard) and the activations hopping by ``ppermute``.  Here each
stage computes only its ``M`` real microbatches, in order, and skips the
bubble, which changes no value: stage ``s`` takes microbatch ``m`` from
stage ``s − 1`` (stage 0 from the input), runs its layers and hands the
result to stage ``s + 1``; the last stage's outputs are broadcast back to
every stage, as the JAX version's masked ``psum`` does.  So a stage runs
each of its layers ``M`` times a forward (and a backward).

The hops are autograd functions, so a plain ``loss.backward()`` on every
rank runs the backward schedule: each stage takes microbatch ``m``'s
output gradient from its successor, backpropagates its layers and sends
the input gradient to its predecessor, for ``m = M − 1, …, 0``.  A hop is
a broadcast in the two-rank group of the neighbours (gloo carries only
all-reduce and broadcast on CUDA tensors, and NCCL refuses two ranks on
one card, so the same code runs under both).  The gradients equal one
process's, neither ``S`` times them nor zero off the first stage:

- every rank computes the same loss of the broadcast outputs, and the
  broadcast's backward takes the last stage's own output gradient once;
- the input (the embedded tokens) is replicated and only stage 0 reads it,
  so its gradient is broadcast from stage 0 to every stage: the replicated
  embedding, the RoPE tables' inputs and ``x`` get one process's gradient
  on every rank; the final norms, applied on every rank to the same
  outputs, get it too.

Every hop op takes a zero ``anchor`` that requires a gradient whenever
autograd records, so every rank's backward runs every one of its hops
whatever requires a gradient, in the same order on the two ranks of each
pair (the engine runs the later microbatch's nodes first).

A ``('data', 'pipe')`` mesh runs one pipeline on each data rank's batch
rows, as the JAX version shards the microbatch stream over every axis but
the pipe axis.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as tdist
import torch.nn as nn
from torch.utils._pytree import tree_leaves, tree_map

from ever_tpu_torch.parallel.mesh import _CURRENT, Mesh

__all__ = ['stack_layer_params', 'pipeline', 'pipelined_vit_apply']


def stack_layer_params(per_layer: Sequence[Any]) -> Any:
    """Stack ``L`` structurally identical per-layer trees of tensors on a new
    leading layer axis (each leaf ``[L, ...]``): the layout a stage's
    layers take in :func:`pipeline`."""
    return tree_map(lambda *xs: torch.stack(xs), per_layer[0], *per_layer[1:])


@dataclass
class _Pipe:
    """This rank's place on a pipe axis: the axis's group and global ranks,
    its stage, the two-rank groups it shares with its neighbours, and what
    its hops moved (``stats``: this rank's sent bytes and its host ms in
    the neighbour hops and in the broadcasts over the axis)."""
    group: Any
    ranks: tuple
    stage: int
    prev: Any
    next: Any
    stats: dict = field(default_factory=lambda: dict(hops=0, hop_bytes=0, hop_ms=0.0,
                                                     broadcasts=0, broadcast_bytes=0,
                                                     broadcast_ms=0.0))

    @classmethod
    def of(cls, mesh: Mesh, axis: str) -> '_Pipe':
        if mesh.abstract:
            raise ValueError('an abstract mesh runs no pipeline: it needs the mesh of a '
                             'process group (parallel.mesh.make_mesh)')
        prev, nxt = mesh.neighbour_groups(axis)
        return cls(mesh.axis_group(axis), mesh.axis_ranks(axis), mesh.rank(axis), prev, nxt)

    @property
    def stages(self) -> int:
        return len(self.ranks)

    def _move(self, t: torch.Tensor, src_stage: int, group, kind: str) -> None:
        t0 = time.perf_counter()
        tdist.broadcast(t, src=self.ranks[src_stage], group=group)
        stats = self.stats
        stats[f'{kind}_ms'] += (time.perf_counter() - t0) * 1e3
        if src_stage == self.stage:
            stats[f'{kind}s'] += 1
            stats[f'{kind}_bytes'] += t.numel() * t.element_size()

    def from_prev(self, t: torch.Tensor) -> None:
        """Receive ``t`` from the previous stage, in place."""
        self._move(t, self.stage - 1, self.prev, 'hop')

    def to_prev(self, t: torch.Tensor) -> None:
        self._move(t, self.stage, self.prev, 'hop')

    def to_next(self, t: torch.Tensor) -> None:
        self._move(t, self.stage, self.next, 'hop')

    def from_next(self, t: torch.Tensor) -> None:
        """Receive ``t`` from the next stage, in place."""
        self._move(t, self.stage + 1, self.next, 'hop')

    def broadcast(self, t: torch.Tensor, src_stage: int) -> None:
        """``t`` from ``src_stage`` to every stage of the axis, in place."""
        self._move(t, src_stage, self.group, 'broadcast')


class _FromFirst(torch.autograd.Function):
    """Identity forward on the replicated pipeline input; backward, the
    gradient stage 0 computed, broadcast to every stage."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        ctx.pipe.broadcast(grad, 0)
        return grad, None


class _Recv(torch.autograd.Function):
    """A microbatch's activation from the previous stage; backward, its
    gradient sent back there."""

    @staticmethod
    def forward(ctx, anchor, pipe, shape, dtype):
        ctx.pipe = pipe
        h = torch.empty(shape, dtype=dtype, device=anchor.device)
        pipe.from_prev(h)
        return h

    @staticmethod
    def backward(ctx, grad):
        ctx.pipe.to_prev(grad.contiguous())
        return None, None, None, None


class _Send(torch.autograd.Function):
    """A microbatch's activation to the next stage (the output is a zero
    placeholder); backward, the activation's gradient from there."""

    @staticmethod
    def forward(ctx, h, anchor, pipe):
        ctx.pipe, ctx.shape, ctx.dtype = pipe, h.shape, h.dtype
        pipe.to_next(h.contiguous())
        return anchor.new_zeros(())

    @staticmethod
    def backward(ctx, placeholder_grad):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=placeholder_grad.device)
        ctx.pipe.from_next(grad)
        return grad, None, None


class _Collect(torch.autograd.Function):
    """The last stage's stacked outputs broadcast to every stage.  Backward,
    the last stage passes its own output gradient on (every rank computed
    the same loss of the same outputs: the gradient counts once), and the
    placeholders of the other stages' hops get zeros."""

    @staticmethod
    def forward(ctx, pipe, shape, dtype, anchor, stacked, *placeholders):
        ctx.last = stacked is not None
        ctx.shapes = [(p.shape, p.dtype) for p in placeholders]
        out = stacked.clone(memory_format=torch.contiguous_format) if ctx.last else \
            torch.empty(shape, dtype=dtype, device=anchor.device)
        pipe.broadcast(out, pipe.stages - 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        zeros = [grad.new_zeros(s, dtype=d) for s, d in ctx.shapes]
        return (None, None, None, None, grad if ctx.last else None, *zeros)


def _gpipe(stage_fn: Callable[[torch.Tensor], torch.Tensor], xs: torch.Tensor,
           pipe: _Pipe) -> torch.Tensor:
    """``xs`` ``[M, mb, ...]`` (the same on every stage) through the stages'
    ``stage_fn`` by the schedule of the module docstring: ``[M, mb, ...]``
    on every stage.  ``stage_fn`` keeps a microbatch's shape and dtype."""
    stages, s, m_count = pipe.stages, pipe.stage, xs.shape[0]
    if stages == 1:
        return torch.stack([stage_fn(xs[m]) for m in range(m_count)])
    anchor = torch.zeros((), device=xs.device, requires_grad=torch.is_grad_enabled())
    if xs.requires_grad:
        xs = _FromFirst.apply(xs, pipe)
    placeholders, outs = [], []
    for m in range(m_count):
        h = xs[m] if s == 0 else _Recv.apply(anchor, pipe, xs.shape[1:], xs.dtype)
        h = stage_fn(h)
        if h.shape != xs.shape[1:] or h.dtype != xs.dtype:
            raise ValueError(f'a stage changed a microbatch from {tuple(xs.shape[1:])} '
                             f'{xs.dtype} to {tuple(h.shape)} {h.dtype}')
        if s < stages - 1:
            placeholders.append(_Send.apply(h, anchor, pipe))
        else:
            outs.append(h)
    if s > 0 and xs.requires_grad:
        placeholders.append(xs)
    stacked = torch.stack(outs) if outs else None
    return _Collect.apply(pipe, xs.shape, xs.dtype, anchor, stacked, *placeholders)


def pipeline(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
             x_microbatches: torch.Tensor, *, axis_name: str = 'pipe') -> torch.Tensor:
    """GPipe over ``axis_name`` of the current mesh (``with mesh:``), on
    every rank of it.

    ``stage_params``: this rank's layer stack (each leaf ``[L_stage,
    ...]``); ``layer_fn(p, h) -> h`` applies one layer; ``x_microbatches``
    ``[M, mb, ...]``, the same on every rank (stage 0 reads it).  Returns
    ``[M, mb, ...]``, the same on every rank; gradients reach this stage's
    parameters and, on every rank, the input (module docstring)."""
    mesh = _CURRENT.get()
    if mesh is None:
        raise ValueError(f'pipeline over {axis_name!r} outside a mesh: enter `with mesh:`')
    depth = tree_leaves(stage_params)[0].shape[0]

    def stage_fn(h):
        for i in range(depth):
            h = layer_fn(tree_map(lambda t: t[i], stage_params), h)
        return h

    return _gpipe(stage_fn, x_microbatches, _Pipe.of(mesh, axis_name))


class PipelinedViT(nn.Module):
    """This stage of a ``DinoVisionTransformer`` pipelined over a mesh axis
    (:func:`pipelined_vit_apply`): the patch embedding, the cls and
    storage tokens, RoPE and the final norms (replicated), and the stage's
    blocks, under the trunk's own names (``blocks.{i}`` of the whole
    trunk's numbering).  Calling it on this rank's batch rows returns the
    trunk's output dict; ``stats`` is what its hops moved."""

    def __init__(self, model: nn.Module, variables: Optional[dict], mesh: Mesh,
                 num_microbatches: int, axis_name: str, device):
        from ever_tpu_torch.core.device import get_device

        super().__init__()
        stages, depth = mesh.axis_size(axis_name), model.depth
        stage = mesh.rank(axis_name)
        per = depth // stages
        self.block_ids = list(range(stage * per, (stage + 1) * per))
        dev = get_device(device)
        # the trunk without its blocks, then this stage's blocks alone
        trunk = copy.deepcopy(model, memo={id(model.blocks): nn.ModuleList()})
        trunk.blocks = nn.ModuleDict({str(i): copy.deepcopy(model.blocks[i])
                                      for i in self.block_ids})
        if variables is not None:
            mine = {k: v for k, v in variables.items()
                    if not k.startswith('blocks.') or int(k.split('.')[1]) in self.block_ids}
            trunk.load_state_dict(mine, strict=True)
        trunk.to(dev)
        self._trunk = [trunk]                 # its methods; not a second registration
        for name, child in trunk.named_children():
            self.add_module(name, child)
        for name, p in trunk.named_parameters(recurse=False):
            self.register_parameter(name, p)
        self.num_microbatches, self.axis_name = num_microbatches, axis_name
        self.data_axes = tuple(a for a in mesh.axis_names if a != axis_name)
        self.data_ranks = math.prod(mesh.shape[a] for a in self.data_axes)
        self.pipe = _Pipe.of(mesh, axis_name)

    @property
    def stats(self) -> dict:
        return self.pipe.stats

    def forward(self, x: torch.Tensor) -> dict:
        trunk, m_count = self._trunk[0], self.num_microbatches
        b = x.shape[0]
        total = b * self.data_ranks
        if total % m_count:
            raise ValueError(f'batch {total} not divisible by {m_count} microbatches')
        if (total // m_count) % self.data_ranks:
            raise ValueError(f'microbatch size {total // m_count} not divisible by the '
                             f'{self.data_ranks}-way data sharding over {self.data_axes}')
        tokens, hw = trunk._tokens(x)
        rope = trunk.rope_embed(*hw, device=tokens.device)
        n, d = tokens.shape[1:]
        blocks = list(trunk.blocks.values())

        def stage_fn(t):
            for blk in blocks:
                t = blk(t, rope)
            return t

        out = _gpipe(stage_fn, tokens.reshape(m_count, b // m_count, n, d), self.pipe)
        cls_and_storage, patches = trunk._norm_prefix_patches(out.reshape(b, n, d), hw)
        return dict(x_norm_clstoken=cls_and_storage[:, 0],
                    x_storage_tokens=cls_and_storage[:, 1:],
                    x_norm_patchtokens=patches, grid=hw)


def pipelined_vit_apply(model: nn.Module, variables: Optional[dict], mesh: Mesh, *,
                        num_microbatches: Optional[int] = None, axis_name: str = 'pipe',
                        device=None) -> PipelinedViT:
    """A pipelined forward of the ``DinoVisionTransformer`` ``model`` over
    ``mesh``'s ``axis_name``, on ``device`` (the GPU unless given): this
    rank's :class:`PipelinedViT`, a module called as ``fn(x) -> dict`` with
    the trunk's output keys on this rank's rows of the batch.

    ``variables`` is the trunk's standard ``state_dict`` (None: the
    model's own weights); the stage loads the embedding, the norms and its
    blocks from it and nothing else.  ``num_microbatches`` defaults to the
    number of stages.  A depth the stages do not divide, a batch the
    microbatches do not divide and a microbatch the data axes do not divide
    raise ``ValueError``, as in the JAX package.  A collective call: every
    rank of the mesh makes its stage."""
    stages = mesh.axis_size(axis_name)
    if model.depth % stages:
        raise ValueError(f'depth {model.depth} not divisible by {stages} pipeline stages')
    return PipelinedViT(model, variables, mesh, num_microbatches or stages, axis_name, device)
