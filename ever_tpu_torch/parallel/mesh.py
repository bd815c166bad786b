"""The data axis over the process group (counterpart of
``ever_tpu/parallel/mesh.py``).

A JAX mesh lays devices out on named axes, and a jitted step over a batch
sharded on ``'data'`` reduces every batch sum over all of them.  Here one
process drives one card, so the data axis is the process group, and the
reductions the JAX compiler inserts are explicit: the model's code asks
:func:`reduction_group` whether it runs inside a data-parallel step (``with
mesh:``, as the train step enters it) over more than one rank, and if so
sums its batch statistics with :func:`all_reduce_sum`, whose gradient is the
same sum of the gradients.  Outside a mesh, or with one rank, nothing is
reduced and the code is that of one process.

Only the 1-D data mesh is ported; the 2-D and hybrid meshes wait for the
model-parallel layouts.
"""

from __future__ import annotations

import contextvars
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ever_tpu_torch.core import dist

__all__ = ['Mesh', 'make_mesh', 'reduction_group', 'data_shard', 'all_reduce_sum']

_CURRENT: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_mesh',
                                                         default=None)


class Mesh:
    """The ``'data'`` axis over the processes of ``group`` (None: one process
    and no process group).

    ``size()`` and ``shape`` read as the JAX mesh's; ``with mesh:`` makes it
    the current mesh, whose data axis the batch statistics are reduced over.
    """

    def __init__(self, axis_names: Sequence[str] = ('data',), group=None):
        self.axis_names = tuple(axis_names)
        self.group = group
        self._wrapped = {}
        self._token = []

    def size(self) -> int:
        return 1 if self.group is None else tdist.get_world_size(self.group)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size()}

    def rank(self) -> int:
        """This process's index on the data axis."""
        return 0 if self.group is None else tdist.get_rank(self.group)

    def axis_group(self, axis_name: Optional[str] = None):
        """The process group of ``axis_name`` (the data axis by default)."""
        if axis_name is not None and axis_name not in self.axis_names:
            raise ValueError(f'unknown mesh axis {axis_name!r}; axes: {self.axis_names}')
        return self.group

    def data_parallel(self, model: torch.nn.Module, find_unused_parameters: bool = False):
        """``model`` wrapped once in ``DistributedDataParallel`` over the data
        axis.  Buffers are not broadcast (``broadcast_buffers=False``): the
        running statistics move by the global batch statistics, so every
        rank holds the same ones."""
        key = (id(model), find_unused_parameters)
        if key not in self._wrapped:
            from torch.nn.parallel import DistributedDataParallel
            dev = next(model.parameters()).device
            with warnings.catch_warnings():
                # newer releases rename the flag; its meaning here is unchanged
                warnings.filterwarnings('ignore', '`broadcast_buffers` is deprecated')
                self._wrapped[key] = (model, DistributedDataParallel(
                    model, device_ids=[dev.index] if dev.type == 'cuda' else None,
                    process_group=self.group, broadcast_buffers=False,
                    find_unused_parameters=find_unused_parameters))
        return self._wrapped[key][1]

    def __enter__(self):
        self._token.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._token.pop())
        return False

    def __repr__(self) -> str:
        return f'Mesh({self.shape})'


def make_mesh(axes: Sequence[str] = ('data',), shape=None, devices=None) -> Mesh:
    """The data mesh over every process of the run: its group is the
    default process group once :func:`~ever_tpu_torch.core.dist.init_dist_env`
    started one, else None (one process).  ``shape`` and ``devices`` of the
    JAX signature lay out more than one axis, which is not ported."""
    if len(tuple(axes)) != 1 or devices is not None or (
            shape is not None and list(shape) != [dist.get_world_size()]):
        raise NotImplementedError('only the 1-D data mesh over every process is ported '
                                  '(ROADMAP.md A.9)')
    initialized = tdist.is_available() and tdist.is_initialized()
    return Mesh(axes, tdist.group.WORLD if initialized else None)


def reduction_group(axis_name: Optional[str] = None):
    """The group a batch statistic is summed over: the current mesh's
    ``axis_name`` axis (its data axis by default) when it spans more than
    one rank, else None.  An ``axis_name`` outside a mesh raises, as an
    unbound axis name does in JAX."""
    mesh = _CURRENT.get()
    if mesh is None:
        if axis_name is not None:
            raise ValueError(f'axis_name={axis_name!r} outside a mesh: enter `with mesh:`')
        return None
    group = mesh.axis_group(axis_name)
    return group if mesh.size() > 1 else None


def data_shard() -> Tuple[int, int]:
    """(this rank's index, the number of ranks) on the current mesh's data
    axis; (0, 1) outside a mesh."""
    mesh = _CURRENT.get()
    return (0, 1) if mesh is None else (mesh.rank(), mesh.size())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient is the sum over the
    ranks of the gradients, as ``jax.lax.psum``'s is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity for None)."""
    return x if group is None else _AllReduceSum.apply(x, group)
