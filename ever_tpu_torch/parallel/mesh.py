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

Placements (A.9.4): a :class:`NamedSharding` is the JAX package's pair of a
mesh and a :class:`PartitionSpec` (``P(None, 'data')``: dimension 1 split
over the data axis), read as ``torch.distributed`` placements
(``Shard(d)``/``Replicate()``, one a mesh axis).  :func:`replicated` and
:func:`batch_sharding` build the two a step uses, and
:func:`host_to_global` turns the host's global batch into each rank's rows
of it, held as a ``DTensor`` over the mesh (a batch that is one already
is left alone).  :func:`abstract_mesh` lays out ``n`` ranks without
processes, for planning placements (``parallel/zero.py``,
``parallel/sharded.py``) as JAX plans them over fake devices.

Only the 1-D data mesh is ported; the 2-D and hybrid meshes
(``make_hybrid_mesh``) wait for the model-parallel layouts (``ROADMAP.md``
A.9.3).
"""

from __future__ import annotations

import contextvars
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
from torch.utils._pytree import tree_map

from ever_tpu_torch.core import dist

__all__ = ['Mesh', 'make_mesh', 'abstract_mesh', 'reduction_group', 'data_shard',
           'all_reduce_sum', 'PartitionSpec', 'P', 'NamedSharding', 'replicated',
           'batch_sharding', 'host_to_global']

_CURRENT: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_mesh',
                                                         default=None)


class Mesh:
    """The ``'data'`` axis over the processes of ``group`` (None: one process
    and no process group).

    ``size()`` and ``shape`` read as the JAX mesh's; ``with mesh:`` makes it
    the current mesh, whose data axis the batch statistics are reduced over.
    """

    def __init__(self, axis_names: Sequence[str] = ('data',), group=None,
                 size: Optional[int] = None):
        self.axis_names = tuple(axis_names)
        self.group = group
        self._size = size
        self._wrapped = {}
        self._device_meshes = {}
        self._token = []

    def size(self) -> int:
        if self.group is None:
            return 1 if self._size is None else self._size
        return tdist.get_world_size(self.group)

    @property
    def abstract(self) -> bool:
        """True for a mesh of :func:`abstract_mesh`: ranks without processes."""
        return self.group is None and self._size is not None

    def device_mesh(self, device_type: str):
        """The ``torch.distributed`` ``DeviceMesh`` of the data axis over
        this mesh's group, for ``device_type`` tensors (made once)."""
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_meshes[device_type] = DeviceMesh.from_group(
                self.group, device_type, mesh_dim_names=self.axis_names[:1])
        return self._device_meshes[device_type]

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
                                  '(ROADMAP.md A.9.3)')
    initialized = tdist.is_available() and tdist.is_initialized()
    return Mesh(axes, tdist.group.WORLD if initialized else None)


def abstract_mesh(size: int, axes: Sequence[str] = ('data',)) -> Mesh:
    """A data mesh of ``size`` ranks with no process behind them, on which
    placements are planned (JAX's fake-device mesh); it runs no step."""
    return Mesh(axes, None, int(size))


def __getattr__(name: str):
    if name == 'make_hybrid_mesh':
        raise AttributeError('make_hybrid_mesh: the 2-D and hybrid meshes are not ported '
                             '(ROADMAP.md A.9.3)')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: for each dimension of a tensor, the mesh
    axis it is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f'P{tuple(self)!r}'


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over ``mesh``: ``spec`` names, for each dimension,
    the mesh axis it is split over.  ``placements`` are the same as
    ``torch.distributed`` placements, one a mesh axis."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, a in enumerate(self.spec)
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    @property
    def shard_dim(self) -> Optional[int]:
        """The dimension split over the mesh's first (data) axis, or None."""
        from torch.distributed.tensor import Shard
        first = self.placements[0]
        return first.dim if isinstance(first, Shard) else None

    @property
    def is_fully_replicated(self) -> bool:
        return self.shard_dim is None or self.mesh.size() == 1


def replicated(mesh: Mesh) -> NamedSharding:
    """Every rank holds the whole tensor."""
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, *, accum_leading=False, axis: str = 'data') -> NamedSharding:
    """A batch's layout: its batch dimension split over ``axis``.
    ``accum_leading`` counts the replicated leading dimensions before it
    (``True`` is 1: the microbatch or steps-per-loop index; 2 when both)."""
    return NamedSharding(mesh, P(*([None] * int(accum_leading)), axis))


def _is_global(x, sharding: NamedSharding) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and tuple(x.placements) == sharding.placements


def host_to_global(batch: Any, sharding: NamedSharding) -> Any:
    """The host's global batch as this rank's rows of it on the sharded
    dimension, each leaf a ``DTensor`` over the mesh whose local tensor is
    those rows (``.to_local()``; the train step takes either).  A leaf that
    is already such a ``DTensor`` is left alone, as JAX leaves a global
    array.  Without a process group (one process) the leaves are returned
    as tensors, whole.  A global batch the data axis does not divide
    raises ``ValueError``."""
    mesh, dim = sharding.mesh, sharding.shard_dim
    n = mesh.size()
    if dim is not None and n > 1:
        for x in [t for t in _leaves(batch) if not _is_global(t, sharding)]:
            rows = x.shape[dim] if len(x.shape) > dim else None
            if rows is not None and rows % n:
                raise ValueError(
                    f'global batch {rows} is not divisible by the {n}-way batch sharding '
                    f'({sharding.spec}); raise total_batch_size to a multiple of the '
                    f'device count (reference semantics: ever/interface/dataloader.py:61-67)')
    if mesh.group is None or dim is None:
        return tree_map(lambda x: x if _is_global(x, sharding) else torch.as_tensor(x), batch)
    from torch.distributed.tensor import DTensor
    rank = mesh.rank()

    def local(x):
        if _is_global(x, sharding):
            return x
        x = torch.as_tensor(x)
        rows = x.shape[dim] // n
        return DTensor.from_local(x.narrow(dim, rank * rows, rows),
                                  mesh.device_mesh(x.device.type), sharding.placements,
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_map(local, batch)


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if hasattr(t, 'shape')]


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
