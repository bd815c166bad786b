"""Meshes of named axes over the process group (counterpart of
``ever_tpu/parallel/mesh.py``).

A JAX mesh lays devices out on named axes, and a jitted step over a batch
sharded on ``'data'`` reduces every batch sum over all of them.  Here one
process drives one card, so a mesh lays the world's ranks out row-major on
its axes, as JAX's ``np.asarray(devices).reshape(shape)``, and each axis is
a process group: one group for each line of the axis (the ranks that differ
only in their coordinate on it).  The reductions the JAX compiler inserts
are explicit: the model's code asks :func:`reduction_group` whether it runs
inside a step (``with mesh:``, as the train step enters it) whose batch
axes span more than one rank, and if so sums its batch statistics with
:func:`all_reduce_sum`, whose gradient is the same sum of the gradients.
Outside a mesh, or with one rank, nothing is reduced and the code is that
of one process.

The **batch axes** of a mesh are those a batch is split over: ``'data'``
when the mesh has that axis, else none (a ``('pipe',)`` or ``('expert',)``
mesh replicates the batch); ``make_hybrid_mesh`` adds its dcn axis in
front.  ``mesh.group``, ``mesh.size()`` and
``mesh.rank()`` are theirs, so the data-parallel code (DDP, ZeRO, the
global BatchNorm and losses, the metrics' mean) runs over the batch axes
of a 2-D mesh and leaves its other axes (``'model'``, ``'pipe'``,
``'expert'``) to the layouts of ``tp.py``, ``pp.py`` and ``ep.py``.

Every process of the run must build the same meshes in the same order:
``torch.distributed.new_group`` is collective, and each mesh makes the
groups of every line of every axis, the lines a process is not on too.
An axis of one rank has no group (None), an axis over the whole world the
default group.

Placements (A.9.4): a :class:`NamedSharding` is the JAX package's pair of a
mesh and a :class:`PartitionSpec` (``P(None, 'data')``: dimension 1 split
over the data axis), read as ``torch.distributed`` placements
(``Shard(d)``/``Replicate()``, one a mesh axis).  :func:`replicated` and
:func:`batch_sharding` build the two a step uses, and
:func:`host_to_global` turns the host's global batch into each rank's rows
of it, held as a ``DTensor`` over the batch axes (a batch that is one
already is left alone).  :func:`abstract_mesh` lays out a shape of ranks
without processes, for planning placements (``parallel/zero.py``,
``parallel/sharded.py``) as JAX plans them over fake devices.
"""

from __future__ import annotations

import contextvars
import copy
import itertools
import math
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist
from torch.utils._pytree import tree_map

from ever_tpu_torch.core import dist

__all__ = ['Mesh', 'make_mesh', 'make_hybrid_mesh', 'abstract_mesh', 'reduction_group',
           'data_shard', 'all_reduce_sum', 'PartitionSpec', 'P', 'NamedSharding',
           'replicated', 'batch_sharding', 'host_to_global']

_CURRENT: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_mesh',
                                                         default=None)

Axes = Union[str, Sequence[str], None]


class Mesh:
    """Named axes of the given sizes over the world's ranks, row-major
    (module docstring).  ``shape`` maps every axis to its size; without a
    process group (``grouped=False``) the mesh is one process (every axis
    of size 1) or, with sizes, an abstract layout on which placements are
    planned (:func:`abstract_mesh`) and no step runs.

    ``axis_group(name)``, ``rank(name)`` and ``axis_size(name)`` are an
    axis's process group, this process's coordinate on it and its size;
    with no name (or the batch axes' tuple) they are the batch axes'
    (``group``, ``rank()``, ``size()``).  ``with mesh:`` makes it the
    current mesh, whose batch axes the batch statistics are reduced over.
    """

    def __init__(self, axis_names: Sequence[str] = ('data',),
                 shape: Optional[Sequence[int]] = None, *, grouped: bool = False,
                 batch_axes: Optional[Sequence[str]] = None):
        self.axis_names = tuple(axis_names)
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f'repeated mesh axis names: {self.axis_names}')
        sizes = [1] * len(self.axis_names) if shape is None else [int(s) for s in shape]
        if len(sizes) != len(self.axis_names):
            raise ValueError(f'mesh shape {tuple(sizes)} does not match axes {self.axis_names}')
        self._sizes = dict(zip(self.axis_names, sizes))
        if batch_axes is None:
            batch_axes = ('data',) if 'data' in self.axis_names else ()
        self.batch_axes = tuple(batch_axes)
        if not set(self.batch_axes) <= set(self.axis_names):
            raise ValueError(f'batch axes {self.batch_axes} not in {self.axis_names}')
        self.grouped = grouped
        self.abstract = False
        self._coords = dict.fromkeys(self.axis_names, 0)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._mine: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        self._pairs: Dict[str, Tuple[Any, Any]] = {}
        if grouped:
            world, me = tdist.get_world_size(), tdist.get_rank()
            if math.prod(sizes) != world:
                raise ValueError(f'mesh shape {tuple(sizes)} does not cover {world} processes')
            self._coords = dict(zip(self.axis_names, _unravel(me, sizes)))
            for axes in [(a,) for a in self.axis_names] + [self.batch_axes]:
                if axes and axes not in self._groups:
                    self._groups[axes], self._mine[axes] = self._make_groups(axes)
        self.group = self._groups.get(self.batch_axes)
        self._wrapped = {}
        self._device_meshes = {}
        self._token = []

    def _lines(self, axes: Tuple[str, ...]) -> list:
        """Every line over ``axes`` (the global ranks that differ only in
        their coordinates on them, in axis order), the other axes'
        coordinates row-major."""
        sizes = [self._sizes[a] for a in self.axis_names]
        others = [a for a in self.axis_names if a not in axes]
        lines = []
        for fixed in itertools.product(*[range(self._sizes[a]) for a in others]):
            coords = dict(zip(others, fixed))
            line = []
            for along in itertools.product(*[range(self._sizes[a]) for a in axes]):
                coords.update(zip(axes, along))
                line.append(_ravel([coords[a] for a in self.axis_names], sizes))
            lines.append(tuple(line))
        return lines

    def _make_groups(self, axes: Tuple[str, ...]):
        """The process group of this rank's line over ``axes`` (one group for
        each line, made by every rank in the same order) and that line."""
        lines = self._lines(axes)
        mine = next(line for line in lines if tdist.get_rank() in line)
        if len(mine) == 1:
            return None, mine
        if len(mine) == math.prod(self._sizes.values()):
            return tdist.group.WORLD, mine
        groups = [tdist.new_group(list(line)) for line in lines]
        return groups[lines.index(mine)], mine

    def _axes(self, axis_name: Axes) -> Tuple[str, ...]:
        if axis_name is None:
            return self.batch_axes
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f'unknown mesh axis {unknown[0]!r}; axes: {self.axis_names}')
        if len(axes) > 1 and axes != self.batch_axes:
            raise ValueError(f'no group over the axes {axes}: a mesh has one for each axis '
                             f'and for its batch axes {self.batch_axes}')
        return axes

    @property
    def shape(self) -> dict:
        """Every axis and its size, in axis order."""
        return dict(self._sizes)

    def axis_size(self, axis_name: Axes = None) -> int:
        return math.prod(self._sizes[a] for a in self._axes(axis_name))

    def size(self) -> int:
        """The number of ranks on the batch axes."""
        return self.axis_size(None)

    def rank(self, axis_name: Axes = None) -> int:
        """This process's coordinate on ``axis_name`` (on the batch axes,
        row-major, by default)."""
        axes = self._axes(axis_name)
        return _ravel([self._coords[a] for a in axes], [self._sizes[a] for a in axes])

    def axis_group(self, axis_name: Axes = None):
        """The process group of this rank's line on ``axis_name`` (the batch
        axes by default); None when it spans one rank or the mesh has no
        processes."""
        return self._groups.get(self._axes(axis_name))

    def axis_ranks(self, axis_name: Axes = None) -> Tuple[int, ...]:
        """The global ranks of this rank's line on ``axis_name``, in order."""
        axes = self._axes(axis_name)
        if not self.grouped:
            return (0,) if self.axis_size(axes) == 1 else ()
        return self._mine[axes] if axes else (tdist.get_rank(),)

    def neighbour_groups(self, axis_name: str) -> Tuple[Any, Any]:
        """The two-rank groups this rank shares with its predecessor and its
        successor on ``axis_name`` (None at either end): every pair of
        neighbours of every line gets one, made on first call by every rank
        in the same order (a collective call).  On an axis of two ranks
        both are the axis group."""
        if axis_name not in self._pairs:
            axes = self._axes(axis_name)
            n, s = self.axis_size(axes), self.rank(axes)
            if n <= 2:
                group = self.axis_group(axes)
                self._pairs[axis_name] = (group if s > 0 else None,
                                          group if s < n - 1 else None)
            else:
                prev = nxt = None
                for line in self._lines(axes):
                    for i in range(n - 1):
                        group = tdist.new_group(list(line[i:i + 2]))
                        if line == self._mine[axes]:
                            prev = group if i == s - 1 else prev
                            nxt = group if i == s else nxt
                self._pairs[axis_name] = (prev, nxt)
        return self._pairs[axis_name]

    def with_batch_axes(self, batch_axes: Sequence[str]) -> 'Mesh':
        """This mesh with one axis of it as its batch axis, sharing its
        process groups (no collective call): the spatial step
        (``parallel/spatial.py``) reduces over its strip axis so."""
        axes = tuple(batch_axes)
        if len(axes) != 1 or axes[0] not in self.axis_names:
            raise ValueError(f'one axis of {self.axis_names} as the batch axis, got {axes}')
        view = copy.copy(self)
        view.batch_axes = axes
        view.group = self._groups.get(axes)
        view._wrapped, view._device_meshes, view._token = {}, {}, []
        return view

    def device_mesh(self, device_type: str):
        """The ``torch.distributed`` ``DeviceMesh`` of the batch axes over
        this mesh's batch group, for ``device_type`` tensors (made once)."""
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_meshes[device_type] = DeviceMesh.from_group(
                self.group, device_type, mesh_dim_names=('_'.join(self.batch_axes),))
        return self._device_meshes[device_type]

    def device_mesh_with(self, device_type: str, axis: str):
        """The 2-D ``DeviceMesh`` of the batch axes (flattened, first) and
        ``axis`` over every rank, for ``device_type`` tensors (made once,
        a collective call the first time): the mesh a tensor-parallel
        leaf's shards are placed on.  The mesh may have no other axis
        longer than 1."""
        key = (device_type, axis)
        if key not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh
            others = [a for a in self.axis_names
                      if a not in self.batch_axes and a != axis and self._sizes[a] > 1]
            if others:
                raise ValueError(f'no 2-D device mesh of {self.batch_axes} and {axis!r}: the '
                                 f'mesh also splits {others}')
            sizes = [self._sizes[a] for a in self.axis_names]
            grid = torch.zeros(self.size(), self._sizes[axis], dtype=torch.int64)
            for r in range(math.prod(sizes)):
                coords = dict(zip(self.axis_names, _unravel(r, sizes)))
                b = _ravel([coords[a] for a in self.batch_axes],
                           [self._sizes[a] for a in self.batch_axes])
                grid[b, coords[axis]] = r
            self._device_meshes[key] = DeviceMesh(
                device_type, grid, mesh_dim_names=('_'.join(self.batch_axes) or 'batch', axis))
        return self._device_meshes[key]

    def data_parallel(self, model: torch.nn.Module, find_unused_parameters: bool = False):
        """``model`` wrapped once in ``DistributedDataParallel`` over the
        batch axes.  Buffers are not broadcast (``broadcast_buffers=False``):
        the running statistics move by the global batch statistics, so every
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


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    out = 0
    for c, n in zip(coords, sizes):
        out = out * n + c
    return out


def _unravel(index: int, sizes: Sequence[int]) -> list:
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return out[::-1]


def make_mesh(axes: Sequence[str] = ('data',), shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """A mesh over every process of the run, laid out row-major on ``axes``
    (a collective call once :func:`~ever_tpu_torch.core.dist.init_dist_env`
    started a process group; one process otherwise).  ``shape`` defaults to
    every process on the first axis (``axes=('data', 'model'), shape=(4,
    2)`` for a 2-D mesh).  ``devices``, the JAX signature's device list,
    must be None: one process drives one card, and a mesh spans every
    process."""
    if devices is not None:
        raise ValueError('devices=: one process drives one card, so a mesh spans every '
                         'process of the run; start as many processes as it has ranks')
    return _world_mesh(tuple(axes), shape)


def _world_mesh(axes: Tuple[str, ...], shape, batch_axes=None) -> Mesh:
    n = dist.get_world_size()
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    if math.prod(shape) != n:
        raise ValueError(f'mesh shape {tuple(shape)} does not cover {n} devices')
    initialized = tdist.is_available() and tdist.is_initialized()
    return Mesh(axes, shape, grouped=initialized, batch_axes=batch_axes)


def make_hybrid_mesh(ici_axes: Sequence[str] = ('data',),
                     ici_shape: Optional[Sequence[int]] = None,
                     dcn_axis: str = 'replica') -> Mesh:
    """A mesh whose first axis, ``dcn_axis``, spans the nodes (JAX's slices)
    and whose ``ici_axes`` lay out the ranks within a node: ``(nodes,
    *ici_shape)``.  Nodes are ``WORLD_SIZE // LOCAL_WORLD_SIZE`` under
    ``torchrun``, which numbers ranks node by node, and 1 otherwise, so on
    one node the result is ``(1, *ici_shape)``, as JAX degrades to
    :func:`make_mesh` on a single slice.  ``ici_shape`` defaults to every
    rank of a node on the first ICI axis.  The batch axes are ``dcn_axis``
    and ``'data'`` (when an ICI axis has that name): the gradient reduction
    crosses nodes, the model-parallel axes stay within one."""
    ici_axes = tuple(ici_axes)
    world = dist.get_world_size()
    local = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if local <= 0 or world % local:
        raise ValueError(f'{world} processes do not split into nodes of {local}')
    nodes = world // local
    if ici_shape is None:
        ici_shape = [local] + [1] * (len(ici_axes) - 1)
    if math.prod(ici_shape) != local:
        raise ValueError(f'ICI shape {tuple(ici_shape)} does not cover the {local} '
                         f'processes of a node')
    batch = (dcn_axis,) + (('data',) if 'data' in ici_axes else ())
    return _world_mesh((dcn_axis, *ici_axes), (nodes, *ici_shape), batch)


def abstract_mesh(shape: Union[int, Sequence[int]], axes: Sequence[str] = ('data',)) -> Mesh:
    """A mesh of ``shape`` ranks (a size, or one size an axis of ``axes``)
    with no process behind them, on which placements are planned (JAX's
    fake-device mesh); it runs no step."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    mesh = Mesh(axes, shape)
    mesh.abstract = True
    return mesh


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
        """The dimension split over the mesh's batch axes, or None."""
        batch = set(self.mesh.batch_axes)
        for d, a in enumerate(self.spec):
            names = a if isinstance(a, tuple) else (a,)
            if batch & set(names):
                return d
        return None

    @property
    def batch_placements(self) -> tuple:
        """The placement over the batch axes alone (``mesh.device_mesh``'s
        one dimension)."""
        from torch.distributed.tensor import Replicate, Shard
        dim = self.shard_dim
        return (Replicate(),) if dim is None else (Shard(dim),)

    @property
    def is_fully_replicated(self) -> bool:
        """No dimension is split over an axis of more than one rank."""
        for a in self.spec:
            for name in (a if isinstance(a, tuple) else (a,)):
                if name is not None and self.mesh.shape[name] > 1:
                    return False
        return True


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
    return isinstance(x, DTensor) and tuple(x.placements) == sharding.batch_placements


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
                                  mesh.device_mesh(x.device.type), sharding.batch_placements,
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_map(local, batch)


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if hasattr(t, 'shape')]


def reduction_group(axis_name: Optional[str] = None):
    """The group a batch statistic is summed over: the current mesh's
    ``axis_name`` axis (its batch axes by default) when it spans more than
    one rank, else None.  An ``axis_name`` outside a mesh raises, as an
    unbound axis name does in JAX."""
    mesh = _CURRENT.get()
    if mesh is None:
        if axis_name is not None:
            raise ValueError(f'axis_name={axis_name!r} outside a mesh: enter `with mesh:`')
        return None
    group = mesh.axis_group(axis_name)
    return group if mesh.axis_size(axis_name) > 1 else None


def data_shard() -> Tuple[int, int]:
    """(this rank's index, the number of ranks) on the current mesh's batch
    axes; (0, 1) outside a mesh."""
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
