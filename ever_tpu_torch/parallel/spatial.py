"""Spatial sharding with halo exchange: one tile too large for a card, split
along its rows over a mesh axis (counterpart of
``ever_tpu/parallel/spatial.py``).

Batches are NHWC, as the port's models take them, so a strip is a range of
dimension 1: rank ``s`` of the ``k`` ranks of the axis holds rows
``[s·h, (s+1)·h)`` of a tile of ``k·h`` rows.  Each rank runs on its strip
plus a halo of its neighbours' rows.

Two mechanisms, as in the JAX package:

- **One halo around a whole network** (:func:`spatial_partition_apply`,
  :func:`build_halo_train_step`): :func:`halo_exchange` pads a strip with
  ``halo`` rows from each neighbour (zeros at the true border);
  :func:`halo_exchange_exact` lets the border strips extend inward with
  ``2·halo`` real rows, so the network's own padding applies at the true
  border and the result equals the unsharded forward everywhere.
- **The per-op engine** behind :func:`build_spatial_train_step`.  The JAX
  step is the unsharded step program under a row-sharded input, and GSPMD
  inserts a halo at every conv, pool and resize and keeps the batch
  statistics, the loss and the gradient sum global.  PyTorch has no GSPMD,
  so the step runs the port's unsharded step (``parallel/spmd.py``) inside
  a strip context (:class:`Strips`), and every op of ``module/ops.py`` that
  reads across rows asks :func:`current` for it: a conv or a pool fetches
  the rows its window reads from the neighbours, from the **global**
  geometry (a tile of ``k·h`` rows, this strip at ``s·h``), uses them and
  drops them; a resize (bilinear, antialiased where it shrinks, corner
  aligned, or nearest, at any ratio) takes the strip's rows of the whole
  tile's weight matrix against the strip and the halo rows that matrix
  reads (:meth:`Strips.resize_rows`); a global pool sums over the axis;
  attention gathers every strip's keys and values
  (:meth:`Strips.gather_rows`, below).  No halo row is carried through a
  pointwise layer or a BatchNorm, so each rank's activations hold exactly
  its own rows and every pixel counts once.  BatchNorm, the losses and the
  gradient average run over the axis (the step's mesh takes it as its
  batch axis).  The other
  reductions over the whole tile do as the global pool does, with
  differentiable all-reduces of their sums over the axis: GroupNorm's two
  passes (:meth:`Strips.group_norm`), the squeeze-excite squeezes, the
  context block's softmax pool (:meth:`Strips.softmax_pool`) and the
  adaptive pools to any bins (:meth:`Strips.bin_pool`).

**What raises.**  A strip's output must be its share of what the whole
tile gives, so the strips are even: a stride that does not divide a
strip's height (:meth:`Strips.window`), a resize whose ``k`` strip outputs
are not the whole tile's output rows (:meth:`Strips.share`), and a folded
(space-to-depth) input whose strips would not unfold to the labels' strips
(:meth:`Strips.check_batch`) raise, naming the op; GSPMD computes these
with uneven strips (ROADMAP.md A.11.2).

**Strips and whole maps.**  Under a strip step most tensors are this rank's
strip of the tile, but a reduction over the tile (a global or adaptive
pool, a squeeze) returns a map that is whole on every rank, and the layers
after it (FarSeg++'s scene encoder, a squeeze's 1×1 convs, a pyramid bin's
conv-norm) compute on that whole map.  Nothing in a tensor tells the two
apart (a strip at C5 of a small tile can be one row high, as a pooled map
is), so the code says which it holds: the layers that take a whole map run
under :func:`whole`, which suspends the strip context, so that each runs
as in one process (a GroupNorm of the whole map normalises by its own
statistics; a BatchNorm there still reduces over the axis, whose ranks all
hold the same rows, which gives the same mean and variance).  The way back
from a whole map to the strips is a resize told that it takes a whole map
(:meth:`Strips.resize_whole_rows`: this strip's rows of the whole tile's
resize weights, no halo), or a broadcast of a 1×1 map.  Gradients follow
the rule the global pool set: a rank's gradient of a whole map is its
strip's share of it, and the all-reduce that made the map sums the shares
on the way back.

A hop is a broadcast in the two-rank group of a pair of neighbours
(``Mesh.neighbour_groups``; gloo carries only all-reduce and broadcast on
CUDA tensors), written as an autograd function (:class:`_Swap`) whose
backward sends each halo's gradient back to the strip it came from, where it
is added into the edge rows: the transpose JAX gets from ``ppermute``.
Every rank takes both halos of every exchange into its computation (the
border strips take the fill that stands for the true border's padding), so
every rank's backward runs the same hops in the same order.

**Attention over strips.**  A ViT's tokens are the cls and storage tokens
(the prefix), whole on every rank, and the strip's patch rows.  Each
attention layer runs this rank's queries, prefix included, against the
whole tile's keys: every strip's patch keys and values reach every rank of
the axis by one broadcast from each (:class:`_Gather`; gloo carries only
all-reduce and broadcast on CUDA tensors), in the whole tile's token order
``[prefix | strip 0 | … | strip k−1]``.  Backward, the gathered rows'
gradients are summed over the axis (one all-reduce) and each strip keeps
its own; the prefix's stay this rank's share, the rule of a whole map
above.  The step's numbers are the unsharded step's, as GSPMD's are: a ring
that passes the keys around would give them too, with less memory a rank
at many strips, and more hops.

**Recomputation.**  A block checkpointed under a strip step
(:func:`recomputable`: ``remat`` in a ViT, ``with_cp`` in a ResNet) is
recomputed in the backward with the contexts of its forward (autograd may
run it on another thread, CUDA's device thread), so it issues its halos,
gathers and BatchNorm reductions again on every rank in the same order, as
JAX's ``nn.remat`` does under GSPMD.  ``stats`` counts them apart:
``remat_`` before the key.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves, tree_map

from ever_tpu_torch.parallel.mesh import _CURRENT, Mesh, NamedSharding, P, all_reduce_sum

__all__ = ['halo_exchange', 'halo_exchange_exact', 'spatial_partition_apply',
           'spatial_batch_sharding', 'build_spatial_train_step',
           'build_halo_train_step', 'Strips', 'current', 'recomputable', 'whole']

# what the uneven strips that GSPMD computes and this engine refuses are filed under
_UNEVEN = 'ROADMAP.md A.11.2'

_STRIPS: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_strips',
                                                         default=None)
# set inside a checkpointed block's recomputation under a strip step
_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_recomputing',
                                                              default=False)


def current() -> Optional['Strips']:
    """The strip context of the running spatial step, or None."""
    return _STRIPS.get()


@contextlib.contextmanager
def whole():
    """While entered, the ops run as in one process: the code inside takes
    maps that are whole on every rank (module docstring, "Strips and whole
    maps").  Outside a spatial step it changes nothing."""
    token = _STRIPS.set(None)
    try:
        yield
    finally:
        _STRIPS.reset(token)


def recomputable(fn: Callable) -> Callable:
    """``fn`` as ``torch.utils.checkpoint`` should call it: under a strip
    context every call runs in the contexts of the forward that made it
    (mesh, strips), and the calls after the first, the backward's
    recomputations, count their collectives apart (module docstring,
    "Recomputation").  Outside a strip step ``fn`` itself."""
    if _STRIPS.get() is None:
        return fn
    ctx = contextvars.copy_context()
    calls = []

    def run(*args, **kwargs):
        calls.append(None)
        if len(calls) == 1:
            return ctx.run(fn, *args, **kwargs)
        return ctx.run(_recompute, fn, args, kwargs)

    return run


def _recompute(fn: Callable, args, kwargs):
    _RECOMPUTING.set(True)
    return fn(*args, **kwargs)


class Strips:
    """This rank's strip of a tile split along its rows over ``mesh``'s
    ``axis``: its index ``s`` of ``k``, the neighbours' groups, and what it
    sent (``stats``: the halo broadcasts and bytes this rank sent,
    ``hops``/``bytes``, and its broadcasts of keys and values,
    ``gathers``/``gather_bytes``, from the first gather on; those of a
    recomputation under ``remat_`` keys).  ``with strips:`` makes it the
    context the ops read (module docstring)."""

    def __init__(self, mesh: Mesh, axis: str):
        if mesh.abstract:
            raise ValueError('an abstract mesh runs no spatial step: it needs the mesh of a '
                             'process group (parallel.mesh.make_mesh)')
        self.axis, self.k, self.s = axis, mesh.axis_size(axis), mesh.rank(axis)
        self.group = mesh.axis_group(axis) if self.k > 1 else None
        self.prev = self.next = None
        if self.k > 1:
            self.prev, self.next = mesh.neighbour_groups(axis)
            self.ranks = mesh.axis_ranks(axis)
        self.stats = dict(hops=0, bytes=0)
        self._token = []

    def __enter__(self):
        self._token.append(_STRIPS.set(self))
        return self

    def __exit__(self, *exc):
        _STRIPS.reset(self._token.pop())
        return False

    # -- hops ---------------------------------------------------------------------

    def _cast(self, t: torch.Tensor, src: int, group, keys=('hops', 'bytes')) -> None:
        """Broadcast ``t`` from strip ``src`` in ``group``; what this rank
        sends counts under ``keys`` (a count and its bytes)."""
        if t.numel() == 0:
            return
        tdist.broadcast(t, src=self.ranks[src], group=group)
        if src == self.s:
            pre = 'remat_' if _RECOMPUTING.get() else ''
            for key, add in zip(keys, (1, t.numel() * t.element_size())):
                self.stats[pre + key] = self.stats.get(pre + key, 0) + add

    def exchange(self, to_prev, from_prev, to_next, from_next) -> None:
        """Rows to and from both neighbours, received in place: for each pair
        (i, i+1), i's ``to_next`` into i+1's ``from_prev``, then i+1's
        ``to_prev`` into i's ``from_next``.  Even strips talk to their
        successor first and odd ones to their predecessor, so the pairs
        (0, 1), (2, 3), ... move at once, then (1, 2), ...  A border strip's
        missing side is left as it is."""
        s = self.s

        def with_prev():
            if self.prev is not None:
                self._cast(from_prev, s - 1, self.prev)
                self._cast(to_prev, s, self.prev)

        def with_next():
            if self.next is not None:
                self._cast(to_next, s, self.next)
                self._cast(from_next, s + 1, self.next)

        for side in ((with_prev, with_next) if s % 2 else (with_next, with_prev)):
            side()

    def rows(self, x: torch.Tensor, top: int, bottom: int, dim: int, fill: float = 0.0,
             what: str = 'halo') -> torch.Tensor:
        """``x`` with ``top`` rows of the previous strip above it and
        ``bottom`` rows of the next below it on dimension ``dim``; ``fill``
        rows where the strip meets the true border."""
        h = x.shape[dim]
        if max(top, bottom) > h:
            raise ValueError(f'{what}: a halo of {max(top, bottom)} rows exceeds the strip\'s '
                             f'{h} rows; use fewer ranks on {self.axis!r} or a taller tile')
        if top == bottom == 0:
            return x
        from_prev, from_next = _Swap.apply(x.narrow(dim, 0, bottom),
                                           x.narrow(dim, h - top, top), self, fill)
        out = torch.cat([from_prev, x, from_next], dim)
        if x.dim() == 4 and dim == 2 and x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every strip's ``x`` (equal shapes) in strip order along dimension
        1 (tokens), on every rank: one broadcast from each strip
        (:class:`_Gather`).  Backward, each strip gets the sum over the axis
        of its rows' gradients."""
        return x if self.k == 1 else _Gather.apply(x, self)

    # -- the ops' strip forms -----------------------------------------------------

    def window(self, x: torch.Tensor, what: str, k: int, s: int, d: int, top: int, dim: int,
               fill: float = 0.0) -> torch.Tensor:
        """The strip with the rows that a window op (kernel ``k``, stride
        ``s``, dilation ``d``, ``top`` rows of padding above the global
        tile) reads of its neighbours: ``top`` above and ``(k−1)·d − top −
        (s−1)`` below, so that the op without row padding gives the
        strip's ``h/s`` output rows.  A stride that does not divide the
        strip raises, naming the op (GSPMD would compute it)."""
        h = x.shape[dim]
        if h % s:
            raise ValueError(f'{what} (kernel {k}, stride {s}) needs strips whose height the '
                             f'stride divides; got {h} rows a rank on {self.axis!r}: use a '
                             f'tile height that {s}·{self.k}·(the strides before it) divides '
                             f'(uneven strips: {_UNEVEN})')
        if top > (k - 1) * d:
            raise ValueError(f'{what}: {top} rows of padding above a window of {k} rows')
        return self.rows(x, top, max((k - 1) * d - top - (s - 1), 0), dim, fill, what)

    def share(self, h: int, scale: float, what: str) -> int:
        """``int(h·scale)``: the rows a strip of ``h`` gives when ``what``
        scales it.  Raises where ``k`` of them are not the whole tile's
        ``int(k·h·scale)``: a strip's output would not be its share of the
        whole tile's."""
        m, whole_rows = int(h * scale), int(self.k * h * scale)
        if self.k * m != whole_rows:
            raise ValueError(f'{what} scales a strip of {h} rows by {scale} to {m}, but the whole '
                             f'tile\'s {self.k * h} rows to {whole_rows}, not {self.k} × {m}: a '
                             f'strip\'s output would not be its share of the whole tile\'s; use '
                             f'a tile height whose strips scale to whole rows on {self.axis!r} '
                             f'(uneven strips: {_UNEVEN})')
        return m

    def resize_rows(self, x: torch.Tensor, n_out: int, method: str, align_corners: bool,
                    dtype: torch.dtype) -> torch.Tensor:
        """A resize along the rows (dimension 1 of NHWC ``x``) to ``n_out``
        rows a strip, as a matrix product: the strip's output rows ``[s·m,
        (s+1)·m)`` of the whole tile's ``[k·m, k·h]`` weights
        (``module/ops.py`` ``_make_resize_weights``: ``method`` ``'nearest'``
        or ``'bilinear'``, half-pixel or ``align_corners``, antialiased where
        it shrinks) against the strip and the halo rows that the whole
        matrix's support reads (the same on every strip; fill rows of zero
        weight at the true border, where the whole matrix's own edge
        weights apply).  Backward, the transposed product, and the halo
        rows' gradients go back to their strips (:class:`_Swap`)."""
        w, top, bottom = _strip_weights(x.shape[1], n_out, self.k, self.s, method,
                                        align_corners, dtype, x.device)
        return torch.einsum('oh,nhwc->nowc', w,
                            self.rows(x, top, bottom, 1, 0.0, f'{method} resize'))

    def resize_whole_rows(self, x: torch.Tensor, n_out: int, method: str, align_corners: bool,
                          dtype: torch.dtype) -> torch.Tensor:
        """A resize along the rows of NHWC ``x``, a map whole on every rank,
        to the whole tile's ``k·n_out`` rows, of which this strip's
        ``n_out``: its rows of the whole resize's weights (the families of
        :meth:`resize_rows`, growing or shrinking) against the whole map (no
        halo)."""
        w = _whole_weights(x.shape[1], n_out, self.k, self.s, method, align_corners, dtype,
                           x.device)
        return torch.einsum('oh,nhwc->nowc', w, x)

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of ``t`` over the strips."""
        return all_reduce_sum(t, self.group)

    def row_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest of the strips' ``t``, element by element, without a
        gradient: each rank writes its own slot of a ``[k, ...]`` zero
        tensor and one all-reduce sums them (a gather by sums, which gloo
        carries on CUDA tensors too)."""
        slots = t.new_zeros((self.k,) + tuple(t.shape))
        slots[self.s] = t.detach()
        if self.group is not None:
            tdist.all_reduce(slots, group=self.group)
        return slots.amax(0)

    def group_norm(self, x: torch.Tensor, groups: int, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
        """GroupNorm of an NCHW strip by the whole tile's statistics, in
        x's dtype (the caller's float32 or float64), in two passes as the
        one-process GroupNorm: the groups' sums are summed over the strips
        for the mean, then their sums of squared deviations from it for
        the (biased) variance."""
        n, c, h, w = x.shape
        g = x.reshape(n, groups, -1)
        count = g.shape[-1] * self.k
        mean = self.row_sum(g.sum(-1, keepdim=True)) / count
        d = g - mean
        var = self.row_sum((d * d).sum(-1, keepdim=True)) / count
        y = (d * torch.rsqrt(var + eps)).reshape(n, c, h, w)
        return y * weight[None, :, None, None] + bias[None, :, None, None]

    def softmax_pool(self, logits: torch.Tensor, feats: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        """``Σ_p softmax(logits)_p · feats_p`` over every position of the
        tile: ``logits`` ``[N, P, 1]`` and ``feats`` ``[N, P, C]`` hold
        this strip's positions.  The softmax shifts by the strips' largest
        logit (without a gradient: the softmax does not depend on the
        shift) and divides by the exp-sum over the strips; its weights are
        rounded to the logits' dtype, as a softmax in that dtype rounds
        them, before the product in ``dtype``, whose sums over the strips
        are added.  Returns ``[N, C, 1]`` in ``dtype``, whole on every
        rank."""
        m = self.row_max(logits.amax(dim=1, keepdim=True))
        e = torch.exp((logits - m).to(dtype))
        mask = (e / self.row_sum(e.sum(dim=1, keepdim=True))).to(logits.dtype).to(dtype)
        return self.row_sum(torch.einsum('npc,npo->nco', feats.to(dtype), mask))

    def bin_pool(self, x: torch.Tensor, bins: Tuple[int, int]) -> torch.Tensor:
        """Adaptive average pooling of NHWC ``x`` (this strip) to ``bins``
        in float32 (``module/ops.py`` ``adaptive_avg_pool``'s weights): the
        strip is multiplied by its own columns of the whole tile's row
        weights, the products are summed over the strips, then the columns
        are pooled.  Whole on every rank."""
        from ever_tpu_torch.module.ops import _bin_weights
        h = x.shape[1]
        rows = _bin_weights(h * self.k, bins[0], x.device).narrow(1, self.s * h, h)
        y = self.row_sum(torch.einsum('oh,nhwc->nowc', rows, x.float()))
        return torch.einsum('pw,nowc->nopc', _bin_weights(x.shape[2], bins[1], x.device), y)

    def keep_mask(self, shape, rate: float, generator: torch.Generator,
                  rows_dim: Optional[int]) -> torch.Tensor:
        """A dropout keep mask drawn for the whole tile (``rows_dim`` of
        ``shape`` times ``k``) and this strip's rows of it, or drawn whole
        where the mask is broadcast over the rows (``rows_dim`` None)."""
        if rows_dim is not None and len(shape) != 4:
            raise ValueError(f'dropout of a rank-{len(shape)} tensor under a spatial step: '
                             'its rows are dimension 2 of an NCHW strip')
        if rows_dim is None:
            return torch.rand(tuple(shape), generator=generator,
                              device=generator.device) < 1.0 - rate
        full = list(shape)
        h = full[rows_dim]
        full[rows_dim] = h * self.k
        u = torch.rand(tuple(full), generator=generator, device=generator.device)
        return (u < 1.0 - rate).narrow(rows_dim, self.s * h, h)

    def check_batch(self, batch) -> None:
        """JAX's errors for a spatial batch: every leaf ``[N, H, ...]`` with
        H divisible by the axis size.  A leaf of H rows beside one of 2·H is
        a space-to-depth folded input (``stem='s2d_input'``) beside its
        labels: strip s of its ``H/k`` folded rows unfolds to exactly strip s
        of the labels' ``2H/k`` pixel rows, so where k does not divide H (the
        labels' strips of an odd height) it raises, naming the fold."""
        leaves = [leaf for leaf in tree_leaves(batch) if hasattr(leaf, 'shape')]
        heights = set()
        for leaf in leaves:
            shape = tuple(leaf.shape)
            if len(shape) < 2:
                raise ValueError(
                    f'spatial train batch leaves must be rank>=2 '
                    f'([N, H, ...]); got a rank-{len(shape)} leaf — reshape '
                    f'or replicate it outside the batch pytree')
            heights.add(shape[1])
        for h in sorted(heights):
            if h % self.k and 2 * h in heights:
                raise ValueError(
                    f'the s2d stem\'s folded input of {h} rows (a tile of {2 * h} pixel rows) '
                    f'over the {self.axis!r} axis size {self.k} would make strips of '
                    f'{2 * h / self.k:g} pixel rows, which its folded rows cannot cover '
                    f'exactly; use a tile height that 2·{self.k} divides (uneven strips: '
                    f'{_UNEVEN})')
        for leaf in leaves:
            if leaf.shape[1] % self.k:
                raise ValueError(
                    f'tile height {leaf.shape[1]} is not divisible by the '
                    f'{self.axis!r} axis size {self.k}; pad the tile')

    def take(self, t):
        """This strip's rows of a batch leaf: a ``DTensor`` split on dimension 1
        gives its local rows, a whole tile (tensor or array) is narrowed."""
        if isinstance(t, DTensor):
            from torch.distributed.tensor import Shard
            if tuple(t.placements) != (Shard(1),):
                raise ValueError(f'a spatial batch leaf is a DTensor placed {t.placements}; '
                                 'lay it out with host_to_global(batch, '
                                 'spatial_batch_sharding(mesh, axis))')
            return t.to_local()
        t = torch.as_tensor(t)
        h = t.shape[1] // self.k
        return t.narrow(1, self.s * h, h)


@functools.lru_cache(maxsize=32)
def _strip_weights(h: int, m: int, k: int, s: int, method: str, align_corners: bool,
                   dtype: torch.dtype, device: torch.device) -> tuple:
    """``(w, top, bottom)``: the halo rows above and below that any strip's
    rows of the whole ``[k·m, k·h]`` resize weights read (the largest over
    the strips, so that every strip exchanges the same rows), and rows
    ``[s·m, (s+1)·m)`` of those weights over input rows ``[s·h − top, (s+1)·h
    + bottom)`` (zero columns past the true border), made in float64 and
    kept on ``device`` in ``dtype``."""
    from ever_tpu_torch.module.ops import _make_resize_weights
    full = _make_resize_weights(k * h, k * m, method, align_corners, torch.float64,
                                torch.device('cpu'))
    cols = torch.arange(k * h, dtype=torch.float64)
    support = full != 0
    first = torch.where(support, cols, float(k * h)).amin(1)
    last = torch.where(support, cols, -1.0).amax(1)
    strip = torch.arange(k * m, dtype=torch.float64) // m * h      # each output row's strip start
    top = int(max(float((strip - first).amax()), 0.0))
    bottom = int(max(float((last - (strip + h - 1)).amax()), 0.0))
    w = F.pad(full, (top, bottom))[s * m:(s + 1) * m, s * h:(s + 1) * h + top + bottom]
    return w.to(dtype=dtype, device=device), top, bottom


@functools.lru_cache(maxsize=32)
def _whole_weights(n_in: int, m: int, k: int, s: int, method: str, align_corners: bool,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Rows ``[s·m, (s+1)·m)`` of the ``[k·m, n_in]`` resize weights that
    take a whole map of ``n_in`` rows to the tile's ``k·m``, made in
    float64 and kept on ``device`` in ``dtype``."""
    from ever_tpu_torch.module.ops import _make_resize_weights
    full = _make_resize_weights(n_in, k * m, method, align_corners, torch.float64,
                                torch.device('cpu'))
    return full[s * m:(s + 1) * m].to(dtype=dtype, device=device)


class _Swap(torch.autograd.Function):
    """The halos of one exchange: ``up`` (the strip's first rows, for the
    previous strip's bottom halo) and ``down`` (its last rows, for the next
    strip's top halo) go out; back come ``from_prev`` (the previous strip's
    ``down``) and ``from_next`` (the next strip's ``up``), ``fill`` at the
    true border.  Backward, each halo's gradient goes back to the strip it
    came from and lands on the rows it was made of."""

    @staticmethod
    def forward(ctx, up, down, strips, fill):
        ctx.strips = strips
        ctx.shapes = (up.shape, down.shape, up.dtype)
        from_prev = torch.full(down.shape, fill, dtype=down.dtype, device=down.device)
        from_next = torch.full(up.shape, fill, dtype=up.dtype, device=up.device)
        # copies: a broadcast may write its source (gloo's CUDA path does),
        # and the rows sent are views of a tensor autograd may have saved
        strips.exchange(up.clone(memory_format=torch.contiguous_format), from_prev,
                        down.clone(memory_format=torch.contiguous_format), from_next)
        return from_prev, from_next

    @staticmethod
    def backward(ctx, g_prev, g_next):
        up_shape, down_shape, dtype = ctx.shapes
        g_up = torch.zeros(up_shape, dtype=dtype, device=g_prev.device)
        g_down = torch.zeros(down_shape, dtype=dtype, device=g_prev.device)
        ctx.strips.exchange(g_prev.clone(memory_format=torch.contiguous_format), g_up,
                            g_next.clone(memory_format=torch.contiguous_format), g_down)
        return g_up, g_down, None, None


class _Gather(torch.autograd.Function):
    """:meth:`Strips.gather_rows`: each strip broadcasts its ``x`` to the
    axis; backward, one all-reduce sums the gathered gradient over the axis
    and each strip takes its rows."""

    @staticmethod
    def forward(ctx, x, strips):
        ctx.strips, ctx.n = strips, x.shape[1]
        # a copy is sent: a broadcast may write its source (as in _Swap)
        parts = [x.clone(memory_format=torch.contiguous_format) if r == strips.s
                 else x.new_empty(x.shape) for r in range(strips.k)]
        for r, part in enumerate(parts):
            strips._cast(part, r, strips.group, ('gathers', 'gather_bytes'))
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(grad, group=ctx.strips.group)
        return grad.narrow(1, ctx.strips.s * ctx.n, ctx.n), None


def _strips_of(axis_name: str) -> Strips:
    mesh = _CURRENT.get()
    if mesh is None:
        raise ValueError(f'axis_name={axis_name!r} outside a mesh: enter `with mesh:`')
    return Strips(mesh, axis_name)


def halo_exchange(x: torch.Tensor, halo: int, axis_name: str) -> torch.Tensor:
    """Pad an NHWC strip ``[N, h, W, C]`` with ``halo`` rows from each
    neighbour on the current mesh's ``axis_name`` (``with mesh:``), zeros
    at the true border (conv SAME padding's value there): ``[N, h + 2·halo,
    W, C]``."""
    if halo == 0:
        return x
    return _strips_of(axis_name).rows(x, halo, halo, 1)


def _exact(x: torch.Tensor, halo: int, strips: Strips):
    if strips.k == 1 or halo == 0:
        return x, 0
    from_prev, from_next = _Swap.apply(x[:, :2 * halo], x[:, -2 * halo:], strips, 0.0)
    if strips.s == 0:
        return torch.cat([x, from_next], 1), 0
    if strips.s == strips.k - 1:
        return torch.cat([from_prev, x], 1), 2 * halo
    return torch.cat([from_prev[:, -halo:], x, from_next[:, :halo]], 1), halo


def halo_exchange_exact(x: torch.Tensor, halo: int, axis_name: str):
    """Overlap-strip halo: the border strips extend inward with ``2·halo``
    real rows, so the true border stays the network's own input edge.
    Returns ``(padded, crop_start)``: every strip is ``h + 2·halo`` rows and
    its exact ``h``-row output window starts at ``crop_start`` (0 for the
    first strip, ``2·halo`` for the last, ``halo`` otherwise).  A one-rank
    axis or ``halo == 0`` gives ``(x, 0)``.  Needs ``2·halo <= h``."""
    return _exact(x, halo, _strips_of(axis_name))


def spatial_batch_sharding(mesh: Mesh, axis: str = 'data') -> NamedSharding:
    """The placement of an (image, label, ...) batch with the height
    (dimension 1) on ``axis``: ``P(None, axis)``, a prefix that leaves the
    trailing dimensions of every leaf whole."""
    return NamedSharding(mesh, P(None, axis))


def _halo_apply(fn: Callable, x: torch.Tensor, strips: Strips, halo: int,
                boundary: str) -> torch.Tensor:
    """``fn`` on this strip with its halo, cropped to the strip's rows."""
    h = x.shape[1]
    if halo == 0 or strips.k == 1:
        return fn(x)
    if boundary == 'exact':
        padded, start = _exact(x, halo, strips)
        return fn(padded).narrow(1, start, h)
    return fn(strips.rows(x, halo, halo, 1)).narrow(1, halo, h)


def _strip_layout(x, mesh: Mesh, axis: str, device) -> tuple:
    """(this rank's rows of ``x``, the axis's mesh, its strips): a whole tile
    is laid out with ``host_to_global`` first, as JAX ``device_put``s it."""
    from ever_tpu_torch.parallel.mesh import host_to_global
    view = mesh.with_batch_axes((axis,))
    strips = Strips(mesh, axis)
    if not isinstance(x, DTensor):
        x = torch.as_tensor(x).to(device)
    x = host_to_global(x, spatial_batch_sharding(view, axis))   # whole on a one-rank axis
    return (x.to_local() if isinstance(x, DTensor) else x), view, strips


def _as_global(y: torch.Tensor, view: Mesh, k: int):
    """A strip of the output as ``host_to_global`` gives one: a ``DTensor``
    split on dimension 1 over the axis (the tensor itself on one rank)."""
    if view.group is None:
        return y
    from torch.distributed.tensor import Shard
    shape = (y.shape[0], y.shape[1] * k) + tuple(y.shape[2:])
    return DTensor.from_local(y, view.device_mesh(y.device.type), (Shard(1),), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device='meta').stride())


def spatial_partition_apply(fn: Callable, x, mesh: Mesh, axis: str = 'data', halo: int = 64,
                            boundary: str = 'exact', *, device=None):
    """Run ``fn`` (a resolution-preserving NHWC forward, ``[N, h, W, C] →
    [N, h, W, C']``) on one tile split along H over ``axis``, each strip with
    a halo of ``halo`` rows (half the receptive field or more).
    ``boundary='exact'`` equals the unsharded forward everywhere and needs
    ``2·halo <= H/k``; ``'zeros'`` pads the true border with zeros (half the
    traffic; the rows within half the receptive field of the border
    differ).  ``x`` is the whole tile (an array or tensor, placed on
    ``device``: the GPU unless the caller asks for the CPU) or its
    ``host_to_global(x, spatial_batch_sharding(mesh, axis))``.  Returns this
    rank's strip of the output as ``host_to_global`` gives one: a
    ``DTensor`` split on dimension 1 (``.to_local()`` is the strip)."""
    from ever_tpu_torch.core.device import get_device
    k = mesh.axis_size(axis)
    _check_partition(tuple(x.shape)[1], k, axis, halo, boundary)
    x_local, view, strips = _strip_layout(x, mesh, axis, get_device(device))
    return _as_global(_halo_apply(fn, x_local, strips, halo, boundary), view, k)


def _check_partition(h: int, k: int, axis: str, halo: int, boundary: str) -> None:
    if h % k != 0:
        raise ValueError(f'the {axis!r} axis size {k} must divide H={h}; '
                         f'pad the tile height to a multiple of {k}')
    if boundary not in ('exact', 'zeros'):
        raise ValueError(f"boundary must be 'exact' or 'zeros', got {boundary!r}")
    if halo < 0:
        raise ValueError(f'halo must be >= 0, got {halo}')
    if boundary == 'exact' and 2 * halo > h // k:
        raise ValueError(f"boundary='exact' needs 2*halo <= H/k "
                         f'({2 * halo} > {h // k}); lower halo or use '
                         f"boundary='zeros'")
    if boundary == 'zeros' and halo > h // k:
        raise ValueError(f"halo={halo} exceeds the per-device strip height "
                         f'H/k = {h // k}; lower halo or use fewer devices')


def build_spatial_train_step(model, tx, lr_schedule=None, mesh: Mesh = None,
                             axis: str = 'data', rng_seed: int = 0, donate: bool = True, *,
                             device=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` on tiles split along H
    over ``axis`` (a batch may be one giant tile): the port's
    ``build_train_step`` over the mesh whose batch axis is ``axis``, run
    under the strip context, so that every conv, pool and resize takes its
    halo from the neighbours and the BatchNorm statistics, the losses, the
    dropout draws and the gradient average are the whole tile's (module
    docstring).  A ViT's attention runs each strip's queries against the
    whole tile's keys (module docstring, "Attention over strips"), and a
    checkpointed block recomputes with its forward's contexts.  The
    parameters' gradients are the unsharded step's: DDP's average over the
    axis together with the global loss, as under data parallelism.  Other
    mesh axes hold replicas of the tile, as JAX's ``P(None, axis)``
    replicates it there.

    ``batch`` is ``(x [N, H, W, C], y [N, H, ...])`` whole on every rank, or
    its ``host_to_global(batch, spatial_batch_sharding(mesh, axis))``; H
    must be divisible by the axis size, and by it times every stride before
    each strided op.  ``donate`` is accepted and has no effect (PyTorch
    updates the state in place).  ``device``: where the strips go (the GPU
    unless the caller asks for the CPU); the model must be there.
    ``step.stats`` counts the halo broadcasts and bytes this rank sent and
    its keys' and values' (:class:`Strips`)."""
    from ever_tpu_torch.core.device import get_device
    from ever_tpu_torch.parallel.spmd import build_train_step

    if mesh is None:
        raise ValueError('build_spatial_train_step requires mesh=')
    del donate
    dev = get_device(device)
    strips = Strips(mesh, axis)
    inner = build_train_step(model, tx, lr_schedule, mesh=mesh.with_batch_axes((axis,)),
                             rng_seed=rng_seed)

    def step(state, batch):
        strips.check_batch(batch)
        local = tree_map(lambda t: strips.take(t).to(dev) if hasattr(t, 'shape') else t, batch)
        with strips:
            return inner(state, local)

    step.stats = strips.stats
    return step


def build_halo_train_step(forward: Callable, loss_fn: Callable, tx, mesh: Mesh,
                          axis: str = 'data', halo: int = 64, boundary: str = 'exact',
                          lr_schedule=None, *, device=None) -> Callable:
    """Explicit halo-exchange train step for frozen-BN dense forwards.

    ``forward(params, x) -> logits`` is a resolution-preserving eval-mode
    NHWC forward (frozen BN, no dropout: the giant-tile fine-tune);
    ``loss_fn(logits, y) -> scalar`` a mean over the strip's pixels.  Each
    step exchanges the input strips' halos, runs ``forward`` on the padded
    strip, crops to the owned rows and takes the mean of the strips' losses
    (equal strips: the global pixel mean); the gradients ride the same hops
    back, and the parameters' gradients are summed over the axis, so they
    equal the unsharded step's.

    Returns ``step(opt_pack, batch) -> (opt_pack, metrics)`` where
    ``opt_pack = (step, params, optimizer)``: the step count, the
    parameters ``forward`` takes (a dict or list of leaf tensors) and the
    ``torch.optim`` optimizer ``tx.init`` made over them (the port's
    optimizer state); the step updates them in place.  ``batch`` is ``(x,
    y)`` whole on every rank or laid out by ``spatial_batch_sharding``;
    ``device``: where the strips go (the GPU unless the caller asks for the
    CPU)."""
    from ever_tpu_torch.core.device import get_device

    if boundary not in ('exact', 'zeros'):
        raise ValueError(f"boundary must be 'exact' or 'zeros', got {boundary!r}")
    dev = get_device(device)
    strips = Strips(mesh, axis)
    k = strips.k

    def step(opt_pack, batch):
        it, params, optimizer = opt_pack
        x, y = (strips.take(t).to(dev) for t in batch)
        h = x.shape[1]
        if boundary == 'exact' and halo > 0 and 2 * halo > h:
            raise ValueError(
                f"boundary='exact' needs 2*halo <= H/k ({2 * halo} > "
                f"{h}); lower halo or use boundary='zeros'")
        leaves = [p for p in tree_leaves(params) if isinstance(p, torch.Tensor)]
        for p in leaves:
            p.grad = None
        loss = loss_fn(_halo_apply(lambda t: forward(params, t), x, strips, halo, boundary), y)
        (loss / k).backward()
        total = loss.detach().reshape(1).double()
        if strips.group is not None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            flat = torch.cat([total.to(grads[0].dtype)] + [g.reshape(-1) for g in grads])
            tdist.all_reduce(flat, group=strips.group)
            total = flat[:1].double()
            offset = 1
            for p, g in zip(leaves, grads):
                p.grad = flat[offset:offset + g.numel()].view_as(g).clone()
                offset += g.numel()
        tx.apply(optimizer, it)
        metrics = {'total_loss': (total[0] / k).float()}
        if lr_schedule is not None:
            metrics['learning_rate'] = torch.tensor(float(lr_schedule(it)))
        return (it + 1, params, optimizer), metrics

    step.stats = strips.stats
    return step
