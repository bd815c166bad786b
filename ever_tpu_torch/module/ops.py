"""Building-block ops (counterpart of ``ever_tpu/module/ops.py``).

The functions (``resize``, ``upsample``, ``global_avg_pool``,
``adaptive_avg_pool``, ``max_pool``, ``avg_pool``, ``channel_concat``, ...)
take NHWC tensors, as the JAX package's do.  The modules (``Conv2d``,
``BatchNorm2d``, ``ConvBlock``, ``SeparableConvBlock``, ``PoolBlock``,
``ChannelConcat``, ...) and the dropouts take NCHW tensors, which the
conv-net models keep in ``torch.channels_last`` memory: a permute between
the two is then a view.

The resizes and pools that a train step differentiates are matrix products
(``resize_align_corners``, ``upsample_bilinear``, ``downsample_bilinear``,
``adaptive_avg_pool``) or
a broadcast (``upsample_nearest_int``): ``F.interpolate``'s and
``adaptive_avg_pool2d``'s CUDA backwards add with atomics, these do not,
so a step's gradients are the same bits every run.  Under a spatial step
every resize is a matrix product (``_strip_resize``): the strip's rows of
the whole tile's weights (``parallel/spatial.py``).

Precision: a layer computes in its input's dtype and casts its float32
parameters to it, as flax's ``dtype=`` does; BatchNorm computes its
statistics and normalisation in float32 and returns the input's dtype, as
do GroupNorm and LayerNorm.  Training follows a ``train`` argument, not
``nn.Module.training``; dropout draws from the step's ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.distributed as tdist
from torch.utils import checkpoint as _ckpt

from ever_tpu_torch.parallel import spatial as _spatial
from ever_tpu_torch.parallel.mesh import data_shard, reduction_group

__all__ = ['resize', 'upsample', 'upsample_bilinear', 'downsample_bilinear', 'bilinear_nchw', 'upsample_nearest_int',
           'global_avg_pool', 'adaptive_avg_pool', 'max_pool', 'avg_pool', 'channel_concat',
           'channel_sum', 'list_index', 'Conv2d', 'BatchNorm2d', 'GroupNorm2d', 'LayerNorm2d',
           'Norm', 'ConvBlock', 'Sequential', 'running_stats_frozen', 'checkpointed', 'dropout',
           'channel_dropout', 'sample_dropout', 'DepthwiseConv2d', 'SeparableConv2d',
           'SeparableConvBlock',
           'PoolBlock', 'ResidualBlock', 'ConvUpsampling', 'ChannelReduction',
           'ChannelConcat', 'Sum', 'ListIndex', 'Squeeze', 'Bf16compatible']


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def channel_concat(features):
    """Concatenate a list of NHWC features on the channels (one is returned
    as it is)."""
    if len(features) == 1:
        return features[0]
    return torch.cat(list(features), dim=-1)


def channel_sum(features):
    """The sum of a list of features, in order."""
    out = features[0]
    for f in features[1:]:
        out = out + f
    return out


def list_index(features, *index):
    """``features[i]`` for one index, the list of them for several."""
    if len(index) == 1:
        return features[index[0]]
    return [features[i] for i in index]


def resize(x: torch.Tensor, scale: Optional[float] = None,
           shape: Optional[Tuple[int, int]] = None,
           method: str = 'nearest', align_corners: bool = False) -> torch.Tensor:
    """Spatial resize of an NHWC tensor, returned in x's dtype.

    Both methods use half-pixel centres (``jax.image.resize``'s convention;
    torch's ``'nearest-exact'`` for nearest).  Bilinear is computed in
    float32 except for bfloat16 input, which stays bfloat16 as in the JAX
    package.  Downsampling bilinear antialiases, as ``jax.image.resize``
    does.  ``align_corners=True`` (bilinear only) is
    :func:`resize_align_corners`.  Under a spatial step x is a strip and
    ``shape`` (or ``scale`` of the strip's rows) the strip's output: a
    nearest resize by an integer factor is row-local; every other is
    :func:`_strip_resize`, and a ``scale`` whose strips' outputs are not the
    whole tile's raises (``Strips.share``).
    """
    n, h, w, c = x.shape
    if shape is None:
        shape = _scaled_shape(h, w, scale, f'resize ({method})')
    if method == 'bilinear' and align_corners:
        return resize_align_corners(x, shape)
    strips = _spatial.current()
    if (strips is not None and method in ('nearest', 'bilinear')
            and not (method == 'nearest' and shape[0] % h == 0)):
        # nearest by an integer factor is row-local on aligned strips
        return _strip_resize(x, strips, shape, method)
    xc = x.permute(0, 3, 1, 2)
    if method == 'nearest':
        y = F.interpolate(xc, size=shape, mode='nearest-exact')
    elif method == 'bilinear':
        if x.dtype != torch.bfloat16:
            xc = xc.float()
        y = F.interpolate(xc, size=shape, mode='bilinear', align_corners=False,
                          antialias=shape[0] < h or shape[1] < w)
    else:
        raise ValueError(f"method must be 'nearest' or 'bilinear', got {method!r}")
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_align_corners(x: torch.Tensor, shape: Tuple[int, int],
                         whole: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor with torch's ``align_corners=True``
    (the reference's ``UpsamplingBilinear2d``), computed in float32 as one
    matrix product per axis and returned in x's dtype, as the JAX package
    computes it.  Its backward is two matrix products too: no atomics, so a
    train step's gradients are the same bits every run (``F.interpolate``'s
    CUDA backward adds with atomics).  Under a spatial step ``x`` is a
    strip, or with ``whole=True`` a map whole on every rank; ``shape[0]``
    is the strip's output rows either way (``parallel/spatial.py``)."""
    f32 = torch.float32
    strips = _spatial.current()
    if strips is not None:
        y = (strips.resize_whole_rows if whole else strips.resize_rows)(
            x.float(), shape[0], 'bilinear', True, f32)
    else:
        y = torch.einsum('oh,nhwc->nowc',
                         _bilinear_weights(x.shape[1], shape[0], f32, x.device, True), x.float())
    y = torch.einsum('pw,nowc->nopc',
                     _bilinear_weights(x.shape[2], shape[1], f32, x.device, True), y)
    return y.to(x.dtype)


def _bilinear_weights(n_in: int, n_out: int, dtype: torch.dtype,
                      device: torch.device, align_corners: bool = False) -> torch.Tensor:
    """``[n_out, n_in]`` weights of a bilinear resize along one axis, made
    on ``device``: with half-pixel centres and the edges clamped
    (``F.interpolate``'s ``align_corners=False``), or output i sampling
    input i·(n_in−1)/(n_out−1) (``align_corners=True``, where an output of
    size 1 takes input 0, torch's convention and the JAX package's).
    Cached, except while ``torch.export`` (or ``torch.compile``) traces: a
    traced program makes them itself, and the cache must not keep a
    tracer's tensor."""
    if torch.compiler.is_compiling():
        return _make_bilinear_weights(n_in, n_out, dtype, device, align_corners)
    return _cached_bilinear_weights(n_in, n_out, dtype, device, align_corners)


def _make_bilinear_weights(n_in, n_out, dtype, device, align_corners):
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    if align_corners:
        src = i * (n_in - 1) / max(n_out - 1, 1)
    else:
        src = ((i + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    i0 = src.floor().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = (src - i0)[:, None]
    cols = torch.arange(n_in, dtype=torch.float64, device=device)[None]
    w = (cols == i0[:, None]) * (1 - frac) + (cols == i1[:, None]) * frac
    return w.to(dtype)


_cached_bilinear_weights = functools.lru_cache(maxsize=16)(_make_bilinear_weights)


def _make_resize_weights(n_in: int, n_out: int, method: str, align_corners: bool,
                         dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of :func:`resize` along one axis, as the
    JAX package computes it: nearest as a one-hot matrix of
    ``jax.image.resize``'s sources ``floor((i + 0.5)·n_in/n_out)`` (in
    float32, as it computes them); bilinear with ``align_corners``, or
    half-pixel where the axis grows or keeps its size
    (:func:`_make_bilinear_weights`), antialiased where it shrinks
    (:func:`_make_antialias_weights`)."""
    if method == 'nearest':
        src = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in
               / n_out).floor().clamp(max=n_in - 1)
        cols = torch.arange(n_in, dtype=torch.float32, device=device)
        return (cols[None] == src[:, None]).to(dtype)
    if method != 'bilinear':
        raise ValueError(f"method must be 'nearest' or 'bilinear', got {method!r}")
    if align_corners or n_out >= n_in:
        return _make_bilinear_weights(n_in, n_out, dtype, device, align_corners)
    return _make_antialias_weights(n_in, n_out, dtype, device)


_cached_resize_weights = functools.lru_cache(maxsize=16)(_make_resize_weights)


def _scaled_shape(h: int, w: int, scale: float, what: str) -> Tuple[int, int]:
    """``(int(h·scale), int(w·scale))``; under a spatial step h is a strip's
    rows, and a scale whose strips' outputs are not the whole tile's raises
    (``Strips.share``)."""
    strips = _spatial.current()
    rows = int(h * scale) if strips is None else strips.share(h, scale, what)
    return rows, int(w * scale)


def _strip_resize(x: torch.Tensor, strips, shape: Tuple[int, int], method: str,
                  whole: bool = False) -> torch.Tensor:
    """:func:`resize` of NHWC ``x`` under a spatial step, by two matrix
    products: the rows by ``Strips.resize_rows`` (x a strip) or
    ``Strips.resize_whole_rows`` (``whole``: x a map whole on every rank),
    to ``shape[0]`` rows a strip, then the columns by the whole axis's
    weights (:func:`_make_resize_weights`).  Nearest in x's dtype (a one-hot
    product is exact), bilinear in float32 except for bfloat16 input, as
    :func:`resize` computes them; returned in x's dtype.  The backward is
    the transposed products: no atomics."""
    if method == 'nearest' or x.dtype == torch.bfloat16:
        ct = x.dtype
    else:
        ct = torch.float32
    y = (strips.resize_whole_rows if whole else strips.resize_rows)(
        x.to(ct), shape[0], method, False, ct)
    cols = _cached_resize_weights(x.shape[2], shape[1], method, False, ct, x.device)
    return torch.einsum('pw,nowc->nopc', cols, y).to(x.dtype)


def upsample_bilinear(x: torch.Tensor, shape: Tuple[int, int],
                      whole: bool = False) -> torch.Tensor:
    """Bilinear upsampling of an NHWC tensor to ``shape`` (half-pixel
    centres): ``resize``'s numbers, computed as one matrix product per axis,
    as ``jax.image.resize`` computes them.  Unlike ``F.interpolate``, whose
    CUDA backward adds into the input gradient with atomics, the backward is
    two matrix products, so a train step's gradients are the same bits every
    run.  Under a spatial step ``x`` is a strip, or with ``whole=True`` a
    map whole on every rank; ``shape[0]`` is the strip's output rows either
    way (``parallel/spatial.py``)."""
    n, h, w, c = x.shape
    strips = _spatial.current()
    rows = shape[0] * (strips.k if strips is not None and whole else 1)
    if rows < h or shape[1] < w:
        raise ValueError(f'upsample_bilinear grows each axis; {(h, w)} -> {(rows, shape[1])} '
                         'shrinks one (resize antialiases that)')
    if strips is not None:
        y = (strips.resize_whole_rows if whole else strips.resize_rows)(
            x, shape[0], 'bilinear', False, x.dtype)
    else:
        y = torch.einsum('oh,nhwc->nowc', _bilinear_weights(h, shape[0], x.dtype, x.device), x)
    return torch.einsum('pw,nowc->nopc', _bilinear_weights(w, shape[1], x.dtype, x.device), y)


def _antialias_weights(n_in: int, n_out: int, dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of ``jax.image.resize``'s antialiased
    bilinear shrink along one axis: the triangle kernel widened by
    ``n_in / n_out``, sampled at the half-pixel centres, each row
    renormalised over the inputs that exist (halving: [1, 3, 3, 1]/8
    inside, [3, 3, 1]/7 at the edges).  Cached, except while a program is
    traced, as :func:`_bilinear_weights`."""
    if torch.compiler.is_compiling():
        return _make_antialias_weights(n_in, n_out, dtype, device)
    return _cached_antialias_weights(n_in, n_out, dtype, device)


def _make_antialias_weights(n_in, n_out, dtype, device):
    ratio = n_in / n_out
    src = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * ratio - 0.5
    cols = torch.arange(n_in, dtype=torch.float64, device=device)
    w = (1 - (src[:, None] - cols[None]).abs() / max(ratio, 1.0)).clamp(min=0)
    return (w / w.sum(1, keepdim=True)).to(dtype)


_cached_antialias_weights = functools.lru_cache(maxsize=16)(_make_antialias_weights)


def downsample_bilinear(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear shrinking of an NHWC tensor to ``shape``:
    ``jax.image.resize``'s numbers (and ``resize``'s), computed as one
    matrix product per axis in float32 (bfloat16 stays bfloat16) and
    returned in x's dtype.  Its backward is two matrix products: no
    atomics, unlike ``F.interpolate``'s.  Under a spatial step x is a strip
    and ``shape[0]`` the strip's output rows (:func:`_strip_resize`)."""
    n, h, w, c = x.shape
    if shape[0] > h or shape[1] > w:
        raise ValueError(f'downsample_bilinear shrinks each axis; {(h, w)} -> {tuple(shape)} '
                         'grows one (upsample_bilinear does that)')
    strips = _spatial.current()
    if strips is not None:
        return _strip_resize(x, strips, shape, 'bilinear')
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    y = torch.einsum('oh,nhwc->nowc', _antialias_weights(h, shape[0], ct, x.device), x.to(ct))
    y = torch.einsum('pw,nowc->nopc', _antialias_weights(w, shape[1], ct, x.device), y)
    return y.to(x.dtype)


def bilinear_nchw(x: torch.Tensor, shape: Tuple[int, int],
                  align_corners: bool = False, whole: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``shape`` by matrix products,
    in x's dtype: :func:`resize_align_corners` (float32) with
    ``align_corners``, else :func:`upsample_bilinear` (float32 unless x is
    bfloat16), which only grows; a shrinking half-pixel resize antialiases
    and goes through :func:`resize`.  ``whole``: under a spatial step, x is
    whole on every rank and ``shape`` the strip's (``upsample_bilinear``,
    and :func:`_strip_resize` where it shrinks)."""
    h, w = x.shape[2:]
    xh = x.permute(0, 2, 3, 1)
    if align_corners:
        return resize_align_corners(xh, shape, whole).permute(0, 3, 1, 2)
    strips = _spatial.current()
    rows = shape[0] * (strips.k if strips is not None and whole else 1)
    if rows < h or shape[1] < w:
        if strips is not None and whole:
            return _strip_resize(xh, strips, shape, 'bilinear', whole=True).permute(0, 3, 1, 2)
        return resize(xh, shape=shape, method='bilinear').permute(0, 3, 1, 2)
    xh = xh if xh.dtype == torch.bfloat16 else xh.float()
    return upsample_bilinear(xh, shape, whole).to(x.dtype).permute(0, 3, 1, 2)


def upsample_nearest_int(x: torch.Tensor, k: int) -> torch.Tensor:
    """Nearest upsampling of an NCHW tensor by an integer ``k`` as a
    broadcast and a reshape (the JAX package's ``_upsample_nearest_int``):
    ``resize(method='nearest')``'s values, and a backward that is a plain
    sum over each k×k block.  The result lies in ``channels_last`` memory."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, k, w, k, c)
    return y.reshape(n, h * k, w * k, c).permute(0, 3, 1, 2)


def upsample(x: torch.Tensor, scale: int = 2, method: str = 'nearest') -> torch.Tensor:
    """:func:`resize` of an NHWC tensor by ``scale``."""
    return resize(x, scale=scale, method=method)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """NHWC → N11C spatial mean, accumulated in float32, in x's dtype.
    Under a spatial step the strips' sums are added over the axis (one
    differentiable all-reduce) and divided by the whole tile's count."""
    strips = _spatial.current()
    if strips is None:
        return torch.mean(x, dim=(1, 2), keepdim=keepdims, dtype=torch.float32).to(x.dtype)
    total = strips.row_sum(x.sum(dim=(1, 2), keepdim=keepdims, dtype=torch.float32))
    return (total / (x.shape[1] * strips.k * x.shape[2])).to(x.dtype)


def _nchw_mean(x: torch.Tensor) -> torch.Tensor:
    """The spatial mean of an NCHW tensor as ``[N, C, 1, 1]``, accumulated
    in float32, in x's dtype (the squeezes' pool); under a spatial step
    :func:`global_avg_pool`'s sum over the strips, whole on every rank."""
    if _spatial.current() is None:
        return x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
    return global_avg_pool(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _bin_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``[n_out, n_in]`` float32 averaging weights of adaptive pooling along
    one axis: bin i spans ``[floor(i·n/m), ceil((i+1)·n/m))`` (torch's
    bins), each of its inputs weighted 1/its length."""
    i = torch.arange(n_out, device=device)
    lo = (i * n_in) // n_out
    hi = -((-(i + 1) * n_in) // n_out)
    cols = torch.arange(n_in, device=device)[None]
    inside = (cols >= lo[:, None]) & (cols < hi[:, None])
    return inside.to(torch.float32) / (hi - lo)[:, None].to(torch.float32)


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """Adaptive average pooling of an NHWC tensor with torch's bins (uneven
    ones too, e.g. 64 → 3), in float32 and returned in x's dtype, as the
    JAX package pools (there through an integral image).  Computed as one
    bin-averaging matrix product per axis: unlike ``adaptive_avg_pool2d``,
    whose CUDA backward adds with atomics where the bins do not divide the
    map, its backward is two matrix products, the same bits every run.
    Under a spatial step x is a strip and the bins are the whole tile's,
    whole on every rank: (1, 1) by :func:`global_avg_pool`, others by
    ``Strips.bin_pool``."""
    oh, ow = _pair(output_size)
    n, h, w, c = x.shape
    if (oh, ow) == (1, 1):
        return global_avg_pool(x)
    strips = _spatial.current()
    if strips is not None:
        return strips.bin_pool(x, (oh, ow)).to(x.dtype)
    if (oh, ow) == (h, w):
        return x
    y = torch.einsum('oh,nhwc->nowc', _bin_weights(h, oh, x.device), x.float())
    y = torch.einsum('pw,nowc->nopc', _bin_weights(w, ow, x.device), y)
    return y.to(x.dtype)


def _lax_same(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(low, high) padding of lax's ``'SAME'``: the output has ceil(size/s)
    positions and the extra pad goes to the high side."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, w, s, padding, strips=None):
    """((top, bottom), (left, right)) of ``padding`` (``'SAME'``,
    ``'VALID'`` or explicit pairs) for an NHWC x; under a spatial step
    ``'SAME'``'s rows are the whole tile's."""
    if padding == 'VALID':
        return ((0, 0), (0, 0))
    if padding == 'SAME':
        rows = x.shape[1] * (1 if strips is None else strips.k)
        return tuple(_lax_same((rows, x.shape[2])[i], w[i], s[i]) for i in range(2))
    return tuple(tuple(p) for p in padding)


def max_pool(x: torch.Tensor, window=3, stride=2, padding='SAME',
             impl: str = 'reduce_window') -> torch.Tensor:
    """Max pool of an NHWC tensor; ``padding`` is ``'SAME'``, ``'VALID'`` or
    ``((top, bottom), (left, right))``, padded with -inf.

    Routed as the JAX package routes it: ``impl='pallas'`` (and ``'planes'``,
    the JAX package's XLA formulation of the same gradient) takes
    :func:`~ever_tpu_torch.ops.pool.max_pool_32`, whose backward is the
    hand-written kernel K8, for a 3×3/2 window with padding ((1,1),(1,1)),
    even H and W and a float type; everything else is ``F.max_pool2d``
    forward and backward (``'reduce_window'`` and ``'separable'``).  The two
    differ only at exact ties, where K8 gives every tied maximum the
    gradient and ``F.max_pool2d`` one of them.  Under a spatial step
    (``parallel/spatial.py``) each route takes its halo rows from the
    neighbouring strips.
    """
    w, s = _pair(window), _pair(stride)
    if impl not in ('reduce_window', 'separable', 'planes', 'pallas'):
        raise ValueError(f'unknown max_pool impl {impl!r}')
    strips = _spatial.current()
    if (impl in ('planes', 'pallas') and w == (3, 3) and s == (2, 2)
            and padding == ((1, 1), (1, 1))
            and x.dim() == 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            and x.is_floating_point()):
        from ever_tpu_torch.ops.pool import max_pool_32
        if strips is None:
            return max_pool_32(x)
        # K8 pads one -inf row itself and takes an even height: give it the
        # previous strip's last 2 rows (-inf above the true top) and drop the
        # first output row, so that its own -inf row stands only there
        return max_pool_32(strips.rows(x, 2, 0, 1, float('-inf'), 'max_pool (K8)'))[:, 1:]
    pads = _pads(x, w, s, padding, strips)
    if strips is not None:
        x = strips.window(x, 'max_pool', w[0], s[0], 1, pads[0][0], 1, float('-inf'))
        xc = F.pad(x.permute(0, 3, 1, 2), (pads[1][0], pads[1][1]), value=float('-inf'))
        return F.max_pool2d(xc, w, s).permute(0, 2, 3, 1)
    xc = x.permute(0, 3, 1, 2)
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        y = F.max_pool2d(xc, w, s, (pads[0][0], pads[1][0]))
    else:
        xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]),
                   value=float('-inf'))
        y = F.max_pool2d(xc, w, s)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window=3, stride=2, padding='SAME') -> torch.Tensor:
    """Average pool of an NHWC tensor with flax's ``nn.avg_pool`` semantics:
    the padding (as :func:`max_pool` takes it) is zeros, counted in each
    window's mean."""
    w, s = _pair(window), _pair(stride)
    strips = _spatial.current()
    (t, b), (l, r) = _pads(x, w, s, padding, strips)
    if strips is not None:
        x = strips.window(x, 'avg_pool', w[0], s[0], 1, t, 1)
        t = b = 0
    xc = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b))
    return F.avg_pool2d(xc, w, s).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype.

    ``padding='same'`` pads as flax's ``'SAME'``: symmetric where that is
    (stride 1 and an odd dilated kernel), otherwise lax's asymmetric
    padding, worked out from each input's size (``_lax_same``: the output
    has ⌈n/s⌉ positions and the odd pixel of padding goes after) and
    applied by ``F.pad`` before a conv without padding.  Integer padding is
    symmetric, as the ResNet's ``_conv`` pads.  Under a spatial step
    (``parallel/spatial.py``) the rows above and below come from the
    neighbouring strips.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding: Union[str, int] = 'same', dilation=1,
                 groups: int = 1, bias: bool = False):
        k, s, d = _pair(kernel_size), _pair(stride), _pair(dilation)
        lax_same = False
        if padding == 'same':
            totals = [(k[i] - 1) * d[i] for i in range(2)]
            if s == (1, 1) and not any(t % 2 for t in totals):
                padding = (totals[0] // 2, totals[1] // 2)
            else:
                lax_same, padding = True, 0
        super().__init__(in_channels, out_channels, k, s, padding, d, groups, bias)
        self.lax_same = lax_same

    def forward(self, x):
        strips = _spatial.current()
        padding = self.padding
        if strips is not None:
            x, padding = self._strip(x, strips)
        elif self.lax_same:
            (t, b), (l, r) = (_lax_same(x.shape[2 + i], self.kernel_size[i], self.stride[i],
                                        self.dilation[i]) for i in range(2))
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, padding, self.dilation, self.groups)

    def _strip(self, x, strips):
        """Under a spatial step: the strip with the rows the window reads of
        the neighbours' strips (the true border padded as the whole tile is,
        lax's ``'SAME'`` worked out from the whole tile's height), and the
        conv's remaining padding (the columns')."""
        if self.lax_same:
            rows = x.shape[2] * strips.k
            (t, _), (l, r) = (_lax_same((rows, x.shape[3])[i], self.kernel_size[i],
                                        self.stride[i], self.dilation[i]) for i in range(2))
            x, padding = F.pad(x, (l, r)), (0, 0)
        elif isinstance(self.padding, str):             # 'valid'
            t, padding = 0, (0, 0)
        else:
            t, padding = self.padding[0], (0, self.padding[1])
        return strips.window(x, f'Conv2d {tuple(self.kernel_size)}', self.kernel_size[0],
                             self.stride[0], self.dilation[0], t, 2), padding


class BatchNorm2d(nn.Module):
    """BatchNorm over the channels of an NCHW tensor with flax's semantics
    (``ever_tpu/module/ops.py`` ``Norm('bn')``, torch's defaults as flax
    spells them: momentum 0.9, eps 1e-5).

    ``forward(x, train)``: with ``train=True`` (and not ``frozen``) it
    normalises by the batch's statistics and moves the running ones,
    ``r = 0.9·r + 0.1·batch``, with the **biased** batch variance, as flax
    does (``nn.BatchNorm2d`` would take the unbiased one).  The batch mean
    and variance come from the kernel's saved mean and inverse standard
    deviation (``var = invstd⁻² − eps``), so the update costs no extra pass
    over x.  Otherwise, and always when ``frozen``, it normalises by the
    running statistics.  Statistics and normalisation are float32; the
    output has x's dtype.  The parameters and buffers stay float32 and are
    named as torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``).  ``update_running_stats=False`` (see
    :func:`running_stats_frozen`) keeps the train-mode normalisation but
    leaves the running statistics alone.

    Inside a data-parallel step over more than one rank (``with mesh:``,
    :func:`~ever_tpu_torch.parallel.mesh.reduction_group`) train mode uses
    the **global** batch statistics, as the JAX package's are under a
    sharded batch: :class:`_GlobalBatchNorm`.  With one rank the code path
    is the one above.
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 frozen: bool = False):
        super().__init__()
        self.eps, self.momentum, self.frozen = eps, momentum, frozen
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x, train: bool = False):
        if not train or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        group = reduction_group()
        if group is None:
            y, mean, invstd = torch.ops.aten.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = invstd.pow(-2) - self.eps
        else:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, group)
        if self.update_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of an NCHW tensor over the batch of every rank
    of ``group``, in float32 (float64 for float64 input).

    Forward: one ``all_reduce`` of each rank's count, mean and centred sum
    of squares per channel, each rank writing its own row of an ``[R, 2C+1]``
    zero tensor, so that the sum is a gather; every rank then combines the
    rows in rank order (Chan's pairwise formula: no large sums of squares
    cancel).  Backward: one ``all_reduce`` of Σdy and Σdy·x̂ per channel for
    dx; dγ and dβ are the rank's own sums, which the data-parallel step
    reduces with the other gradients.  Returns y in x's dtype, and the
    global mean and biased variance for the running statistics.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        ct = torch.float64 if x.dtype == torch.float64 else torch.float32
        xc = x.to(ct)
        c = x.shape[1]
        var, mean = torch.var_mean(xc, dim=(0, 2, 3), correction=0)
        n = x.numel() // c
        rows = xc.new_zeros(tdist.get_world_size(group), 2 * c + 1)
        row = rows[tdist.get_rank(group)]
        row[0] = n
        row[1:c + 1] = mean
        row[c + 1:] = var * n
        tdist.all_reduce(rows, group=group)
        counts = rows[:, :1]
        total = counts.sum()
        gmean = (counts * rows[:, 1:c + 1]).sum(0) / total
        m2 = rows[:, c + 1:].sum(0) + (counts * (rows[:, 1:c + 1] - gmean) ** 2).sum(0)
        gvar = m2 / total
        rstd = torch.rsqrt(gvar + eps)
        y = ((xc - _per_channel(gmean)) * _per_channel(rstd * weight.to(ct))
             + _per_channel(bias.to(ct)))
        ctx.save_for_backward(x, weight, gmean, rstd)
        ctx.total, ctx.group = total, group
        ctx.mark_non_differentiable(gmean, gvar)
        return y.to(x.dtype), gmean, gvar

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        ct = mean.dtype
        xhat = (x.to(ct) - _per_channel(mean)) * _per_channel(rstd)
        dy = dy.to(ct)
        c = x.shape[1]
        sums = torch.cat([dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))])
        local = sums.clone()
        tdist.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xhat = sums[:c] / ctx.total, sums[c:] / ctx.total
        dx = (dy - _per_channel(g_dy) - xhat * _per_channel(g_dy_xhat)) * _per_channel(
            rstd * weight.to(ct))
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Inside, no :class:`BatchNorm2d` of ``module`` moves its running
    statistics (train-mode normalisation is unchanged): a checkpointed
    stage's recomputation must not update them a second time, as JAX's
    ``nn.remat`` never writes state in its recompute."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.update_running_stats for m in bns]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_running_stats = s


def checkpointed(module: nn.Module, fn, x):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward pass recomputes it, and the recomputation leaves the running
    statistics of ``module``'s BatchNorms alone (:func:`running_stats_frozen`),
    so they move once per forward, as under JAX's ``nn.remat``.  Under a
    spatial step the recomputation runs with the forward's strip and mesh
    contexts (``parallel.spatial.recomputable``), so it issues the block's
    halo exchanges and BatchNorm reductions again on every rank, in the
    same order, as ``nn.remat`` does under GSPMD."""
    calls = []

    def run(x):
        calls.append(None)
        if len(calls) == 1:
            return fn(x)
        with running_stats_frozen(module):
            return fn(x)

    return _ckpt.checkpoint(_spatial.recomputable(run), x, use_reentrant=False)


class GroupNorm2d(nn.GroupNorm):
    """GroupNorm of an NCHW tensor with flax's semantics: statistics and
    normalisation in float32 (float64 for float64 input), the output in x's
    dtype; float32 ``weight`` and ``bias`` (flax's ``scale`` and ``bias``).
    The eps is each call site's: 1e-5 in ``Norm('gn')``, flax's default
    1e-6 in FarSeg++'s scene encoders.  Under a spatial step x is a strip,
    normalised by the whole tile's statistics (``Strips.group_norm``); a
    map whole on every rank runs under ``parallel.spatial.whole``."""

    def forward(self, x):
        ct = torch.float64 if x.dtype == torch.float64 else torch.float32
        strips = _spatial.current()
        if strips is not None:
            return strips.group_norm(x.to(ct), self.num_groups, self.weight.to(ct),
                                     self.bias.to(ct), self.eps).to(x.dtype)
        return F.group_norm(x.to(ct), self.num_groups, self.weight.to(ct),
                            self.bias.to(ct), self.eps).to(x.dtype)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of each pixel of an NCHW tensor (flax's
    ``nn.LayerNorm`` over the last axis of NHWC), in float32 (float64 for
    float64 input), the output in x's dtype; flax's default eps 1e-6."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        ct = torch.float64 if x.dtype == torch.float64 else torch.float32
        y = F.layer_norm(x.to(ct).permute(0, 2, 3, 1), self.weight.shape,
                         self.weight.to(ct), self.bias.to(ct), self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


def Norm(kind: Optional[str], channels: int, frozen: bool = False,
         eps: float = 1e-5, groups: int = 32) -> Optional[nn.Module]:
    """The JAX package's pluggable norm: ``'bn'`` (eps ``eps``), ``'gn'``
    (``min(groups, channels)`` groups, lowered until they divide the
    channels, eps 1e-5), ``'ln'`` (over the channels, eps 1e-6) or None,
    with the JAX package's eps for each."""
    if kind is None:
        return None
    if kind == 'bn':
        return BatchNorm2d(channels, eps=eps, frozen=frozen)
    if kind == 'gn':
        g = min(groups, channels)
        while channels % g:
            g -= 1
        return GroupNorm2d(g, channels, eps=1e-5)
    if kind == 'ln':
        return LayerNorm2d(channels, eps=1e-6)
    raise ValueError(f'unknown norm kind: {kind!r}')


def _keep_mask(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """A 0/1 keep mask of ``shape`` (batch first), each entry kept with
    probability ``1 - rate``, drawn from ``generator`` on its device.
    Inside a data-parallel step over R ranks the draw is the global batch's
    (R·B rows) and rank r keeps rows ``[r·B, (r+1)·B)``, so R ranks draw
    what one process draws for the global batch."""
    rank, ranks = data_shard()
    b = shape[0]
    u = torch.rand((b * ranks,) + tuple(shape[1:]), generator=generator,
                   device=generator.device)
    return (u < 1.0 - rate)[rank * b:(rank + 1) * b]


def _dropout(x, rate, train, generator, mask_shape, rows_dim=None):
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in training draws from a generator: pass generator=')
    # under a spatial step the draw is the whole tile's (rows_dim: the
    # mask's row dimension, None where it is broadcast over the rows) and
    # each strip keeps its rows
    strips = _spatial.current()
    keep = (_keep_mask(mask_shape, rate, generator) if strips is None
            else strips.keep_mask(mask_shape, rate, generator, rows_dim)).to(x.device)
    return x * keep.to(x.dtype) / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element dropout (flax ``nn.Dropout``): in training each element is
    kept with probability ``1 - rate`` and scaled by ``1/(1 - rate)``; the
    identity otherwise.  Under a spatial step x is an NCHW strip."""
    return _dropout(x, rate, train, generator, x.shape, 2)


def channel_dropout(x: torch.Tensor, rate: float, train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Channel dropout of an NCHW tensor (flax ``nn.Dropout(broadcast_dims=
    (1, 2))`` on NHWC, torch's ``Dropout2d``): one draw per sample and
    channel, broadcast over the pixels."""
    return _dropout(x, rate, train, generator, x.shape[:2] + (1, 1))


def sample_dropout(x: torch.Tensor, rate: float, train: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample dropout (stochastic depth: EfficientNet's drop-connect,
    ConvNeXt's drop-path; flax ``nn.Dropout(broadcast_dims=(1, 2, 3))``):
    one draw per sample, broadcast over the rest."""
    return _dropout(x, rate, train, generator, x.shape[:1] + (1,) * (x.dim() - 1))


class Sequential(nn.Sequential):
    """``nn.Sequential`` whose forward passes ``train`` on to the children
    that take it (BatchNorm and nested Sequentials)."""

    def forward(self, x, train: bool = False):
        for m in self:
            x = m(x, train) if isinstance(m, (BatchNorm2d, Sequential)) else m(x)
        return x


class ConvBlock(Sequential):
    """conv → [norm] → [activation] with ``'SAME'`` padding, bias off by
    default (``ever_tpu/module/ops.py`` ``ConvBlock``).  ``act``: True
    (ReLU), ``'gelu'`` (flax's ``nn.gelu``, the tanh approximation) or
    False.  Children ``0`` (conv), ``1`` (norm) and then the activation, as
    the reference's ``nn.Sequential`` numbers them."""

    def __init__(self, in_channels: int, features: int, kernel_size=3,
                 stride=1, dilation=1, groups: int = 1, use_bias: bool = False,
                 norm: Optional[str] = 'bn', act: Union[bool, str] = True,
                 bn_frozen: bool = False):
        layers = [Conv2d(in_channels, features, kernel_size, stride, 'same',
                         dilation, groups, use_bias)]
        bn = Norm(norm, features, frozen=bn_frozen)
        if bn is not None:
            layers.append(bn)
        if act == 'gelu':
            layers.append(nn.GELU(approximate='tanh'))
        elif act:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class DepthwiseConv2d(Conv2d):
    """Depthwise conv (one group a channel) with ``'SAME'`` padding, bias
    on by default (``ever_tpu/module/ops.py`` ``DepthwiseConv2d``)."""

    def __init__(self, channels: int, kernel_size=3, stride=1, dilation=1,
                 use_bias: bool = True):
        super().__init__(channels, channels, kernel_size, stride, 'same', dilation,
                         channels, use_bias)


class SeparableConv2d(Sequential):
    """Depthwise conv without bias (child ``0``) → 1×1 pointwise conv
    (child ``1``, bias on by default)."""

    def __init__(self, in_channels: int, features: int, kernel_size=3, stride=1,
                 dilation=1, use_bias: bool = True):
        super().__init__(DepthwiseConv2d(in_channels, kernel_size, stride, dilation, False),
                         Conv2d(in_channels, features, 1, bias=use_bias))


class SeparableConvBlock(Sequential):
    """Separable conv without bias → [norm] → [ReLU] (children ``0``, ``1``,
    then the activation)."""

    def __init__(self, in_channels: int, features: int, kernel_size=3, stride=1,
                 dilation=1, norm: Optional[str] = 'bn', act: bool = True):
        layers = [SeparableConv2d(in_channels, features, kernel_size, stride, dilation,
                                  use_bias=False)]
        bn = Norm(norm, features)
        if bn is not None:
            layers.append(bn)
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class PoolBlock(nn.Module):
    """A PSP pyramid bin: :func:`adaptive_avg_pool` to ``output_size`` →
    1×1 conv-norm-ReLU (``conv``) → back to the input's size, by a
    broadcast from 1×1 and otherwise by :func:`bilinear_nchw` (half-pixel
    centres), as the JAX package's ``PoolBlock``.  Under a spatial step the
    pooled map is whole on every rank: the conv runs under
    ``parallel.spatial.whole`` and the resize takes the strip's rows of the
    whole tile's."""

    def __init__(self, in_channels: int, output_size=1, features: int = 256,
                 norm: Optional[str] = 'bn'):
        super().__init__()
        self.output_size = output_size
        self.conv = ConvBlock(in_channels, features, 1, norm=norm)

    def forward(self, x, train: bool = False):
        n, _, h, w = x.shape
        y = adaptive_avg_pool(x.permute(0, 2, 3, 1), self.output_size).permute(0, 3, 1, 2)
        with _spatial.whole():
            y = self.conv(y, train)
        if y.shape[2:] == (1, 1):
            return y.expand(n, y.shape[1], h, w)
        return bilinear_nchw(y, (h, w), whole=True)


class ResidualBlock(Sequential):
    """Two 3×3 conv-norm blocks, ReLU after the first only (children ``0``
    and ``1``), plus the input: no activation after the add, as in the
    reference."""

    def __init__(self, features: int, norm: Optional[str] = 'bn'):
        super().__init__(ConvBlock(features, features, 3, norm=norm),
                         ConvBlock(features, features, 3, norm=norm, act=False))

    def forward(self, x, train: bool = False):
        return super().forward(x, train) + x


class ConvUpsampling(nn.Module):
    """conv with bias (``conv``) → upsampling by ``scale``: bilinear by
    :func:`bilinear_nchw` (with the reference's ``align_corners`` by
    default), or :func:`resize`'s nearest."""

    def __init__(self, in_channels: int, features: int, scale: int = 2,
                 kernel_size=3, method: str = 'bilinear', align_corners: bool = True):
        super().__init__()
        self.scale, self.method, self.align_corners = scale, method, align_corners
        self.conv = Conv2d(in_channels, features, kernel_size, bias=True)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        shape = _scaled_shape(x.shape[2], x.shape[3], self.scale, 'ConvUpsampling')
        if self.method == 'bilinear':
            return bilinear_nchw(x, shape, self.align_corners)
        return resize(x.permute(0, 2, 3, 1), shape=shape,
                      method=self.method).permute(0, 3, 1, 2)


# -- the reference's module spellings of the list functions -----------------

class ChannelReduction(nn.Module):
    """A 1×1 conv-norm projection of each feature of a list to
    ``out_channels`` (``reduce{i}``)."""

    def __init__(self, in_channels_list, out_channels: int, norm: Optional[str] = 'bn'):
        super().__init__()
        self.n = len(in_channels_list)
        for i, c in enumerate(in_channels_list):
            self.add_module(f'reduce{i}', ConvBlock(c, out_channels, 1, norm=norm, act=False))

    def forward(self, features, train: bool = False):
        return [getattr(self, f'reduce{i}')(f, train) for i, f in enumerate(features)]


class ChannelConcat(nn.Module):
    """Concatenate a list of NCHW features on the channels."""

    def forward(self, features):
        assert isinstance(features, (list, tuple))
        return features[0] if len(features) == 1 else torch.cat(list(features), dim=1)


class Sum(nn.Module):
    """:func:`channel_sum` of a list."""

    def forward(self, features):
        assert isinstance(features, (list, tuple))
        return channel_sum(list(features))


class ListIndex(nn.Module):
    """:func:`list_index` of a list at ``index`` (a tuple)."""

    def __init__(self, index: Tuple[int, ...] = (0,)):
        super().__init__()
        self.index = tuple(index)

    def forward(self, features):
        return list_index(features, *self.index)


class Squeeze(nn.Module):
    """Squeeze one axis."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return torch.squeeze(x, self.dim)


def _cast_floats(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree


class Bf16compatible(nn.Module):
    """Run ``inner`` in float32 on bfloat16 input and cast its output (a
    tensor, or a list, tuple or dict of them) back to bfloat16; other
    inputs pass as they are."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x, *args, **kwargs):
        if x.dtype != torch.bfloat16:
            return self.inner(x, *args, **kwargs)
        return _cast_floats(self.inner(x.float(), *args, **kwargs), torch.bfloat16)
