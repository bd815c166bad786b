"""Exploratory data-analysis helpers for remote-sensing imagery, without
PIL (counterpart of ``ever_tpu/util/eda.py``).

The JAX package opens images with PIL and returns PIL images; the card
machine has no PIL, so the port reads PNGs with ``data/_png.py`` and
returns numpy arrays:

- :func:`thumbnail` gives the uint8 array of PIL's ``Image.thumbnail`` for
  a grey or RGB PNG: PIL's size (the aspect kept by its rounding) and its
  pixels (an integer box ``reduce`` by the factor ``reducing_gap=2.0``
  gives, then the separable antialiased bicubic, a = −0.5, horizontal pass
  first, in PIL's 22-bit fixed point, each pass rounded to uint8);
- :func:`render_multi_binary_mask` gives ``(indices, palette)`` where the
  JAX package gives a ``P`` image.

Any other source (JPEG, TIFF, a PNG with a palette or alpha for a
thumbnail) raises ``ValueError`` naming it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ever_tpu_torch.data._png import read_png

__all__ = ['thumbnail', 'render_multi_binary_mask']

_PNG = b'\x89PNG\r\n\x1a\n'
_PRECISION_BITS = 22                 # PIL's fixed point for 8-bit resampling


def _format(path: str) -> Tuple[str, Optional[int]]:
    """The file's format from its first bytes, and a PNG's colour type."""
    with open(path, 'rb') as f:
        head = f.read(26)
    if head[:8] == _PNG:
        return 'PNG', head[25]
    if head[:3] == b'\xff\xd8\xff':
        return 'JPEG', None
    if head[:4] in (b'II*\x00', b'MM\x00*'):
        return 'TIFF', None
    return 'an unknown format', None


def _imread(path: str) -> np.ndarray:
    fmt, _ = _format(path)
    if fmt != 'PNG':
        raise ValueError(f'{path}: {fmt}; the port reads PNG images only (no PIL on the '
                         f'card machine)')
    return read_png(path)


def _thumbnail_size(w: int, h: int, size) -> Optional[Tuple[int, int]]:
    """PIL's ``thumbnail`` size for ``size`` (width, height): the aspect
    kept by its rounding, or None when the image already fits."""
    x, y = (math.floor(s) for s in size)
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def _reduce(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """PIL's ``Image.reduce((fx, fy))``: the mean of each fx × fy block
    (the last row and column of blocks partial), rounded as PIL's
    ``((sum + n/2) · ⌊2³²/(256·n)⌋) >> 24``."""
    h, w = img.shape[:2]
    oh, ow = -(-h // fy), -(-w // fx)
    pad = [(0, oh * fy - h), (0, ow * fx - w)] + [(0, 0)] * (img.ndim - 2)
    blocks = np.pad(img.astype(np.int64), pad).reshape(oh, fy, ow, fx, *img.shape[2:])
    total = blocks.sum(axis=(1, 3))
    rows = np.minimum(fy, h - np.arange(oh) * fy)
    cols = np.minimum(fx, w - np.arange(ow) * fx)
    n = (rows[:, None] * cols[None, :]).reshape(oh, ow, *([1] * (img.ndim - 2)))
    mult = (np.float32(4294967296.0) / (256 * n).astype(np.float32)).astype(np.int64)
    return (((total + n // 2) * mult) >> 24).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, extent: float, out_size: int) -> np.ndarray:
    """``[out_size, in_size]`` fixed-point weights of PIL's antialiased
    bicubic along one axis over source ``[0, extent)``."""
    scale = float(np.float32(extent)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    kk = np.zeros((out_size, in_size), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) * (1.0 / filterscale))
        total = w.sum()
        if total != 0.0:
            w = w / total
        w = w * (1 << _PRECISION_BITS)
        kk[i, lo:hi] = np.trunc(np.where(w < 0, w - 0.5, w + 0.5)).astype(np.int64)
    return kk


def _pass(img: np.ndarray, kk: np.ndarray, axis: int) -> np.ndarray:
    """One resampling pass along ``axis``, rounded and clipped to uint8."""
    moved = np.moveaxis(img.astype(np.int64), axis, -1)
    ss = (1 << (_PRECISION_BITS - 1)) + moved @ kk.T
    out = np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def _resize(img: np.ndarray, size: Tuple[int, int], reducing_gap: float = 2.0) -> np.ndarray:
    """PIL's ``resize(size, BICUBIC, reducing_gap=2.0)`` of a uint8 grey or
    RGB array to ``size`` (width, height)."""
    h, w = img.shape[:2]
    box = (float(w), float(h))
    fx = int(w / size[0] / reducing_gap) or 1
    fy = int(h / size[1] / reducing_gap) or 1
    if fx > 1 or fy > 1:
        img = _reduce(img, fx, fy)
        box = (w / fx, h / fy)
    ih, iw = img.shape[:2]
    if size[0] != iw or box[0] != size[0]:
        img = _pass(img, _coeffs(iw, box[0], size[0]), 1)
    if size[1] != ih or box[1] != size[1]:
        img = _pass(img, _coeffs(ih, box[1], size[1]), 0)
    return img


def thumbnail(image_path: str, sample_ratio: float = 0.1) -> np.ndarray:
    """Downscale a grey or RGB PNG on disk to ``sample_ratio`` of its size,
    as PIL's ``thumbnail`` does (module docstring): a uint8 ``[h, w]`` or
    ``[h, w, 3]`` array."""
    _, colour = _format(image_path)
    img = _imread(image_path)
    if colour not in (0, 2):
        kind = {3: 'a palette', 4: 'grey and alpha', 6: 'RGBA'}.get(colour, f'type {colour}')
        raise ValueError(f'{image_path}: a PNG of colour {kind}; thumbnail takes grey or RGB '
                         'PNGs')
    h, w = img.shape[:2]
    size = _thumbnail_size(w, h, (int(w * sample_ratio), int(h * sample_ratio)))
    if size is None or size == (w, h):
        return img
    return _resize(img, size)


def render_multi_binary_mask(file_paths, indexes, palette):
    """Merge per-class binary mask files into one index image.

    Each file is a one-channel 0/255 binary mask (another raises, as PIL
    does when the JAX package palettises such a canvas); its pixel values
    are divided by 255 and truncated, so a mask contributes its class
    ``index`` where it fires and 0 elsewhere.  Earlier files win overlaps (a pixel already labelled
    is never overwritten).  Returns ``(indices, palette)``: the uint8 index
    array and the palette as uint8 ``[n, 3]`` rows, where the JAX package
    returns a ``P`` image of them."""
    canvas = None
    for fp, index in zip(file_paths, indexes):
        binary = _imread(fp)
        if binary.ndim != 2:
            # the JAX package's P image of such a canvas raises in PIL
            raise ValueError(f'{fp}: a mask of shape {binary.shape}; an index image takes '
                             'one-channel masks')
        hit = (binary / 255).astype(np.uint8, copy=False) * index
        if canvas is None:
            canvas = np.zeros(binary.shape, np.uint8)
        unlabeled = canvas == 0
        canvas[unlabeled] = hit[unlabeled]
    return canvas, np.asarray(palette, np.uint8).reshape(-1, 3)
