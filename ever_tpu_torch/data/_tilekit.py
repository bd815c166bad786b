"""The port's host library (``csrc/tilekit.cpp``) through ``ctypes``.

``extract_tiles`` is the tile gather of ``GeoTileDataset.read_batch``
(``extract_tiles_s2d`` its space-to-depth form, for ``layout='s2d'``),
``png_unfilter`` the row unfilter of ``data/_png.py`` and ``normalize_u8``
the uint8 path of ``preprocess.segm.MeanStdNormalize``.  The library is built
with ``g++`` into ``ever_tpu_torch/_build/`` at first use (``ops/_build.py``);
there is no numpy fallback: a failed build raises.  Call :func:`load` in the
parent process before a ``DataLoader`` forks its workers, so that they share
one build instead of each compiling.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ['load', 'extract_tiles', 'extract_tiles_s2d', 'png_unfilter', 'normalize_u8']

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
ABI_VERSION = 2


def load() -> ctypes.CDLL:
    """The host library, built and typed at first use."""
    from ever_tpu_torch.ops import _build

    lib = _build.load('tilekit')
    if lib.ever_extract_tiles_u8.argtypes is None:
        lib.ever_tilekit_abi_version.restype = ctypes.c_int
        if lib.ever_tilekit_abi_version() != ABI_VERSION:
            raise RuntimeError('tilekit ABI mismatch')
        lib.ever_normalize_u8_f32.restype = ctypes.c_int
        lib.ever_normalize_u8_f32.argtypes = [_u8p, _i64, _i64, _f32p, _f32p, _f32p]
        lib.ever_normalize_u8_bf16.restype = ctypes.c_int
        lib.ever_normalize_u8_bf16.argtypes = [_u8p, _i64, _i64, _f32p, _f32p,
                                               ctypes.POINTER(ctypes.c_uint16)]
        lib.ever_png_unfilter.restype = ctypes.c_int
        lib.ever_png_unfilter.argtypes = [_u8p, _i64, _i64, _i64, _u8p]
        for fn in (lib.ever_extract_tiles_u8, lib.ever_extract_tiles_s2d_u8):
            fn.restype = ctypes.c_int
            fn.argtypes = [_u8p, _i64, _i64, _i64, ctypes.POINTER(ctypes.c_int64), _i64,
                           _i64, _i64, _u8p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def extract_tiles(scene: np.ndarray, boxes: np.ndarray, tile_hw=(512, 512)) -> np.ndarray:
    """Gather N ``(th, tw)`` uint8 tiles at ``boxes[:, (y0, x0)]`` of an HWC
    (or HW) uint8 scene: ``[N, th, tw, C]``."""
    return _extract(load().ever_extract_tiles_u8, scene, boxes, tile_hw, s2d=False)


def extract_tiles_s2d(scene: np.ndarray, boxes: np.ndarray, tile_hw=(512, 512)) -> np.ndarray:
    """:func:`extract_tiles` emitting each tile 2×2 space-to-depth folded:
    ``[N, th/2, tw/2, 4C]`` with channel ``(dy·2 + dx)·C + c``; th and tw
    even."""
    return _extract(load().ever_extract_tiles_s2d_u8, scene, boxes, tile_hw, s2d=True)


def _extract(fn, scene, boxes, tile_hw, s2d: bool) -> np.ndarray:
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    if s2d and (th % 2 or tw % 2):
        raise ValueError(f'extract_tiles_s2d: tile sides must be even, got {th}x{tw}')
    scene = np.ascontiguousarray(scene)
    if scene.ndim == 2:
        scene = scene[..., None]
    if scene.dtype != np.uint8:
        raise ValueError(f'extract_tiles: scene must be uint8, got {scene.dtype}')
    boxes = np.ascontiguousarray(boxes, dtype=np.int64)
    if boxes.ndim != 2 or boxes.shape[-1] != 2:
        raise ValueError(f'boxes must be [N, 2] (y0, x0) pairs, got shape {boxes.shape}')
    h, w, c = scene.shape
    n = len(boxes)
    shape = (n, th // 2, tw // 2, 4 * c) if s2d else (n, th, tw, c)
    out = np.empty(shape, np.uint8)
    rc = fn(_ptr(scene, ctypes.c_uint8), h, w, c, _ptr(boxes, ctypes.c_int64), n, th, tw,
            _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f'extract_tiles: a box outside the scene (rc={rc})')
    return out


def png_unfilter(filtered: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's row filters: ``filtered`` holds ``height`` rows of a filter
    byte and ``stride`` bytes; returns the raw ``[height, stride]`` bytes.
    Raises ``ValueError`` on a wrong length or an unknown filter type."""
    src = np.frombuffer(filtered, np.uint8)
    if src.size != height * (stride + 1):
        raise ValueError(f'{src.size} bytes of image data for {height} rows of '
                         f'{stride + 1}')
    out = np.empty((height, stride), np.uint8)
    rc = load().ever_png_unfilter(_ptr(src, ctypes.c_uint8), height, stride, bpp,
                                  _ptr(out, ctypes.c_uint8))
    if rc == -1:
        raise ValueError('png_unfilter: bad arguments')
    if rc != 0:
        row = -rc - 2
        raise ValueError(f'unknown PNG filter type {src[row * (stride + 1)]} on row {row}')
    return out


def normalize_u8(img: np.ndarray, mean, std, dtype=np.float32):
    """``(img − mean) · (1/std)`` of a uint8 ``[..., C]`` image (C ≤ 64) in
    one pass on the host library's threads: a float32 numpy array, or with
    ``dtype=torch.bfloat16`` a ``torch.bfloat16`` tensor rounded to nearest
    even from the float32 result (numpy has no bfloat16).  Bit-equal to the
    JAX package's ``ever_tpu.native.normalize_u8``."""
    import torch

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim < 1:
        raise ValueError(f'normalize_u8 takes a uint8 [..., C] image, got {img.dtype} '
                         f'{img.shape}')
    c = img.shape[-1]
    if not 0 < c <= 64:
        raise ValueError(f'normalize_u8 takes 1 to 64 channels, got {c}')
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    std = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32), (c,)))
    lib = load()
    if dtype is torch.bfloat16:
        out = np.empty(img.shape, np.uint16)
        rc = lib.ever_normalize_u8_bf16(_ptr(img, ctypes.c_uint8), img.size // c, c,
                                        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                                        _ptr(out, ctypes.c_uint16))
        result = torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    elif np.dtype(dtype) == np.float32:
        out = np.empty(img.shape, np.float32)
        rc = lib.ever_normalize_u8_f32(_ptr(img, ctypes.c_uint8), img.size // c, c,
                                       _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                                       _ptr(out, ctypes.c_float))
        result = out
    else:
        raise ValueError(f'normalize_u8 gives float32 or torch.bfloat16, not {dtype}')
    if rc != 0:
        raise ValueError(f'normalize_u8: bad arguments (rc={rc})')
    return result
