"""PNG read and write without PIL, on ``zlib`` and numpy.

The port's counterpart of what the JAX package's readers get from
``np.asarray(PIL.Image.open(path))`` (``ever_tpu/data/loveda.py``,
``geotile.py``): the card machine has no PIL.

- :func:`read_png` decodes bit depth 8, non-interlaced files of colour
  types 0 (grey, ``[H, W]``), 2 (RGB), 3 (palette: the *index* array
  ``[H, W]``, as PIL's ``P`` mode gives), 4 (grey and alpha, ``[H, W, 2]``)
  and 6 (RGBA), with all five row filters.  The row unfilter runs in the
  port's host library (``csrc/tilekit.cpp``): Average and Paeth depend on
  the byte decoded just to their left.  Any other file (another bit depth,
  interlaced, a bad CRC, truncated) raises a ``ValueError`` that names it.
- :func:`write_png` encodes ``[H, W]`` or ``[H, W, C]`` uint8 arrays
  (C = 1..4) with one filter type for every row (0 by default) and zlib
  at its default level.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ['read_png', 'write_png', 'png_size']

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type → samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes, path: str):
    """(type, payload) of every chunk after the signature, CRC-checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f'{path}: truncated chunk at byte {pos}')
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f'{path}: truncated {kind!r} chunk')
        payload = data[pos + 8:end]
        (crc,) = struct.unpack('>I', data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f'{path}: bad CRC in the {kind.decode("latin-1")} chunk')
        yield kind, payload
        if kind == b'IEND':
            return
        pos = end + 4
    raise ValueError(f'{path}: no IEND chunk')


def _header(payload: bytes, path: str) -> Tuple[int, int, int]:
    """(height, width, channels) from IHDR, or a ValueError for what the
    decoder does not read."""
    if len(payload) != 13:
        raise ValueError(f'{path}: IHDR of {len(payload)} bytes')
    width, height, depth, color, comp, filt, interlace = struct.unpack('>IIBBBBB', payload)
    if depth != 8:
        raise ValueError(f'{path}: bit depth {depth} (only 8 is supported)')
    if color not in _CHANNELS:
        raise ValueError(f'{path}: unknown colour type {color}')
    if comp != 0 or filt != 0:
        raise ValueError(f'{path}: unknown compression {comp} or filter method {filt}')
    if interlace != 0:
        raise ValueError(f'{path}: interlaced PNG (Adam7) is not supported')
    return height, width, _CHANNELS[color]


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) from the header alone."""
    with open(path, 'rb') as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: not a PNG file')
    width, height = struct.unpack('>II', head[16:24])
    return height, width


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to uint8 ``[H, W]`` (grey, palette indices) or
    ``[H, W, C]``."""
    from ever_tpu_torch.data._tilekit import png_unfilter

    with open(path, 'rb') as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b'IHDR':
            header = _header(payload, path)
        elif kind == b'IDAT':
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f'{path}: no IHDR or IDAT chunk')
    height, width, channels = header
    try:
        filtered = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise ValueError(f'{path}: corrupt image data ({e})') from None
    try:
        raw = png_unfilter(filtered, height, width * channels, channels)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from None
    return raw.reshape(height, width, channels) if channels > 1 else raw.reshape(height, width)


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Apply one PNG filter to every row of ``raw`` ``[H, stride]``; the
    neighbours are the unfiltered bytes, so this is whole-array numpy."""
    if filter_type == 0:
        return raw
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    if filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = ((a.astype(np.int16) + b) >> 1).astype(np.uint8)
    elif filter_type == 4:
        c = np.zeros_like(raw)
        c[1:, bpp:] = raw[:-1, :-bpp]
        a16, b16, c16 = a.astype(np.int16), b.astype(np.int16), c.astype(np.int16)
        p = a16 + b16 - c16
        pa, pb, pc = np.abs(p - a16), np.abs(p - b16), np.abs(p - c16)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f'unknown PNG filter type {filter_type}')
    return raw - pred          # uint8: modulo 256, as the format wants


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload)))


def write_png(path: str, image: np.ndarray, filter_type: int = 0) -> None:
    """Encode a uint8 ``[H, W]`` or ``[H, W, C]`` (C = 1..4: grey, grey and
    alpha, RGB, RGBA) array, every row with ``filter_type`` (0..4)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f'write_png: uint8 needed, got {image.dtype}')
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPE:
        raise ValueError(f'write_png: [H, W] or [H, W, 1..4] needed, got {image.shape}')
    height, width, channels = image.shape
    raw = np.ascontiguousarray(image).reshape(height, width * channels)
    rows = np.empty((height, width * channels + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = _filter_rows(raw, channels, filter_type)
    header = struct.pack('>IIBBBBB', width, height, 8, _COLOR_TYPE[channels], 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(_SIGNATURE + _chunk(b'IHDR', header)
                + _chunk(b'IDAT', zlib.compress(rows.tobytes()))
                + _chunk(b'IEND', b''))
