"""Sliding-window tiling for big scenes (the port's own copy of
``ever_tpu/magic/sliding_window.py``).

Boxes are ``[xmin, ymin, xmax, ymax]``; edge tiles are shifted inward, not
padded, so every box is full-size and in-bounds.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np

__all__ = ['sliding_window']


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def sliding_window(input_size: Tuple[int, int],
                   kernel_size: Union[int, Tuple[int, int]],
                   stride: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Generate [N, 4] int tile boxes covering ``input_size``."""
    ih, iw = input_size
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    if min(ih, iw, kh, kw, sh, sw) <= 0:
        raise ValueError('all sizes must be positive')

    kh = min(kh, ih)
    kw = min(kw, iw)

    def _num(i, k, s):
        n = math.ceil((i - k) / s)
        return n if n * s + k >= i else n + 1

    num_rows = _num(ih, kh, sh)
    num_cols = _num(iw, kw, sw)

    x, y = np.meshgrid(np.arange(num_cols + 1), np.arange(num_rows + 1))
    xmin = (x * sw).ravel()
    ymin = (y * sh).ravel()
    # shift out-of-bounds tiles inward so each box is exactly (kh, kw)
    xmin = xmin + np.where(xmin + kw > iw, iw - xmin - kw, 0)
    ymin = ymin + np.where(ymin + kh > ih, ih - ymin - kh, 0)
    return np.stack([xmin, ymin,
                     np.minimum(xmin + kw, iw),
                     np.minimum(ymin + kh, ih)], axis=1)
