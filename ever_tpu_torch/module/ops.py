"""Spatial ops on NHWC tensors (counterpart of ``ever_tpu/module/ops.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ['resize']


def resize(x: torch.Tensor, scale: Optional[float] = None,
           shape: Optional[Tuple[int, int]] = None,
           method: str = 'nearest') -> torch.Tensor:
    """Spatial resize of an NHWC tensor, returned in x's dtype.

    Both methods use half-pixel centres (``jax.image.resize``'s convention;
    torch's ``'nearest-exact'`` for nearest).  Bilinear is computed in
    float32 except for bfloat16 input, which stays bfloat16 as in the JAX
    package.  Downsampling bilinear antialiases, as ``jax.image.resize``
    does.
    """
    n, h, w, c = x.shape
    if shape is None:
        shape = (int(h * scale), int(w * scale))
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
