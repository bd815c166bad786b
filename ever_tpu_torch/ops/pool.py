"""Backward of the 3x3 / stride-2 max pool: the plain PyTorch version or the
hand-written kernel.

Counterpart of ``ever_tpu/ops/pool.py`` (K8, ``_bwd_kernel``, launched by
``max_pool_32_pallas``).  For ``out = max_pool(x, 3, 2, ((1,1),(1,1)))`` on
NHWC tensors with H and W even, and the upstream gradient ``g``::

    dx[y, x] = sum over the <= 4 windows (oy, ox) covering (y, x) of
               g[oy, ox] * [x[y, x] == out[oy, ox]]

Every tied maximum receives its window's gradient (``F.max_pool2d``'s
backward picks one winner per window); the ResNet stem pools BatchNorm
output before its ReLU, where exact ties have measure zero in float32 but
are not rare in bf16.

:class:`MaxPool32` is the autograd Function: ``F.max_pool2d`` forward,
:func:`max_pool_32_bwd` backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

__all__ = ['max_pool_32_bwd', 'max_pool_32_bwd_reference', 'MaxPool32']

# element types the kernel takes, with its code for each
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(x, out, g):
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f'x must be [N, H, W, C] with H and W even, got '
                         f'{tuple(x.shape)}')
    n, h, w, c = x.shape
    want = (n, h // 2, w // 2, c)
    if tuple(out.shape) != want or tuple(g.shape) != want:
        raise ValueError(f'out and g must be {list(want)}, got '
                         f'{tuple(out.shape)} and {tuple(g.shape)}')
    if not (x.dtype == out.dtype == g.dtype) or not x.is_floating_point():
        raise TypeError(f'x, out and g must share one float type, got '
                        f'{x.dtype}, {out.dtype}, {g.dtype}')


def max_pool_32_bwd_reference(x: torch.Tensor, out: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dx ``[N, H, W, C]`` in x's type.

    Window row ``y // 2 + a`` covers row y for ``a = 0``, and for ``a = 1``
    when y is odd (and the row exists); columns likewise.  ``out`` and ``g``
    are padded by one zero row and column and repeated 2× along H and W, so
    that the slice at offset ``(2a, 2b)`` holds window ``(y//2 + a, x//2 +
    b)`` at every input pixel.  Terms are summed in float32 and rounded once.
    """
    _check(x, out, g)
    n, h, w, c = x.shape
    pad = (0, 0, 0, 1, 0, 1)
    up_out = F.pad(out, pad).repeat_interleave(2, 1).repeat_interleave(2, 2)
    up_g = F.pad(g.float(), pad).repeat_interleave(2, 1).repeat_interleave(2, 2)
    odd_y = (torch.arange(h, device=x.device) % 2 == 1).view(1, h, 1, 1)
    odd_x = (torch.arange(w, device=x.device) % 2 == 1).view(1, 1, w, 1)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for a in (0, 1):
        for b in (0, 1):
            hit = x == up_out[:, 2 * a:2 * a + h, 2 * b:2 * b + w]
            if a:
                hit = hit & odd_y
            if b:
                hit = hit & odd_x
            dx += torch.where(hit, up_g[:, 2 * a:2 * a + h, 2 * b:2 * b + w], 0.0)
    return dx.to(x.dtype)


def _launch(x, out, g):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f'the maxpool backward kernel takes bfloat16 or float32, '
                        f'got {x.dtype}')
    if not (x.device == out.device == g.device):
        raise ValueError('x, out and g must be on one device')
    if not all(t.is_contiguous() for t in (x, out, g)):
        raise ValueError('the maxpool backward kernel takes contiguous [N, H, W, C] '
                         'tensors (NCHW tensors in channels_last memory, permuted)')
    n, h, w, c = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 _KERNEL_DTYPES[x.dtype], n, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f'maxpool backward kernel launch failed: CUDA error {err}')
    max_pool_32_bwd.launches += 1
    return dx


def _kernel():
    from ever_tpu_torch.ops._build import function
    return function('maxpool_bwd', 'ever_maxpool32_bwd',
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)


def max_pool_32_bwd(x: torch.Tensor, out: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dx of ``max_pool(x, 3, 2, ((1,1),(1,1)))`` from the forward's output
    and the upstream gradient, through the hand-written kernel.

    x ``[N, H, W, C]`` (H, W even); out, g ``[N, H/2, W/2, C]``.  On a CUDA
    tensor this launches ``csrc/maxpool_bwd.cu`` (bf16 or f32, contiguous
    NHWC) or raises; on a CPU tensor it runs
    :func:`max_pool_32_bwd_reference`.  ``max_pool_32_bwd.launches`` counts
    kernel launches.
    """
    _check(x, out, g)
    if x.device.type == 'cuda':
        return _launch(x, out, g)
    if x.device.type == 'cpu':
        return max_pool_32_bwd_reference(x, out, g)
    raise RuntimeError(f'no maxpool backward kernel for device {x.device}')


max_pool_32_bwd.launches = 0


class MaxPool32(torch.autograd.Function):
    """``out = max_pool(x, 3, 2, ((1,1),(1,1)))`` on NHWC ``x``:
    ``F.max_pool2d`` forward, :func:`max_pool_32_bwd` backward (the kernel on
    CUDA tensors, its plain version on CPU tensors).  The counterpart of the
    JAX package's ``_max_pool_32_p`` custom VJP."""

    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return max_pool_32_bwd(x.contiguous(), out.contiguous(), g.contiguous())
