"""Fused LayerNorm: the plain PyTorch versions or the hand-written kernels.

Counterpart of ``ever_tpu/ops/norm.py`` (K4 ``_fwd_kernel`` and K5
``_bwd_kernel``).  Over the last axis of ``x``, with float32 ``weight``
(γ) and ``bias`` (β), the JAX kernels' math exactly:

- forward: mean μ and the **one-pass** variance E[x²] − μ² in float32,
  unclamped, ``rstd = rsqrt(var + eps)``; ``y = x̂·γ + β`` in float32, cast
  to x's dtype; μ and rstd are kept as float32 ``[R]`` for the backward;
- backward: ``x̂ = (x − μ)·rstd``, ``dx̂ = dy·γ``, ``dx = rstd·(dx̂ −
  mean(dx̂) − x̂·mean(dx̂·x̂))`` in x's dtype, ``dγ = Σ dy·x̂`` and
  ``dβ = Σ dy`` over all rows in float32.

:func:`layer_norm_fwd` (``csrc/layernorm.cu``, K4) and
:func:`layer_norm_bwd` (the same source, K5) launch the kernels on CUDA
tensors and run :func:`layer_norm_reference` / :func:`layer_norm_bwd_reference`
on CPU tensors.  :func:`layer_norm` joins them in an autograd Function, and
:class:`FusedLayerNorm` is the module (the counterpart of the JAX
``FusedLayerNorm``).  Unlike the JAX module, which falls back to flax math
when the width is not a multiple of 128, the CUDA kernels take any width.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable

__all__ = ['layer_norm', 'layer_norm_fwd', 'layer_norm_bwd', 'layer_norm_reference',
           'layer_norm_bwd_reference', 'layer_norm_bwd_path', 'FusedLayerNorm']

# element types the kernels take, with their code for each
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# rows per CTA of K5 (kBwdRows in csrc/layernorm.cu): the partial sums'
# row count is ceil(R / this); the kernel refuses a smaller buffer
_BWD_ROWS_PER_CTA = 32
# K5's paths, as ``ever_layernorm_bwd_path`` numbers them, and the widest
# row its one-pass path keeps in registers (kOnePassMaxWidth)
BWD_PATHS = ('one_pass', 'two_sweep', 'elementwise')
_ONE_PASS_MAX_WIDTH = 1280


def _check(x, weight, *rest):
    if x.dim() != 2:
        raise ValueError(f'x must be [R, C], got {tuple(x.shape)}')
    c = x.shape[1]
    for t in (weight,) + rest:
        if tuple(t.shape) != (c,):
            raise ValueError(f'weight and bias must be [{c}], got {tuple(t.shape)}')
    if not x.is_floating_point():
        raise TypeError(f'x must be a float tensor, got {x.dtype}')


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float):
    """Plain PyTorch version of K4 on ``x`` ``[R, C]``: ``(y, mean, rstd)``
    with y in x's dtype and mean, rstd float32 ``[R]``."""
    _check(x, weight, bias)
    x32 = x.float()
    mean = x32.mean(-1)
    var = (x32 * x32).mean(-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[:, None]) * rstd[:, None] * weight.float() + bias.float()
    return y.to(x.dtype), mean, rstd


def layer_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor):
    """Plain PyTorch version of K5: ``(dx, dweight, dbias)``, dx in x's dtype,
    dweight and dbias float32 ``[C]``."""
    _check(x, weight)
    x32, dy32 = x.float(), dy.float()
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    dxhat = dy32 * weight.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dy32 * xhat).sum(0), dy32.sum(0)


def _ready(x, *tensors):
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f'the LayerNorm kernels take bfloat16 or float32, got {x.dtype}')
    if any(t.device != x.device for t in tensors):
        raise ValueError('all LayerNorm operands must be on one device')
    if not all(t.is_contiguous() for t in (x,) + tensors):
        raise ValueError('the LayerNorm kernels take contiguous tensors')


def _kernel(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    from ever_tpu_torch.ops._build import function
    return function('layernorm', name, [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                    + [ctypes.c_float] * n_floats)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(x, weight, bias, eps):
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    _ready(x, weight, bias)
    r, c = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(r, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fn = _kernel('ever_layernorm_fwd', 6, 3, 1)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), _KERNEL_DTYPES[x.dtype], r, c,
                 eps, _stream(x))
    if err != 0:
        raise RuntimeError(f'LayerNorm forward kernel launch failed: CUDA error {err}')
    layer_norm_fwd.launches += 1
    return y, mean, rstd


def layer_norm_bwd_path(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor) -> str:
    """The path K5 takes for ``x``, ``dy`` ``[R, C]`` and float32
    ``weight`` (its fresh dx and partial sums start on 16 bytes):
    ``'one_pass'`` when C is a multiple of 32 16-byte vectors and at most
    1280 (each row read once, held in a warp's registers), ``'two_sweep'``
    for other widths that are a multiple of the vector (the rows read twice),
    ``'elementwise'`` when C is off the vector or a pointer off 16 bytes
    (scalar loads).  The kernel makes the same choice from the same facts
    (``ever_layernorm_bwd_path``)."""
    c = x.shape[-1]
    per_vector = 16 // x.element_size()
    if c % per_vector or any(t.data_ptr() % 16 for t in (x, dy, weight)):
        return BWD_PATHS[2]
    if c % (32 * per_vector) == 0 and c <= _ONE_PASS_MAX_WIDTH:
        return BWD_PATHS[0]
    return BWD_PATHS[1]


def _bwd_partial(r: int, c: int, device) -> torch.Tensor:
    """K5's scratch: one [2C] float32 row of partial sums (dweight | dbias)
    per CTA of 32 rows, on every path."""
    return torch.empty((-(-r // _BWD_ROWS_PER_CTA), 2 * c), dtype=torch.float32,
                       device=device)


def _launch_bwd(x, dy, weight, mean, rstd):
    weight = weight.float().contiguous()
    _ready(x, dy, weight, mean, rstd)
    if dy.dtype != x.dtype:
        raise TypeError(f'dy must have x\'s type {x.dtype}, got {dy.dtype}')
    r, c = x.shape
    dx = torch.empty_like(x)
    partial = _bwd_partial(r, c, x.device)
    dwb = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    fn = _kernel('ever_layernorm_bwd', 8, 4)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), weight.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(), dwb.data_ptr(),
                 _KERNEL_DTYPES[x.dtype], r, c, partial.shape[0], _stream(x))
    if err != 0:
        raise RuntimeError(f'LayerNorm backward kernel launch failed: CUDA error {err}')
    layer_norm_bwd.launches += 1
    return dx, dwb[:c], dwb[c:]


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float):
    """``(y, mean, rstd)`` of the LayerNorm of ``x`` ``[R, C]``.

    On a CUDA tensor this launches K4 (``csrc/layernorm.cu``; bf16 or f32,
    contiguous; γ and β are taken as float32) or raises; on a CPU tensor it
    runs :func:`layer_norm_reference`.  ``layer_norm_fwd.launches`` counts
    kernel launches.
    """
    _check(x, weight, bias)
    if x.device.type == 'cuda':
        return _launch_fwd(x, weight, bias, eps)
    if x.device.type == 'cpu':
        return layer_norm_reference(x, weight, bias, eps)
    raise RuntimeError(f'no LayerNorm kernel for device {x.device}')


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor):
    """``(dx, dweight, dbias)`` from the forward's x, mean and rstd and the
    upstream gradient ``dy``.

    On a CUDA tensor this launches K5 (``csrc/layernorm.cu``: one kernel for
    dx and a row of partial sums of dweight and dbias per 32 rows, on the
    path :func:`layer_norm_bwd_path` names (at ViT widths one pass, each row
    of x and dy read once), and a second that adds the partial rows in a
    fixed order, so the same inputs give the same bits; counted as one
    launch) or raises; on a CPU tensor it runs
    :func:`layer_norm_bwd_reference`.  ``layer_norm_bwd.launches`` counts
    kernel launches.
    """
    _check(x, weight)
    if x.device.type == 'cuda':
        return _launch_bwd(x, dy, weight, mean, rstd)
    if x.device.type == 'cpu':
        return layer_norm_bwd_reference(x, dy, weight, mean, rstd)
    raise RuntimeError(f'no LayerNorm kernel for device {x.device}')


layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """K4 forward, K5 backward (their plain versions on CPU tensors); saves
    x, mean and rstd, as the JAX ``_ln_core_fwd`` does."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x2, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, dy.contiguous(), weight, mean, rstd)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape) with γ and
    β applied in float32; y in x's dtype.  Differentiable: K4 forward and K5
    backward on CUDA tensors, their plain versions on CPU tensors."""
    shape = x.shape
    y = _LayerNorm.apply(x.reshape(-1, shape[-1]).contiguous(), weight, bias, eps)
    return y.reshape(shape)


class FusedLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` through :func:`layer_norm`: the same float32
    ``weight`` and ``bias`` (so ``state_dict``s are the same either way),
    the JAX kernels' one-pass statistics, γ and β applied in float32, y in
    the input's dtype."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)
