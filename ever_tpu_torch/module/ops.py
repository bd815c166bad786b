"""Building-block ops (counterpart of ``ever_tpu/module/ops.py``).

The functions (``resize``, ``global_avg_pool``, ``max_pool``) take NHWC
tensors, as the JAX package's do.  The modules (``Conv2d``, ``BatchNorm2d``,
``ConvBlock``) take NCHW tensors, which the conv-net models keep in
``torch.channels_last`` memory: a permute between the two is then a view.

Precision: a layer computes in its input's dtype and casts its float32
parameters to it, as flax's ``dtype=`` does; BatchNorm computes its
statistics and normalisation in float32 and returns the input's dtype.
Training follows a ``train`` argument, not ``nn.Module.training``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ['resize', 'upsample_bilinear', 'global_avg_pool', 'max_pool', 'Conv2d',
           'BatchNorm2d', 'Norm', 'ConvBlock', 'Sequential', 'running_stats_frozen']


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


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


@functools.lru_cache(maxsize=16)
def _bilinear_weights(n_in: int, n_out: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of a bilinear resize along one axis, with
    half-pixel centres and the edges clamped (``F.interpolate``'s
    ``align_corners=False``), made on ``device``."""
    src = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
           * (n_in / n_out) - 0.5).clamp(min=0)
    i0 = src.floor().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = (src - i0)[:, None]
    cols = torch.arange(n_in, dtype=torch.float64, device=device)[None]
    w = (cols == i0[:, None]) * (1 - frac) + (cols == i1[:, None]) * frac
    return w.to(dtype)


def upsample_bilinear(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of an NHWC tensor to ``shape`` (half-pixel
    centres): ``resize``'s numbers, computed as one matrix product per axis,
    as ``jax.image.resize`` computes them.  Unlike ``F.interpolate``, whose
    CUDA backward adds into the input gradient with atomics, the backward is
    two matrix products, so a train step's gradients are the same bits every
    run."""
    n, h, w, c = x.shape
    if shape[0] < h or shape[1] < w:
        raise ValueError(f'upsample_bilinear grows each axis; {(h, w)} -> {tuple(shape)} '
                         'shrinks one (resize antialiases that)')
    y = torch.einsum('oh,nhwc->nowc', _bilinear_weights(h, shape[0], x.dtype, x.device), x)
    return torch.einsum('pw,nowc->nopc', _bilinear_weights(w, shape[1], x.dtype, x.device), y)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """NHWC → N11C spatial mean, accumulated in float32, in x's dtype."""
    return torch.mean(x, dim=(1, 2), keepdim=keepdims,
                      dtype=torch.float32).to(x.dtype)


def _lax_same(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(low, high) padding of lax's ``'SAME'``: the output has ceil(size/s)
    positions and the extra pad goes to the high side."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def max_pool(x: torch.Tensor, window=3, stride=2, padding='SAME',
             impl: str = 'reduce_window') -> torch.Tensor:
    """Max pool of an NHWC tensor; ``padding`` is ``'SAME'``, ``'VALID'`` or
    ``((top, bottom), (left, right))``, padded with -inf.

    Routed as the JAX package routes it: ``impl='pallas'`` (and ``'planes'``,
    the JAX package's XLA formulation of the same gradient) takes
    :class:`~ever_tpu_torch.ops.pool.MaxPool32`, whose backward is the
    hand-written kernel K8, for a 3×3/2 window with padding ((1,1),(1,1)),
    even H and W and a float type; everything else is ``F.max_pool2d``
    forward and backward (``'reduce_window'`` and ``'separable'``).  The two
    differ only at exact ties, where K8 gives every tied maximum the
    gradient and ``F.max_pool2d`` one of them.
    """
    w, s = _pair(window), _pair(stride)
    if impl not in ('reduce_window', 'separable', 'planes', 'pallas'):
        raise ValueError(f'unknown max_pool impl {impl!r}')
    if (impl in ('planes', 'pallas') and w == (3, 3) and s == (2, 2)
            and padding == ((1, 1), (1, 1))
            and x.dim() == 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            and x.is_floating_point()):
        from ever_tpu_torch.ops.pool import MaxPool32
        return MaxPool32.apply(x)
    if padding == 'VALID':
        pads = ((0, 0), (0, 0))
    elif padding == 'SAME':
        pads = tuple(_lax_same(x.shape[1 + i], w[i], s[i]) for i in range(2))
    else:
        pads = tuple(tuple(p) for p in padding)
    xc = x.permute(0, 3, 1, 2)
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        y = F.max_pool2d(xc, w, s, (pads[0][0], pads[1][0]))
    else:
        xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]),
                   value=float('-inf'))
        y = F.max_pool2d(xc, w, s)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype.

    ``padding='same'`` pads as flax's ``'SAME'`` where that is symmetric
    (stride 1 and an odd dilated kernel, all the FarSeg path uses); lax's
    asymmetric strided ``'SAME'`` is not ported.  Integer padding is
    symmetric, as the ResNet's ``_conv`` pads.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding: Union[str, int] = 'same', dilation=1,
                 groups: int = 1, bias: bool = False):
        k, s, d = _pair(kernel_size), _pair(stride), _pair(dilation)
        if padding == 'same':
            totals = [(k[i] - 1) * d[i] for i in range(2)]
            if s != (1, 1) or any(t % 2 for t in totals):
                raise NotImplementedError("asymmetric 'SAME' padding is not ported yet")
            padding = (totals[0] // 2, totals[1] // 2)
        super().__init__(in_channels, out_channels, k, s, padding, d, groups, bias)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype),
                        self.stride, self.padding, self.dilation, self.groups)


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
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.update_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(invstd.pow(-2) - self.eps, alpha=1 - m)
        return y


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


def Norm(kind: Optional[str], channels: int, frozen: bool = False,
         eps: float = 1e-5) -> Optional[nn.Module]:
    """The JAX package's pluggable norm: ``'bn'`` or None.  GroupNorm and
    LayerNorm (``'gn'``, ``'ln'``) wait for the modules that use them."""
    if kind is None:
        return None
    if kind == 'bn':
        return BatchNorm2d(channels, eps=eps, frozen=frozen)
    if kind in ('gn', 'ln'):
        raise NotImplementedError(f'norm {kind!r} is not ported yet (ROADMAP.md A.15)')
    raise ValueError(f'unknown norm kind: {kind!r}')


class Sequential(nn.Sequential):
    """``nn.Sequential`` whose forward passes ``train`` on to the children
    that take it (BatchNorm and nested Sequentials)."""

    def forward(self, x, train: bool = False):
        for m in self:
            x = m(x, train) if isinstance(m, (BatchNorm2d, Sequential)) else m(x)
        return x


class ConvBlock(Sequential):
    """conv → [norm] → [ReLU] with ``'SAME'`` padding, bias off by default
    (``ever_tpu/module/ops.py`` ``ConvBlock``).  Children ``0`` (conv),
    ``1`` (norm) and then the activation, as the reference's
    ``nn.Sequential`` numbers them."""

    def __init__(self, in_channels: int, features: int, kernel_size=3,
                 stride=1, dilation=1, groups: int = 1, use_bias: bool = False,
                 norm: Optional[str] = 'bn', act: bool = True,
                 bn_frozen: bool = False):
        layers = [Conv2d(in_channels, features, kernel_size, stride, 'same',
                         dilation, groups, use_bias)]
        bn = Norm(norm, features, frozen=bn_frozen)
        if bn is not None:
            layers.append(bn)
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)
