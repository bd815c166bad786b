"""Squeeze-and-Excitation blocks (counterpart of ``ever_tpu/module/se_block.py``).

``SEBlock`` (channel attention), ``SCSEModule`` (concurrent spatial and
channel SE in its modes ``'concat'``, ``'maxout'`` and ``'add'``) and the
plugin functions that give a ResNet's blocks an SE branch.  Tensors are
NCHW; each conv is 1×1 with a bias and computes in its input's dtype.
Parameter names map one to one onto the JAX package's: ``fc1``/``fc2`` are
flax's ``Conv_0``/``Conv_1``, SCSE's ``spatial`` its ``Conv_2``.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from ever_tpu_torch.core import registry
from ever_tpu_torch.module.ops import Conv2d, _nchw_mean
from ever_tpu_torch.parallel.spatial import whole

__all__ = ['SEBlock', 'SCSEModule', 'plugin_to_basicblock', 'plugin_to_bottleneck', 'conv3x3',
           'conv1x1', 'BasicBlock', 'Bottleneck']


def _squeeze(x: torch.Tensor) -> torch.Tensor:
    """The spatial mean of an NCHW tensor, accumulated in float32, as
    ``[N, C, 1, 1]`` in x's dtype; under a spatial step the whole tile's,
    whole on every rank (``module/ops.py`` ``_nchw_mean``)."""
    return _nchw_mean(x)


def _excite(fc1: nn.Module, fc2: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The channel gate ``sigmoid(fc2(relu(fc1(squeeze(x)))))``, its convs
    on the squeezed map, which is whole on every rank under a spatial step
    (``parallel.spatial.whole``)."""
    s = _squeeze(x)
    with whole():
        return torch.sigmoid(fc2(torch.relu(fc1(s))))


@registry.OP.register()
class SEBlock(nn.Module):
    """Channel SE: global pool → 1×1 reduce to ``max(C // inv_ratio, 1)`` →
    ReLU → 1×1 expand → sigmoid gate on x."""

    def __init__(self, channels: int, inv_ratio: int = 16):
        super().__init__()
        mid = max(channels // inv_ratio, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=True)
        self.fc2 = Conv2d(mid, channels, 1, bias=True)

    def forward(self, x):
        return x * _excite(self.fc1, self.fc2, x)


@registry.OP.register()
class SCSEModule(nn.Module):
    """Concurrent spatial and channel SE: the channel gate of
    :class:`SEBlock` and a spatial gate (a bias-free 1×1 conv to one map,
    sigmoid), joined by ``mode``: ``'concat'`` (2C channels out, the
    reference's default), ``'maxout'`` (the larger) or ``'add'``."""

    def __init__(self, channels: int, inv_ratio: int = 16, mode: str = 'concat'):
        super().__init__()
        if mode not in ('concat', 'maxout', 'add'):
            raise ValueError(f"mode must be 'concat', 'maxout' or 'add', got {mode!r}")
        self.mode = mode
        mid = max(channels // inv_ratio, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=True)
        self.fc2 = Conv2d(mid, channels, 1, bias=True)
        self.spatial = Conv2d(channels, 1, 1, bias=False)

    def forward(self, x):
        cse = x * _excite(self.fc1, self.fc2, x)
        sse = x * torch.sigmoid(self.spatial(x))
        if self.mode == 'concat':
            return torch.cat([cse, sse], dim=1)
        if self.mode == 'maxout':
            return torch.maximum(cse, sse)
        return cse + sse


def with_ratio(module: nn.Module, key: str, ratio) -> nn.Module:
    """A copy of ``module`` (a ResNet block, stage, trunk or
    ``ResNetEncoder``) whose every BasicBlock and Bottleneck has the branch
    ``key`` names (``'se_ratio'`` or ``'gc_ratio'``) at ``ratio``.  The copy
    keeps the existing parameters and buffers; the new branches are freshly
    initialised, as the JAX package's config transform means with its
    parameters held outside the module."""
    from ever_tpu_torch.module.resnet import BasicBlock, Bottleneck

    out = copy.deepcopy(module)
    if hasattr(out, 'config') and key in out.config:
        out.config[key] = ratio
    for m in out.modules():
        if isinstance(m, (BasicBlock, Bottleneck)):
            m.set_branch(key, ratio)
    return out


def plugin_to_basicblock(module: nn.Module, ratio: int) -> nn.Module:
    """SE-augmented BasicBlocks: :func:`with_ratio` with ``se_ratio``."""
    return with_ratio(module, 'se_ratio', ratio)


def plugin_to_bottleneck(module: nn.Module, ratio: int) -> nn.Module:
    """SE-augmented Bottlenecks: :func:`with_ratio` with ``se_ratio``."""
    return with_ratio(module, 'se_ratio', ratio)


def __getattr__(name):
    """The reference's ``conv3x3``/``conv1x1`` (``module._resnets``'s, which
    take the input width) and ``BasicBlock``/``Bottleneck``
    (``module.resnet``'s), resolved when asked for: ``resnet`` imports this
    module."""
    if name in ('conv3x3', 'conv1x1'):
        from ever_tpu_torch.module import _resnets
        return getattr(_resnets, name)
    if name in ('BasicBlock', 'Bottleneck'):
        from ever_tpu_torch.module import resnet
        return getattr(resnet, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
