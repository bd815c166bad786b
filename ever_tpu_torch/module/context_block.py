"""The GCNet global-context block (counterpart of
``ever_tpu/module/context_block.py``).

``ContextBlock2d`` pools the pixels (a softmax attention map, ``'att'``,
or their mean, ``'avg'``), transforms the pooled context (1×1 reduce →
LayerNorm → ReLU → 1×1 expand, the expand zero-initialised so that the
block starts as the identity) and fuses it into x (``channel_mul``: a
sigmoid gate, ``channel_add``: an addition).  Tensors are NCHW.  Names
follow GCNet's torch modules and map one to one onto the JAX package's:
``conv_mask`` is flax's ``Conv_0``, ``channel_add_conv.{0,1,3}`` its
``channel_add_{reduce,ln,expand}`` (and ``channel_mul_*`` alike).

The transform's LayerNorm is flax's default, over the inner channels with
eps 1e-6 (torch's default would be 1e-5); the attention pool accumulates in
float32 and casts to x's dtype, as the JAX package's ``einsum`` with
``preferred_element_type=float32`` does.

Under a spatial step (``parallel/spatial.py``) x is a strip: the attention
pool's softmax runs over every position of the tile
(``Strips.softmax_pool``), the mean pool sums over the strips, and the
transforms run on the pooled context, whole on every rank
(``parallel.spatial.whole``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ever_tpu_torch.core import registry
from ever_tpu_torch.module.ops import Conv2d, LayerNorm2d, _nchw_mean
from ever_tpu_torch.module.se_block import with_ratio
from ever_tpu_torch.parallel.spatial import current, whole

__all__ = ['ContextBlock2d', 'plugin_to_basicblock', 'plugin_to_resnet', 'constant_init',
           'kaiming_init', 'last_zero_init', 'conv3x3', 'conv1x1', 'BasicBlock', 'Bottleneck']

_FUSIONS = ('channel_add', 'channel_mul')


@registry.OP.register()
class ContextBlock2d(nn.Module):
    def __init__(self, channels: int, inner_ratio: float = 1.0 / 16, pool: str = 'att',
                 fusions: Sequence[str] = ('channel_add',)):
        super().__init__()
        if pool not in ('att', 'avg'):
            raise ValueError(pool)
        if not fusions or not all(f in _FUSIONS for f in fusions):
            raise ValueError(f'bad fusions: {fusions}')
        self.pool, self.fusions = pool, tuple(fusions)
        inner = max(int(channels * inner_ratio), 1)
        if pool == 'att':
            self.conv_mask = Conv2d(channels, 1, 1, bias=True)
        for f in _FUSIONS:
            if f in self.fusions:
                expand = Conv2d(inner, channels, 1, bias=True)
                nn.init.zeros_(expand.weight)
                nn.init.zeros_(expand.bias)
                self.add_module(f'{f}_conv', nn.Sequential(
                    Conv2d(channels, inner, 1, bias=True), LayerNorm2d(inner, eps=1e-6),
                    nn.ReLU(), expand))

    def forward(self, x):
        n, c, h, w = x.shape
        if self.pool == 'att':
            logits = self.conv_mask(x).reshape(n, h * w, 1)
            feats = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
            ct = torch.float64 if x.dtype == torch.float64 else torch.float32
            strips = current()
            if strips is None:
                context = torch.einsum('npc,npo->nco', feats.to(ct),
                                       torch.softmax(logits, dim=1).to(ct))
            else:
                context = strips.softmax_pool(logits, feats, ct)
            context = context.reshape(n, c, 1, 1).to(x.dtype)
        else:
            context = _nchw_mean(x)
        with whole():               # the context is whole on every rank under a spatial step
            mul = (torch.sigmoid(self.channel_mul_conv(context))
                   if 'channel_mul' in self.fusions else None)
            add = self.channel_add_conv(context) if 'channel_add' in self.fusions else None
        out = x
        if mul is not None:
            out = out * mul
        if add is not None:
            out = out + add
        return out


def plugin_to_basicblock(module: nn.Module, ratio: float) -> nn.Module:
    """GC-augmented BasicBlocks: a copy of the block, stage, trunk or
    encoder with ``gc_ratio=ratio``, the existing parameters kept
    (:func:`~ever_tpu_torch.module.se_block.with_ratio`)."""
    return with_ratio(module, 'gc_ratio', ratio)


def plugin_to_resnet(module: nn.Module, ratio: float) -> nn.Module:
    """GC-augmented Bottlenecks: as :func:`plugin_to_basicblock`."""
    return with_ratio(module, 'gc_ratio', ratio)


def constant_init(module: nn.Module, val: float, bias: float = 0) -> None:
    """Set a module's ``weight`` to ``val`` and its ``bias`` to ``bias``, in
    place (the reference's helper; the JAX package returns the matching
    initializers)."""
    nn.init.constant_(module.weight, val)
    if getattr(module, 'bias', None) is not None:
        nn.init.constant_(module.bias, bias)


def kaiming_init(module: nn.Module, a: float = 0, mode: str = 'fan_out',
                 nonlinearity: str = 'relu', bias: float = 0,
                 distribution: str = 'normal') -> None:
    """He initialisation of a module's ``weight`` (normal or uniform), its
    ``bias`` set to ``bias``, in place (the reference's helper)."""
    init = nn.init.kaiming_uniform_ if distribution == 'uniform' else nn.init.kaiming_normal_
    init(module.weight, a=a, mode=mode, nonlinearity=nonlinearity)
    if getattr(module, 'bias', None) is not None:
        nn.init.constant_(module.bias, bias)


def last_zero_init(module: nn.Module) -> None:
    """Zero the weight and bias of a fusion's last layer, in place: the last
    child of an ``nn.Sequential``, else the module (the reference's
    helper)."""
    constant_init(module[-1] if isinstance(module, nn.Sequential) else module, 0)


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
