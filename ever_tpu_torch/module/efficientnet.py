"""EfficientNet encoders (counterpart of ``ever_tpu/module/efficientnet.py``).

The MBConv trunk (b0–b7 compound scaling) returning the reference's five
taps: the feature map entering each stride-2 stage (output strides 2, 4,
8, 16) and the last block's output (32).  ``output_stride`` 16 or 8 takes
the stride out of the last stride-2 stages: the first block of such a
stage keeps the previous dilation and the later blocks double it
(``nostride_dilate``).  The stem and the strided depthwise convs pad as
lax's ``'SAME'`` (the odd pixel after), through ``Conv2d(padding='same')``.

Drop-connect is on, as in the JAX package (``drop_connect_rate`` 0.2,
block i of n at ``0.2·i/n``): in training a residual block drops its
branch for whole samples, each kept with probability 1 − rate and scaled by
1/(1 − rate), drawn from ``forward``'s ``generator``.

Tensors are NCHW inside (in ``channels_last`` memory); ``EFNetEncoder``
takes NHWC, as the JAX package does.  Parameter and buffer names follow
``efficientnet_pytorch`` (``_conv_stem``, ``_bn0``, ``_blocks.{i}`` flat,
and in a block ``_expand_conv``, ``_bn0``, ``_depthwise_conv``, ``_bn1``,
``_se_reduce``, ``_se_expand``, ``_project_conv``, ``_bn2``), so a
reference file loads by name.  BatchNorm's eps is that package's 1e-3.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import BatchNorm2d, Conv2d, _nchw_mean, sample_dropout
from ever_tpu_torch.parallel.spatial import whole

__all__ = ['EfficientNet', 'EFNetEncoder', 'EFFICIENTNET_SPECS', 'MBConv', 'BN_EPS',
           'stage_repeats', 'nostride_dilate']

# efficientnet_pytorch's (and TF's) batch-norm epsilon
BN_EPS = 1e-3

# the base (B0) stages: (expand, channels, layers, stride, kernel)
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# name → (width_mult, depth_mult)
EFFICIENTNET_SPECS = {
    'efficientnet-b0': (1.0, 1.0),
    'efficientnet-b1': (1.0, 1.1),
    'efficientnet-b2': (1.1, 1.2),
    'efficientnet-b3': (1.2, 1.4),
    'efficientnet-b4': (1.4, 1.8),
    'efficientnet-b5': (1.6, 2.2),
    'efficientnet-b6': (1.8, 2.6),
    'efficientnet-b7': (2.0, 3.1),
}

# the reference's tap widths (os2, os4, os8, os16, os32)
_OUT_CHANNELS = {
    'efficientnet-b0': (16, 24, 40, 112, 320),
    'efficientnet-b1': (16, 24, 40, 112, 320),
    'efficientnet-b2': (16, 24, 48, 120, 352),
    'efficientnet-b3': (24, 32, 48, 136, 384),
    'efficientnet-b4': (24, 32, 56, 160, 448),
    'efficientnet-b5': (24, 40, 64, 176, 512),
    'efficientnet-b6': (32, 40, 72, 200, 576),
    'efficientnet-b7': (32, 48, 80, 224, 640),
}


def _round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    c = c * width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def stage_repeats(model_name: str) -> Sequence[int]:
    """The blocks of each stage after compound depth scaling."""
    _, dm = EFFICIENTNET_SPECS[model_name]
    return [_round_repeats(layers, dm) for (_, _, layers, _, _) in _B0_STAGES]


class MBConv(nn.Module):
    """Mobile inverted bottleneck: [1×1 expand-BN-SiLU] → depthwise
    k×k-BN-SiLU → squeeze-excitation (SiLU, sigmoid gate) → 1×1
    project-BN, plus the input (after drop-connect) where the stride is 1
    and the width is kept."""

    def __init__(self, in_channels: int, features: int, expand_ratio: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, se_ratio: float = 0.25,
                 drop_connect_rate: float = 0.0, bn_frozen: bool = False):
        super().__init__()
        mid = in_channels * expand_ratio
        self.drop_connect_rate = drop_connect_rate
        self.residual = stride == 1 and in_channels == features
        if expand_ratio != 1:
            self._expand_conv = Conv2d(in_channels, mid, 1)
            self._bn0 = BatchNorm2d(mid, eps=BN_EPS, frozen=bn_frozen)
        else:
            self._expand_conv = None
        self._depthwise_conv = Conv2d(mid, mid, kernel, stride, 'same', dilation, groups=mid)
        self._bn1 = BatchNorm2d(mid, eps=BN_EPS, frozen=bn_frozen)
        if se_ratio:
            se_c = max(1, int(in_channels * se_ratio))
            self._se_reduce = Conv2d(mid, se_c, 1, bias=True)
            self._se_expand = Conv2d(se_c, mid, 1, bias=True)
        else:
            self._se_reduce = None
        self._project_conv = Conv2d(mid, features, 1)
        self._bn2 = BatchNorm2d(features, eps=BN_EPS, frozen=bn_frozen)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = x
        if self._expand_conv is not None:
            h = F.silu(self._bn0(self._expand_conv(h), train))
        h = F.silu(self._bn1(self._depthwise_conv(h), train))
        if self._se_reduce is not None:
            s = _nchw_mean(h)
            with whole():           # s is whole on every rank under a spatial step
                gate = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(s))))
            h = h * gate
        h = self._bn2(self._project_conv(h), train)
        if self.residual:
            h = sample_dropout(h, self.drop_connect_rate, train, generator) + x
        return h


class EfficientNet(nn.Module):
    """The trunk: NCHW in, the five taps out (module docstring)."""

    def __init__(self, model_name: str = 'efficientnet-b0', output_stride: int = 32,
                 drop_connect_rate: float = 0.2, bn_frozen: bool = False):
        super().__init__()
        if output_stride not in (8, 16, 32):
            raise ValueError(f'output_stride must be 8, 16 or 32, got {output_stride}')
        wm, dm = EFFICIENTNET_SPECS[model_name]
        self.model_name = model_name
        cin = _round_filters(32, wm)
        self._conv_stem = Conv2d(3, cin, 3, 2, 'same')
        self._bn0 = BatchNorm2d(cin, eps=BN_EPS, frozen=bn_frozen)
        total = sum(stage_repeats(model_name))
        blocks, self.tap_before = [], []
        current_stride, dilation = 2, 1
        for expand, c, layers, stride, kernel in _B0_STAGES:
            features = _round_filters(c, wm)
            first_dil = dilation
            if stride == 2:
                self.tap_before.append(len(blocks))
                if current_stride * 2 > output_stride:
                    dilation *= 2
                    stride = 1
                else:
                    current_stride *= 2
            for li in range(_round_repeats(layers, dm)):
                blocks.append(MBConv(
                    cin, features, expand, kernel, stride if li == 0 else 1,
                    first_dil if li == 0 else dilation,
                    drop_connect_rate=drop_connect_rate * len(blocks) / total,
                    bn_frozen=bn_frozen))
                cin = features
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = F.silu(self._bn0(self._conv_stem(x), train))
        feats = []
        for i, block in enumerate(self._blocks):
            if i in self.tap_before:
                feats.append(x)
            x = block(x, train, generator)
        feats.append(x)
        return feats


for _name in EFFICIENTNET_SPECS:
    registry.MODEL.register(
        _name, (lambda n: lambda **kw: EfficientNet(model_name=n, **kw))(_name))


@registry.MODEL.register()
class EFNetEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/efficientnet.py``
    ``EFNetEncoder``), with the same config keys: ``ef_name`` (the
    reference's spelling) wins over ``efficientnet_type`` when set.
    ``forward(x, train, generator)`` takes NHWC ``[B, H, W, 3]``, computes
    in ``config.dtype`` and returns the five NCHW taps; drop-connect draws
    from ``generator`` in training."""

    def set_default_config(self):
        self.config.update(dict(
            efficientnet_type='efficientnet-b0',
            ef_name='',
            output_stride=32,
            bn_frozen=False,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.net = EfficientNet(model_name=self._model_name,
                                output_stride=self.config.output_stride,
                                bn_frozen=self.config.bn_frozen)

    @property
    def _model_name(self) -> str:
        return self.config.get('ef_name') or self.config.efficientnet_type

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return self.net(x, train, generator)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        """The five taps' widths (the reference's table)."""
        return _OUT_CHANNELS[self._model_name]


def nostride_dilate(encoder: EFNetEncoder, dilate: int) -> EFNetEncoder:
    """The reference's surgery as a new encoder: the same config with
    ``output_stride = max(32 // dilate, 8)`` (freshly initialised, as the
    JAX package's returns a reconfigured copy)."""
    cfg = encoder.config.to_dict()
    cfg['output_stride'] = max(32 // int(dilate), 8)
    return type(encoder)(cfg)
