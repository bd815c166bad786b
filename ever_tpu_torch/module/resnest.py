"""ResNeSt encoders (counterpart of ``ever_tpu/module/resnest.py``).

The split-attention bottleneck: the 3×3 conv makes ``radix`` groups of
maps (radix group g in channels [g·F, (g+1)·F)), their sum is pooled
(accumulated in float32) and squeezed through ``fc1``-BN-ReLU-``fc2`` into
per-radix attention weights (a softmax over the radix groups; a sigmoid
gate at radix 1), and the groups are summed under those weights.
ResNeSt-D's details: the deep 3×3 stem (32 wide for ``resnest50``, 64
for the others), the avd 3×3 average pool after the split conv carrying a
stage's stride (symmetric padding 1, counted in the mean; at stride 1 in
a dilated first block too), and the average-pool shortcut (``'SAME'``).
Output stride 8 or 16 dilates the last stages as ``ResNet`` does.

Tensors are NCHW inside (in ``channels_last`` memory); ``ResNeStEncoder``
takes NHWC, as the JAX package does.  Parameter and buffer names follow
the ``resnest`` package (``conv1.{0,1,3,4,6}``, ``bn1``,
``layer{i}.{b}.{conv1,bn1,conv2.{conv,bn0,fc1,bn1,fc2},conv3,bn3,
downsample.{1,2}}``), so a reference file loads by name.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import (BatchNorm2d, Conv2d, Sequential, avg_pool, global_avg_pool,
                                       max_pool)
from ever_tpu_torch.module.resnet import _conv, _stage_geometry

__all__ = ['SplAtConv2d', 'ResNeStBottleneck', 'ResNeSt', 'ResNeStEncoder', 'RESNEST_SPECS']

# name → stage sizes
RESNEST_SPECS = {
    'resnest50': (3, 4, 6, 3),
    'resnest101': (3, 4, 23, 3),
    'resnest200': (3, 24, 36, 3),
    'resnest269': (3, 30, 48, 8),
}


def _avg_pool(x, window: int, stride: int, padding):
    return avg_pool(x.permute(0, 2, 3, 1), window, stride, padding).permute(0, 3, 1, 2)


class SplAtConv2d(nn.Module):
    """Split-attention conv (module docstring): ``conv`` (grouped by
    radix, bias-free) → ``bn0`` → ReLU, the attention ``fc1`` (with a
    bias, ``max(F·radix/reduction, 32)`` wide) → ``bn1`` → ReLU → ``fc2``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, radix: int = 2, reduction: int = 4,
                 bn_frozen: bool = False):
        super().__init__()
        self.radix, self.features = radix, features
        inter = max(features * radix // reduction, 32)
        self.conv = Conv2d(in_channels, features * radix, kernel, stride, 'same', dilation,
                           groups=radix)
        self.bn0 = BatchNorm2d(features * radix, frozen=bn_frozen)
        self.fc1 = Conv2d(features, inter, 1, bias=True)
        self.bn1 = BatchNorm2d(inter, frozen=bn_frozen)
        self.fc2 = Conv2d(inter, features * radix, 1, bias=True)

    def forward(self, x, train: bool = False):
        r, c = self.radix, self.features
        h = F.relu(self.bn0(self.conv(x), train))
        n, _, hh, ww = h.shape
        splits = h.reshape(n, r, c, hh, ww)
        gap = global_avg_pool(splits.sum(1).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        a = self.fc2(F.relu(self.bn1(self.fc1(gap), train))).reshape(n, r, c, 1, 1)
        att = torch.sigmoid(a) if r == 1 else torch.softmax(a, dim=1)
        return (att * splits).sum(1)


class _AvgDown(nn.Module):
    """The shortcut's average pool (``'SAME'``) at ``stride``; the
    identity at stride 1."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return x if self.stride == 1 else _avg_pool(x, self.stride, self.stride, 'SAME')


class ResNeStBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, filters: int, stride: int = 1, dilation: int = 1,
                 conv_dilation: int = 1, downsample: bool = False, avd: bool = False,
                 radix: int = 2, bn_frozen: bool = False):
        super().__init__()
        out = filters * self.expansion
        self.stride, self.avd = stride, avd
        self.conv1 = _conv(inplanes, filters, 1)
        self.bn1 = BatchNorm2d(filters, frozen=bn_frozen)
        self.conv2 = SplAtConv2d(filters, filters, 3, 1, conv_dilation, radix=radix,
                                 bn_frozen=bn_frozen)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = BatchNorm2d(out, frozen=bn_frozen)
        self.downsample = (Sequential(_AvgDown(stride), _conv(inplanes, out, 1),
                                      BatchNorm2d(out, frozen=bn_frozen))
                           if downsample else None)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.conv2(y, train)
        if self.avd:
            y = _avg_pool(y, 3, max(self.stride, 1), ((1, 1), (1, 1)))
        y = self.bn3(self.conv3(y), train)
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + identity)


class ResNeSt(nn.Module):
    """The trunk: NCHW in, ``[c2, c3, c4, c5]`` out."""

    def __init__(self, resnest_type: str = 'resnest50', output_stride: int = 32,
                 radix: int = 2, bn_frozen: bool = False):
        super().__init__()
        sizes = RESNEST_SPECS[resnest_type]
        sw = 32 if resnest_type == 'resnest50' else 64
        self.conv1 = Sequential(
            _conv(3, sw, 3, 2), BatchNorm2d(sw, frozen=bn_frozen), nn.ReLU(),
            _conv(sw, sw, 3), BatchNorm2d(sw, frozen=bn_frozen), nn.ReLU(),
            _conv(sw, 2 * sw, 3))
        self.bn1 = BatchNorm2d(2 * sw, frozen=bn_frozen)
        inplanes = 2 * sw
        for i, (stride, dil, first_dil) in enumerate(_stage_geometry(output_stride)):
            filters = 64 * 2 ** i
            blocks = []
            for b in range(sizes[i]):
                blocks.append(ResNeStBottleneck(
                    inplanes, filters, stride if b == 0 else 1, dil,
                    first_dil if b == 0 else dil,
                    downsample=b == 0 and (stride != 1 or inplanes != 4 * filters),
                    avd=b == 0 and i >= 1, radix=radix, bn_frozen=bn_frozen))
                inplanes = 4 * filters
            self.add_module(f'layer{i + 1}', nn.ModuleList(blocks))

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x, train), train))
        x = max_pool(x.permute(0, 2, 3, 1), 3, 2, padding=((1, 1), (1, 1))).permute(0, 3, 1, 2)
        feats = []
        for i in range(1, 5):
            for block in getattr(self, f'layer{i}'):
                x = block(x, train)
            feats.append(x)
        return feats


for _name in RESNEST_SPECS:
    registry.MODEL.register(
        _name, (lambda n: lambda **kw: ResNeSt(resnest_type=n, **kw))(_name))


@registry.MODEL.register()
class ResNeStEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/resnest.py``
    ``ResNeStEncoder``), with the same config keys: ``name`` (the
    reference's spelling) wins over ``resnest_type`` when set.
    ``forward(x, train)`` takes NHWC ``[B, H, W, 3]``, computes in
    ``config.dtype`` and returns the four NCHW features."""

    def set_default_config(self):
        self.config.update(dict(
            resnest_type='resnest50',
            name='',
            output_stride=32,
            radix=2,
            bn_frozen=False,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self.net = ResNeSt(resnest_type=c.get('name') or c.resnest_type,
                           output_stride=c.output_stride, radix=c.radix,
                           bn_frozen=c.bn_frozen)

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return self.net(x, train)

    @property
    def out_channels(self) -> Sequence[int]:
        return [256, 512, 1024, 2048]
