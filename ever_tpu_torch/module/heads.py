"""Segmentation decoder heads: ASPP, PPM, DeepLabv3+ and the HRNet fusion
head (counterpart of ``ever_tpu/module/heads.py``).

Tensors are NCHW (in ``channels_last`` memory); a head returns NCHW logits
at the scale its config asks for.  Input widths come from the config, as
torch needs them when a module is built (flax infers them).  Module names
follow the JAX package's (``branch0``, ``image_pool``, ``project``,
``pool{i}``, ``bottleneck``, ``os4_transform``, ``stack_conv{i}``,
``fuse_conv``, ``classifier``), so ``util.weight_io`` maps them one to one.

Every resize is a matrix product (``module/ops.py`` ``bilinear_nchw``) and
the pyramid bins' pooling too (``adaptive_avg_pool``): their backwards add
without atomics, so a train step is the same bits every run.  The ASPP's
element dropout (0.5 by default) and the PPM's channel dropout draw from
``forward``'s ``generator`` in training.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.fpn import upsample_bilinear_nchw
from ever_tpu_torch.module.ops import (Conv2d, ConvBlock, PoolBlock, SeparableConvBlock,
                                       bilinear_nchw, channel_dropout, dropout)

__all__ = ['AtrousSpatialPyramidPool', 'ASPPHead', 'PyramidPoolModule', 'PPMHead',
           'Deeplabv3pDecoder', 'Deeplabv3pHead', 'SimpleFusion', 'HRNetHead']


@registry.OP.register()
class AtrousSpatialPyramidPool(nn.Module):
    """1×1 and dilated 3×3 conv branches and an image pool, concatenated and
    projected by a 1×1 conv, then element dropout in training."""

    def __init__(self, in_channels: int = 2048, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (6, 12, 18), dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.n_branches = len(atrous_rates) + 1
        self.branch0 = ConvBlock(in_channels, out_channels, 1)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f'branch{i + 1}',
                            ConvBlock(in_channels, out_channels, 3, dilation=rate))
        self.image_pool = PoolBlock(in_channels, 1, out_channels)
        self.project = ConvBlock(out_channels * (self.n_branches + 1), out_channels, 1)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        res = [getattr(self, f'branch{i}')(x, train) for i in range(self.n_branches)]
        res.append(self.image_pool(x, train))
        y = self.project(torch.cat(res, dim=1), train)
        return dropout(y, self.dropout_rate, train, generator)


class _ClassifierHead(ERModule):
    """What the four heads share: a 1×1 classifier with bias over the
    decoder's output, then a bilinear resize by ``upsample_scale``
    (``align_corners`` as the reference's ``UpsamplingBilinear2d`` by
    default).  ``forward(x, train, generator)`` takes and returns NCHW."""

    def _classifier(self, channels: int) -> None:
        self.classifier = Conv2d(channels, int(self.config.num_classes), 1, bias=True)

    def _logits(self, y):
        return upsample_bilinear_nchw(self.classifier(y), float(self.config.upsample_scale),
                                      bool(self.config.get('align_corners', True)))


@registry.MODEL.register()
class ASPPHead(_ClassifierHead):
    """ASPP → classifier → upsampling (DeepLabv3's head)."""

    def set_default_config(self):
        self.config.update(dict(
            aspp=dict(in_channels=2048, out_channels=256, atrous_rates=[6, 12, 18]),
            num_classes=3,
            upsample_scale=8.0,
            align_corners=True,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.aspp = AtrousSpatialPyramidPool(**self.config.aspp.to_dict())
        self._classifier(int(self.config.aspp.get('out_channels', 256)))

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        return self._logits(self.aspp(x, train, generator))


@registry.OP.register()
class PyramidPoolModule(nn.Module):
    """PSPNet's pyramid pooling: the input and a :class:`PoolBlock` per bin,
    concatenated, through a 3×3 (``bottleneck_conv='3x3'``) or 1×1
    conv-BN-ReLU (none for another value), then channel dropout in training
    (``dropout_rate``, or the reference's spelling ``dropout``)."""

    def __init__(self, in_channels: int = 2048, pool_channels: int = 512,
                 out_channels: int = 512, bins: Sequence[int] = (1, 2, 3, 6),
                 bottleneck_conv: str = '3x3', dropout_rate: float = 0.0,
                 dropout: float = 0.0):
        super().__init__()
        self.n_bins = len(bins)
        self.rate = dropout_rate or dropout
        for i, size in enumerate(bins):
            self.add_module(f'pool{i}', PoolBlock(in_channels, size, pool_channels))
        width = in_channels + self.n_bins * pool_channels
        kernel = {'3x3': 3, '1x1': 1}.get(bottleneck_conv)
        self.bottleneck = (ConvBlock(width, out_channels, kernel)
                           if kernel is not None else None)
        self.out_width = out_channels if kernel is not None else width

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        out = [x] + [getattr(self, f'pool{i}')(x, train) for i in range(self.n_bins)]
        y = torch.cat(out, dim=1)
        if self.bottleneck is not None:
            y = self.bottleneck(y, train)
        return channel_dropout(y, self.rate, train, generator)


@registry.MODEL.register()
class PPMHead(_ClassifierHead):
    """PPM → classifier → upsampling (PSPNet's head)."""

    def set_default_config(self):
        self.config.update(dict(
            ppm=dict(in_channels=2048, pool_channels=512, out_channels=512,
                     bins=(1, 2, 3, 6)),
            num_classes=3,
            upsample_scale=8.0,
            align_corners=True,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.ppm = PyramidPoolModule(**self.config.ppm.to_dict())
        self._classifier(self.ppm.out_width)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        return self._logits(self.ppm(x, train, generator))


@registry.OP.register()
class Deeplabv3pDecoder(nn.Module):
    """DeepLabv3+'s decoder over ``[os4, os16]`` features: the os4 feature
    reduced by a 3×3 conv (``os4_transform``); the os16 feature through an
    ASPP (its dropout at 0.5, as the JAX package builds it) and a 3×3 conv
    (``os16_transform``), upsampled by ``scale_factor``; both concatenated
    and through ``num_3x3_convs`` separable conv blocks."""

    def __init__(self, os4_feature_channels: int = 256, os16_feature_channels: int = 2048,
                 aspp_channels: int = 256, aspp_atrous: Sequence[int] = (6, 12, 18),
                 reduction_dim: int = 48, out_channels: int = 256, num_3x3_convs: int = 2,
                 scale_factor: float = 4.0, align_corners: bool = True):
        super().__init__()
        self.scale_factor, self.align_corners = scale_factor, align_corners
        self.num_3x3_convs = num_3x3_convs
        self.os4_transform = ConvBlock(os4_feature_channels, reduction_dim, 3)
        self.aspp = AtrousSpatialPyramidPool(os16_feature_channels, aspp_channels, aspp_atrous)
        self.os16_transform = ConvBlock(aspp_channels, aspp_channels, 3)
        width = reduction_dim + aspp_channels
        for i in range(num_3x3_convs):
            self.add_module(f'stack_conv{i}', SeparableConvBlock(width, out_channels, 3))
            width = out_channels

    def forward(self, feat_list, train: bool = False,
                generator: Optional[torch.Generator] = None):
        os4_feat, os16_feat = feat_list
        low = self.os4_transform(os4_feat, train)
        high = self.os16_transform(self.aspp(os16_feat, train, generator), train)
        high = upsample_bilinear_nchw(high, float(self.scale_factor), self.align_corners)
        y = torch.cat([low, high], dim=1)
        for i in range(self.num_3x3_convs):
            y = getattr(self, f'stack_conv{i}')(y, train)
        return y


@registry.MODEL.register()
class Deeplabv3pHead(_ClassifierHead):
    """The DeepLabv3+ decoder → classifier → upsampling."""

    def set_default_config(self):
        self.config.update(dict(
            deeplabv3p_decoder=dict(
                os4_feature_channels=256,
                os16_feature_channels=2048,
                aspp_channels=256,
                aspp_atrous=(6, 12, 18),
                reduction_dim=48,
                out_channels=256,
                num_3x3_convs=2,
                scale_factor=4.0,
            ),
            num_classes=3,
            upsample_scale=4.0,
            align_corners=True,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        dec = self.config.deeplabv3p_decoder.to_dict()
        self.decoder = Deeplabv3pDecoder(**dec)
        self._classifier(int(dec.get('out_channels', 256)))

    def forward(self, feat_list, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self._logits(self.decoder(feat_list, train, generator))


@registry.OP.register()
class SimpleFusion(nn.Module):
    """The HRNet features upsampled to the finest one's size (bilinear,
    ``align_corners`` as the reference), concatenated and fused by a 1×1
    conv-BN-ReLU (``fuse_conv``) of ``in_channels`` (their total width)."""

    def __init__(self, in_channels: int = 480, align_corners: bool = True):
        super().__init__()
        self.align_corners = align_corners
        self.fuse_conv = ConvBlock(in_channels, in_channels, 1)

    def forward(self, feat_list, train: bool = False):
        target = tuple(feat_list[0].shape[2:])
        ups = [feat_list[0]] + [bilinear_nchw(f, target, self.align_corners)
                                for f in feat_list[1:]]
        return self.fuse_conv(torch.cat(ups, dim=1), train)


@registry.MODEL.register()
class HRNetHead(_ClassifierHead):
    """SimpleFusion → classifier → upsampling (HRNetV2's segmentation head;
    ``in_channels=480`` is HRNetV2-W32's 32 + 64 + 128 + 256)."""

    def set_default_config(self):
        self.config.update(dict(
            hrnet_decoder=dict(in_channels=480),
            num_classes=3,
            upsample_scale=4.0,
            align_corners=True,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        dec = self.config.hrnet_decoder.to_dict()
        self.fusion = SimpleFusion(**dec)
        self._classifier(int(dec.get('in_channels', 480)))

    def forward(self, feat_list, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self._logits(self.fusion(feat_list, train))
