"""FPN and the FarSeg decoder (counterpart of ``ever_tpu/module/fpn.py``).

Tensors are NCHW (in ``channels_last`` memory).  Input widths come from the
config, as torch needs them when a module is built (flax infers them); a
feature list whose widths differ from the config raises.  Parameter names
follow the reference torch modules (``fpn_inner1.0.weight``,
``blocks.0.0.1.running_mean``, ``classifier.0.weight``), the inverse of the
JAX package's ``convert_torch_farseg_head``.  ``LastLevelMaxPool``,
``LastLevelP6P7``, ``Fusion`` and ``BiFPN`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ever_tpu_torch.module.ops import ConvBlock, resize, upsample_bilinear

__all__ = ['FPN', 'AssymetricDecoder', 'resize_nchw', 'upsample_bilinear_nchw']


def resize_nchw(x, scale=None, shape=None, method: str = 'nearest'):
    """:func:`~ever_tpu_torch.module.ops.resize` of an NCHW tensor (a view
    each way when it lies in ``channels_last`` memory)."""
    return resize(x.permute(0, 2, 3, 1), scale, shape, method).permute(0, 3, 1, 2)


def upsample_bilinear_nchw(x: torch.Tensor, scale) -> torch.Tensor:
    """Bilinear upsampling of an NCHW tensor by ``scale``: ``resize_nchw(x,
    scale=scale, method='bilinear')``'s numbers (float32 unless x is
    bfloat16, returned in x's dtype), computed by
    :func:`~ever_tpu_torch.module.ops.upsample_bilinear`'s two matrix
    products.  ``F.interpolate``'s CUDA backward adds into the input
    gradient with atomics; this one does not, so a train step's gradients
    are the same bits every run, as a resumed or data-parallel run needs."""
    h, w = x.shape[2:]
    xh = x.permute(0, 2, 3, 1)
    xh = xh if xh.dtype == torch.bfloat16 else xh.float()
    y = upsample_bilinear(xh, (int(h * scale), int(w * scale)))
    return y.to(x.dtype).permute(0, 3, 1, 2)


def check_widths(what: str, feats, want: Sequence[int]) -> None:
    got = [int(f.shape[1]) for f in feats]
    if got != [int(c) for c in want]:
        raise ValueError(f'{what} was built for input widths {list(want)}, got '
                         f'features of widths {got}: set them in its config')


class FPN(nn.Module):
    """Feature Pyramid Network over ``[c2, c3, c4, c5]``: bias-free 1×1
    lateral convs (``fpn_inner{i}``) and 3×3 output convs (``fpn_layer{i}``),
    with optional BN (``conv_norm='bn'``) and ReLU (``conv_act``); nearest
    top-down upsampling.  Returns the levels highest resolution first."""

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256,
                 conv_norm: Optional[str] = None, conv_act: bool = False,
                 top_blocks: Optional[str] = None):
        super().__init__()
        if top_blocks is not None:
            raise NotImplementedError(f'FPN top_blocks={top_blocks!r} is not '
                                      f'ported yet (ROADMAP.md A.15)')
        self.in_channels_list = tuple(in_channels_list)
        for i, cin in enumerate(self.in_channels_list, start=1):
            self.add_module(f'fpn_inner{i}', ConvBlock(
                cin, out_channels, 1, norm=conv_norm, act=conv_act))
            self.add_module(f'fpn_layer{i}', ConvBlock(
                out_channels, out_channels, 3, norm=conv_norm, act=conv_act))

    def forward(self, feats, train: bool = False):
        check_widths('FPN', feats, self.in_channels_list)
        n = len(feats)
        last_inner = getattr(self, f'fpn_inner{n}')(feats[-1], train)
        results = [getattr(self, f'fpn_layer{n}')(last_inner, train)]
        for idx in range(n - 2, -1, -1):
            lateral = getattr(self, f'fpn_inner{idx + 1}')(feats[idx], train)
            top_down = resize_nchw(last_inner, shape=tuple(lateral.shape[2:]))
            last_inner = lateral + top_down
            results.insert(0, getattr(self, f'fpn_layer{idx + 1}')(last_inner, train))
        return tuple(results)


class AssymetricDecoder(nn.Module):
    """FarSeg decoder (the reference's spelling): per scale, conv → BN →
    ReLU layers each followed by a half-pixel bilinear ×2 until the output
    stride, the mean over the scales, then the optional classifier (a conv
    with bias) and its bilinear upsampling by ``scale_factor``."""

    def __init__(self, in_channels: int = 256, out_channels: int = 256,
                 in_feat_output_strides: Sequence[int] = (4, 8, 16, 32),
                 out_feat_output_stride: int = 4, norm: Optional[str] = 'bn',
                 classifier_config: Optional[dict] = None,
                 align_corners: bool = False):
        super().__init__()
        if norm != 'bn':
            raise NotImplementedError(f'AssymetricDecoder norm={norm!r} (GELU) is '
                                      f'not ported yet (ROADMAP.md A.15)')
        if align_corners:
            raise NotImplementedError('align_corners=True resizing is not ported '
                                      'yet (ROADMAP.md A.15)')
        self.in_channels = in_channels
        self.num_upsample = [int(math.log2(s)) - int(math.log2(out_feat_output_stride))
                             for s in in_feat_output_strides]
        self.blocks = nn.ModuleList()
        for n_up in self.num_upsample:
            self.blocks.append(nn.ModuleList(
                ConvBlock(in_channels if layer == 0 else out_channels,
                          out_channels, 3) for layer in range(max(n_up, 1))))
        self.classifier = None
        self.scale_factor = 1
        if classifier_config:
            cfg = dict(classifier_config)
            if (cfg.get('dropout_rate', -1) or 0) > 0:
                raise NotImplementedError('classifier dropout is not ported yet '
                                          '(ROADMAP.md A.15)')
            self.classifier = ConvBlock(out_channels, int(cfg['num_classes']),
                                        int(cfg.get('kernel_size', 1)),
                                        use_bias=True, norm=None, act=False)
            self.scale_factor = cfg.get('scale_factor', 1) or 1

    def forward(self, feat_list, train: bool = False):
        check_widths('AssymetricDecoder', feat_list,
                     [self.in_channels] * len(self.blocks))
        inner = []
        for y, layers, n_up in zip(feat_list, self.blocks, self.num_upsample):
            for layer in layers:
                y = layer(y, train)
                if n_up > 0:
                    y = upsample_bilinear_nchw(y, 2)
            inner.append(y)
        out = sum(inner) / len(inner)
        if self.classifier is not None:
            out = self.classifier(out)
            if self.scale_factor > 1:
                out = upsample_bilinear_nchw(out, float(self.scale_factor))
        return out
