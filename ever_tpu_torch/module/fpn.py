"""FPN and the FarSeg decoder (counterpart of ``ever_tpu/module/fpn.py``).

Tensors are NCHW (in ``channels_last`` memory).  Input widths come from the
config, as torch needs them when a module is built (flax infers them); a
feature list whose widths differ from the config raises.  Parameter names
follow the reference torch modules (``fpn_inner1.0.weight``,
``blocks.0.0.1.running_mean``, ``classifier.0.weight``), the inverse of the
JAX package's ``convert_torch_farseg_head``; the P6/P7 convs are
``top_blocks.p6``/``top_blocks.p7``.

``Fusion`` and ``BiFPN`` (EfficientDet's bidirectional pyramid) name their
parts after the JAX package's modules: ``bin_fusion{i}``/``tri_fusion{i}``
(each a ``fusion.weights`` vector and a separable ``conv`` block),
``down{i}`` (a 3×3/2 conv block), ``down{i}_bn`` (after a max pool) and
the duplicate-stride adapters ``up{i}_adapter``/``down{i}_adapter``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.module.ops import (BatchNorm2d, Conv2d, ConvBlock, SeparableConvBlock,
                                       _scaled_shape, bilinear_nchw, dropout, max_pool, resize,
                                       upsample_nearest_int)

__all__ = ['FPN', 'LastLevelMaxPool', 'LastLevelP6P7', 'AssymetricDecoder', 'Fusion', 'BiFPN',
           'FastNormalizedFusionConv3x3', 'NormalizedFusionConv3x3', 'init_conv',
           'conv_with_kaiming_uniform', 'resize_nchw', 'nearest_to', 'upsample_bilinear_nchw',
           'logits_nhwc']


def resize_nchw(x, scale=None, shape=None, method: str = 'nearest'):
    """:func:`~ever_tpu_torch.module.ops.resize` of an NCHW tensor (a view
    each way when it lies in ``channels_last`` memory)."""
    return resize(x.permute(0, 2, 3, 1), scale, shape, method).permute(0, 3, 1, 2)


def nearest_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Nearest resize of an NCHW tensor to ``shape`` (half-pixel centres):
    :func:`~ever_tpu_torch.module.ops.upsample_nearest_int` where both axes
    grow by one integer factor (a backward without atomics), else
    :func:`resize_nchw`."""
    h, w = x.shape[2:]
    k = shape[0] // h
    if k > 1 and tuple(shape) == (h * k, w * k):
        return upsample_nearest_int(x, k)
    return resize_nchw(x, shape=tuple(shape))


def upsample_bilinear_nchw(x: torch.Tensor, scale, align_corners: bool = False
                           ) -> torch.Tensor:
    """Bilinear upsampling of an NCHW tensor by ``scale``: ``resize_nchw(x,
    scale=scale, method='bilinear')``'s numbers (float32 unless x is
    bfloat16, returned in x's dtype), computed by
    :func:`~ever_tpu_torch.module.ops.bilinear_nchw`'s two matrix products
    (with ``align_corners`` in float32).  ``F.interpolate``'s CUDA backward
    adds into the input gradient with atomics; these do not, so a train
    step's gradients are the same bits every run, as a resumed or
    data-parallel run needs."""
    h, w = x.shape[2:]
    return bilinear_nchw(x, _scaled_shape(h, w, scale, 'upsample_bilinear_nchw'), align_corners)


def logits_nhwc(cls: nn.Module, dense: torch.Tensor) -> torch.Tensor:
    """A 1×1 classifier over NCHW features, upsampled ×4 bilinearly and
    returned as float32 NHWC logits (what the JAX models compute with
    ``resize(cls(x), scale=4.0, method='bilinear').astype(float32)``)."""
    return upsample_bilinear_nchw(cls(dense), 4.0).permute(0, 2, 3, 1).float()


def check_widths(what: str, feats, want: Sequence[int]) -> None:
    got = [int(f.shape[1]) for f in feats]
    if got != [int(c) for c in want]:
        raise ValueError(f'{what} was built for input widths {list(want)}, got '
                         f'features of widths {got}: set them in its config')


@registry.OP.register()
class FPN(nn.Module):
    """Feature Pyramid Network over ``[c2, c3, c4, c5]``: bias-free 1×1
    lateral convs (``fpn_inner{i}``) and 3×3 output convs (``fpn_layer{i}``),
    with optional BN (``conv_norm='bn'``) and ReLU (``conv_act``); nearest
    top-down upsampling.  Returns the levels highest resolution first, then
    those of ``top_blocks``: ``'maxpool'`` (:class:`LastLevelMaxPool` of
    the last level) or ``'p6p7'`` (:class:`LastLevelP6P7` of it)."""

    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256,
                 conv_norm: Optional[str] = None, conv_act: bool = False,
                 top_blocks: Optional[str] = None):
        super().__init__()
        self.in_channels_list = tuple(in_channels_list)
        for i, cin in enumerate(self.in_channels_list, start=1):
            self.add_module(f'fpn_inner{i}', ConvBlock(
                cin, out_channels, 1, norm=conv_norm, act=conv_act))
            self.add_module(f'fpn_layer{i}', ConvBlock(
                out_channels, out_channels, 3, norm=conv_norm, act=conv_act))
        if top_blocks == 'maxpool':
            self.top_blocks = LastLevelMaxPool()
        elif top_blocks == 'p6p7':
            self.top_blocks = LastLevelP6P7(out_channels)
        elif top_blocks is None:
            self.top_blocks = None
        else:
            raise ValueError(f"top_blocks must be None, 'maxpool' or 'p6p7', got {top_blocks!r}")

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
        if self.top_blocks is not None:
            results.extend(self.top_blocks(results[-1]))
        return tuple(results)


class LastLevelMaxPool(nn.Module):
    """One more level: a 1×1 max pool with stride 2 (VALID) of the last."""

    def forward(self, p):
        return [max_pool(p.permute(0, 2, 3, 1), 1, 2, padding='VALID').permute(0, 3, 1, 2)]


class LastLevelP6P7(nn.Module):
    """RetinaNet's P6 and P7 from P5: 3×3/2 convs with a bias and lax's
    ``'SAME'`` padding (asymmetric at stride 2), a ReLU between them;
    kaiming-uniform (a=1) weights and zero biases, as the JAX package
    initialises them."""

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = Conv2d(channels, channels, 3, 2, 'same', bias=True)
        self.p7 = Conv2d(channels, channels, 3, 2, 'same', bias=True)
        for conv in (self.p6, self.p7):
            nn.init.kaiming_uniform_(conv.weight, a=1)
            nn.init.zeros_(conv.bias)

    def forward(self, p5):
        p6 = self.p6(p5)
        return [p6, self.p7(F.relu(p6))]


@registry.OP.register()
class AssymetricDecoder(nn.Module):
    """FarSeg decoder (the reference's spelling): per scale, conv → norm →
    activation layers each followed by a bilinear ×2 until the output
    stride, the mean over the scales, then the optional classifier (a conv
    with bias) and its bilinear upsampling by ``scale_factor``.

    ``norm='bn'`` takes ReLU; ``'gn'``, ``'ln'`` and None take GELU (the
    tanh approximation, flax's ``nn.gelu``), as in the JAX package.
    ``align_corners=True`` resizes with torch's corner-aligned grid (the
    reference's ``UpsamplingBilinear2d``), otherwise with half-pixel
    centres.  ``classifier_config['dropout_rate']`` drops elements of the
    classifier's input in training, drawn from ``forward``'s ``generator``.
    """

    def __init__(self, in_channels: int = 256, out_channels: int = 256,
                 in_feat_output_strides: Sequence[int] = (4, 8, 16, 32),
                 out_feat_output_stride: int = 4, norm: Optional[str] = 'bn',
                 classifier_config: Optional[dict] = None,
                 align_corners: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.align_corners = align_corners
        act = True if norm == 'bn' else 'gelu'
        self.num_upsample = [int(math.log2(s)) - int(math.log2(out_feat_output_stride))
                             for s in in_feat_output_strides]
        self.blocks = nn.ModuleList()
        for n_up in self.num_upsample:
            self.blocks.append(nn.ModuleList(
                ConvBlock(in_channels if layer == 0 else out_channels,
                          out_channels, 3, norm=norm, act=act)
                for layer in range(max(n_up, 1))))
        self.classifier = None
        self.scale_factor = 1
        self.dropout_rate = 0.0
        if classifier_config:
            cfg = dict(classifier_config)
            self.dropout_rate = max(float(cfg.get('dropout_rate', 0) or 0), 0.0)
            self.classifier = ConvBlock(out_channels, int(cfg['num_classes']),
                                        int(cfg.get('kernel_size', 1)),
                                        use_bias=True, norm=None, act=False)
            self.scale_factor = cfg.get('scale_factor', 1) or 1

    def forward(self, feat_list, train: bool = False,
                generator: Optional[torch.Generator] = None):
        feat_list = feat_list[:len(self.blocks)]     # as the JAX package, extra levels unused
        check_widths('AssymetricDecoder', feat_list,
                     [self.in_channels] * len(self.blocks))
        inner = []
        for y, layers, n_up in zip(feat_list, self.blocks, self.num_upsample):
            for layer in layers:
                y = layer(y, train)
                if n_up > 0:
                    y = upsample_bilinear_nchw(y, 2, self.align_corners)
            inner.append(y)
        out = sum(inner) / len(inner)
        if self.classifier is not None:
            out = self.classifier(dropout(out, self.dropout_rate, train, generator))
            if self.scale_factor > 1:
                out = upsample_bilinear_nchw(out, float(self.scale_factor),
                                             self.align_corners)
        return out


@registry.OP.register()
class Fusion(nn.Module):
    """Learned weighted sum of ``num_inputs`` features of one shape:
    ``'softmax'`` weights (zero-initialised) or ``'fast_normalize'`` ones
    (ones-initialised, ReLU, divided by their sum + ``eps``).  The float32
    weights are cast to the features' dtype before the sum, as the JAX
    package's ``tensordot`` takes them."""

    def __init__(self, num_inputs: int, norm_method: str = 'fast_normalize',
                 eps: float = 1e-4):
        super().__init__()
        if norm_method not in ('softmax', 'fast_normalize'):
            raise NotImplementedError(norm_method)
        self.norm_method, self.eps = norm_method, eps
        init = torch.zeros if norm_method == 'softmax' else torch.ones
        self.weights = nn.Parameter(init(num_inputs))

    def forward(self, features):
        if self.norm_method == 'softmax':
            w = torch.softmax(self.weights, 0)
        else:
            w = F.relu(self.weights)
            w = w / (w.sum() + self.eps)
        w = w.to(features[0].dtype)
        out = features[0] * w[0]
        for i, f in enumerate(features[1:], start=1):
            out = out + f * w[i]
        return out


class _FusedConv3x3(nn.Module):
    """:class:`Fusion` (``fusion``) → separable 3×3 conv → BN → ReLU
    (``conv``)."""

    norm_method = 'fast_normalize'

    def __init__(self, num_inputs: int, in_channels: int, out_channels: int,
                 norm_method: Optional[str] = None):
        super().__init__()
        self.fusion = Fusion(num_inputs, norm_method or self.norm_method)
        self.conv = SeparableConvBlock(in_channels, out_channels, 3, norm='bn')

    def forward(self, features, train: bool = False):
        return self.conv(self.fusion(features), train)


class FastNormalizedFusionConv3x3(_FusedConv3x3):
    """ReLU-sum-normalised fusion → separable 3×3 conv-BN-ReLU."""

    norm_method = 'fast_normalize'


class NormalizedFusionConv3x3(_FusedConv3x3):
    """Softmax-weighted fusion → separable 3×3 conv-BN-ReLU."""

    norm_method = 'softmax'


@registry.OP.register()
class BiFPN(nn.Module):
    """One bidirectional FPN layer over ``len(feature_strides)`` features of
    ``in_channels`` each, finest first: a top-down pass of 2-input fusions
    (the coarser level resized to the finer one, nearest), then a bottom-up
    pass of 3-input fusions (the input, the top-down result and the finer
    output brought down by a 3×3/2 conv block, or by ``downsample_op=
    'maxpool'``: a 3×3/2 max pool, BN and ReLU).  A level whose stride
    equals the coarsest one is paired through a learned 1×1 conv-BN-ReLU
    adapter instead.  Returns the outputs finest first."""

    def __init__(self, in_channels: int, feature_strides: Sequence[int],
                 normalized_fusion: str = 'fast_normalize', downsample_op: str = 'conv'):
        super().__init__()
        if downsample_op not in ('conv', 'maxpool'):
            raise ValueError(f"downsample_op must be 'conv' or 'maxpool', got {downsample_op!r}")
        c = in_channels
        self.in_channels = c
        self.feature_strides = tuple(feature_strides)
        self.downsample_op = downsample_op
        n, cs = len(self.feature_strides), max(self.feature_strides)
        self.up_adapted = [cs / s <= 1 for s in self.feature_strides[::-1][1:]]
        self.down_adapted = [cs / s <= 1 for s in self.feature_strides[:n - 1]]
        for idx in range(n - 1):
            if self.up_adapted[idx]:
                self.add_module(f'up{idx}_adapter', ConvBlock(c, c, 1, norm='bn'))
            self.add_module(f'bin_fusion{idx}', _FusedConv3x3(2, c, c, normalized_fusion))
        for idx in range(n - 1):
            if self.down_adapted[idx]:
                self.add_module(f'down{idx}_adapter', ConvBlock(c, c, 1, norm='bn'))
            elif downsample_op == 'conv':
                self.add_module(f'down{idx}', ConvBlock(c, c, 3, stride=2, norm='bn'))
            else:
                self.add_module(f'down{idx}_bn', BatchNorm2d(c))
            self.add_module(f'tri_fusion{idx}', _FusedConv3x3(3, c, c, normalized_fusion))

    def _down(self, idx: int, x, train: bool):
        if self.down_adapted[idx]:
            return getattr(self, f'down{idx}_adapter')(x, train)
        if self.downsample_op == 'conv':
            return getattr(self, f'down{idx}')(x, train)
        x = max_pool(x.permute(0, 2, 3, 1), 3, 2, padding=((1, 1), (1, 1))).permute(0, 3, 1, 2)
        return F.relu(getattr(self, f'down{idx}_bn')(x, train))

    def forward(self, features, train: bool = False):
        n = len(self.feature_strides)
        if len(features) != n:
            raise ValueError(f'BiFPN was built for {n} levels, got {len(features)}')
        check_widths('BiFPN', features, [self.in_channels] * n)
        feats, inner = list(features), []
        for idx in range(n - 1):
            x_top, x_down = feats.pop(), feats.pop()
            if self.up_adapted[idx]:
                up = getattr(self, f'up{idx}_adapter')(x_top, train)
            else:
                up = nearest_to(x_top, x_down.shape[2:])
            fused = getattr(self, f'bin_fusion{idx}')([x_down, up], train)
            feats.append(fused)
            inner.append(fused)
        inner.reverse()
        inner.append(features[-1])
        out = [inner[0]]
        for idx in range(n - 1):
            x_bottom, x_up = inner.pop(0), inner.pop(0)
            fused = getattr(self, f'tri_fusion{idx}')(
                [features[idx + 1], x_up, self._down(idx, x_bottom, train)], train)
            inner.insert(0, fused)
            out.append(fused)
        return out


def init_conv():
    """FPN's conv weight initialiser, in place: torch's
    ``kaiming_uniform_(w, a=1)``, uniform within ±√(3 / fan_in) (the JAX
    package's ``variance_scaling(1, 'fan_in', 'uniform')``)."""
    return lambda w: nn.init.kaiming_uniform_(w, a=1)


def conv_with_kaiming_uniform(use_bn: bool = False, use_relu: bool = False):
    """A factory of :class:`~ever_tpu_torch.module.ops.ConvBlock`s with
    FPN's initialisation: ``make_conv(in_channels, features, kernel_size,
    stride=1, dilation=1, **kw)`` gives conv → [BN] → [ReLU], the conv's
    weight from :func:`init_conv` (bias-free unless ``use_bias=True``,
    then zero)."""
    def make_conv(in_channels, features, kernel_size, stride=1, dilation=1, **kw):
        block = ConvBlock(in_channels, features, kernel_size, stride, dilation,
                          norm='bn' if use_bn else None, act=use_relu, **kw)
        init_conv()(block[0].weight)
        if block[0].bias is not None:
            nn.init.zeros_(block[0].bias)
        return block
    return make_conv
