"""ResNet family encoders (counterpart of ``ever_tpu/module/resnet.py``).

``BasicBlock``/``Bottleneck`` (stride on the 3×3), ``ResNetStage``, the
size ladder ``RESNET_SPECS`` (groups, the deep v1c stem),
``_stage_geometry`` (output stride 8, 16 or 32), ``ResNet`` returning
``[c2, c3, c4, c5]`` and the configurable ``ResNetEncoder``.  Tensors are
NCHW inside (in ``channels_last`` memory); ``ResNetEncoder`` takes NHWC, as
the JAX package does.  Parameter names follow torchvision (``conv1.weight``,
``layer1.0.bn2.running_var``, ``layer2.0.downsample.0.weight``; the deep
stem as ``stem.{0..7}``), so ``util.weight_io`` moves weights across.

The stem is conv → BN → max pool → ReLU, in the JAX package's order: the
pool reads the BatchNorm output, where exact ties are rare, and
``maxpool_impl='pallas'`` sends its backward through the kernel K8.

The JAX package's TPU layouts compute the same function with the same
parameters, so ``stem='s2d'|'s2dw'|'s2d3'`` (and their ``_pack2``
variants) is the plain 7×7/2 conv here and ``pack2_layer1`` changes
nothing.  ``stem='s2d_input'`` (and ``'s2d_input_pack2'``) takes the input
already space-to-depth folded, ``[B, H/2, W/2, 4C]`` in channel order
``(dy·2 + dx)·C + c`` (what ``data.SpaceToDepth`` and the readers'
``layout='s2d'`` give): depth-to-space, a reshape and a permute, restores
``[B, C, H, W]`` for the same 7×7/2 conv, so the parameter stays
``conv1.weight`` ``[64, C, 7, 7]`` with ``in_channels`` = C, a checkpoint
moves between stems unchanged, and the features are the bits of
``stem='conv'`` on the unfolded batch.  The deep (v1c) stem ignores
``stem`` in the JAX package and convolves the folded input as it comes, 4C
channels in; the port does the same.

``se_ratio`` and ``gc_ratio`` add an SE (``se``) or a GCNet context
(``gc``) branch to every block, after its last BatchNorm and before the
residual add, as the JAX package does; ``set_branch`` adds or removes one
on a built block (the plugin functions of ``se_block`` and
``context_block``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.context_block import ContextBlock2d
from ever_tpu_torch.module.ops import BatchNorm2d, Conv2d, Sequential, checkpointed, max_pool
from ever_tpu_torch.module.se_block import SEBlock

__all__ = ['BasicBlock', 'Bottleneck', 'ResNetStage', 'ResNet', 'ResNetEncoder',
           'RESNET_SPECS', 'depth_to_space', 'make_layer', 'patch_first_conv']


def _conv(cin, cout, kernel, stride=1, dilation=1, groups=1):
    """Bias-free conv with symmetric padding (torch's convention)."""
    return Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2,
                  dilation, groups)


class _Block(nn.Module):
    """What BasicBlock and Bottleneck share: the optional SE and GC
    branches on the residual branch's output, and the residual add."""

    def _branches(self, out: int, se_ratio, gc_ratio):
        self.out_channels = out
        self.se = self.gc = None
        self.set_branch('se_ratio', se_ratio)
        self.set_branch('gc_ratio', gc_ratio)

    def set_branch(self, key: str, ratio) -> None:
        """Add (a ratio) or remove (None) the SE (``key='se_ratio'``, as
        ``se``) or GC (``'gc_ratio'``, as ``gc``) branch; a new branch is
        freshly initialised on the block's device."""
        make = {'se_ratio': SEBlock, 'gc_ratio': ContextBlock2d}[key]
        branch = make(self.out_channels, ratio).to(self.bn1.weight.device) if ratio else None
        setattr(self, key[:2], branch)

    def _join(self, y, x, train):
        if self.se is not None:
            y = self.se(y)
        if self.gc is not None:
            y = self.gc(y)
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(y + identity)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, filters: int, stride: int = 1,
                 dilation: int = 1, conv_dilation: int = 1,
                 downsample: bool = False, bn_frozen: bool = False,
                 se_ratio=None, gc_ratio=None):
        super().__init__()
        self.conv1 = _conv(inplanes, filters, 3, stride, conv_dilation)
        self.bn1 = BatchNorm2d(filters, frozen=bn_frozen)
        self.conv2 = _conv(filters, filters, 3, 1, dilation)
        self.bn2 = BatchNorm2d(filters, frozen=bn_frozen)
        self.downsample = (Sequential(_conv(inplanes, filters, 1, stride),
                                      BatchNorm2d(filters, frozen=bn_frozen))
                           if downsample else None)
        self._branches(filters, se_ratio, gc_ratio)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        return self._join(self.bn2(self.conv2(y), train), x, train)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes: int, filters: int, stride: int = 1,
                 dilation: int = 1, conv_dilation: int = 1,
                 downsample: bool = False, groups: int = 1,
                 width_per_group: int = 64, bn_frozen: bool = False,
                 se_ratio=None, gc_ratio=None):
        super().__init__()
        width = int(filters * (width_per_group / 64.0)) * groups
        out = filters * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm2d(width, frozen=bn_frozen)
        # stride on the 3x3 (torchvision v1.5)
        self.conv2 = _conv(width, width, 3, stride, conv_dilation, groups)
        self.bn2 = BatchNorm2d(width, frozen=bn_frozen)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = BatchNorm2d(out, frozen=bn_frozen)
        self.downsample = (Sequential(_conv(inplanes, out, 1, stride),
                                      BatchNorm2d(out, frozen=bn_frozen))
                           if downsample else None)
        self._branches(out, se_ratio, gc_ratio)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        return self._join(self.bn3(self.conv3(y), train), x, train)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """The inverse of the 2×2 space-to-depth fold of an NCHW tensor:
    ``[B, 4C, h, w]`` with channel ``(dy·2 + dx)·C + c`` → ``[B, C, 2h, 2w]``,
    a reshape and a permute, copied into ``channels_last`` memory as the
    unfolded batch lies (the stem conv then takes the same kernel and gives
    the same bits).  Row-local: under a spatial step a strip of h folded
    rows unfolds to exactly its 2h pixel rows (``Strips.check_batch`` keeps
    the folded input's strips on the labels')."""
    b, c4, h, w = x.shape
    c = c4 // 4
    y = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)


class ResNetStage(nn.ModuleList):
    """One stage (``layerN``) of blocks sharing filters and dilation; the
    first block carries the stride and, when the width changes, the
    downsample shortcut."""

    def __init__(self, block, inplanes: int, filters: int, num_blocks: int,
                 stride: int = 1, dilation: int = 1, first_dilation: int = 1,
                 groups: int = 1, width_per_group: int = 64,
                 bn_frozen: bool = False, se_ratio=None, gc_ratio=None):
        kw = dict(bn_frozen=bn_frozen, se_ratio=se_ratio, gc_ratio=gc_ratio)
        if block is Bottleneck:
            kw.update(groups=groups, width_per_group=width_per_group)
        out = filters * block.expansion
        blocks = [block(inplanes, filters, stride, dilation, first_dilation,
                        downsample=stride != 1 or inplanes != out, **kw)]
        blocks += [block(out, filters, 1, dilation, dilation, **kw)
                   for _ in range(1, num_blocks)]
        super().__init__(blocks)

    def forward(self, x, train: bool = False):
        for blk in self:
            x = blk(x, train)
        return x


# name → (block, stage_sizes, groups, width_per_group, deep_stem)
RESNET_SPECS = {
    'resnet18': (BasicBlock, (2, 2, 2, 2), 1, 64, False),
    'resnet34': (BasicBlock, (3, 4, 6, 3), 1, 64, False),
    'resnet50': (Bottleneck, (3, 4, 6, 3), 1, 64, False),
    'resnet101': (Bottleneck, (3, 4, 23, 3), 1, 64, False),
    'resnet152': (Bottleneck, (3, 8, 36, 3), 1, 64, False),
    'resnext50_32x4d': (Bottleneck, (3, 4, 6, 3), 32, 4, False),
    'resnext101_32x4d': (Bottleneck, (3, 4, 23, 3), 32, 4, False),
    'resnext101_32x8d': (Bottleneck, (3, 4, 23, 3), 32, 8, False),
    'resnet50_v1c': (Bottleneck, (3, 4, 6, 3), 1, 64, True),
    'resnet101_v1c': (Bottleneck, (3, 4, 23, 3), 1, 64, True),
}


def _stage_geometry(output_stride: int) -> Sequence[Tuple[int, int, int]]:
    """(stride, dilation, first_dilation) per stage for an output stride:
    os16 → layer4 {s1, d2, first d1}; os8 → layer3 {s1, d2, first d1},
    layer4 {s1, d4, first d2}."""
    if output_stride == 32:
        return [(1, 1, 1), (2, 1, 1), (2, 1, 1), (2, 1, 1)]
    if output_stride == 16:
        return [(1, 1, 1), (2, 1, 1), (2, 1, 1), (1, 2, 1)]
    if output_stride == 8:
        return [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 4, 2)]
    raise ValueError('output_stride must be 8, 16 or 32.')


class ResNet(nn.Module):
    """Backbone trunk: NCHW in, the multi-scale features ``[c2, c3, c4, c5]``
    out (``[c2, c3, c4]`` without ``include_conv5``).

    ``with_cp[i]`` recomputes stage i in the backward pass
    (``torch.utils.checkpoint``, when a gradient is recorded); its
    recomputation leaves the running statistics alone, so they move once
    per forward, as under JAX's ``nn.remat``.
    """

    def __init__(self, resnet_type: str = 'resnet50', output_stride: int = 32,
                 include_conv5: bool = True, bn_frozen: bool = False,
                 with_cp: Sequence[bool] = (False, False, False, False),
                 se_ratio=None, gc_ratio=None, stem: str = 'conv',
                 maxpool_impl: str = 'reduce_window', pack2_layer1: bool = False,
                 in_channels: int = 3):
        super().__init__()
        del pack2_layer1          # a TPU layout of the same function
        if not (stem == 'conv' or stem.startswith('s2d')):
            raise ValueError(f'unknown stem {stem!r}')
        block, sizes, groups, wpg, deep_stem = RESNET_SPECS[resnet_type]
        self.maxpool_impl = maxpool_impl
        self.with_cp = tuple(with_cp)
        self.folded_input = stem.startswith('s2d_input')
        if deep_stem:
            # the JAX package's deep stem takes the folded input as it comes
            cin = 4 * in_channels if self.folded_input else in_channels
            self.stem = Sequential(
                _conv(cin, 32, 3, 2), BatchNorm2d(32, frozen=bn_frozen),
                nn.ReLU(), _conv(32, 32, 3), BatchNorm2d(32, frozen=bn_frozen),
                nn.ReLU(), _conv(32, 64, 3), BatchNorm2d(64, frozen=bn_frozen))
        else:
            self.conv1 = _conv(in_channels, 64, 7, 2)
            self.bn1 = BatchNorm2d(64, frozen=bn_frozen)
        self.deep_stem = deep_stem
        inplanes = 64
        for i, (stride, dil, first_dil) in enumerate(
                _stage_geometry(output_stride)[:4 if include_conv5 else 3]):
            filters = 64 * 2 ** i
            self.add_module(f'layer{i + 1}', ResNetStage(
                block, inplanes, filters, sizes[i], stride, dil, first_dil,
                groups, wpg, bn_frozen, se_ratio, gc_ratio))
            inplanes = filters * block.expansion
        self.n_stages = i + 1

    def _stage(self, i: int, x, train: bool):
        stage = getattr(self, f'layer{i + 1}')
        if not (self.with_cp[i] and torch.is_grad_enabled()):
            return stage(x, train)
        return checkpointed(stage, lambda x: stage(x, train), x)

    def forward(self, x, train: bool = False):
        if self.deep_stem:
            x = self.stem(x, train)
        else:
            if self.folded_input:
                x = depth_to_space(x)
            x = self.bn1(self.conv1(x), train)
        # the pool reads the BatchNorm output; ReLU after it (max commutes
        # with ReLU, and K8's equality test sees pre-ReLU values)
        x = max_pool(x.permute(0, 2, 3, 1), 3, 2, padding=((1, 1), (1, 1)),
                     impl=self.maxpool_impl).permute(0, 3, 1, 2)
        x = F.relu(x)
        feats = []
        for i in range(self.n_stages):
            x = self._stage(i, x, train)
            feats.append(x)
        return feats


for _name in RESNET_SPECS:
    registry.MODEL.register(_name, (lambda n: lambda **kw: ResNet(resnet_type=n, **kw))(_name))


def resnet_frozen_prefixes(freeze_at: int) -> List[str]:
    """The ``ResNet`` parameter prefixes that ``freeze_at`` freezes: the
    stem at 1 and more, then ``layer1`` .. ``layer4`` at 2 .. 5."""
    prefixes = ['conv1', 'bn1', 'stem.'] if freeze_at >= 1 else []
    return prefixes + [f'layer{i - 1}' for i in range(2, 6) if freeze_at >= i]


@registry.MODEL.register()
class ResNetEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/resnet.py``
    ``ResNetEncoder``), with the same config keys.  ``forward(x, train)``
    takes NHWC ``[B, H, W, in_channels]`` (``[B, H/2, W/2, 4·in_channels]``
    with ``stem='s2d_input'``) and returns the NCHW features.
    ``pretrained`` and ``freeze_at`` are the trainer's business, as in the
    JAX package; ``batchnorm_trainable=False`` pins the running statistics.
    """

    def set_default_config(self):
        self.config.update(dict(
            resnet_type='resnet50',
            include_conv5=True,
            batchnorm_trainable=True,
            pretrained=False,
            freeze_at=0,
            output_stride=32,
            with_cp=(False, False, False, False),
            in_channels=3,
            se_ratio=None,
            gc_ratio=None,
            stem='conv',
            maxpool_impl='reduce_window',
            pack2_layer1=False,
            dtype='float32',
        ))

    def __init__(self, config=None):
        super().__init__(config)
        c = self.config
        self.resnet = ResNet(
            resnet_type=c.resnet_type, output_stride=c.output_stride,
            include_conv5=c.include_conv5, bn_frozen=not c.batchnorm_trainable,
            with_cp=tuple(c.with_cp), se_ratio=c.se_ratio, gc_ratio=c.gc_ratio,
            stem=c.get('stem', 'conv'),
            maxpool_impl=c.get('maxpool_impl', 'reduce_window'),
            pack2_layer1=c.get('pack2_layer1', False),
            in_channels=int(c.get('in_channels', 3)))

    def forward(self, x, train: bool = False):
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return self.resnet(x, train)

    def frozen_param_prefixes(self) -> List[str]:
        """Parameter prefixes the optimizer leaves out for ``freeze_at``
        (the JAX package's ``resnet/conv1`` .. ``resnet/layer4``)."""
        return ['resnet.' + p for p in resnet_frozen_prefixes(int(self.config.freeze_at))]


def make_layer(block, in_channel: int, basic_out_channel: int, blocks: int, stride: int = 1,
               dilation: int = 1, **kw) -> ResNetStage:
    """The reference's spelling of one ResNet stage: a :class:`ResNetStage`
    of ``blocks`` blocks of ``basic_out_channel`` filters on ``in_channel``
    inputs, the shortcut where the stride or the width changes."""
    return ResNetStage(block, in_channel, basic_out_channel, blocks, stride, dilation, **kw)


def patch_first_conv(weight: torch.Tensor, new_in_channels: int,
                     default_in_channels: int = 3) -> torch.Tensor:
    """The reference's spelling of ``util.weight_io.patch_first_conv`` (a
    stem conv's ``[O, I, kh, kw]`` weight for ``new_in_channels`` inputs)."""
    from ever_tpu_torch.util.weight_io import patch_first_conv as patch
    return patch(weight, new_in_channels, default_in_channels)
