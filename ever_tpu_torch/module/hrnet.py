"""HRNetV2 encoders (counterpart of ``ever_tpu/module/hrnet.py``).

``HRNET_WIDTHS`` (W18, W32, W40, W48), ``HighResolutionModule``, the trunk
``HRNet`` returning the four branches' features, and the configurable
``HRNetEncoder`` (``frozen_stages``, ``norm_eval``, ``with_cp``, the SE and
GC branches).  Structure: stem (two 3×3/2 conv-BN-ReLU) → layer1 (four
bottlenecks at 64, 256 out) → transition → stage2 (2 branches, 1 module) →
stage3 (3 branches, 4 modules) → stage4 (4 branches, 3 modules); every
module ends in a full cross-resolution fuse (down by chains of 3×3/2
conv-BN, up by 1×1 conv-BN and nearest upsampling).

Tensors are NCHW inside (in ``channels_last`` memory); ``HRNetEncoder``
takes NHWC, as the JAX package does.  Parameter names are the reference's
vendored ``_hrnet.py`` ones (``conv1``, ``layer1.0.downsample.0``,
``transition1.1.0.0``, ``stage3.2.branches.1.3.conv2``,
``stage4.0.fuse_layers.3.0.2.1``), so a reference file loads as it is and
``util.weight_io`` maps the JAX package's names one to one.  The nearest
upsampling of the fuse is a broadcast (``ops.upsample_nearest_int``),
whose backward is a plain sum.

The JAX package's TPU layout ``pack_branches=True`` computes the same
function with the same parameters, so it changes nothing here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import (BatchNorm2d, Sequential, checkpointed,
                                       upsample_nearest_int)
from ever_tpu_torch.module.resnet import BasicBlock, Bottleneck, _conv

__all__ = ['HighResolutionModule', 'HRNet', 'HRNetEncoder', 'HRNET_WIDTHS']

HRNET_WIDTHS = {
    'hrnetv2_w18': (18, 36, 72, 144),
    'hrnetv2_w32': (32, 64, 128, 256),
    'hrnetv2_w40': (40, 80, 160, 320),
    'hrnetv2_w48': (48, 96, 192, 384),
}
# (num_modules, blocks_per_branch) for stages 2-4: standard HRNetV2
STAGE_MODULES = (1, 4, 3)
BLOCKS_PER_BRANCH = 4


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, bn_frozen: bool,
             relu: bool) -> Sequential:
    layers = [_conv(cin, cout, kernel, stride), BatchNorm2d(cout, frozen=bn_frozen)]
    return Sequential(*layers, nn.ReLU()) if relu else Sequential(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks (``branches.{i}.{b}``) and the full
    fuse: output i is ReLU of the sum over j of branch j brought to branch
    i's width and size (``fuse_layers.{i}.{j}``: for j > i a 1×1 conv-BN,
    upsampled by 2^(j−i); for j < i i−j 3×3/2 conv-BN steps, ReLU between
    them; branch i itself), summed in order of j."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 bn_frozen: bool = False, se_ratio=None, gc_ratio=None, pack: bool = False):
        super().__init__()
        del pack                  # a TPU layout of the same function
        self.channels = tuple(channels)
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.ModuleList(BasicBlock(c, c, bn_frozen=bn_frozen, se_ratio=se_ratio,
                                     gc_ratio=gc_ratio) for _ in range(num_blocks))
            for c in channels)
        if n == 1:
            self.fuse_layers = None
            return
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, 1, bn_frozen, False))
                elif j < i:
                    row.append(Sequential(*(
                        _conv_bn(channels[j], channels[i] if s == i - j - 1 else channels[j],
                                 3, 2, bn_frozen, s < i - j - 1)
                        for s in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: List[torch.Tensor], train: bool = False) -> List[torch.Tensor]:
        outs = []
        for x, blocks in zip(xs, self.branches):
            for blk in blocks:
                x = blk(x, train)
            outs.append(x)
        if self.fuse_layers is None:
            return outs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j] if layer is None else layer(outs[j], train)
                if j > i:
                    y = upsample_nearest_int(y, 2 ** (j - i))
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNetV2 trunk: NCHW ``[B, in_channels, H, W]`` in, the four branches'
    features at strides 4, 8, 16 and 32 out.  ``transition{t}.{i}`` adapts
    branch i to the next stage's width by a 3×3 conv-BN-ReLU where it
    differs, and makes the new branch by one more Sequential level of a
    3×3/2 conv-BN-ReLU from the last branch (the reference's layout)."""

    def __init__(self, hrnet_type: str = 'hrnetv2_w18', bn_frozen: bool = False,
                 se_ratio=None, gc_ratio=None, pack_branches: bool = False,
                 in_channels: int = 3):
        super().__init__()
        del pack_branches         # a TPU layout of the same function
        widths = HRNET_WIDTHS[hrnet_type]
        self.conv1 = _conv(in_channels, 64, 3, 2)
        self.bn1 = BatchNorm2d(64, frozen=bn_frozen)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = BatchNorm2d(64, frozen=bn_frozen)
        self.layer1 = nn.ModuleList(
            Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0, bn_frozen=bn_frozen)
            for b in range(4))
        pre = [256]
        for t, n_branches in enumerate((2, 3, 4)):
            layers = []
            for i in range(n_branches):
                if i < len(pre):
                    layers.append(_conv_bn(pre[i], widths[i], 3, 1, bn_frozen, True)
                                  if pre[i] != widths[i] else None)
                else:
                    layers.append(Sequential(_conv_bn(pre[-1], widths[i], 3, 2, bn_frozen,
                                                      True)))
            self.add_module(f'transition{t + 1}', nn.ModuleList(layers))
            self.add_module(f'stage{t + 2}', nn.ModuleList(
                HighResolutionModule(widths[:n_branches], BLOCKS_PER_BRANCH, bn_frozen,
                                     se_ratio, gc_ratio)
                for _ in range(STAGE_MODULES[t])))
            pre = list(widths[:n_branches])

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.relu(self.bn2(self.conv2(x), train))
        for blk in self.layer1:
            x = blk(x, train)
        xs = [x]
        for t in (1, 2, 3):
            transition = getattr(self, f'transition{t}')
            xs = [(xs[i] if layer is None else layer(xs[i], train)) if i < len(xs)
                  else layer(xs[-1], train)
                  for i, layer in enumerate(transition)]
            for module in getattr(self, f'stage{t + 1}'):
                xs = module(xs, train)
        return xs


for _name in HRNET_WIDTHS:
    registry.MODEL.register(_name, (lambda n: lambda **kw: HRNet(hrnet_type=n, **kw))(_name))


@registry.MODEL.register()
class HRNetEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/hrnet.py``
    ``HRNetEncoder``), with the same config keys.  ``forward(x, train)``
    takes NHWC ``[B, H, W, 3]`` (``in_channels`` in the config for
    another count), computes in ``config.dtype`` and returns the four NCHW
    features.  ``norm_eval`` pins every BatchNorm to its running
    statistics; ``with_cp`` recomputes the trunk in the backward pass
    (``torch.utils.checkpoint``), its recomputation leaving the running
    statistics alone, as JAX's ``nn.remat`` does; ``frozen_stages`` is the
    optimizer's business, through :meth:`frozen_param_prefixes`.
    ``pretrained`` and ``weight_path`` are the trainer's, as in the JAX
    package."""

    def set_default_config(self):
        self.config.update(dict(
            hrnet_type='hrnetv2_w18',
            pretrained=False,
            weight_path=None,
            norm_eval=False,
            frozen_stages=-1,
            with_cp=False,
            se_ratio=None,
            gc_ratio=None,
            pack_branches=False,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self.hrnet = HRNet(hrnet_type=c.hrnet_type, bn_frozen=bool(c.norm_eval),
                           se_ratio=c.se_ratio, gc_ratio=c.gc_ratio,
                           pack_branches=c.get('pack_branches', False),
                           in_channels=int(c.get('in_channels', 3)))

    def _trunk(self, x, train: bool):
        if not (self.config.with_cp and torch.is_grad_enabled()):
            return self.hrnet(x, train)
        return checkpointed(self.hrnet, lambda x: self.hrnet(x, train), x)

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return list(self._trunk(x, train))

    def output_channels(self) -> Tuple[int, ...]:
        return HRNET_WIDTHS[self.config.hrnet_type]

    def frozen_param_prefixes(self) -> List[str]:
        """``frozen_stages``: -1 freezes nothing, 0 the stem, k ≥ 1 the stem,
        ``layer1`` and stages 2..k with their transitions in."""
        fs = int(self.config.frozen_stages)
        prefixes = []
        if fs >= 0:
            prefixes += ['hrnet.conv1', 'hrnet.bn1', 'hrnet.conv2', 'hrnet.bn2']
        if fs >= 1:
            prefixes += ['hrnet.layer1']
        for s in (2, 3, 4):
            if fs >= s:
                prefixes += [f'hrnet.stage{s}', f'hrnet.transition{s - 1}']
        return prefixes
