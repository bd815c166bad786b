"""DenseNet encoders (counterpart of ``ever_tpu/module/densenet.py``).

densenet121/161/169/201: a 7×7/2 stem with BN, ReLU and a 3×3/2 max pool,
then four dense blocks (each layer BN-ReLU-1×1 conv to ``4·growth``,
BN-ReLU-3×3 conv to ``growth``, concatenated onto its input) joined by
transitions (BN-ReLU-1×1 conv halving the width, 2×2/2 average pool).
``DenseNet`` returns the four blocks' outputs, d121: (256, 512, 1024,
1024) wide at strides 4 to 32.  ``memory_efficient`` recomputes each dense
layer in the backward pass (``ops.checkpointed``: the recomputation leaves
the running statistics alone, as JAX's ``nn.remat`` does).

Tensors are NCHW inside (in ``channels_last`` memory); ``DenseNetEncoder``
takes NHWC, as the JAX package does.  Parameter and buffer names follow
torchvision (``features.conv0``, ``features.norm0``,
``features.denseblock{b}.denselayer{l}.{norm1,conv1,norm2,conv2}``,
``features.transition{b}.{norm,conv}``), so a reference file loads by
name.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import BatchNorm2d, Conv2d, avg_pool, checkpointed, max_pool

__all__ = ['DenseNet', 'DenseNetEncoder', 'DenseLayer', 'DENSENET_SPECS']

# name → (growth_rate, block_config, init_features)
DENSENET_SPECS = {
    'densenet121': (32, (6, 12, 24, 16), 64),
    'densenet161': (48, (6, 12, 36, 24), 96),
    'densenet169': (32, (6, 12, 32, 32), 64),
    'densenet201': (32, (6, 12, 48, 32), 64),
}


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    """Bias-free conv with symmetric padding (torch's convention)."""
    return Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2)


class DenseLayer(nn.Module):
    """BN-ReLU-1×1 conv → BN-ReLU-3×3 conv, its ``growth_rate`` maps
    concatenated after its input's."""

    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4,
                 bn_frozen: bool = False):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = BatchNorm2d(in_channels, frozen=bn_frozen)
        self.conv1 = _conv(in_channels, mid, 1)
        self.norm2 = BatchNorm2d(mid, frozen=bn_frozen)
        self.conv2 = _conv(mid, growth_rate, 3)

    def forward(self, x, train: bool = False):
        y = self.conv1(F.relu(self.norm1(x, train)))
        y = self.conv2(F.relu(self.norm2(y, train)))
        return torch.cat([x, y], dim=1)


class _Transition(nn.Module):
    def __init__(self, in_channels: int, bn_frozen: bool = False):
        super().__init__()
        self.norm = BatchNorm2d(in_channels, frozen=bn_frozen)
        self.conv = _conv(in_channels, in_channels // 2, 1)

    def forward(self, x, train: bool = False):
        x = self.conv(F.relu(self.norm(x, train)))
        return avg_pool(x.permute(0, 2, 3, 1), 2, 2, 'VALID').permute(0, 3, 1, 2)


class DenseNet(nn.Module):
    """The trunk: NCHW in, the four dense blocks' outputs out."""

    def __init__(self, densenet_type: str = 'densenet121', memory_efficient: bool = False,
                 bn_frozen: bool = False):
        super().__init__()
        growth, blocks, c = DENSENET_SPECS[densenet_type]
        self.memory_efficient = memory_efficient
        self.n_blocks = len(blocks)
        self.features = nn.Module()
        self.features.conv0 = _conv(3, c, 7, 2)
        self.features.norm0 = BatchNorm2d(c, frozen=bn_frozen)
        for b, n_layers in enumerate(blocks, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                block.add_module(f'denselayer{li}', DenseLayer(c, growth, bn_frozen=bn_frozen))
                c += growth
            self.features.add_module(f'denseblock{b}', block)
            if b != len(blocks):
                self.features.add_module(f'transition{b}', _Transition(c, bn_frozen))
                c //= 2

    def _layer(self, layer: DenseLayer, x, train: bool):
        if not (self.memory_efficient and torch.is_grad_enabled()):
            return layer(x, train)
        return checkpointed(layer, lambda x: layer(x, train), x)

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        f = self.features
        x = F.relu(f.norm0(f.conv0(x), train))
        x = max_pool(x.permute(0, 2, 3, 1), 3, 2, padding=((1, 1), (1, 1))).permute(0, 3, 1, 2)
        feats = []
        for b in range(1, self.n_blocks + 1):
            for layer in getattr(f, f'denseblock{b}').children():
                x = self._layer(layer, x, train)
            feats.append(x)
            if b != self.n_blocks:
                x = getattr(f, f'transition{b}')(x, train)
        return feats


for _name in DENSENET_SPECS:
    registry.MODEL.register(_name, (lambda n: lambda **kw: DenseNet(densenet_type=n, **kw))(_name))


@registry.MODEL.register()
@registry.MODEL.register('densenet_encoder')
class DenseNetEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/densenet.py``
    ``DenseNetEncoder``), with the same config keys.  ``forward(x,
    train)`` takes NHWC ``[B, H, W, 3]``, computes in ``config.dtype`` and
    returns the four NCHW features; ``pretrained`` is the trainer's
    business, as in the JAX package."""

    def set_default_config(self):
        self.config.update(dict(
            densenet_type='densenet121',
            pretrained=False,
            memory_efficient=False,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.densenet = DenseNet(densenet_type=self.config.densenet_type,
                                 memory_efficient=bool(self.config.memory_efficient))

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return self.densenet(x, train)

    def out_channels(self) -> Tuple[int, ...]:
        """The four blocks' widths."""
        growth, blocks, c = DENSENET_SPECS[self.config.densenet_type]
        chans = []
        for n in blocks:
            c += n * growth
            chans.append(c)
            c //= 2
        return tuple(chans)
