"""ConvNeXt encoders (counterpart of ``ever_tpu/module/convnext.py``).

A 4×4/4 patchify stem with LayerNorm, per stage a LayerNorm and a 2×2/2
downsampling conv (the stem and the downsamples pad as lax's ``'SAME'``:
only where the size does not divide, the odd pixel after), and blocks of
depthwise 7×7 (with bias) → LayerNorm → Linear 4× → GELU → Linear →
``gamma`` (layer scale, 1e-6 at init) → drop-path, plus the input.
``ConvNeXt`` returns each stage's output, convnext_tiny (96, 192, 384,
768) wide at strides 4 to 32.

The GELU is the tanh approximation (flax's ``nn.gelu``, as the JAX
package's); the reference's torch ConvNeXt takes the exact one, so a
loaded reference file computes slightly differently there (``ROADMAP.md``
§C).  The LayerNorms have eps 1e-6 and take their statistics in float32
(float64 for float64 input).  Drop-path's rate rises linearly from 0 at
the first block to ``drop_path_rate`` at the last; in training a block
drops its branch for whole samples, drawn from ``forward``'s
``generator``.

Tensors are NCHW inside (in ``channels_last`` memory, so the MLP's
channels-last view is free); ``ConvNeXtEncoder`` takes NHWC, as the JAX
package does.  Parameter names follow DINOv3's vendored ConvNeXt
(``downsample_layers.{s}.{0,1}``,
``stages.{s}.{b}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``pwconv1`` and
``pwconv2`` as ``nn.Linear``), so a reference file loads by name; its
``gamma`` is the block's own parameter, applied as ``vit.LayerScale``
applies its own.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import Conv2d, LayerNorm2d, sample_dropout
from ever_tpu_torch.module.vit import LayerNorm, Linear

__all__ = ['ConvNeXt', 'ConvNeXtEncoder', 'ConvNeXtBlock', 'CONVNEXT_SPECS']

# name → (depths, dims)
CONVNEXT_SPECS = {
    'convnext_tiny': ((3, 3, 9, 3), (96, 192, 384, 768)),
    'convnext_small': ((3, 3, 27, 3), (96, 192, 384, 768)),
    'convnext_base': ((3, 3, 27, 3), (128, 256, 512, 1024)),
    'convnext_large': ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layerscale_init: float = 1e-6, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dwconv = Conv2d(dim, dim, 7, 1, 'same', groups=dim, bias=True)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layerscale_init)))
                      if layerscale_init else None)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        h = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        h = self.pwconv2(F.gelu(self.pwconv1(h), approximate='tanh'))
        if self.gamma is not None:
            h = h * self.gamma.to(h.dtype)
        return x + sample_dropout(h.permute(0, 3, 1, 2), self.drop_path_rate, train, generator)


class ConvNeXt(nn.Module):
    """The trunk: NCHW in, the four stages' outputs out."""

    def __init__(self, model_name: str = 'convnext_tiny', drop_path_rate: float = 0.0):
        super().__init__()
        depths, dims = CONVNEXT_SPECS[model_name]
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            Conv2d(3, dims[0], 4, 4, 'same', bias=True), LayerNorm2d(dims[0], eps=1e-6))])
        for s in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[s - 1], eps=1e-6),
                Conv2d(dims[s - 1], dims[s], 2, 2, 'same', bias=True)))
        self.stages = nn.ModuleList()
        i = 0
        for s in range(4):
            self.stages.append(nn.ModuleList(
                ConvNeXtBlock(dims[s], drop_path_rate=dpr[i + b]) for b in range(depths[s])))
            i += depths[s]

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        feats = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = block(x, train, generator)
            feats.append(x)
        return feats


for _name in CONVNEXT_SPECS:
    registry.MODEL.register(
        _name, (lambda n: lambda **kw: ConvNeXt(model_name=n, **kw))(_name))


@registry.MODEL.register()
class ConvNeXtEncoder(ERModule):
    """The configurable encoder (``ever_tpu/module/convnext.py``
    ``ConvNeXtEncoder``), with the same config keys.  ``forward(x, train,
    generator)`` takes NHWC ``[B, H, W, 3]``, computes in ``config.dtype``
    and returns the four NCHW features; drop-path draws from ``generator``
    in training."""

    def set_default_config(self):
        self.config.update(dict(
            convnext_type='convnext_tiny',
            drop_path_rate=0.0,
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self.net = ConvNeXt(model_name=self.config.convnext_type,
                            drop_path_rate=float(self.config.drop_path_rate))

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        return self.net(x, train, generator)

    def out_channels(self) -> Tuple[int, ...]:
        return CONVNEXT_SPECS[self.config.convnext_type][1]
