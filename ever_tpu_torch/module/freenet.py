"""FreeNet: patch-free whole-scene hyperspectral image classification
(counterpart of ``ever_tpu/module/freenet.py``).

An encoder of conv-GroupNorm-ReLU blocks, each closed by a spectral
(channel) attention gate, with 2×2 max pools between the stages; a
lateral-fusion decoder that upsamples each level bilinearly to the next
lateral's size and adds the lateral's 1×1 projection; a 1×1 pixel
classifier.  GroupNorm, not BatchNorm: hyperspectral scenes train as one
whole scene a batch.  Training takes sparse ground truth (the unlabelled
pixels ``ignore_index``) and the cross-entropy counts the labelled pixels
only.

``FreeNet`` takes NHWC ``[N, H, W, bands]``, as the JAX package's, and
computes NCHW inside.  The pools are ``'VALID'`` and floor odd sizes; the
decoder's upsamplings are matrix products (:func:`~ever_tpu_torch.module.
ops.bilinear_nchw`), whose backward adds without atomics, at ratios that
need not be whole numbers (145 → 72 → 36 → 18 and back).  The spectral
gate's global pool accumulates in float32, as the JAX package's
``global_avg_pool``, and so do the decoder's resizes.  No kernel of the
port is on this path: the JAX model reaches no Pallas kernel (its pool is
2×2, not the 3×3/2 window of K8).

Under a spatial step (``parallel/spatial.py``) the convs and GroupNorms
take their strip forms, the spectral gate squeezes the whole tile (its
1×1 convs on the squeezed map, whole on every rank), the pools are
``module/ops.py``'s ``max_pool`` (a strip of odd height raises, naming it)
and the decoder's resizes the strips' rows of the whole tile's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module.ops import Conv2d, ConvBlock, _nchw_mean, bilinear_nchw, max_pool
from ever_tpu_torch.parallel.spatial import whole

__all__ = ['SpectralAttention', 'FreeNet']


@registry.OP.register()
class SpectralAttention(nn.Module):
    """Band (channel) gate of an NCHW tensor: the global spatial mean, a 1×1
    conv down to ``max(C // reduction, 4)`` channels with ReLU, a 1×1 conv
    back up with sigmoid, times the input.  Under a spatial step the mean
    is the whole tile's (the strips' sums added over the axis), whole on
    every rank, and the convs run on it under ``whole()``; a rank's
    gradient of it is its strip's share, which the all-reduce sums."""

    def __init__(self, in_channels: int, reduction: int = 4):
        super().__init__()
        hidden = max(in_channels // reduction, 4)
        self.reduce = Conv2d(in_channels, hidden, 1, bias=True)
        self.expand = Conv2d(hidden, in_channels, 1, bias=True)

    def forward(self, x):
        s = _nchw_mean(x)
        with whole():
            s = torch.sigmoid(self.expand(F.relu(self.reduce(s))))
        return x * s


class _FreeNetBlock(nn.Module):
    """Two 3×3 conv-GroupNorm-ReLU blocks and the spectral gate."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, features, 3, norm='gn')
        self.conv2 = ConvBlock(features, features, 3, norm='gn')
        self.spec_attn = SpectralAttention(features)

    def forward(self, x):
        return self.spec_attn(self.conv2(self.conv1(x)))


@registry.MODEL.register()
class FreeNet(ERModule):
    """Whole-scene hyperspectral classifier.

    ``forward(x, y=None, train=False, generator=None)`` (it draws nothing,
    so the train step's generator goes unused): with ``train=True`` and labels
    ``y`` ``[N, H, W]`` (unlabelled pixels ``loss.ignore_index``) the loss
    dict ``{cls_loss}``; otherwise the per-pixel class probabilities
    ``[N, H, W, classes]`` in float32.  ``in_channels`` is the number of
    bands (the JAX package infers it from the input).  Modules are named
    as the JAX package's: ``enc{i}`` (``conv1``, ``conv2``,
    ``spec_attn``), ``lat{i}``, ``fuse{i}``, ``classifier``.
    """

    def set_default_config(self):
        self.config.update(dict(
            in_channels=200,
            stage_channels=(96, 128, 192, 256),
            classes=16,
            loss=dict(ignore_index=255),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        chans = [int(c) for c in self.config.stage_channels]
        self.n_stages = len(chans)
        for i, c in enumerate(chans):
            self.add_module(f'enc{i}', _FreeNetBlock(
                int(self.config.in_channels) if i == 0 else chans[i - 1], c))
        for i in range(len(chans) - 2, -1, -1):
            self.add_module(f'lat{i}', ConvBlock(chans[i], chans[i], 1, norm='gn'))
            self.add_module(f'fuse{i}', ConvBlock(chans[i + 1], chans[i], 3, norm='gn'))
        self.classifier = Conv2d(chans[0], int(self.config.classes), 1, bias=True)

    def forward(self, x, y=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = x.to(getattr(torch, self.config.dtype)).permute(0, 3, 1, 2)
        laterals = []
        for i in range(self.n_stages):
            h = getattr(self, f'enc{i}')(h)
            laterals.append(h)
            if i != self.n_stages - 1:
                h = max_pool(h.permute(0, 2, 3, 1), 2, 2, 'VALID').permute(0, 3, 1, 2)
        out = laterals[-1]
        for i in range(self.n_stages - 2, -1, -1):
            out = bilinear_nchw(out, tuple(laterals[i].shape[2:]))
            out = getattr(self, f'fuse{i}')(out) + getattr(self, f'lat{i}')(laterals[i])
        logits = self.classifier(out).permute(0, 2, 3, 1).float()
        if train and y is not None:
            ignore = int(self.config.loss.get('ignore_index', 255))
            return dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y, ignore_index=ignore))
        return torch.softmax(logits, dim=-1)
