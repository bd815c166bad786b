"""Bi-temporal change detection models (counterpart of
``ever_tpu/module/change.py``): ``ChangeMixin``/``ChangeStar``,
``ChangeMask`` and ``ChangeOS``.

Bi-temporal input: ``x`` is ``[N, H, W, 2C]`` (t1 ‖ t2 on the channels, as
the LEVIR-CD and xView2 readers yield it) or a tuple ``(x1, x2)``.  Each
model runs **one** encoder pass over the stacked ``[2N]`` batch, so
BatchNorm pools its statistics over both dates.  Labels are a dict (or, for
ChangeStar, a tuple) as each model's docstring says.

Flax infers input widths, torch does not, so the layers whose configured
widths the JAX models ignore are built from the real ones: every decoder
takes ``fpn.out_channels`` per date (ChangeMask's change decoder 3× that,
ChangeOS's damage decoder 2×), and ``ChangeMixin`` takes
``decoder.out_channels`` per date.  ``order_stacked=True`` is a TPU layout
of ``ChangeMixin``'s first conv with the same parameters and outputs; the
port computes it as the plain both-orders batch.  The ×4 logit upsampling
is the matrix-product form (``module/fpn.py`` ``upsample_bilinear_nchw``),
whose backward has no atomics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module.fpn import FPN, AssymetricDecoder, logits_nhwc, upsample_bilinear_nchw
from ever_tpu_torch.module.ops import Conv2d, ConvBlock
from ever_tpu_torch.module.resnet import ResNetEncoder

__all__ = ['ChangeMixin', 'ChangeStar', 'ChangeMask', 'ChangeOS', 'split_bitemporal']


def split_bitemporal(x):
    """``[N, H, W, 2C]`` → ``(t1, t2)``; a tuple or list passes through."""
    if isinstance(x, (tuple, list)):
        return x[0], x[1]
    c = x.shape[-1] // 2
    return x[..., :c], x[..., c:]


@registry.OP.register()
class ChangeMixin(nn.Module):
    """ChangeStar's change detector (ICCV'21): both temporal orders of the
    dense features, ``[f1‖f2 ; f2‖f1]`` as one ``[2N]`` batch (BatchNorm
    pools over both orders), through ``num_convs`` 3×3 conv → BN → ReLU
    blocks ``inner_channels`` wide (``conv{i}``), a 3×3 ``cls`` conv with
    bias to one channel and a bilinear ×``scale_factor``.  ``forward(f1,
    f2, train)`` takes NCHW features ``in_channels`` wide each and returns
    the float32 NHWC logits ``(c12, c21)``.  ``order_stacked`` is accepted
    for the JAX configs: the same function (module docstring)."""

    def __init__(self, in_channels: int = 256, inner_channels: int = 16,
                 num_convs: int = 4, scale_factor: float = 4.0,
                 order_stacked: bool = False):
        super().__init__()
        self.num_convs, self.scale_factor = int(num_convs), float(scale_factor)
        width = 2 * int(in_channels)
        for i in range(self.num_convs):
            self.add_module(f'conv{i}', ConvBlock(width, inner_channels, 3, norm='bn'))
            width = inner_channels
        self.cls = Conv2d(width, 1, 3, bias=True)

    def forward(self, f1, f2, train: bool = False):
        x = torch.cat([torch.cat([f1, f2], dim=1), torch.cat([f2, f1], dim=1)], dim=0)
        for i in range(self.num_convs):
            x = getattr(self, f'conv{i}')(x, train)
        x = self.cls(x)
        if self.scale_factor != 1:
            x = upsample_bilinear_nchw(x, self.scale_factor)
        logits = x.permute(0, 2, 3, 1).float()
        n = f1.shape[0]
        return logits[:n], logits[n:]


class _Siamese(ERModule):
    """What the three detectors share: the ResNet encoder and FPN run once
    over the stacked ``[2N]`` batch of both dates."""

    def _trunk(self):
        c = self.config
        enc = c.encoder.to_dict()
        enc.setdefault('dtype', c.dtype)
        self.encoder = ResNetEncoder(enc)
        self.fpn = FPN(**c.fpn.to_dict())

    def _decoder(self, per_level: int) -> AssymetricDecoder:
        """A decoder over ``per_level`` FPN outputs concatenated per level."""
        width = per_level * int(self.config.fpn.out_channels)
        return AssymetricDecoder(**dict(self.config.decoder.to_dict(), in_channels=width))

    def _features(self, x, train: bool):
        """(n, the FPN levels of the stacked batch, NCHW)."""
        x1, x2 = split_bitemporal(x)
        stacked = torch.cat([x1, x2], dim=0).to(getattr(torch, self.config.dtype))
        return x1.shape[0], list(self.fpn(self.encoder(stacked, train), train))


@registry.MODEL.register()
class ChangeStar(_Siamese):
    """Siamese FarSeg-style segmentation + ``ChangeMixin`` (ChangeStar,
    ICCV'21).

    Train labels: a dict with ``masks`` ``[N, H, W, 2]`` (or ``[N, H, W]``,
    one date) and optionally ``change`` ``[N, H, W]``, or the tuple
    ``(m1[, m2], change)``.  Without ``change`` and with both masks, the
    change label is ``m1 != m2`` where both are valid.  Losses:
    ``seg_loss`` (the BCE of s1, plus that of s2) and ``change_loss`` (the
    BCE of c12, averaged with c21's under ``loss.symmetry``).  Eval returns
    ``(σ(s1), σ(s2), ½(σ(c12) + σ(c21)))``.
    """

    def set_default_config(self):
        self.config.update(dict(
            encoder=dict(resnet_type='resnet50'),
            fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
            decoder=dict(in_channels=256, out_channels=256,
                         in_feat_output_strides=(4, 8, 16, 32),
                         out_feat_output_stride=4),
            changemixin=dict(in_channels=512, inner_channels=16, num_convs=4,
                             scale_factor=4.0, order_stacked=True),
            classes=1,
            loss=dict(ignore_index=255, seg=dict(), change=dict(), symmetry=True),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self._trunk()
        self.decoder = self._decoder(1)
        width = int(c.decoder.out_channels)
        self.seg_cls = Conv2d(width, int(c.classes), 1, bias=True)
        self.changemixin = ChangeMixin(**dict(c.changemixin.to_dict(), in_channels=width))

    def forward(self, x, y=None, train: bool = False, generator=None):
        n, feats = self._features(x, train)
        dense = self.decoder(feats, train)
        seg = logits_nhwc(self.seg_cls, dense)
        s1, s2 = seg[:n], seg[n:]
        c12, c21 = self.changemixin(dense[:n], dense[n:], train)
        if not (train and y is not None):
            return (torch.sigmoid(s1), torch.sigmoid(s2),
                    0.5 * (torch.sigmoid(c12) + torch.sigmoid(c21)))
        lcfg = self.config.loss
        ignore = int(lcfg.get('ignore_index', 255))
        masks = y['masks'] if isinstance(y, dict) else y
        if isinstance(masks, (tuple, list)):
            # the tuple form: (m1[, m2], change)
            parts = list(masks)
            change_t = parts.pop() if len(parts) > 1 else None
            m1 = parts[0]
            m2 = parts[1] if len(parts) > 1 else None
            if change_t is not None and not isinstance(y, dict):
                y = dict(masks=None, change=change_t)
        elif masks.ndim == 4:
            m1 = masks[..., 0]
            m2 = masks[..., 1] if masks.shape[-1] > 1 else None
        else:
            m1, m2 = masks, None            # [N, H, W]: one date
        out = dict(seg_loss=L.binary_cross_entropy_with_logits(
            s1[..., 0], m1.float(), ignore_index=ignore))
        if m2 is not None:
            out['seg_loss'] = out['seg_loss'] + L.binary_cross_entropy_with_logits(
                s2[..., 0], m2.float(), ignore_index=ignore)
        change = y.get('change') if isinstance(y, dict) else None
        if change is None and m2 is not None:
            valid = (m1 != ignore) & (m2 != ignore)
            change = torch.where(valid, (m1 != m2).int(), torch.full_like(m1, ignore).int())
        if change is not None:
            cf = change.float()
            out['change_loss'] = L.binary_cross_entropy_with_logits(
                c12[..., 0], cf, ignore_index=ignore)
            if lcfg.get('symmetry', True):
                out['change_loss'] = 0.5 * (out['change_loss'] + L.binary_cross_entropy_with_logits(
                    c21[..., 0], cf, ignore_index=ignore))
        return out


@registry.MODEL.register()
class ChangeMask(_Siamese):
    """Semantic change + binary change (ChangeMask, ISPRS'22): a semantic
    decoder over the stacked FPN levels (shared by both dates) and a change
    decoder over ``[f1 ‖ f2 ‖ |f1 − f2|]`` at every level.

    Train labels: ``{'masks': [N, H, W, 2], 'change': [N, H, W]}``.
    Losses: ``sem_loss`` (the CE of s1 plus that of s2), ``change_loss``
    (the BCE of c) and, with ``loss.consistency_weight`` w > 0,
    ``consistency_loss`` = w · the mean over all N·H·W·C elements of
    ``unchanged · |p1 − p2|``.  Eval returns ``(softmax(s1), softmax(s2),
    σ(c))``.
    """

    def set_default_config(self):
        self.config.update(dict(
            encoder=dict(resnet_type='resnet50'),
            fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
            decoder=dict(in_channels=256, out_channels=256,
                         in_feat_output_strides=(4, 8, 16, 32),
                         out_feat_output_stride=4),
            classes=7,
            loss=dict(ignore_index=255, sem=dict(), change=dict(), consistency_weight=0.0),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self._trunk()
        self.sem_decoder = self._decoder(1)
        self.change_decoder = self._decoder(3)
        width = int(c.decoder.out_channels)
        self.sem_cls = Conv2d(width, int(c.classes), 1, bias=True)
        self.change_cls = Conv2d(width, 1, 1, bias=True)

    def forward(self, x, y=None, train: bool = False, generator=None):
        n, feats = self._features(x, train)
        sem = logits_nhwc(self.sem_cls, self.sem_decoder(feats, train))
        s1, s2 = sem[:n], sem[n:]
        fused = [torch.cat([f[:n], f[n:], (f[:n] - f[n:]).abs()], dim=1) for f in feats]
        c = logits_nhwc(self.change_cls, self.change_decoder(fused, train))
        if not (train and y is not None):
            return torch.softmax(s1, -1), torch.softmax(s2, -1), torch.sigmoid(c)
        lcfg = self.config.loss
        ignore = int(lcfg.get('ignore_index', 255))
        masks, change = y['masks'], y['change']
        out = dict(
            sem_loss=(L.softmax_ce_loss_with_logits(s1, masks[..., 0], ignore_index=ignore)
                      + L.softmax_ce_loss_with_logits(s2, masks[..., 1], ignore_index=ignore)),
            change_loss=L.binary_cross_entropy_with_logits(
                c[..., 0], change.float(), ignore_index=ignore))
        w = float(lcfg.get('consistency_weight', 0.0))
        if w > 0:
            unchanged = (change == 0).float()[..., None]
            diff = (torch.softmax(s1, -1) - torch.softmax(s2, -1)).abs()
            out['consistency_loss'] = w * (unchanged * diff).mean()
        return out


@registry.MODEL.register()
class ChangeOS(_Siamese):
    """Building damage assessment (ChangeOS, RSE'21): a localisation
    decoder over the pre-event levels ``f[:n]`` and a damage decoder over
    ``[f1 ‖ f2]``.

    Train labels: ``{'loc': [N, H, W] 0/1, 'damage': [N, H, W] classes}``;
    losses ``loc_loss`` (BCE) and ``damage_loss`` (CE).  Eval returns
    ``(σ(loc), softmax(damage))``; whole scenes go through
    ``magic.tiled_inference`` with a ``predict_fn`` that concatenates the
    two.
    """

    def set_default_config(self):
        self.config.update(dict(
            encoder=dict(resnet_type='resnet50'),
            fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
            decoder=dict(in_channels=256, out_channels=256,
                         in_feat_output_strides=(4, 8, 16, 32),
                         out_feat_output_stride=4),
            damage_classes=5,
            loss=dict(ignore_index=255),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self._trunk()
        self.loc_decoder = self._decoder(1)
        self.dam_decoder = self._decoder(2)
        width = int(c.decoder.out_channels)
        self.loc_cls = Conv2d(width, 1, 1, bias=True)
        self.dam_cls = Conv2d(width, int(c.damage_classes), 1, bias=True)

    def forward(self, x, y=None, train: bool = False, generator=None):
        n, feats = self._features(x, train)
        loc = logits_nhwc(self.loc_cls, self.loc_decoder([f[:n] for f in feats], train))
        fused = [torch.cat([f[:n], f[n:]], dim=1) for f in feats]
        dam = logits_nhwc(self.dam_cls, self.dam_decoder(fused, train))
        if not (train and y is not None):
            return torch.sigmoid(loc), torch.softmax(dam, -1)
        ignore = int(self.config.loss.get('ignore_index', 255))
        return dict(
            loc_loss=L.binary_cross_entropy_with_logits(
                loc[..., 0], y['loc'].float(), ignore_index=ignore),
            damage_loss=L.softmax_ce_loss_with_logits(dam, y['damage'], ignore_index=ignore))
