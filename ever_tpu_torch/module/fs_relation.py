"""FarSeg: foreground-scene relation, its head and the full model
(counterpart of ``ever_tpu/module/fs_relation.py``).

``FSRelation`` (FarSeg, CVPR'20), ``FarSegHead`` (FPN → scene pooling →
FSRelation → AssymetricDecoder) and ``FarSeg`` (ResNet encoder + head +
loss), the JAX package's flagship model.  Parameter names follow the
reference torch modules (``scene_encoder.0.0.weight``,
``content_encoders.0.1.running_var``, ``feature_reencoders.0.0.weight``).
The content and re-encoder convs have no bias, as in the JAX package: a
bias before a train-mode BatchNorm cancels.  ``FSRelationV2`` (FarSeg++)
waits for GroupNorm and channel dropout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module.fpn import FPN, AssymetricDecoder, check_widths
from ever_tpu_torch.module.ops import Conv2d, ConvBlock, Sequential, global_avg_pool
from ever_tpu_torch.module.resnet import ResNetEncoder

__all__ = ['FSRelation', 'FarSegHead', 'FarSeg']


def _relation(scene_feat, content_feat):
    """sigmoid(<scene, content>) over the channels, summed in float32: an
    ``[N, 1, H, W]`` map in the content's dtype."""
    r = (scene_feat * content_feat).float().sum(dim=1, keepdim=True)
    return torch.sigmoid(r).to(content_feat.dtype)


class FSRelation(nn.Module):
    """Foreground-scene relation gating: the scene embedding ``[N, C, 1, 1]``
    is projected (per scale with ``scale_aware_proj``), dotted with each
    scale's content encoding, and the sigmoid map gates the re-encoded
    features."""

    def __init__(self, scene_embedding_channels: int,
                 in_channels_list: Sequence[int], out_channels: int,
                 scale_aware_proj: bool = False):
        super().__init__()
        self.scene_embedding_channels = scene_embedding_channels
        self.in_channels_list = tuple(in_channels_list)
        self.scale_aware_proj = scale_aware_proj

        def scene_encoder():
            return Sequential(Conv2d(scene_embedding_channels, out_channels, 1, bias=True),
                              nn.ReLU(),
                              Conv2d(out_channels, out_channels, 1, bias=True))

        self.scene_encoder = (nn.ModuleList(scene_encoder() for _ in in_channels_list)
                              if scale_aware_proj else scene_encoder())
        self.content_encoders = nn.ModuleList(
            ConvBlock(c, out_channels, 1) for c in in_channels_list)
        self.feature_reencoders = nn.ModuleList(
            ConvBlock(c, out_channels, 1) for c in in_channels_list)

    def forward(self, scene_feature, features, train: bool = False):
        check_widths('FSRelation', features, self.in_channels_list)
        check_widths('FSRelation scene encoder', [scene_feature],
                     [self.scene_embedding_channels])
        if self.scale_aware_proj:
            scene_feats = [enc(scene_feature) for enc in self.scene_encoder]
        else:
            scene_feats = [self.scene_encoder(scene_feature)] * len(features)
        content = [enc(f, train) for enc, f in zip(self.content_encoders, features)]
        re_enc = [enc(f, train) for enc, f in zip(self.feature_reencoders, features)]
        return [_relation(s, c) * p for s, c, p in zip(scene_feats, content, re_enc)]


@registry.MODEL.register()
class FarSegHead(ERModule):
    """FPN → scene average pool of the last feature → FSRelation →
    AssymetricDecoder, with the JAX package's config keys.
    ``forward(features, train)`` takes and returns NCHW tensors."""

    def set_default_config(self):
        self.config.update(dict(
            fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
            relation_type='v1',
            fs_relation=dict(scene_embedding_channels=2048,
                             in_channels_list=(256, 256, 256, 256),
                             out_channels=256, scale_aware_proj=True),
            fpn_decoder=dict(in_channels=256, out_channels=256,
                             in_feat_output_strides=(4, 8, 16, 32),
                             out_feat_output_stride=4,
                             classifier_config=dict(scale_factor=4.0, num_classes=1,
                                                    kernel_size=1)),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        if self.config.get('relation_type', 'v1') != 'v1':
            raise NotImplementedError('FarSegHead relation_type v2 (FSRelationV2) is '
                                      'not ported yet (ROADMAP.md A.8)')
        self.fpn = FPN(**self.config.fpn.to_dict())
        self.fs_relation = FSRelation(**self.config.fs_relation.to_dict())
        self.fpn_decoder = AssymetricDecoder(**self.config.fpn_decoder.to_dict())

    def forward(self, feature_list, train: bool = False):
        fpn_feats = self.fpn(feature_list, train)
        scene = global_avg_pool(feature_list[-1].permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        refined = self.fs_relation(scene, list(fpn_feats), train)
        return self.fpn_decoder(refined, train)


@registry.MODEL.register()
class FarSeg(ERModule):
    """FarSeg segmentation model: ResNet encoder + FarSegHead + loss.

    ``forward(x, y=None, train=False, generator=None)`` takes NHWC
    ``[B, H, W, C]`` and computes in ``config.dtype`` (the parameters stay
    float32).  The logits are cast to float32; with ``train=True`` and labels
    ``y`` ``[B, H, W]`` it returns ``cls_loss`` (and ``dice_loss`` when
    ``loss.dice`` is set), otherwise the class probabilities
    ``[B, H, W, classes]``.  FarSeg draws nothing: ``generator`` is taken
    because the train step passes one.
    """

    def set_default_config(self):
        self.config.update(dict(
            encoder=dict(resnet_type='resnet50', pretrained=False, output_stride=32,
                         with_cp=(False, False, False, False)),
            head=dict(
                fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
                fs_relation=dict(scene_embedding_channels=2048,
                                 in_channels_list=(256, 256, 256, 256),
                                 out_channels=256, scale_aware_proj=True),
                fpn_decoder=dict(in_channels=256, out_channels=256,
                                 in_feat_output_strides=(4, 8, 16, 32),
                                 out_feat_output_stride=4),
            ),
            classes=7,
            loss=dict(ignore_index=255, ce=dict(), dice=None),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        dtype = self.config.dtype
        enc_cfg = self.config.encoder.to_dict()
        enc_cfg.setdefault('dtype', dtype)
        self.encoder = ResNetEncoder(enc_cfg)
        head_cfg = self.config.head.to_dict()
        head_cfg['fpn_decoder'] = dict(head_cfg['fpn_decoder'], classifier_config=dict(
            scale_factor=4.0, num_classes=int(self.config.classes), kernel_size=1))
        head_cfg['dtype'] = dtype
        self.head = FarSegHead(head_cfg)

    def forward(self, x, y=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        del generator
        feats = self.encoder(x.to(getattr(torch, self.config.dtype)), train)
        logits = self.head(feats, train).permute(0, 2, 3, 1).float()
        if train and y is not None:
            lcfg = self.config.loss
            ignore = int(lcfg.get('ignore_index', 255))
            out = dict(cls_loss=L.softmax_ce_loss_with_logits(logits, y,
                                                              ignore_index=ignore))
            if lcfg.get('dice'):
                out['dice_loss'] = L.dice_loss_with_logits(
                    logits, y, ignore_index=ignore, **dict(lcfg.dice))
            return out
        return torch.softmax(logits, dim=-1)
