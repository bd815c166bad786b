"""FactSeg: foreground-activation dual-branch small-object segmentation
(counterpart of ``ever_tpu/module/factseg.py``).

One ResNet encoder feeds two FPN + ``AssymetricDecoder`` branches: a
one-channel foreground activation (``fa``) and a ``classes``-channel
semantic branch (``sem``).  Their logits combine into the collaborative
probability (:meth:`FactSeg.joint_probability`).  Parameter names follow
the JAX module's (``fa_fpn``, ``sem_fpn``, ``fa_decoder``, ``sem_decoder``,
``fa_cls``, ``sem_cls``), so ``util.weight_io.convert_flax_factseg`` maps
them one to one.  The ×4 logit upsampling is the matrix-product form
(``module/fpn.py`` ``upsample_bilinear_nchw``), whose backward has no
atomics, so a resumed run's gradients are the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module.fpn import FPN, AssymetricDecoder, logits_nhwc
from ever_tpu_torch.module.ops import Conv2d
from ever_tpu_torch.module.resnet import ResNetEncoder

__all__ = ['FactSeg']


@registry.MODEL.register()
class FactSeg(ERModule):
    """Dual-branch (foreground activation ⊕ semantic) segmentation.

    ``forward(x, y=None, train=False)`` takes NHWC ``[N, H, W, C]`` and
    computes in ``config.dtype``.  With ``train=True`` and int labels ``y``
    ``[N, H, W]`` (class 0 the background) it returns ``cls_loss`` (the CE
    of the log joint probability), ``fa_loss`` (the BCE of the foreground
    logit, when ``loss.fa`` is not None) and ``dice_loss`` (its sigmoid
    dice, when ``loss.dice`` is not None: ``dice=dict()`` means the
    defaults); otherwise the joint probabilities ``[N, H, W, classes]``.
    """

    def set_default_config(self):
        self.config.update(dict(
            encoder=dict(resnet_type='resnet50'),
            fpn=dict(in_channels_list=(256, 512, 1024, 2048), out_channels=256),
            decoder=dict(in_channels=256, out_channels=128,
                         in_feat_output_strides=(4, 8, 16, 32),
                         out_feat_output_stride=4),
            classes=16,
            loss=dict(ignore_index=255, fa=dict(), dice=dict(smooth_value=1.0),
                      sem=dict()),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        enc = c.encoder.to_dict()
        enc.setdefault('dtype', c.dtype)
        self.encoder = ResNetEncoder(enc)
        self.fa_fpn = FPN(**c.fpn.to_dict())
        self.sem_fpn = FPN(**c.fpn.to_dict())
        # flax infers the decoder's input width; torch builds it from the FPN's
        dec = dict(c.decoder.to_dict(), in_channels=int(c.fpn.out_channels))
        self.fa_decoder = AssymetricDecoder(**dec)
        self.sem_decoder = AssymetricDecoder(**dec)
        width = int(dec['out_channels'])
        self.fa_cls = Conv2d(width, 1, 1, bias=True)
        self.sem_cls = Conv2d(width, int(c.classes), 1, bias=True)

    def _forward_logits(self, x, train: bool):
        feats = self.encoder(x.to(getattr(torch, self.config.dtype)), train)
        fa = self.fa_decoder(list(self.fa_fpn(feats, train)), train)
        sem = self.sem_decoder(list(self.sem_fpn(feats, train)), train)
        return logits_nhwc(self.fa_cls, fa), logits_nhwc(self.sem_cls, sem)

    @staticmethod
    def joint_probability(fa_logit: torch.Tensor, sem_logit: torch.Tensor) -> torch.Tensor:
        """The collaborative probability: background ``1 − σ(fa)``, and the
        foreground classes' softmax renormalised by ``max(Σ, 1e-7)`` and
        scaled by ``σ(fa)``."""
        p_fg = torch.sigmoid(fa_logit)
        fg = torch.softmax(sem_logit, dim=-1)[..., 1:]
        fg = fg / torch.clamp(fg.sum(-1, keepdim=True), min=1e-7)
        return torch.cat([1.0 - p_fg, p_fg * fg], dim=-1)

    def forward(self, x, y=None, train: bool = False, generator=None):
        fa, sem = self._forward_logits(x, train)
        joint = self.joint_probability(fa, sem)
        if not (train and y is not None):
            return joint
        lcfg = self.config.loss
        ignore = int(lcfg.get('ignore_index', 255))
        binary_y = torch.where(y == ignore, torch.full_like(y, ignore), (y > 0).to(y.dtype))
        # the CE log-softmaxes these log-probabilities again, as the JAX model does
        out = dict(cls_loss=L.softmax_ce_loss_with_logits(
            torch.log(torch.clamp(joint, min=1e-7)), y, ignore_index=ignore))
        if lcfg.get('fa') is not None:
            out['fa_loss'] = L.binary_cross_entropy_with_logits(
                fa[..., 0], binary_y.float(), ignore_index=ignore)
        if lcfg.get('dice') is not None:
            out['dice_loss'] = L.dice_loss_with_logits(
                fa, binary_y, ignore_index=ignore, **dict(lcfg.dice))
        return out
