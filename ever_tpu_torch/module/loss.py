"""Segmentation losses (NHWC logits, ``ignore_index`` aware, registered in
``LOSS``).

Counterpart of ``ever_tpu/module/loss.py``: the ignore handling is the same
mask arithmetic, so a batch whose labels are all ``ignore_index`` gives a
cross-entropy of 0 (``F.cross_entropy(ignore_index=...)`` gives NaN there).
Logits are ``[N, H, W, C]``; labels are ``[N, H, W]`` integers.  The rest of
the JAX package's loss family is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ever_tpu_torch.core import registry

__all__ = ['softmax_ce_loss_with_logits', 'dice_loss_with_logits']


def _flatten(y_pred, y_true):
    """Logits as f32 ``[P, C]`` and labels as ``[P]``."""
    c = y_pred.shape[-1]
    return y_pred.reshape(-1, c).float(), y_true.reshape(-1)


@registry.LOSS.register('softmax_ce')
def softmax_ce_loss_with_logits(y_pred, y_true, ignore_index: int = 255,
                                reduction: str = 'mean',
                                class_weight: Optional[Sequence[float]] = None):
    """Masked-mean pixel cross-entropy: ``sum(nll·valid) / max(sum(valid·w),
    1)``, with ``w`` the labels' class weights (1 without ``class_weight``)."""
    y_pred, y_true = _flatten(y_pred, y_true)
    ignored = y_true == ignore_index
    valid = (~ignored).float()
    labels = torch.where(ignored, torch.zeros_like(y_true), y_true).long()
    nll = -F.log_softmax(y_pred, dim=-1).gather(1, labels[:, None])[:, 0]
    valid_w = valid
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=torch.float32,
                            device=y_pred.device)[labels]
        nll = nll * w
        valid_w = valid * w
    nll = nll * valid
    if reduction == 'mean':
        return nll.sum() / torch.clamp(valid_w.sum(), min=1.0)
    if reduction == 'sum':
        return nll.sum()
    return nll


@registry.LOSS.register('dice')
def dice_loss_with_logits(y_pred, y_true, smooth_value: float = 1.0,
                          ignore_index: int = 255, ignore_channel: int = -1,
                          **_compat):
    """Dice loss over the valid pixels: ``1 - mean_c (2·I_c + s)/(Z_c + s)``
    (mean over the channels other than ``ignore_channel``); one channel
    means a sigmoid and float labels."""
    c = y_pred.shape[-1]
    y_pred, y_true = _flatten(y_pred, y_true)
    valid = (y_true != ignore_index).float()[:, None]
    if c == 1:
        y_prob = torch.sigmoid(y_pred)
        y_onehot = y_true.reshape(-1, 1).float()
    else:
        y_prob = torch.softmax(y_pred, dim=-1)
        labels = torch.where(y_true == ignore_index, torch.zeros_like(y_true), y_true)
        y_onehot = F.one_hot(labels.long(), c).float()
    y_prob, y_onehot = y_prob * valid, y_onehot * valid
    inter = (y_prob * y_onehot).sum(0)
    z = y_prob.sum(0) + y_onehot.sum(0)
    coeff = (2.0 * inter + smooth_value) / (z + smooth_value)
    if ignore_channel != -1 and c > 1:
        keep = torch.ones(c, dtype=torch.bool, device=coeff.device)
        keep[ignore_channel] = False
        coeff = coeff[keep].mean()
    else:
        coeff = coeff.mean()
    return 1.0 - coeff
