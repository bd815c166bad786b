"""Segmentation losses (NHWC logits, ``ignore_index`` aware, registered in
``LOSS``).

Counterpart of ``ever_tpu/module/loss.py``: the ignore handling is the same
mask arithmetic, so a batch whose labels are all ``ignore_index`` gives a
cross-entropy of 0 (``F.cross_entropy(ignore_index=...)`` gives NaN there).
Logits are ``[N, H, W, C]``; labels are ``[N, H, W]`` integers (the BCE
takes logits and float targets of any one shape).  The rest of the JAX
package's loss family is not ported yet (``ROADMAP.md`` A.7.3).

Inside a data-parallel step over more than one rank (``with mesh:``; see
``parallel/mesh.py``) the batch sums are global, as they are in the JAX
package under a sharded batch: the cross-entropy's mean is Σnll / Σvalid·w
over every rank's pixels, the BCE's likewise Σloss / Σvalid, and the dice
statistics are summed over the ranks, each through one
:func:`all_reduce_sum`.  The loss is then the same on
every rank, and its gradient reaches each rank's logits R times over (the
sum's gradient is the sum of the R ranks' gradients); DDP's average of the
parameter gradients over R ranks divides that out, so the step's gradient
is the global loss's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.parallel import mesh as _mesh

__all__ = ['softmax_ce_loss_with_logits', 'dice_loss_with_logits',
           'binary_cross_entropy_with_logits', 'all_reduce_sum']


def all_reduce_sum(x: torch.Tensor, axis_name: Optional[str] = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the current mesh's ``axis_name``
    axis (``ever_tpu/module/loss.py`` ``all_reduce_sum``): the identity
    outside a data-parallel step or with one rank."""
    return _mesh.all_reduce_sum(x, _mesh.reduction_group(axis_name))


def _flatten(y_pred, y_true):
    """Logits as f32 ``[P, C]`` and labels as ``[P]``."""
    c = y_pred.shape[-1]
    return y_pred.reshape(-1, c).float(), y_true.reshape(-1)


@registry.LOSS.register('softmax_ce')
def softmax_ce_loss_with_logits(y_pred, y_true, ignore_index: int = 255,
                                reduction: str = 'mean',
                                class_weight: Optional[Sequence[float]] = None):
    """Masked-mean pixel cross-entropy: ``sum(nll·valid) / max(sum(valid·w),
    1)``, with ``w`` the labels' class weights (1 without ``class_weight``);
    both sums (and ``reduction='sum'``) over every rank's pixels inside a
    data-parallel step."""
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
        return _global_mean(nll.sum(), valid_w.sum())
    if reduction == 'sum':
        return all_reduce_sum(nll.sum())
    return nll


def _global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)``, both summed over the data group's ranks
    inside a data-parallel step with one all-reduce."""
    group = _mesh.reduction_group()
    if group is not None:
        total, count = _mesh.all_reduce_sum(torch.stack([total, count]), group)
    return total / torch.clamp(count, min=1.0)


@registry.LOSS.register('dice')
def dice_loss_with_logits(y_pred, y_true, smooth_value: float = 1.0,
                          ignore_index: int = 255, ignore_channel: int = -1,
                          axis_name: Optional[str] = None, **_compat):
    """Dice loss over the valid pixels: ``1 - mean_c (2·I_c + s)/(Z_c + s)``
    (mean over the channels other than ``ignore_channel``); one channel
    means a sigmoid and float labels.  ``I`` and ``Z`` are summed over the
    current mesh's ``axis_name`` axis (the data axis by default) inside a
    data-parallel step."""
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
    group = _mesh.reduction_group(axis_name)
    if group is not None:
        inter, z = _mesh.all_reduce_sum(torch.stack([inter, z]), group)
    coeff = (2.0 * inter + smooth_value) / (z + smooth_value)
    if ignore_channel != -1 and c > 1:
        keep = torch.ones(c, dtype=torch.bool, device=coeff.device)
        keep[ignore_channel] = False
        coeff = coeff[keep].mean()
    else:
        coeff = coeff.mean()
    return 1.0 - coeff


@registry.LOSS.register('bce')
def binary_cross_entropy_with_logits(output, target, reduction: str = 'mean',
                                     ignore_index: int = 255, pos_weight=None):
    """Masked binary cross-entropy of logits (``ever_tpu/module/loss.py``
    ``binary_cross_entropy_with_logits``): flattened float32, targets equal
    to ``ignore_index`` masked out (and read as 0), the stable form
    ``max(z, 0) − z·t + log1p(exp(−|z|))``, and ``pos_weight`` weighting
    the positive term as torch does.  ``'mean'`` is ``Σloss / max(Σvalid,
    1)``, both sums (and ``'sum'``) over every rank's pixels inside a
    data-parallel step; ``'none'`` gives the masked per-element losses."""
    z = output.reshape(-1).float()
    t = target.reshape(-1).float()
    valid = (t != ignore_index).float()
    t = torch.where(valid > 0, t, torch.zeros_like(t))
    softplus_neg = torch.log1p(torch.exp(-z.abs()))
    losses = torch.clamp(z, min=0) - z * t + softplus_neg
    if pos_weight is not None:
        losses = losses + (pos_weight - 1.0) * t * (softplus_neg + torch.clamp(-z, min=0))
    losses = losses * valid
    if reduction == 'mean':
        return _global_mean(losses.sum(), valid.sum())
    if reduction == 'sum':
        return all_reduce_sum(losses.sum())
    return losses
