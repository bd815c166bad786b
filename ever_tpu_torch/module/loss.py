"""Segmentation losses (NHWC logits, ``ignore_index`` aware, registered in
``LOSS``).

Counterpart of ``ever_tpu/module/loss.py``: the ignore handling is the same
mask arithmetic, so a batch whose labels are all ``ignore_index`` gives a
cross-entropy of 0 (``F.cross_entropy(ignore_index=...)`` gives NaN there).
Logits are ``[N, H, W, C]``; labels are ``[N, H, W]`` integers (the
binary losses take logits and float targets of any one shape).  Every loss
computes in float32.

Inside a data-parallel step over more than one rank (``with mesh:``; see
``parallel/mesh.py``) each loss gives the JAX package's value on the
global batch, as the JAX package does under a sharded batch:

- **Ratios of batch sums** go through one :func:`all_reduce_sum` of the
  stacked sums: the cross-entropy's Σnll / Σvalid·w, the BCE's and the
  smoothed losses' Σloss / Σvalid, the dice and Tversky statistics,
  :func:`dice_coeff`'s, and ``focal_loss(normalize=True)``'s ΣBCE and
  Σmodulated.  ``reduction='sum'`` is summed over the ranks too.
- **OHEM's top k** is over the global batch: every rank's per-element
  losses are gathered (see :func:`online_hard_example_mining`).
- **Plain means of equal shards** (``sigmoid_focal_loss`` and
  ``focal_loss`` without ``normalize`` at ``'mean'``,
  ``soft_cross_entropy``) stay rank-local: the ranks hold batches of one
  shape, so the mean of their means is the global mean, and DDP's average
  of the parameter gradients is the global loss's gradient.

A global loss is the same on every rank, and its gradient reaches each
rank's logits R times over (the sum's gradient is the sum of the R ranks'
gradients); DDP's average of the parameter gradients over R ranks divides
that out, so the step's gradient is the global loss's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.parallel import mesh as _mesh

__all__ = ['softmax_ce_loss_with_logits', 'dice_loss_with_logits',
           'tversky_loss_with_logits', 'online_hard_example_mining', 'focal_loss',
           'sigmoid_focal_loss', 'label_smoothing_cross_entropy',
           'label_smoothing_binary_cross_entropy', 'binary_cross_entropy_with_logits',
           'soft_cross_entropy', 'all_reduce_sum', 'select', 'dice_coeff']


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


def _global_sums(*sums: torch.Tensor, axis_name: Optional[str] = None):
    """``sums`` (tensors of one shape) summed over the ranks of the current
    mesh's ``axis_name`` axis with one all-reduce of their stack; as they
    are outside a data-parallel step."""
    group = _mesh.reduction_group(axis_name)
    if group is None:
        return sums
    return tuple(_mesh.all_reduce_sum(torch.stack(sums), group).unbind(0))


def _global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)``, both summed over the data group's ranks
    inside a data-parallel step with one all-reduce."""
    total, count = _global_sums(total, count)
    return total / torch.clamp(count, min=1.0)


def _probs_onehot(y_pred, y_true, ignore_index: int):
    """Softmax probabilities and one-hot labels ``[P, C]`` of flattened
    logits, both zero on ignored pixels; one channel means a sigmoid and
    float labels."""
    c = y_pred.shape[-1]
    valid = (y_true != ignore_index).float()[:, None]
    if c == 1:
        y_prob = torch.sigmoid(y_pred)
        y_onehot = y_true.reshape(-1, 1).float()
    else:
        y_prob = torch.softmax(y_pred, dim=-1)
        labels = torch.where(y_true == ignore_index, torch.zeros_like(y_true), y_true)
        y_onehot = F.one_hot(labels.long(), c).float()
    return y_prob * valid, y_onehot * valid


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
    y_prob, y_onehot = _probs_onehot(*_flatten(y_pred, y_true), ignore_index)
    inter, z = _dice_stats(y_prob, y_onehot, axis_name)
    coeff = (2.0 * inter + smooth_value) / (z + smooth_value)
    if ignore_channel != -1 and c > 1:
        keep = torch.ones(c, dtype=torch.bool, device=coeff.device)
        keep[ignore_channel] = False
        coeff = coeff[keep].mean()
    else:
        coeff = coeff.mean()
    return 1.0 - coeff


def _dice_stats(y_prob, y_onehot, axis_name: Optional[str]):
    """Per-class (intersection, denominator) sums of masked ``[P, C]``
    probabilities and one-hot labels, over the ranks in a data-parallel
    step."""
    inter = (y_prob * y_onehot).sum(0)
    return _global_sums(inter, y_prob.sum(0) + y_onehot.sum(0), axis_name=axis_name)


@registry.LOSS.register('tversky')
def tversky_loss_with_logits(y_pred, y_true, alpha: Union[float, Sequence[float]],
                             beta=None, gamma: float = 1.0, smooth_value: float = 1.0,
                             ignore_index: int = 255, reduction: str = 'mean',
                             axis_name: Optional[str] = None, **_compat):
    """(Focal) Tversky loss ``(1 - (TP + s)/(TP + α·FN + β·FP + s))^γ`` per
    class over the valid pixels (``ever_tpu/module/loss.py``
    ``tversky_loss_with_logits``): ``alpha`` a number or one per class,
    ``beta`` ``1 - alpha`` by default; one channel means a sigmoid and
    float labels.  ``TP`` and the denominator are summed over the current
    mesh's ``axis_name`` axis (the data axis by default) inside a
    data-parallel step.  ``reduction`` ``'mean'`` over the classes or
    ``'none'`` (``[C]``)."""
    y_prob, y_onehot = _probs_onehot(*_flatten(y_pred, y_true), ignore_index)
    if isinstance(alpha, (list, tuple)):
        alpha = torch.tensor(alpha, dtype=torch.float32, device=y_prob.device)
    if beta is None:
        beta = 1.0 - alpha
    tp = (y_prob * y_onehot).sum(0)
    fp = y_prob.sum(0) - tp
    fn = y_onehot.sum(0) - tp
    tp, den = _global_sums(tp, tp + alpha * fn + beta * fp, axis_name=axis_name)
    loss = (1.0 - (tp + smooth_value) / (den + smooth_value)) ** gamma
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'none':
        return loss
    raise ValueError(f'unknown reduction: {reduction}')


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
    losses = _bce_terms(z, t)
    if pos_weight is not None:
        losses = losses + (pos_weight - 1.0) * t * (torch.log1p(torch.exp(-z.abs()))
                                                    + torch.clamp(-z, min=0))
    losses = losses * valid
    if reduction == 'mean':
        return _global_mean(losses.sum(), valid.sum())
    if reduction == 'sum':
        return all_reduce_sum(losses.sum())
    return losses


def _bce_terms(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The stable BCE of logits ``max(z, 0) − z·t + log1p(exp(−|z|))``."""
    return torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


@registry.LOSS.register('ohem')
def online_hard_example_mining(losses: torch.Tensor, keep_ratio: float) -> torch.Tensor:
    """The mean of the non-zero values among the ``k = max(int(keep_ratio ·
    P), 1)`` largest of the ``P`` per-element ``losses`` (any shape;
    ``ever_tpu/module/loss.py`` ``online_hard_example_mining``).  Ties are
    taken in element order, as ``jax.lax.top_k`` takes them.

    Inside a data-parallel step the ranks' losses (one shape on every rank)
    are gathered in rank order, which is the global batch's, by one
    differentiable all-reduce of a ``[R, P]`` tensor holding this rank's row
    and zeros; ``P`` and the top k are then the global batch's, exactly,
    and every rank computes the same value."""
    if not 0 < keep_ratio < 1:
        raise ValueError('The value of keep_ratio must be from 0 to 1.')
    flat = losses.reshape(-1).float()
    group = _mesh.reduction_group()
    if group is not None:
        rank, world = _mesh.data_shard()
        rows = [torch.zeros_like(flat)] * world
        rows[rank] = flat
        flat = _mesh.all_reduce_sum(torch.stack(rows), group).reshape(-1)
    k = max(int(keep_ratio * flat.shape[0]), 1)
    top = torch.sort(flat, descending=True, stable=True).values[:k]
    nonzero = (top != 0).float()
    return (top * nonzero).sum() / torch.clamp(nonzero.sum(), min=1.0)


@registry.LOSS.register('focal')
def focal_loss(y_pred, y_true, gamma: float = 2.0, normalize: bool = False):
    """Binary focal loss ``BCE · pt^γ`` with ``pt = |t − sigmoid(z)|`` taken
    without a gradient (``ever_tpu/module/loss.py`` ``focal_loss``, whose
    ``stop_gradient`` this is).  Without ``normalize`` the mean (rank-local);
    with it ``Σmodulated · ΣBCE / max(Σmodulated, 1e-12)``, both sums over
    the ranks in a data-parallel step.  As in the JAX package the scale is
    not detached, so the normalised value equals ΣBCE and so does its
    gradient."""
    z = y_pred.float()
    t = y_true.float()
    with torch.no_grad():
        p = torch.sigmoid(z)
        mod = ((1 - p) * t + p * (1 - t)) ** gamma
    losses = _bce_terms(z, t)
    if normalize:
        total, modulated = _global_sums(losses.sum(), (losses * mod).sum())
        return modulated * (total / torch.clamp(modulated, min=1e-12))
    return (losses * mod).mean()


@registry.LOSS.register('sigmoid_focal')
def sigmoid_focal_loss(y_pred, y_true, alpha: float = -1, gamma: float = 2,
                       reduction: str = 'mean'):
    """fvcore's focal loss ``α_t · BCE · (1 − p_t)^γ``, gradient through
    every term (``ever_tpu/module/loss.py`` ``sigmoid_focal_loss``);
    ``alpha < 0`` leaves out ``α_t``.  ``'mean'`` is rank-local, ``'sum'``
    over the ranks, anything else the elements."""
    z = y_pred.float()
    t = y_true.float()
    p = torch.sigmoid(z)
    p_t = p * t + (1 - p) * (1 - t)
    loss = _bce_terms(z, t) * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return all_reduce_sum(loss.sum())
    return loss


@registry.LOSS.register('label_smoothing_ce')
def label_smoothing_cross_entropy(output, target, eps: float = 0.1,
                                  reduction: str = 'mean', ignore_index: int = -1):
    """Label-smoothed cross-entropy ``ε/C · Σ_c(−log p_c) + (1 − ε) · nll``
    over the valid pixels (``ever_tpu/module/loss.py``
    ``label_smoothing_cross_entropy``; its default ``ignore_index`` is -1).
    ``'mean'`` divides both sums by ``max(Σvalid, 1)``, all three over the
    ranks in a data-parallel step; ``'sum'`` sums over the ranks; anything
    else gives the per-pixel terms."""
    output, target = _flatten(output, target)
    c = output.shape[-1]
    ignored = target == ignore_index
    valid = (~ignored).float()
    labels = torch.where(ignored, torch.zeros_like(target), target).long()
    logp = F.log_softmax(output, dim=-1)
    smooth = -logp.sum(-1) * valid
    nll = -logp.gather(1, labels[:, None])[:, 0] * valid
    if reduction == 'mean':
        smooth, nll, count = _global_sums(smooth.sum(), nll.sum(), valid.sum())
        count = torch.clamp(count, min=1.0)
        smooth, nll = smooth / count, nll / count
    elif reduction == 'sum':
        smooth, nll = _global_sums(smooth.sum(), nll.sum())
    return smooth * eps / c + (1 - eps) * nll


@registry.LOSS.register('label_smoothing_bce')
def label_smoothing_binary_cross_entropy(output, target, eps: float = 0.1,
                                         reduction: str = 'mean',
                                         ignore_index: int = 255):
    """Binary cross-entropy of logits against targets moved ``eps`` towards
    ½ (0 → ε, others t − ε), targets equal to ``ignore_index`` masked out
    (``ever_tpu/module/loss.py`` ``label_smoothing_binary_cross_entropy``).
    ``'mean'`` is ``Σloss / max(Σvalid, 1)`` and ``'sum'`` the sum, over
    the ranks in a data-parallel step."""
    z = output.reshape(-1).float()
    t = target.reshape(-1).float()
    valid = (t != ignore_index).float()
    smoothed = torch.where(t == 0, t + eps, t - eps)
    losses = _bce_terms(z, torch.where(valid > 0, smoothed, torch.zeros_like(t))) * valid
    if reduction == 'mean':
        return _global_mean(losses.sum(), valid.sum())
    if reduction == 'sum':
        return all_reduce_sum(losses.sum())
    return losses


@registry.LOSS.register('soft_ce')
def soft_cross_entropy(input, target):
    """Cross-entropy against soft labels over ``[N, H, W, C]``:
    ``−Σ_c mean_{n,h,w}(target · log_softmax(input))``
    (``ever_tpu/module/loss.py`` ``soft_cross_entropy``); the mean is
    rank-local."""
    if input.ndim != 4 or target.ndim != 4:
        raise ValueError(f'soft_cross_entropy takes [N, H, W, C] input and target, got '
                         f'{tuple(input.shape)} and {tuple(target.shape)}')
    logp = F.log_softmax(input.float(), dim=-1)
    return -(target * logp).mean(dim=(0, 1, 2)).sum()


def select(y_pred, y_true, ignore_index: int = 255):
    """``(logits [P, C] float32, labels [P], valid [P] float32)``: the
    flattened pixels and their mask (``ever_tpu/module/loss.py``
    ``select``, which keeps static shapes instead of gathering)."""
    y_pred, y_true = _flatten(y_pred, y_true)
    return y_pred, y_true, (y_true != ignore_index).float()


def dice_coeff(y_prob, y_onehot, valid=None, smooth_value: float = 1.0,
               axis_name: Optional[str] = None):
    """The mean per-class dice coefficient ``(2·I + s)/(Z + s)`` of ``[P,
    C]`` probabilities and one-hot labels over the ``valid`` rows (all by
    default; ``ever_tpu/module/loss.py`` ``dice_coeff``), ``I`` and ``Z``
    summed over the current mesh's ``axis_name`` axis (the data axis by
    default) inside a data-parallel step."""
    if valid is None:
        valid = torch.ones(y_prob.shape[0], dtype=torch.float32, device=y_prob.device)
    valid = valid[:, None]
    inter, z = _dice_stats(y_prob * valid, y_onehot * valid, axis_name)
    return ((2.0 * inter + smooth_value) / (z + smooth_value)).mean()
