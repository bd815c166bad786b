"""Metric functions on tensors (counterpart of ``ever_tpu/metric/function.py``).

The confusion matrix is one integer ``torch.bincount`` over
``y_true * C + y_pred`` on the labels' device: a dense ``[C, C]`` int64
matrix (row = truth, column = prediction).  Ignored pixels go to an
overflow bucket past ``C * C`` rather than being weighted out, so every
count stays exact.  The derived scores follow the JAX functions, in
float32.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-7

__all__ = [
    'confusion_matrix', 'overall_accuracy_score', 'average_accuracy_score',
    'cohen_kappa_score', 'iou_per_class', 'mean_iou', 'th_confusion_matrix',
    'EPS', 'intersection_over_union_per_class', 'mean_intersection_over_union',
    'th_overall_accuracy_score', 'th_average_accuracy_score', 'th_cohen_kappa_score',
    'th_intersection_over_union_per_class', 'th_mean_intersection_over_union',
]


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_classes: int, ignore_index: int = 255) -> torch.Tensor:
    """Dense ``[C, C]`` int64 confusion matrix on ``y_pred``'s device.
    Truth labels outside ``[0, C)`` or equal to ``ignore_index`` are not
    counted; predictions are clipped into ``[0, C)``."""
    y_pred = y_pred.reshape(-1).long()
    y_true = torch.as_tensor(y_true, device=y_pred.device).reshape(-1).long()
    valid = (y_true != ignore_index) & (y_true >= 0) & (y_true < num_classes)
    idx = y_true * num_classes + y_pred.clamp(0, num_classes - 1)
    idx = torch.where(valid, idx, torch.full_like(idx, num_classes * num_classes))
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def overall_accuracy_score(cm: torch.Tensor) -> torch.Tensor:
    return torch.trace(cm).float() / (cm.sum().float() + EPS)


def average_accuracy_score(cm: torch.Tensor, return_accuracys: bool = False):
    accs = torch.diag(cm).float() / (cm.sum(dim=1).float() + EPS)
    if return_accuracys:
        return accs.mean(), accs
    return accs.mean()


def cohen_kappa_score(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.float()
    n = cm.shape[0]
    sum0 = cm.sum(dim=0)
    sum1 = cm.sum(dim=1)
    expected = torch.outer(sum0, sum1) / (sum0.sum() + EPS)
    w = 1.0 - torch.eye(n, device=cm.device)
    k = (w * cm).sum() / ((w * expected).sum() + EPS)
    return 1.0 - k


def iou_per_class(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.float()
    diag = torch.diag(cm)
    return diag / (cm.sum(dim=0) + cm.sum(dim=1) - diag + EPS)


def mean_iou(cm: torch.Tensor) -> torch.Tensor:
    return iou_per_class(cm).mean()


def th_confusion_matrix(y_true, y_pred, num_classes: Optional[int] = None,
                        to_dense: bool = True) -> torch.Tensor:
    """The reference's spelling: the fourth positional is ``to_dense`` (the
    matrix is always dense), and every in-range pixel counts (no 255
    filtering at this level).  ``num_classes`` defaults to the largest label
    plus one."""
    del to_dense
    y_pred = torch.as_tensor(y_pred)
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    if num_classes is None:
        num_classes = int(torch.maximum(y_true.max(), y_pred.max())) + 1
    return confusion_matrix(y_true, y_pred, int(num_classes), ignore_index=-1)


# the reference's other spellings of the same functions
intersection_over_union_per_class = iou_per_class
mean_intersection_over_union = mean_iou
th_overall_accuracy_score = overall_accuracy_score
th_average_accuracy_score = average_accuracy_score
th_cohen_kappa_score = cohen_kappa_score
th_intersection_over_union_per_class = iou_per_class
th_mean_intersection_over_union = mean_iou
