"""Streaming confusion-matrix accumulator (counterpart of
``ever_tpu/metric/confusion_matrix.py``).

Each batch's ``[C, C]`` matrix is counted in int64 on the predictions'
device (:func:`~ever_tpu_torch.metric.function.confusion_matrix`) and only
that small matrix is copied to the host, once per batch, where the total
accumulates in float64 (exact up to 2⁵³ counts a cell).
"""

from __future__ import annotations

import numpy as np
import torch

from ever_tpu_torch.metric.function import confusion_matrix as _cm

__all__ = ['ConfusionMatrix']


class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self._total = np.zeros((num_classes, num_classes), np.float64)

    def forward(self, y_true, y_pred) -> np.ndarray:
        """Accumulate one batch and return its matrix.  ``y_pred`` is either
        integer predictions or scores with a trailing class axis (the first
        maximum is taken); labels and predictions are tensors or arrays, and
        the counting runs on ``y_pred``'s device."""
        y_pred = torch.as_tensor(y_pred)
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        if y_pred.ndim == y_true.ndim + 1:
            y_pred = y_pred.argmax(dim=-1)
        cm = _cm(y_true, y_pred, self.num_classes, self.ignore_index).cpu().numpy()
        self._total += cm
        return cm

    update = forward

    @property
    def dense_cm(self) -> np.ndarray:
        return self._total.copy()

    sparse_cm = dense_cm

    def reset(self) -> None:
        self._total = np.zeros((self.num_classes, self.num_classes), np.float64)
