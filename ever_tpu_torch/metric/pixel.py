"""PixelMetric: per-class metrics, tables and confusion-matrix dumps
(counterpart of ``ever_tpu/metric/pixel.py``).

The cross-process reduction is a host all-gather of the small float64
matrix (``core/dist.py``).  :class:`AccTable` is a dependency-free table
with the getters (``f1/iou/precision/recall/get``) and CSV export;
summaries dump the matrix to ``<logdir>/cm/confusion_matrix-*.npy``.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ever_tpu_torch.core.dist import all_gather_host, is_main_process
from ever_tpu_torch.core.logger import get_console_file_logger
from ever_tpu_torch.metric.confusion_matrix import ConfusionMatrix

EPS = 1e-7

__all__ = ['PixelMetric', 'AccTable']


class AccTable:
    """A prettytable-like accuracy table: ``get``, ``f1``, ``iou``,
    ``precision``, ``recall``, ``to_csv`` and string rendering."""

    def __init__(self, field_names: Sequence[str]):
        self.field_names = list(field_names)
        self._rows: List[list] = []

    def add_row(self, row: Sequence) -> None:
        if len(row) != len(self.field_names):
            raise ValueError('row length mismatch')
        self._rows.append(list(row))

    @property
    def rows(self):
        return self._rows

    @staticmethod
    def _get_data(data, class_index=None):
        if isinstance(class_index, int):
            return data[class_index]
        if isinstance(class_index, (list, tuple)):
            return [data[c] for c in class_index]
        return data

    def get(self, col_name: str, row_index=None):
        idx = self.field_names.index(col_name)
        return self._get_data([r[idx] for r in self._rows], row_index)

    def f1(self, class_index=None):
        return self.get('f1', class_index)

    def iou(self, class_index=None):
        return self.get('iou', class_index)

    def precision(self, class_index=None):
        return self.get('precision', class_index)

    def recall(self, class_index=None):
        return self.get('recall', class_index)

    def to_csv(self, csv_file: str) -> None:
        with open(csv_file, 'w', newline='') as f:
            w = csv.writer(f)
            w.writerow([''] + self.field_names)
            for i, row in enumerate(self._rows):
                w.writerow([i] + row)

    def get_string(self) -> str:
        cols = [self.field_names] + [[str(c) for c in r] for r in self._rows]
        widths = [max(len(str(row[i])) for row in cols)
                  for i in range(len(self.field_names))]

        def fmt(row):
            return '| ' + ' | '.join(str(c).ljust(w) for c, w in zip(row, widths)) + ' |'

        sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
        lines = [sep, fmt(self.field_names), sep]
        lines += [fmt(r) for r in self._rows]
        lines.append(sep)
        return '\n'.join(lines)

    def __str__(self) -> str:
        return self.get_string()


class PixelMetric(ConfusionMatrix):
    def __init__(self, num_classes: int, logdir: Optional[str] = None,
                 logger=None, class_names: Optional[Sequence[str]] = None,
                 ignore_index: int = 255):
        super().__init__(num_classes, ignore_index)
        self.logdir = logdir
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
        if logdir is not None and logger is None:
            self._logger = get_console_file_logger('PixelMetric', logdir)
        else:
            self._logger = logger
        self._class_names = list(class_names) if class_names else None
        if self._class_names and len(self._class_names) != num_classes:
            raise ValueError('class_names length must equal num_classes')

    @property
    def logger(self):
        return self._logger

    # -- derived metrics ---------------------------------------------------
    @staticmethod
    def compute_iou_per_class(cm: np.ndarray) -> np.ndarray:
        sum_over_row = np.sum(cm, axis=0)
        sum_over_col = np.sum(cm, axis=1)
        diag = np.diag(cm)
        return diag / (sum_over_row + sum_over_col - diag + EPS)

    @staticmethod
    def compute_recall_per_class(cm: np.ndarray) -> np.ndarray:
        return np.diag(cm) / (np.sum(cm, axis=1) + EPS)

    @staticmethod
    def compute_precision_per_class(cm: np.ndarray) -> np.ndarray:
        return np.diag(cm) / (np.sum(cm, axis=0) + EPS)

    @staticmethod
    def compute_overall_accuracy(cm: np.ndarray) -> float:
        return np.sum(np.diag(cm)) / (np.sum(cm) + EPS)

    @staticmethod
    def compute_F_measure_per_class(cm: np.ndarray, beta: float = 1.0) -> np.ndarray:
        p = PixelMetric.compute_precision_per_class(cm)
        r = PixelMetric.compute_recall_per_class(cm)
        return (1 + beta ** 2) * p * r / ((beta ** 2) * p + r + EPS)

    @staticmethod
    def cohen_kappa_score(cm: np.ndarray) -> float:
        cm = cm.astype(np.float64)
        n = cm.shape[0]
        sum0 = cm.sum(axis=0)
        sum1 = cm.sum(axis=1)
        expected = np.outer(sum0, sum1) / (np.sum(sum0) + EPS)
        w = np.ones((n, n))
        w.flat[::n + 1] = 0
        k = np.sum(w * cm) / (np.sum(w * expected) + EPS)
        return 1.0 - k

    # -- summaries ---------------------------------------------------------
    def _gathered_cm(self) -> np.ndarray:
        # float64 counts travel pickled, exactly
        return np.sum(all_gather_host(self._total), axis=0)

    def _log_summary(self, table, dense_cm: np.ndarray) -> None:
        if self._logger is not None:
            self._logger.info('\n' + table.get_string())
            if self.logdir is not None:
                cm_dir = os.path.join(self.logdir, 'cm')
                os.makedirs(cm_dir, exist_ok=True)
                t = time.strftime('%Y-%m-%d-%H:%M:%S', time.localtime())
                np.save(os.path.join(cm_dir, f'confusion_matrix-{t}-{time.time()}.npy'),
                        dense_cm)
        else:
            print(table)

    def summary_iou(self) -> AccTable:
        dense_cm = self._gathered_cm()
        iou = self.compute_iou_per_class(dense_cm)
        tb = AccTable(['class', 'iou'])
        for i, v in enumerate(iou):
            tb.add_row([i, v])
        tb.add_row(['mIoU', iou.mean()])
        if is_main_process():
            self._log_summary(tb, dense_cm)
        return tb

    def summary_all(self, dense_cm: Optional[np.ndarray] = None, dec: int = 5) -> AccTable:
        if dense_cm is None:
            dense_cm = self._gathered_cm()
        iou = np.round(self.compute_iou_per_class(dense_cm), dec)
        f1 = np.round(self.compute_F_measure_per_class(dense_cm), dec)
        prec = np.round(self.compute_precision_per_class(dense_cm), dec)
        rec = np.round(self.compute_recall_per_class(dense_cm), dec)
        oa = np.round(self.compute_overall_accuracy(dense_cm), dec)
        kappa = np.round(self.cohen_kappa_score(dense_cm), dec)

        if self._class_names:
            tb = AccTable(['name', 'class', 'iou', 'f1', 'precision', 'recall'])
            for i in range(self.num_classes):
                tb.add_row([self._class_names[i], i, iou[i], f1[i], prec[i], rec[i]])
            tb.add_row(['', 'mean', np.round(iou.mean(), dec), np.round(f1.mean(), dec),
                        np.round(prec.mean(), dec), np.round(rec.mean(), dec)])
            tb.add_row(['', 'OA', oa, '-', '-', '-'])
            tb.add_row(['', 'Kappa', kappa, '-', '-', '-'])
        else:
            tb = AccTable(['class', 'iou', 'f1', 'precision', 'recall'])
            for i in range(self.num_classes):
                tb.add_row([i, iou[i], f1[i], prec[i], rec[i]])
            tb.add_row(['mean', np.round(iou.mean(), dec), np.round(f1.mean(), dec),
                        np.round(prec.mean(), dec), np.round(rec.mean(), dec)])
            tb.add_row(['OA', oa, '-', '-', '-'])
            tb.add_row(['Kappa', kappa, '-', '-', '-'])

        if is_main_process():
            self._log_summary(tb, dense_cm)
        return tb
