"""Evaluation closures for ``Launcher.override_evaluate`` (counterpart of
``ever_tpu/metric/evaluate_fn.py``).

Each closure runs the launcher's eval step over the test loader, counts
every batch's confusion matrix on the card (``PixelMetric.forward``) and
returns ``summary_all``'s table.  The distributed variant gives each
process a disjoint, non-overlapping share of the samples
(``DistributedNonOverlapSeqSampler``: the ranks may see different numbers
of batches), predicts it with the launcher's rank-local eval step and sums
the matrices over the ranks on the host.  In a run of more than one
process it evaluates ``Launcher.local_state()``, as the JAX loop does: a
state whose parameters are split over the ranks (ZeRO-3, tensor parallel)
raises the JAX package's error on every rank, where a rank-local forward
would compute on its shards alone.  A process drives one card, so no
batch is padded.  The single-process variant summarises its own matrix and
enters no collective, so it may run on rank 0 alone (an
``EvaluationCallback`` with ``only_master``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ever_tpu_torch.core import dist
from ever_tpu_torch.data.distributed import DistributedNonOverlapSeqSampler, with_sampler
from ever_tpu_torch.metric.pixel import PixelMetric

__all__ = ['evaluate_pixel_prediction_task',
           'distributed_evaluate_pixel_prediction_task',
           'evaluate_change_detection_task',
           'evaluate_damage_assessment_task']


def _data_parse_fn(data):
    x, y_blob = data
    return x, y_blob, {}


def _tune_model_fn(eval_step):
    return eval_step


def _process_prediction_fn(y_true, y_pred, data_info, model_dir, checkpoint):
    return y_true, y_pred


def _make_eval_loop(num_classes, data_parse_fn, tune_model_fn, prediction_fn,
                    desc, acc_table_based_callback, distributed, cuda_empty_cache):
    def _evaluate_fn(self, test_dataloader, config=None):
        loader = test_dataloader
        if distributed and not isinstance(loader.sampler, DistributedNonOverlapSeqSampler):
            loader = with_sampler(loader, DistributedNonOverlapSeqSampler(loader.dataset))
        pm = PixelMetric(num_classes, self.model_dir, logger=self.logger)
        eval_step = tune_model_fn(self.get_eval_step())
        state = self.local_state() if distributed and dist.get_world_size() > 1 else self.state
        if desc:
            self.info(f'evaluating: {desc}')
        for data in loader:
            x, y_true, other_info = data_parse_fn(data)
            y_pred = eval_step(state, (torch.as_tensor(x),))
            y_true, y_pred = prediction_fn(y_true, y_pred, other_info,
                                           self.model_dir, self.checkpoint)
            pm.forward(y_true, y_pred)
        acc_tb = pm.summary_all(None if distributed else pm.dense_cm)
        if acc_table_based_callback is not None:
            acc_table_based_callback(self, acc_tb)
        if cuda_empty_cache and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        return acc_tb

    return _evaluate_fn


def evaluate_pixel_prediction_task(num_classes: int,
                                   data_parse_fn: Callable = _data_parse_fn,
                                   tune_model_fn: Callable = _tune_model_fn,
                                   prediction_fn: Callable = _process_prediction_fn,
                                   desc: str = '',
                                   acc_table_based_callback: Optional[Callable] = None,
                                   cuda_empty_cache: bool = True):
    """Single-process pixel-prediction evaluation closure."""
    return _make_eval_loop(num_classes, data_parse_fn, tune_model_fn,
                           prediction_fn, desc, acc_table_based_callback,
                           distributed=False, cuda_empty_cache=cuda_empty_cache)


def evaluate_change_detection_task(threshold: float = 0.5,
                                   desc: str = '',
                                   acc_table_based_callback: Optional[Callable] = None,
                                   distributed: bool = False):
    """Binary change detection: labels ``batch[1]['change']`` (or the plain
    mask), predictions the last output of the model (its change
    probability), thresholded at ``threshold``."""

    def parse(d):
        x, y = d[0], d[1]
        return x, (y['change'] if isinstance(y, dict) else y), {}

    def pred(y_true, y_pred, data_info, model_dir, checkpoint):
        p = y_pred[-1] if isinstance(y_pred, (tuple, list)) else y_pred
        if p.ndim == 4:          # [N, H, W, 1] probability map
            p = p[..., -1]
        return y_true, (p > threshold).int()

    return _make_eval_loop(2, parse, _tune_model_fn, pred, desc,
                           acc_table_based_callback, distributed=distributed,
                           cuda_empty_cache=True)


def evaluate_damage_assessment_task(damage_classes: int = 5,
                                    loc_threshold: float = 0.5,
                                    desc: str = '',
                                    acc_table_based_callback: Optional[Callable] = None,
                                    distributed: bool = False):
    """Building damage: labels ``batch[1]['damage']``; the per-pixel damage
    argmax where the localization probability passes ``loc_threshold``,
    background (0) elsewhere."""

    def parse(d):
        x, y = d[0], d[1]
        return x, (y['damage'] if isinstance(y, dict) else y), {}

    def pred(y_true, y_pred, data_info, model_dir, checkpoint):
        loc, dam = y_pred
        lab = dam.argmax(dim=-1)
        gate = loc[..., 0] if loc.ndim == lab.ndim + 1 else loc
        return y_true, torch.where(gate > loc_threshold, lab, 0).int()

    return _make_eval_loop(damage_classes, parse, _tune_model_fn, pred, desc,
                           acc_table_based_callback, distributed=distributed,
                           cuda_empty_cache=True)


def distributed_evaluate_pixel_prediction_task(
        num_classes: int,
        data_parse_fn: Callable = _data_parse_fn,
        tune_model_fn: Callable = _tune_model_fn,
        prediction_fn: Callable = _process_prediction_fn,
        desc: str = '',
        acc_table_based_callback: Optional[Callable] = None,
        cuda_empty_cache: bool = True):
    """Exact distributed evaluation: disjoint per-process partitions, the
    matrices gathered and summed."""
    return _make_eval_loop(num_classes, data_parse_fn, tune_model_fn,
                           prediction_fn, desc, acc_table_based_callback,
                           distributed=True, cuda_empty_cache=cuda_empty_cache)
