"""Console and file logging with smoothing and ETA (counterpart of
``ever_tpu/core/logger.py``).

``Logger.train_log`` prints one line per logged step with the windowed
medians of the losses, the learning rate, the data time and the step time
(100-step running means) and the ETA; ``eval_log``, ``save_log``,
``restore_log`` and ``forward_times_log`` are the one-liners the launcher
and the checkpoint call.  ``TrainLogHook`` receives every logged step.

On the main process the logger also feeds TensorBoard
(``use_tensorboard``: a ``torch.utils.tensorboard.SummaryWriter`` on the
model dir) and wandb (``use_wandb``: ``wandb.init(**wandb_config)``) with
the JAX package's scalar names and steps: ``train/{loss}``, ``train/lr``,
``train/time_per_step`` and ``eval/{metric}``, and weight histograms
``weights/{name}``.  Both are optional packages: when one does not import,
the logger warns and logs to the console and file alone, as the JAX
package does.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ever_tpu_torch.core.dist import is_main_process

__all__ = ['info', 'Logger', 'SmoothedValue', 'TrainLogHook', 'get_console_file_logger',
           'get_logger', 'eval_start', 'eval_progress', 'speed', 'save_log', 'restore_log']

_FORMAT = '%(asctime)s %(name)s %(levelname)s: %(message)s'


def get_logger(name: str = 'ever_tpu_torch') -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def info(msg: str) -> None:
    """Log ``msg`` on rank 0 through the port's logger."""
    if is_main_process():
        get_logger().info(msg)


def get_console_file_logger(name: str, logdir: str) -> logging.Logger:
    """Console logging plus one timestamped file under ``logdir`` on rank 0.

    One file handler per logger: the same ``logdir`` reuses it, a new one
    replaces it, so lines land only in the active run's file.
    """
    logger = get_logger(name)
    if is_main_process() and logdir:
        logdir = os.path.abspath(logdir)
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                if os.path.dirname(h.baseFilename) == logdir:
                    return logger
                logger.removeHandler(h)
                h.close()
        os.makedirs(logdir, exist_ok=True)
        fname = time.strftime('%Y-%m-%d-%H-%M-%S', time.localtime()) + '.log'
        fh = logging.FileHandler(os.path.join(logdir, fname))
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Windowed running median and mean."""

    def __init__(self, window_size: int = 100):
        self.deque = deque(maxlen=window_size)

    def update(self, value: float) -> None:
        self.deque.append(float(value))

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0


class TrainLogHook:
    """Receives every logged step and the end of training."""

    def after_iter(self, global_step: int, loss_dict: Dict[str, float],
                   learning_rate: float) -> None:
        pass

    def after_train(self) -> None:
        pass


class Logger:
    """The training logger: console and, with ``tensorboard_logdir`` (the
    model dir), a log file there; TensorBoard and wandb on request (module
    docstring)."""

    def __init__(self, name: str = 'ever_tpu_torch', use_tensorboard: bool = False,
                 tensorboard_logdir: Optional[str] = None,
                 use_wandb: bool = False, wandb_config: Optional[dict] = None):
        self._logger = (get_console_file_logger(name, tensorboard_logdir)
                        if tensorboard_logdir else get_logger(name))
        self._smoothers: Dict[str, SmoothedValue] = {}
        self._hooks = []
        self._tb = None
        self._wandb = None
        if use_tensorboard and tensorboard_logdir and is_main_process():
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._logger.warning('tensorboard unavailable; skipping TB sink')
            else:
                self._tb = SummaryWriter(log_dir=tensorboard_logdir)
        if use_wandb and is_main_process():
            try:
                import wandb
            except ImportError:
                self._logger.warning('wandb unavailable; skipping wandb sink')
            else:
                wandb.init(**(wandb_config or {}))
                self._wandb = wandb

    def register_train_log_hook(self, hook: TrainLogHook) -> None:
        self._hooks.append(hook)

    def on(self) -> bool:
        return is_main_process()

    def info(self, msg: str) -> None:
        if self.on():
            self._logger.info(msg)

    def _smooth(self, key: str, value: float) -> SmoothedValue:
        sm = self._smoothers.setdefault(key, SmoothedValue())
        sm.update(value)
        return sm

    def train_log(self, step: int, num_iters: int, loss_dict: Dict[str, float],
                  data_time: float, time_cost: float, learning_rate: float) -> None:
        """One step's line: smoothed losses, LR, data time, step time, ETA."""
        for hook in self._hooks:
            hook.after_iter(step, loss_dict, learning_rate)
        if not self.on():
            return
        t = self._smooth('time_cost', time_cost)
        d = self._smooth('data_time', data_time)
        parts = [f'step: {step}/{num_iters}', f'lr: {learning_rate:.6f}']
        for k, v in loss_dict.items():
            parts.append(f'{k}: {self._smooth(k, float(v)).median:.4f}')
            if self._tb:
                self._tb.add_scalar(f'train/{k}', float(v), step)
        eta_sec = t.avg * max(num_iters - step, 0)
        h, rem = divmod(int(eta_sec), 3600)
        m, s = divmod(rem, 60)
        parts.append(f'data_time: {d.avg * 1000:.1f}ms')
        parts.append(f'time: {t.avg * 1000:.1f}ms/step')
        parts.append(f'eta: {h}:{m:02d}:{s:02d}')
        self._logger.info(', '.join(parts))
        if self._tb:
            self._tb.add_scalar('train/lr', learning_rate, step)
            self._tb.add_scalar('train/time_per_step', t.avg, step)
        if self._wandb:
            payload = {f'train/{k}': float(v) for k, v in loss_dict.items()}
            payload['train/lr'] = learning_rate
            self._wandb.log(payload, step=step)

    def after_train(self) -> None:
        for hook in self._hooks:
            hook.after_train()

    def log_histograms(self, state_dict, step: int, prefix: str = 'weights') -> None:
        """A TensorBoard histogram ``{prefix}/{name}`` of every tensor (or
        array) of a ``state_dict`` (the model's parameters and buffers,
        dotted names); nothing without the TensorBoard sink."""
        if not (self.on() and self._tb):
            return
        for name, value in state_dict.items():
            if torch.is_tensor(value):
                value = value.detach().float().cpu().numpy()
            self._tb.add_histogram(f'{prefix}/{name}', np.asarray(value), step)

    def eval_log(self, metrics: Dict[str, float], step: int = 0) -> None:
        if not self.on():
            return
        line = ', '.join(f'{k}: {v:.4f}' if isinstance(v, float) else f'{k}: {v}'
                         for k, v in metrics.items())
        self._logger.info(f'[eval @ step {step}] {line}')
        if self._tb:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f'eval/{k}', v, step)
        if self._wandb:
            self._wandb.log({f'eval/{k}': v for k, v in metrics.items()
                             if isinstance(v, (int, float))}, step=step)

    def save_log(self, filename: str) -> None:
        self.info(f'checkpoint saved: {filename}')

    def restore_log(self, filepath: str) -> None:
        self.info(f'resumed from: {filepath}')

    def forward_times_log(self, forward_times: int) -> None:
        if forward_times > 1:
            self.info(f'gradient accumulation: forward_times = {forward_times}')

    def close(self) -> None:
        """Flush and close the TensorBoard writer and finish the wandb run."""
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()


def eval_start(logger: logging.Logger) -> None:
    logger.info('Start evaluation at {}'.format(
        time.strftime('%Y-%m-%d %H:%M:%S', time.localtime())))


def eval_progress(logger: logging.Logger, cur: int, total: int) -> None:
    logger.info('[Eval] {}/{}'.format(cur, total))


def speed(logger: logging.Logger, sec: float, unit: str = 'im') -> None:
    logger.info('[Speed] {} s/{}'.format(sec, unit))


def save_log(logger: logging.Logger, checkpoint_name) -> None:
    logger.info('{} has been saved.'.format(checkpoint_name))


def restore_log(logger: logging.Logger, checkpoint_name) -> None:
    logger.info('{} has been restored.'.format(checkpoint_name))
