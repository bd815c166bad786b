"""Console and file logging with smoothing and ETA (counterpart of
``ever_tpu/core/logger.py``).

``Logger.train_log`` prints one line per logged step with the windowed
medians of the losses, the learning rate, the data time and the step time
(100-step running means) and the ETA; ``eval_log``, ``save_log``,
``restore_log`` and ``forward_times_log`` are the one-liners the launcher
and the checkpoint call.  ``TrainLogHook`` receives every logged step.  The
TensorBoard and wandb sinks are not ported (``ROADMAP.md`` A.5) and raise.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from typing import Dict, Optional

from ever_tpu_torch.core.dist import is_main_process

__all__ = ['info', 'Logger', 'SmoothedValue', 'TrainLogHook', 'get_console_file_logger',
           'get_logger']

_FORMAT = '%(asctime)s %(name)s %(levelname)s: %(message)s'
_SINKS_NOT_PORTED = ('the TensorBoard and wandb sinks are not ported yet '
                     '(ROADMAP.md A.5, the logger sinks)')


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
    model dir), a log file there."""

    def __init__(self, name: str = 'ever_tpu_torch', use_tensorboard: bool = False,
                 tensorboard_logdir: Optional[str] = None,
                 use_wandb: bool = False, wandb_config: Optional[dict] = None):
        if use_tensorboard or use_wandb:
            raise NotImplementedError(_SINKS_NOT_PORTED)
        del wandb_config
        self._logger = (get_console_file_logger(name, tensorboard_logdir)
                        if tensorboard_logdir else get_logger(name))
        self._smoothers: Dict[str, SmoothedValue] = {}
        self._hooks = []

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
        eta_sec = t.avg * max(num_iters - step, 0)
        h, rem = divmod(int(eta_sec), 3600)
        m, s = divmod(rem, 60)
        parts.append(f'data_time: {d.avg * 1000:.1f}ms')
        parts.append(f'time: {t.avg * 1000:.1f}ms/step')
        parts.append(f'eta: {h}:{m:02d}:{s:02d}')
        self._logger.info(', '.join(parts))

    def after_train(self) -> None:
        for hook in self._hooks:
            hook.after_train()

    def eval_log(self, metrics: Dict[str, float], step: int = 0) -> None:
        if not self.on():
            return
        line = ', '.join(f'{k}: {v:.4f}' if isinstance(v, float) else f'{k}: {v}'
                         for k, v in metrics.items())
        self._logger.info(f'[eval @ step {step}] {line}')

    def save_log(self, filename: str) -> None:
        self.info(f'checkpoint saved: {filename}')

    def restore_log(self, filepath: str) -> None:
        self.info(f'resumed from: {filepath}')

    def forward_times_log(self, forward_times: int) -> None:
        if forward_times > 1:
            self.info(f'gradient accumulation: forward_times = {forward_times}')
