"""Epoch-interval callbacks (counterpart of ``ever_tpu/interface/callback.py``).

A callback carries an ``epoch_interval``, an ``only_master`` flag, a
``prior`` ordering key (the launcher sorts its callbacks by it: lower runs
first) and ``before_train``/``after_train`` flags; its properties reach into
the launcher.  Built in: checkpoint save, best checkpoint and evaluation.
"""

from __future__ import annotations

from typing import Optional


class Callback:
    def __init__(self,
                 epoch_interval: int,
                 only_master: bool,
                 prior: int = 100,
                 before_train: bool = False,
                 after_train: bool = False):
        self._epoch_interval = epoch_interval
        self._only_master = only_master
        self._prior = prior
        self._launcher = None
        self.before_train = before_train
        self.after_train = after_train

    def name(self) -> str:
        return ''

    def func(self):
        return NotImplemented

    @property
    def interval(self) -> int:
        return self._epoch_interval

    @property
    def only_master(self) -> bool:
        return self._only_master

    @property
    def prior(self) -> int:
        return self._prior

    @property
    def launcher(self):
        return self._launcher

    def set_launcher(self, launcher) -> None:
        self._launcher = launcher

    # -- accessors into the launcher ----------------------------------------
    @property
    def model(self):
        return self._launcher.model

    @property
    def unwrapped_model(self):
        return self._launcher.model

    model_without_ddp = unwrapped_model

    @property
    def model_dir(self):
        return self._launcher.model_dir

    @property
    def global_step(self):
        return self._launcher.global_step

    @property
    def learning_rate(self):
        return self._launcher.lr

    @property
    def logger(self):
        return self._launcher.logger

    def info(self, msg: str) -> None:
        self._launcher.info(msg)

    def save_model(self, filename: Optional[str] = None) -> None:
        self._launcher.save_model(filename)


class SaveCheckpointCallback(Callback):
    """Save a checkpoint every N epochs and after training (prior 0: runs
    first)."""

    def __init__(self, epoch_interval: int):
        super().__init__(epoch_interval=epoch_interval, only_master=True, prior=0,
                         before_train=False, after_train=True)

    @property
    def only_master(self) -> bool:
        """False for a directory backend over several processes: its save
        is a collective every rank enters."""
        from ever_tpu_torch.core.dist import get_world_size
        tl = self._launcher
        return tl is None or tl.checkpoint.backend == 'msgpack' or get_world_size() == 1

    def func(self):
        self.launcher.checkpoint.save()

    def name(self) -> str:
        return 'SaveCheckpoint'


class BestCheckpointCallback(Callback):
    """Track an eval metric and keep ``model-best.ckpt`` updated.
    ``metric_fn(launcher) -> float`` extracts the score after each
    evaluation (higher is better with ``mode='max'``)."""

    def __init__(self, dataloader, epoch_interval: int, metric_fn,
                 mode: str = 'max', only_master: bool = True,
                 after_train: bool = True, config=None):
        super().__init__(epoch_interval=epoch_interval, only_master=only_master,
                         before_train=False, after_train=after_train)
        self._dataloader = dataloader
        self._metric_fn = metric_fn
        self._mode = mode
        self._best: Optional[float] = None
        self._config = config

    def func(self):
        self.launcher.evaluate(self._dataloader, config=self._config)
        score = float(self._metric_fn(self.launcher))
        better = (self._best is None
                  or (score > self._best if self._mode == 'max' else score < self._best))
        if better:
            self._best = score
            self.launcher.checkpoint.save('model-best.ckpt')
            self.info(f'new best score {score:.5f} → model-best.ckpt')

    def name(self) -> str:
        return 'BestCheckpoint'


class EvaluationCallback(Callback):
    """Run ``launcher.evaluate`` every N epochs."""

    def __init__(self, dataloader, epoch_interval: int, only_master: bool,
                 after_train: bool = True, config=None):
        super().__init__(epoch_interval=epoch_interval, only_master=only_master,
                         before_train=False, after_train=after_train)
        self._dataloader = dataloader
        self._config = config

    def func(self):
        self.launcher.evaluate(self._dataloader, config=self._config)

    def name(self) -> str:
        return 'Evaluation'


__all__ = ['Callback', 'SaveCheckpointCallback', 'EvaluationCallback',
           'BestCheckpointCallback']
