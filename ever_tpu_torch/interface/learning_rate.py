"""LR schedule contract (PyTorch port's own copy).

Counterpart of ``ever_tpu/interface/learning_rate.py``: a schedule is a
plain function of the global step that returns a float.  The train step
writes ``schedule(step)`` into every ``param_group['lr']`` of its
``torch.optim`` optimizer before the update, at the step count before the
increment (the JAX step's convention); ``torch.optim.lr_scheduler``, which
counts differently, is not used.
"""

from __future__ import annotations

__all__ = ['LearningRateBase']


class LearningRateBase:
    def __init__(self, base_lr: float):
        self._base_lr = float(base_lr)

    @property
    def base_lr(self) -> float:
        return self._base_lr

    def value_at(self, global_step: int) -> float:
        """Return the LR at ``global_step``.  Override me."""
        raise NotImplementedError

    def __call__(self, global_step: int) -> float:
        return self.value_at(global_step)

    def step(self, global_step: int, optimizer=None) -> float:
        """The reference's surface: the LR at ``global_step``, also written
        into ``optimizer``'s param groups when one is given."""
        lr = self.value_at(global_step)
        if optimizer is not None:
            for group in optimizer.param_groups:
                group['lr'] = lr
        return lr
