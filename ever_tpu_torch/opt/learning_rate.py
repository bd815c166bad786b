"""LR schedules (registered in ``LR``) as plain functions of the step.

Counterpart of ``ever_tpu/opt/learning_rate.py``: multistep / poly / cosine
/ constant / search schedules with linear / exp / constant warmup
(``WarmupMixin``).  Each returns a Python float; the values are those of the
JAX schedules, which compute in float32.
"""

from __future__ import annotations

import bisect
import math
from typing import Optional

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.learning_rate import LearningRateBase

__all__ = ['WarmupMixin', 'MultiStepLearningRate', 'PolyLearningRate',
           'CosineAnnealingLearningRate', 'ConstantLearningRate',
           'SearchLearningRate']


class WarmupMixin:
    """Warmup ramp applied for ``step <= warmup_step``.

    ``warmup = {type: 'linear'|'exp'|'constant', step: int, ratio: float}``.
    """

    def _init_warmup(self, warmup: Optional[dict]):
        self.warmup = dict(warmup) if warmup else None
        if warmup:
            self.warmup_type = warmup['type']
            self.warmup_step = int(warmup['step'])
            self.warmup_ratio = float(warmup['ratio'])
            if self.warmup_type not in ('linear', 'exp', 'constant'):
                raise ValueError(f'unknown warmup_type: {self.warmup_type}')
        else:
            self.warmup_type = None
            self.warmup_step = 0
            self.warmup_ratio = None

    def warmup_lr(self, step: int, base_lr: float) -> float:
        t = step / max(self.warmup_step, 1)
        if self.warmup_type == 'linear':
            return base_lr * (1.0 - (1.0 - t) * (1.0 - self.warmup_ratio))
        if self.warmup_type == 'exp':
            return base_lr * self.warmup_ratio ** (1.0 - t)
        return base_lr * self.warmup_ratio

    def with_warmup(self, step: int, main_lr: float) -> float:
        if self.warmup is not None and step <= self.warmup_step:
            return self.warmup_lr(step, self.base_lr)
        return main_lr


@registry.LR.register('multistep')
class MultiStepLearningRate(LearningRateBase, WarmupMixin):
    """``base_lr * gamma**(#milestones passed)``."""

    def __init__(self, steps, base_lr=0.1, gamma=0.1, warmup=None):
        super().__init__(base_lr)
        self._steps = [int(s) for s in steps]
        if any(b <= a for a, b in zip(self._steps, self._steps[1:])):
            raise ValueError(f'milestones must be increasing: {steps}')
        self._gamma = float(gamma)
        self._init_warmup(warmup)
        if self.warmup is not None and self.warmup_step >= self._steps[0]:
            raise ValueError('warmup_step must precede the first milestone')

    def value_at(self, global_step):
        n_passed = bisect.bisect_left(self._steps, global_step)   # milestones < step
        return self.with_warmup(global_step, self.base_lr * self._gamma ** n_passed)


@registry.LR.register('poly')
class PolyLearningRate(LearningRateBase, WarmupMixin):
    """``base_lr * (1 - (s - w)/(max - w))**power``."""

    def __init__(self, base_lr, power, max_iters, warmup=None):
        super().__init__(base_lr)
        self.power = float(power)
        self.max_iters = int(max_iters)
        self._init_warmup(warmup)
        if self.warmup_step >= self.max_iters:
            raise ValueError('warmup_step must be < max_iters')

    def value_at(self, global_step):
        frac = (global_step - self.warmup_step) / (self.max_iters - self.warmup_step)
        factor = max(1.0 - frac, 0.0) ** self.power
        return self.with_warmup(global_step, self.base_lr * factor)


@registry.LR.register('cosine')
class CosineAnnealingLearningRate(LearningRateBase, WarmupMixin):
    """Cosine decay to ``eta_min``, with the optional warmup ramp."""

    def __init__(self, base_lr, max_iters, eta_min=0.0, warmup=None):
        super().__init__(base_lr)
        self.eta_min = float(eta_min)
        self.max_iters = int(max_iters)
        self._init_warmup(warmup)
        if self.warmup_step >= self.max_iters:
            raise ValueError('warmup_step must be < max_iters')

    def value_at(self, global_step):
        frac = (global_step - self.warmup_step) / max(self.max_iters - self.warmup_step, 1)
        cos = math.cos(math.pi * min(max(frac, 0.0), 1.0))
        main = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (1.0 + cos)
        return self.with_warmup(global_step, main)


@registry.LR.register('constant')
class ConstantLearningRate(LearningRateBase):
    """Fixed LR."""

    def value_at(self, global_step):
        return self.base_lr


@registry.LR.register('search')
class SearchLearningRate(LearningRateBase):
    """Exponential LR sweep for range tests."""

    def __init__(self, init_lr, final_lr, max_iters):
        super().__init__(init_lr)
        if not (init_lr < final_lr and max_iters > 0):
            raise ValueError('need init_lr < final_lr and max_iters > 0')
        self.mult = (final_lr / init_lr) ** (1.0 / max_iters)

    def value_at(self, global_step):
        return self.base_lr * self.mult ** global_step
