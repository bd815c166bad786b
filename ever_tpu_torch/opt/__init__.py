"""Optimizers and LR schedules (registered in ``OPT`` and ``LR``)."""

from ever_tpu_torch.opt import learning_rate, optimizer  # noqa: F401
from ever_tpu_torch.opt.learning_rate import (  # noqa: F401
    ConstantLearningRate,
    CosineAnnealingLearningRate,
    MultiStepLearningRate,
    PolyLearningRate,
    SearchLearningRate,
)
from ever_tpu_torch.opt.optimizer import DEFAULT_GRAD_CLIP, OptimizerFactory  # noqa: F401
