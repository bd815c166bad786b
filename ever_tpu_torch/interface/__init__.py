from ever_tpu_torch.interface.callback import (  # noqa: F401
    BestCheckpointCallback,
    Callback,
    EvaluationCallback,
    SaveCheckpointCallback,
)
from ever_tpu_torch.interface.configurable import ConfigurableMixin  # noqa: F401
from ever_tpu_torch.interface.dataloader import ERDataLoader, ERDataset  # noqa: F401
from ever_tpu_torch.interface.learning_rate import LearningRateBase  # noqa: F401
from ever_tpu_torch.interface.module import ERModule, split_metrics, sum_losses  # noqa: F401
from ever_tpu_torch.interface.transform_base import MultiTransform, Transform  # noqa: F401

__all__ = [
    'Callback', 'EvaluationCallback', 'SaveCheckpointCallback', 'BestCheckpointCallback',
    'ConfigurableMixin', 'ERDataLoader', 'ERDataset', 'LearningRateBase',
    'ERModule', 'sum_losses', 'split_metrics', 'MultiTransform', 'Transform',
]
