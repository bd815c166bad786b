from ever_tpu_torch.interface.callback import (  # noqa: F401
    BestCheckpointCallback,
    Callback,
    EvaluationCallback,
    SaveCheckpointCallback,
)
from ever_tpu_torch.interface.configurable import ConfigurableMixin  # noqa: F401
from ever_tpu_torch.interface.dataloader import ERDataLoader, ERDataset  # noqa: F401
from ever_tpu_torch.interface.module import ERModule  # noqa: F401
from ever_tpu_torch.interface.transform_base import MultiTransform, Transform  # noqa: F401
