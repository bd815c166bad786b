"""EVer-TPU's PyTorch/CUDA port.

A second package beside the JAX reference ``ever_tpu``: the same configs,
registries and models in PyTorch, with every TPU kernel on its path
rewritten by hand for Hopper (``csrc/``).  It imports neither JAX nor
``ever_tpu``.  Entry points run on the GPU unless given ``device='cpu'``.

The public surface follows ``ever_tpu/__init__.py`` as far as it is ported:
``registry, builder, config, to, param_util, data, metric, magic, opt,
preprocess, trainer, infer_tool``, the interface classes, ``sliding_window``,
``tiled_inference``, ``seed_everything`` and the TTA helpers.
"""

__version__ = '0.1.0'

from ever_tpu_torch.core import builder, config, dist, registry, to  # noqa: F401
from ever_tpu_torch.core.config import AttrDict, FrozenConfig, from_dict, import_config  # noqa: F401
from ever_tpu_torch.core.device import get_device  # noqa: F401
# data before the model zoo: the interface package needs data.distributed
from ever_tpu_torch import data  # noqa: F401  (registers the readers)
from ever_tpu_torch import module  # noqa: F401  (registers the model zoo)
from ever_tpu_torch import magic, metric, ops, opt, parallel, preprocess, trainer, util  # noqa: F401
from ever_tpu_torch.api import infer_tool  # noqa: F401
from ever_tpu_torch.core.logger import info  # noqa: F401
from ever_tpu_torch.core.to import auto_device  # noqa: F401
from ever_tpu_torch.data.distributed import (  # noqa: F401
    DistributedInfiniteSampler,
    DistributedNonOverlapSeqSampler,
    DistributedNonOverlapSubsetSeqSampler,
    RandomSampler,
    SequentialSampler,
    StepDistributedRandomSubsetSampler,
    StepDistributedSampler,
    SubsetRandomSampler,
    SubsetSampler,
    as_ddp_inference_loader,
)
from ever_tpu_torch.data.loveda import LoveDA  # noqa: F401
from ever_tpu_torch.interface import (  # noqa: F401
    Callback,
    ConfigurableMixin,
    ERDataLoader,
    ERDataset,
    ERModule,
    MultiTransform,
    Transform,
)
from ever_tpu_torch.interface.learning_rate import LearningRateBase  # noqa: F401
from ever_tpu_torch.magic.sliding_window import sliding_window  # noqa: F401
from ever_tpu_torch.magic.tiled import tiled_inference  # noqa: F401
from ever_tpu_torch.magic.transform import TestTimeAugmentation, d4_tta, tta  # noqa: F401
from ever_tpu_torch.util import param_util  # noqa: F401
from ever_tpu_torch.util.param_util import count_model_parameters  # noqa: F401
from ever_tpu_torch.util.seedlib import seed_everything, seed_torch  # noqa: F401

__all__ = [
    'builder', 'config', 'dist', 'registry', 'to', 'ops', 'opt', 'data', 'magic',
    'metric', 'module', 'parallel', 'preprocess', 'trainer', 'util', 'infer_tool', 'param_util',
    'AttrDict', 'FrozenConfig', 'from_dict', 'import_config', 'get_device',
    'Callback', 'ConfigurableMixin', 'ERDataLoader', 'ERDataset', 'ERModule',
    'LearningRateBase', 'MultiTransform', 'Transform', 'LoveDA',
    'sliding_window', 'tiled_inference', 'seed_everything', 'seed_torch',
    'count_model_parameters', 'auto_device', 'info', 'tta', 'd4_tta',
    'TestTimeAugmentation',
]
