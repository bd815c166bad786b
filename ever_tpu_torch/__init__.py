"""EVer-TPU's PyTorch/CUDA port.

A second package beside the JAX reference ``ever_tpu``: the same configs,
registries and models in PyTorch, with every TPU kernel on its path
rewritten by hand for Hopper (``csrc/``).  It imports neither JAX nor
``ever_tpu``.  Entry points run on the GPU unless given ``device='cpu'``.
"""

__version__ = '0.1.0'

from ever_tpu_torch.core import builder, registry  # noqa: F401
from ever_tpu_torch.core.config import AttrDict, from_dict, import_config  # noqa: F401
from ever_tpu_torch.core.device import get_device  # noqa: F401
from ever_tpu_torch import module  # noqa: F401  (registers the model zoo)
from ever_tpu_torch.magic.tiled import tiled_inference  # noqa: F401
