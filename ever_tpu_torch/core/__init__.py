"""Config, registries, builders and the process group (counterpart of
``ever_tpu/core/__init__.py``).  These modules import nothing of
``interface``, which imports the registries from here."""

from ever_tpu_torch.core import builder, config, dist, registry  # noqa: F401
from ever_tpu_torch.core.config import AttrDict, FrozenConfig, from_dict, import_config  # noqa: F401

__all__ = ['builder', 'config', 'dist', 'registry', 'AttrDict', 'FrozenConfig',
           'from_dict', 'import_config']
