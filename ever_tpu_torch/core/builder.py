"""Build registered components from ``{type, params}`` config dicts."""

from __future__ import annotations

import inspect
from typing import Optional, Union

import torch

from ever_tpu_torch.core import registry
from ever_tpu_torch.core.device import get_device

__all__ = ['make_model']


def make_model(config, device: Optional[Union[str, torch.device]] = None):
    """Build a model from ``{type, params}`` via the MODEL registry and move
    it to ``device`` (the GPU unless ``device='cpu'`` is given).

    ``ERModule`` subclasses receive the params dict as their single config
    argument; other modules receive ``**params``.
    """
    import ever_tpu_torch.module  # noqa: F401  (registers the model zoo)
    from ever_tpu_torch.interface.module import ERModule

    if 'type' not in config:
        raise KeyError(f'model config needs a "type" key, got {dict(config)}')
    params = dict(config.get('params', {}) or {})
    cls = registry.MODEL[config['type']]
    if inspect.isclass(cls) and issubclass(cls, ERModule):
        model = cls(params)
    else:
        model = cls(**params)
    return model.to(get_device(device))
