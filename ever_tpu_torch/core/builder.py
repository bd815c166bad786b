"""Build registered components from ``{type, params}`` config dicts."""

from __future__ import annotations

import inspect
from typing import Any, Optional, Tuple, Union

import torch

from ever_tpu_torch.core import registry
from ever_tpu_torch.core.config import AttrDict
from ever_tpu_torch.core.device import get_device

__all__ = ['make_model', 'make_dataloader', 'make_learningrate', 'make_optimizer',
           'make_callback']


def _params(config, what: str) -> dict:
    if 'type' not in config:
        raise KeyError(f'{what} config needs a "type" key, got {dict(config)}')
    return dict(config.get('params', {}) or {})


def make_model(config, device: Optional[Union[str, torch.device]] = None):
    """Build a model from ``{type, params}`` via the MODEL registry and move
    it to ``device`` (the GPU unless ``device='cpu'`` is given).

    ``ERModule`` subclasses receive the params dict as their single config
    argument; other modules receive ``**params``.
    """
    import ever_tpu_torch.module  # noqa: F401  (registers the model zoo)
    from ever_tpu_torch.interface.module import ERModule

    params = _params(config, 'model')
    cls = registry.MODEL[config['type']]
    if inspect.isclass(cls) and issubclass(cls, ERModule):
        model = cls(params)
    else:
        model = cls(**params)
    return model.to(get_device(device))


def make_learningrate(config) -> Any:
    """Build an LR schedule (a ``step -> float`` callable) from the LR
    registry."""
    import ever_tpu_torch.opt  # noqa: F401  (registers the schedules)
    return registry.LR[config['type']](**_params(config, 'learning_rate'))


def make_optimizer(config) -> Tuple[Any, AttrDict]:
    """Build an :class:`~ever_tpu_torch.opt.optimizer.OptimizerFactory`;
    returns ``(factory, opt_config)``.  ``opt_config`` carries
    ``grad_clip`` for ``factory.build(schedule, grad_clip=...)``."""
    import ever_tpu_torch.opt  # noqa: F401  (registers the optimizers)
    factory = registry.OPT[config['type']](**_params(config, 'optimizer'))
    return factory, AttrDict(config)


def make_dataloader(config):
    """Build a dataloader from the DATALOADER registry, or a DATASET entry
    turned into one by its ``to_dataloader()``."""
    params = _params(config, 'dataloader')
    t = config['type']
    if t in registry.DATALOADER:
        return registry.DATALOADER[t](params)
    if t in registry.DATASET:
        return registry.DATASET[t](params).to_dataloader()
    raise KeyError(f'{t!r} is registered in neither DATALOADER nor DATASET')


def make_callback(config):
    """Build a callback from the CALLBACK registry."""
    return registry.CALLBACK[config['type']](**_params(config, 'callback'))
