"""Component registries (PyTorch port's own copy).

Counterpart of ``ever_tpu/core/registry.py``: a ``Registry`` is a dict from
name to callable, populated by decorator or direct call.  The port so far
needs ``MODEL``, ``LR``, ``OPT``, ``LOSS``, ``DATASET``, ``DATALOADER``
and ``CALLBACK``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, TypeVar

__all__ = ['Registry', 'MODEL', 'LR', 'OPT', 'LOSS', 'DATASET', 'DATALOADER',
           'CALLBACK']

logger = logging.getLogger('ever_tpu_torch.registry')

_T = TypeVar('_T')


class Registry(dict):
    """Name → callable registry with decorator registration.

    Three call styles: ``@R.register()`` / ``@R.register`` (name from
    ``__name__``), ``@R.register('name')``, and ``R.register('name', obj)``.
    """

    def __init__(self, name: str = ''):
        super().__init__()
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, key: str, obj: Callable) -> None:
        if key in self:
            logger.warning('%r is already registered in registry %r; '
                           'overwriting', key, self._name)
        self[key] = obj

    def register(self, name_or_obj=None, obj: Optional[Callable] = None):
        if callable(name_or_obj) and obj is None:
            self._do_register(name_or_obj.__name__, name_or_obj)
            return name_or_obj
        if obj is not None:
            self._do_register(name_or_obj, obj)
            return obj

        explicit = name_or_obj

        def deco(o: _T) -> _T:
            self._do_register(explicit or o.__name__, o)  # type: ignore[union-attr]
            return o

        return deco

    def __repr__(self) -> str:
        return f'Registry(name={self._name!r}, items={sorted(self.keys())})'


LR = Registry('learning_rate')
OPT = Registry('optimizer')
MODEL = Registry('model')
LOSS = Registry('loss')
DATASET = Registry('dataset')
DATALOADER = Registry('dataloader')
CALLBACK = Registry('callback')
