"""Component registries (PyTorch port's own copy).

Counterpart of ``ever_tpu/core/registry.py``: a ``Registry`` is a dict from
name to callable, populated by decorator or direct call.  A user project's
``module/`` and ``data/`` files register their classes when
:func:`register_dir` imports them (``register_all`` and friends take the
project's conventional directories).
"""

from __future__ import annotations

import glob
import hashlib
import importlib.util
import logging
import os
import sys
from typing import Callable, Optional, TypeVar

__all__ = ['Registry', 'MODEL', 'LR', 'OPT', 'LOSS', 'OP', 'DATASET', 'DATALOADER',
           'CALLBACK', 'register_file', 'register_dir', 'register_modules',
           'register_dataloaders', 'register_callbacks', 'register_all']

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
OP = Registry('op')
DATASET = Registry('dataset')
DATALOADER = Registry('dataloader')
CALLBACK = Registry('callback')

_REGISTERED_FILES: dict = {}


def register_file(py_file: str) -> None:
    """Import one ``.py`` file so that its registration decorators run,
    once per absolute path; a failed import can be retried."""
    py_file = os.path.abspath(py_file)
    if py_file in _REGISTERED_FILES:
        return
    base = os.path.splitext(os.path.basename(py_file))[0].replace('-', '_')
    digest = hashlib.sha1(py_file.encode('utf-8')).hexdigest()[:10]
    mod_name = f'ever_tpu_torch._user.{base}_{digest}'
    spec = importlib.util.spec_from_file_location(mod_name, py_file)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    try:
        spec.loader.exec_module(module)  # type: ignore[union-attr]
    except BaseException:
        sys.modules.pop(mod_name, None)
        raise
    _REGISTERED_FILES[py_file] = mod_name


def register_dir(dir_path: str, recursive: bool = False) -> None:
    """Import every ``.py`` file of a directory (its subdirectories too
    with ``recursive``), in sorted order, skipping names that start with
    ``_``."""
    pattern = (os.path.join(dir_path, '**', '*.py') if recursive
               else os.path.join(dir_path, '*.py'))
    for py_file in sorted(glob.glob(pattern, recursive=recursive)):
        if not os.path.basename(py_file).startswith('_'):
            register_file(py_file)


def register_modules() -> None:
    """Import the project's ``module/`` directory (relative to the working
    directory)."""
    register_dir('module')


def register_dataloaders() -> None:
    """Import the project's ``data/`` directory."""
    register_dir('data')


def register_callbacks() -> None:
    """Import the project's ``callback/`` directory."""
    register_dir('callback')


def register_all() -> None:
    """Import whichever of ``data/``, ``module/`` and ``callback/`` exist."""
    for d in ('data', 'module', 'callback'):
        if os.path.isdir(d):
            register_dir(d)
