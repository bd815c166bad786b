"""Python-file config system (PyTorch port's own copy).

Counterpart of ``ever_tpu/core/config.py``: configs are plain Python files
that define a ``config`` dict; ``import_config`` executes the file and wraps
the dict in an :class:`AttrDict` (an ordered dict with attribute access,
recursive merge semantics and CLI dotted-key overrides).
"""

from __future__ import annotations

import ast
import copy as _copy
import importlib.util
import os
import pickle
from collections import OrderedDict
from typing import Any, Iterable, Sequence

__all__ = ['AttrDict', 'FrozenConfig', 'from_dict', 'from_pickle', 'import_config',
           'save_pkl', 'to_dict']


class AttrDict(OrderedDict):
    """Ordered dict with attribute access and recursive update.

    - ``d.key`` reads/writes ``d['key']``.
    - Nested plain dicts are promoted to ``AttrDict`` on construction and on
      assignment; lists/tuples of dicts are promoted element-wise.
    - :meth:`update` merges recursively: if both old and new values are dicts
      the old one is updated in place rather than replaced.
    - :meth:`update_from_list` applies CLI-style dotted-key overrides
      (``['train.lr', '0.1']``) with ``ast.literal_eval`` typing.
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        if args:
            if len(args) != 1:
                raise TypeError(f'AttrDict expected at most 1 positional '
                                f'argument, got {len(args)}')
            self._init_from(args[0])
        self._init_from(kwargs)

    def _init_from(self, mapping) -> None:
        items: Iterable = mapping.items() if hasattr(mapping, 'items') else mapping
        for k, v in items:
            self[k] = _promote(v)

    def __getattr__(self, name: str) -> Any:
        if name.startswith('__') and name.endswith('__'):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith('_OrderedDict__'):
            super().__setattr__(name, value)
        else:
            self[name] = _promote(value)

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, _promote(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def update(self, other=None, **kwargs):  # type: ignore[override]
        if other is not None:
            _recursive_update(self, other)
        if kwargs:
            _recursive_update(self, kwargs)
        return self

    def update_from_list(self, opts: Sequence[str]):
        """Apply flat ``[key, value, key, value, ...]`` dotted-path overrides.

        ``'true'``/``'false'`` (any case) become booleans, ``'null'`` becomes
        None, anything else goes through ``ast.literal_eval`` and stays a
        string when that fails.
        """
        if opts is None:
            return self
        if len(opts) % 2 != 0:
            raise ValueError(f'override list must have even length, '
                             f'got {len(opts)}: {opts}')
        for dotted, raw in zip(opts[0::2], opts[1::2]):
            low = raw.lower() if isinstance(raw, str) else raw
            if low in ('true', 'false'):
                value = (low == 'true')
            elif low == 'null':
                value = None
            else:
                try:
                    value = ast.literal_eval(raw)
                except (ValueError, SyntaxError):
                    value = raw
            node = self
            keys = dotted.split('.')
            for k in keys[:-1]:
                if k not in node or not isinstance(node[k], dict):
                    node[k] = AttrDict()
                node = node[k]
            node[keys[-1]] = value
        return self

    def to_dict(self) -> dict:
        """Deep-convert back to plain nested dicts/lists."""
        return _demote(self)

    def copy(self) -> 'AttrDict':  # type: ignore[override]
        return _copy.deepcopy(self)

    def __deepcopy__(self, memo) -> 'AttrDict':
        new = AttrDict()
        memo[id(self)] = new
        for k, v in self.items():
            OrderedDict.__setitem__(new, _copy.deepcopy(k, memo),
                                    _copy.deepcopy(v, memo))
        return new

    def __reduce__(self):
        return (AttrDict, (self.to_dict(),))


def _promote(value: Any) -> Any:
    if isinstance(value, AttrDict):
        return value
    if isinstance(value, dict):
        return AttrDict(value)
    if isinstance(value, (list, tuple)):
        promoted = [_promote(v) if isinstance(v, (dict, list, tuple)) else v
                    for v in value]
        return tuple(promoted) if isinstance(value, tuple) else promoted
    return value


def _demote(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _demote(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        out = [_demote(v) for v in value]
        return tuple(out) if isinstance(value, tuple) else out
    return value


def _recursive_update(dst: dict, src) -> None:
    items: Iterable = src.items() if hasattr(src, 'items') else src
    for k, v in items:
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _recursive_update(dst[k], v)
        else:
            dst[k] = _promote(v)


class FrozenConfig:
    """Read-only view of an :class:`AttrDict` (counterpart of the JAX
    package's ``FrozenConfig``): attribute and item access, iteration and
    ``get``; any assignment raises.  ``unfrozen()`` gives a mutable deep
    copy."""

    __slots__ = ('_d',)

    def __init__(self, d: dict):
        object.__setattr__(self, '_d', d if isinstance(d, AttrDict) else AttrDict(d))

    def __getattr__(self, name: str) -> Any:
        try:
            return self._d[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError('FrozenConfig is read-only')

    def __getitem__(self, key):
        return self._d[key]

    def __contains__(self, key) -> bool:
        return key in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, default=None):
        return self._d.get(key, default)

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def values(self):
        return self._d.values()

    def to_dict(self) -> dict:
        return self._d.to_dict()

    def unfrozen(self) -> AttrDict:
        return _copy.deepcopy(self._d)

    def __eq__(self, other) -> bool:
        if isinstance(other, FrozenConfig):
            return self._d == other._d
        return NotImplemented

    def __hash__(self):
        return hash(repr(self._d))

    def __repr__(self) -> str:
        return f'FrozenConfig({dict(self._d)!r})'


def from_dict(d: dict) -> AttrDict:
    return AttrDict(d)


def from_pickle(path: str) -> AttrDict:
    """A config pickled by :func:`save_pkl` (every model dir's
    ``config.pkl``)."""
    with open(path, 'rb') as f:
        cfg = pickle.load(f)
    return cfg if isinstance(cfg, AttrDict) else from_dict(cfg)


def to_dict(obj):
    """AttrDicts and FrozenConfigs, recursively, as plain containers."""
    if isinstance(obj, FrozenConfig):
        return obj.to_dict()
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def save_pkl(config: AttrDict, path: str) -> None:
    """Pickle a config (``import_config`` reads it back from ``.pkl``)."""
    with open(path, 'wb') as f:
        pickle.dump(config, f)


def import_config(config_path: str, prefix: str = 'configs') -> AttrDict:
    """Load a config from a ``.py`` file path, dotted module name, or ``.pkl``.

    - ``path/to/cfg.py`` — executed as a module; its ``config`` dict is
      wrapped in an :class:`AttrDict`.
    - ``cfgname`` or ``sub.cfgname`` — resolved to ``{prefix}/sub/cfgname.py``
      under the current working directory.
    - ``path/to/cfg.pkl`` — unpickled (a config saved by a training run).
    """
    if config_path.endswith('.pkl'):
        with open(config_path, 'rb') as f:
            cfg = pickle.load(f)
        return cfg if isinstance(cfg, AttrDict) else AttrDict(cfg)

    if (config_path.endswith('.py') or os.sep in config_path
            or os.path.isfile(config_path)):
        path = config_path
    else:
        path = os.path.join(prefix, *config_path.split('.')) + '.py'
    if not os.path.isfile(path):
        raise FileNotFoundError(f'config file not found: {path!r} '
                                f'(from {config_path!r})')

    spec = importlib.util.spec_from_file_location('_ever_tpu_torch_config', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    if not hasattr(module, 'config'):
        raise AttributeError(f'config file {path!r} does not define a '
                             f'`config` dict')
    return AttrDict(module.config)
