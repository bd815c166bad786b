"""Default-config ⊕ user-config merge (counterpart of
``ever_tpu/interface/configurable.py``).

A configurable object owns an :class:`~ever_tpu_torch.core.config.AttrDict`
``config`` filled by ``set_default_config()`` and then updated recursively
with the user's config, so user configs only name deltas.
"""

from __future__ import annotations

from typing import Optional

from ever_tpu_torch.core.config import AttrDict

__all__ = ['ConfigurableMixin', 'merge_config']


class ConfigurableMixin:
    """Holds a merged ``config`` AttrDict: class defaults ⊕ user overrides."""

    def __init__(self, config: Optional[dict] = None):
        self._config = AttrDict()
        self.set_default_config()
        if config:
            self._config.update(config)

    @property
    def config(self) -> AttrDict:
        return self._config

    def set_default_config(self) -> None:
        """Subclasses fill ``self.config`` with defaults here."""


def merge_config(defaults: dict, user: Optional[dict]) -> AttrDict:
    """The functional form of the default ⊕ user merge."""
    cfg = AttrDict(defaults or {})
    if user:
        cfg.update(user)
    return cfg
