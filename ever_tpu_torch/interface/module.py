"""`ERModule` — the configurable model base class (``torch.nn.Module`` edition).

Counterpart of ``ever_tpu/interface/module.py`` and
``ever_tpu/interface/configurable.py``: a module owns an :class:`AttrDict`
``config`` built from the class defaults (``set_default_config``) merged
recursively with the user's dict, so user configs only name deltas.  The
forward contract is ``forward(x, y=None, train=False)``: a loss dict when
training with labels, predictions otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from ever_tpu_torch.core.config import AttrDict

__all__ = ['ERModule']


class ERModule(nn.Module):
    """Configurable ``nn.Module``: ``config`` = defaults ⊕ user config.

    ::

        @MODEL.register()
        class MySeg(ERModule):
            def set_default_config(self):
                self.config.update(dict(classes=7, channels=256))

        m = MySeg(dict(classes=5))   # config.classes == 5, channels == 256
    """

    def __init__(self, config: Optional[dict] = None):
        super().__init__()
        self.config = AttrDict()
        self.set_default_config()
        if config:
            self.config.update(config)

    def set_default_config(self) -> None:
        """Populate ``self.config`` with class defaults (override me)."""

    def forward(self, x, y=None, train: bool = False):
        raise NotImplementedError
