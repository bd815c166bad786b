"""`ERModule` — the configurable model base class (``torch.nn.Module`` edition).

Counterpart of ``ever_tpu/interface/module.py`` and
``ever_tpu/interface/configurable.py``: a module owns an :class:`AttrDict`
``config`` built from the class defaults (``set_default_config``) merged
recursively with the user's dict, so user configs only name deltas.  The
forward contract is ``forward(x, y=None, train=False)``: a loss dict when
training with labels, predictions otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ever_tpu_torch.core.config import AttrDict

__all__ = ['ERModule', 'sum_losses', 'split_metrics']


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


def sum_losses(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum every ``*loss`` entry of a forward output dict into the objective,
    in float32.  Other keys are metrics and are left out.  The sum stays on
    the losses' device: a host-made zero copied there would make the host
    wait for the card in every step."""
    losses = [v.float() for k, v in loss_dict.items() if k.endswith('loss')]
    if not losses:
        return torch.zeros(())
    total = losses[0]
    for v in losses[1:]:
        total = total + v
    return total


def split_metrics(loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All entries (losses and metrics) as detached float32 scalars."""
    return {k: torch.as_tensor(v).detach().float() for k, v in loss_dict.items()}
