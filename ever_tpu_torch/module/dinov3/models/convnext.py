"""``ever.module.dinov3.models.convnext``'s names in the port.

``LayerNorm`` is the channels-last norm (over the last axis, as the
reference's ``data_format='channels_last'``), ``Block`` the ConvNeXt block
and ``DropPath`` the module spelling of stochastic depth.
"""

from typing import Optional

import torch
import torch.nn as nn

from ever_tpu_torch.module.convnext import (CONVNEXT_SPECS, ConvNeXt,  # noqa: F401
                                            ConvNeXtBlock as Block)
from ever_tpu_torch.module.dinov3 import get_convnext_arch  # noqa: F401
from ever_tpu_torch.module.ops import sample_dropout
from ever_tpu_torch.module.vit import LayerNorm, drop_path  # noqa: F401


class DropPath(nn.Module):
    """Per-sample stochastic depth at ``rate``: in training each sample
    keeps its branch with probability ``1 - rate``, scaled by ``1/(1 -
    rate)``, drawn from ``generator``; the identity otherwise."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        return sample_dropout(x, self.rate, train, generator)


__all__ = ['drop_path', 'DropPath', 'Block', 'LayerNorm', 'ConvNeXt',
           'get_convnext_arch', 'CONVNEXT_SPECS']
