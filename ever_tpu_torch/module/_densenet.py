"""Path-parity shim: ``ever.module._densenet``, the reference's vendored
DenseNet.

``CollectibleSequential`` is the reference's feature-tapping
``nn.Sequential``: its forward returns every child's output in order.
Each factory spelling returns a :class:`~ever_tpu_torch.module.densenet.DenseNet`
trunk (weights load through :mod:`ever_tpu_torch.util.weight_io`).
"""

from typing import List

import torch
import torch.nn as nn

from ever_tpu_torch.module.densenet import DENSENET_SPECS, DenseNet

__all__ = ['DenseNet', 'CollectibleSequential',
           'densenet121', 'densenet161', 'densenet169', 'densenet201']


class CollectibleSequential(nn.Sequential):
    """``nn.Sequential`` whose forward returns the list of each child's
    output, in order."""

    def forward(self, x) -> List[torch.Tensor]:
        feats = []
        for layer in self:
            x = layer(x)
            feats.append(x)
        return feats


def _factory(name):
    def make(pretrained=False, **kwargs):
        del pretrained
        return DenseNet(densenet_type=name, **kwargs)
    make.__name__ = name
    make.__doc__ = f'The ``{name}`` trunk.'
    return make


for _name in DENSENET_SPECS:
    globals()[_name] = _factory(_name)
