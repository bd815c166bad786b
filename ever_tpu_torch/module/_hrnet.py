"""Path-parity shim: ``ever.module._hrnet``, the reference's vendored
HRNetV2.

``HighResolutionNet`` is the reference's trunk class name; here it is
:class:`ever_tpu_torch.module.hrnet.HRNet`, parameterized by
``hrnet_type``, and each factory spelling returns one configured (weights
load through :mod:`ever_tpu_torch.util.weight_io`).
"""

from ever_tpu_torch.module._resnets import BasicBlock, Bottleneck, conv3x3
from ever_tpu_torch.module.context_block import constant_init, kaiming_init
from ever_tpu_torch.module.hrnet import HRNET_WIDTHS, HighResolutionModule, HRNet

HighResolutionNet = HRNet

__all__ = ['HighResolutionModule', 'HighResolutionNet', 'HRNet',
           'hrnetv2_w18', 'hrnetv2_w32', 'hrnetv2_w40', 'hrnetv2_w48',
           'BasicBlock', 'Bottleneck', 'conv3x3', 'constant_init', 'kaiming_init']


def _factory(name):
    def make(pretrained=False, **kwargs):
        del pretrained
        return HRNet(hrnet_type=name, **kwargs)
    make.__name__ = name
    make.__doc__ = f'The ``{name}`` trunk.'
    return make


for _name in HRNET_WIDTHS:
    globals()[_name] = _factory(_name)
