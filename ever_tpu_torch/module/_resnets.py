"""Path-parity shim: ``ever.module._resnets``, the reference's vendored
torchvision ResNet.

The trunk is :class:`ever_tpu_torch.module.resnet.ResNet`, parameterized by
``resnet_type``; each factory spelling returns one configured (weights load
through :mod:`ever_tpu_torch.util.weight_io`, so ``pretrained`` is taken
for the signature and ignored).  ``conv3x3`` and ``conv1x1`` take the input
width, as torchvision's do (flax infers it).
"""

from ever_tpu_torch.module.ops import Conv2d
from ever_tpu_torch.module.resnet import RESNET_SPECS, BasicBlock, Bottleneck, ResNet

__all__ = ['BasicBlock', 'Bottleneck', 'ResNet',
           'resnet18', 'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'resnext50_32x4d', 'resnext101_32x4d', 'resnext101_32x8d',
           'resnet50_v1c', 'resnet101_v1c', 'conv3x3', 'conv1x1']


def _factory(name):
    def make(pretrained=False, **kwargs):
        del pretrained
        return ResNet(resnet_type=name, **kwargs)
    make.__name__ = name
    make.__doc__ = f'The ``{name}`` trunk.'
    return make


for _name in RESNET_SPECS:
    globals()[_name] = _factory(_name)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> Conv2d:
    """3×3 conv without bias, padding ``dilation`` (torchvision's)."""
    return Conv2d(in_planes, out_planes, 3, stride, dilation, dilation, groups)


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> Conv2d:
    """1×1 conv without bias."""
    return Conv2d(in_planes, out_planes, 1, stride, 0)
