"""The model zoo (counterpart of ``ever_tpu/module/__init__.py``, as far as
it is ported): importing it registers the models in ``MODEL`` (the heads,
the HRNet, EfficientNet, DenseNet, ResNeSt, ConvNeXt and ViT encoders,
FreeNet and the DCGAN among them) and ``ChangeMixin``, the heads' blocks, the FPNs,
``Fusion``, the SE, GC and FarSeg relation blocks and ``SpectralAttention``
in ``OP``; ``dinov3`` is the reference's DINOv3 namespace."""

from ever_tpu_torch.module import dinov3, loss, ops  # noqa: F401
from ever_tpu_torch.module import vit  # noqa: F401  (registers the ViT models)
from ever_tpu_torch.module import fs_relation  # noqa: F401  (FarSeg and the ResNets)
from ever_tpu_torch.module import change, factseg  # noqa: F401
from ever_tpu_torch.module.change import ChangeMask, ChangeMixin, ChangeOS, ChangeStar  # noqa: F401
from ever_tpu_torch.module.context_block import ContextBlock2d  # noqa: F401
from ever_tpu_torch.module.convnext import ConvNeXt, ConvNeXtEncoder  # noqa: F401
from ever_tpu_torch.module.densenet import DenseNet, DenseNetEncoder  # noqa: F401
from ever_tpu_torch.module.efficientnet import EfficientNet, EFNetEncoder  # noqa: F401
from ever_tpu_torch.module.factseg import FactSeg  # noqa: F401
from ever_tpu_torch.module.freenet import FreeNet, SpectralAttention  # noqa: F401
from ever_tpu_torch.module.gan import DCGAN, DCGANDiscriminator, DCGANGenerator  # noqa: F401
from ever_tpu_torch.module.fpn import (  # noqa: F401
    FPN, AssymetricDecoder, BiFPN, FastNormalizedFusionConv3x3, Fusion, LastLevelMaxPool,
    LastLevelP6P7, NormalizedFusionConv3x3, conv_with_kaiming_uniform)
from ever_tpu_torch.module.fs_relation import FarSeg, FarSegHead, FSRelation, FSRelationV2  # noqa: F401
from ever_tpu_torch.module.heads import (  # noqa: F401
    ASPPHead, AtrousSpatialPyramidPool, Deeplabv3pDecoder, Deeplabv3pHead, HRNetHead, PPMHead,
    PyramidPoolModule, SimpleFusion)
from ever_tpu_torch.module.hrnet import HRNet, HRNetEncoder  # noqa: F401
from ever_tpu_torch.module.misc import PadCropWrapper  # noqa: F401
from ever_tpu_torch.module.ops import (  # noqa: F401
    Bf16compatible, ChannelConcat, ChannelReduction, ConvBlock, ConvUpsampling, DepthwiseConv2d,
    LayerNorm2d, ListIndex, PoolBlock, ResidualBlock, SeparableConv2d, SeparableConvBlock,
    Squeeze, Sum)
from ever_tpu_torch.module.resnest import ResNeSt, ResNeStEncoder, SplAtConv2d  # noqa: F401
from ever_tpu_torch.module.resnet import ResNet, ResNetEncoder  # noqa: F401
from ever_tpu_torch.module.se_block import SCSEModule, SEBlock  # noqa: F401
from ever_tpu_torch.module.vit import (  # noqa: F401
    DinoSeg, DinoVisionTransformer, RMSNorm, ViTEncoder)
