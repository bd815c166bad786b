"""Preprocessing (counterpart of ``ever_tpu/preprocess``): the numpy
family a reader's ``transforms`` list holds (``segm``, with the
albumentations spellings in ``albu`` and ``comm``), the tensor family
(``thcomm``, ``thsegm``), the functions they share (``function``) and the
batched augmentation on the device (``device``)."""

from ever_tpu_torch.preprocess import albu, comm, device, function, segm, thcomm, thsegm
from ever_tpu_torch.preprocess.albu import ConstantPad, ToTensor
from ever_tpu_torch.preprocess.function import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    divisible_pad,
    mean_std_normalize,
    pad_to_size,
)
from ever_tpu_torch.preprocess.segm import (
    ChannelFirstToLast,
    Compose,
    CustomOp,
    DivisiblePad,
    FixedPad,
    MeanStdNormalize,
    RandomCrop,
    RandomDiscreteScale,
    RandomHorizontalFlip,
    RandomRotate90K,
    RandomScale,
    RandomTranspose,
    RandomVerticalFlip,
    SpaceToDepth,
    ToArray,
    transpose,
)
