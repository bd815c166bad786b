"""The reference's ``preprocess.comm`` path (counterpart of
``ever_tpu/preprocess/comm.py``): ``Compose`` and ``CustomOp`` of the numpy
family, and ``THMeanStdNormalize`` of the tensor family."""

from ever_tpu_torch.preprocess.segm import Compose, CustomOp
from ever_tpu_torch.preprocess.thcomm import THMeanStdNormalize

__all__ = ['Compose', 'CustomOp', 'THMeanStdNormalize']
