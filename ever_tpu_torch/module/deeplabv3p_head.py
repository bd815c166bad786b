"""Path-parity shim: ``ever.module.deeplabv3p_head`` (the implementations
live in :mod:`ever_tpu_torch.module.heads`)."""

from ever_tpu_torch.module.heads import Deeplabv3pDecoder, Deeplabv3pHead

__all__ = ['Deeplabv3pDecoder', 'Deeplabv3pHead']
