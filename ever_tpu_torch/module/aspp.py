"""Path-parity shim: ``ever.module.aspp`` (the implementations live in
:mod:`ever_tpu_torch.module.heads`)."""

from ever_tpu_torch.module.heads import ASPPHead, AtrousSpatialPyramidPool

__all__ = ['AtrousSpatialPyramidPool', 'ASPPHead']
