"""Path-parity shim: ``ever.module.ppm`` (the implementations live in
:mod:`ever_tpu_torch.module.heads`)."""

from ever_tpu_torch.module.heads import PPMHead, PyramidPoolModule

__all__ = ['PyramidPoolModule', 'PPMHead']
