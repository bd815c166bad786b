"""Path-parity shim: ``ever.module.hrnet_head`` (the implementations live
in :mod:`ever_tpu_torch.module.heads`)."""

from ever_tpu_torch.module.heads import HRNetHead, SimpleFusion

__all__ = ['SimpleFusion', 'HRNetHead']
