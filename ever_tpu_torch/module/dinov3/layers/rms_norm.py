"""``ever.module.dinov3.layers.rms_norm``'s names in the port."""

from ever_tpu_torch.module.vit import RMSNorm

__all__ = ['RMSNorm']
