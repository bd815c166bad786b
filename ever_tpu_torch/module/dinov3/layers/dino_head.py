"""``ever.module.dinov3.layers.dino_head``'s names in the port."""

from ever_tpu_torch.module.vit import DINOHead

__all__ = ['DINOHead']
