"""``ever.module.dinov3.layers.layer_scale``'s names in the port."""

from ever_tpu_torch.module.vit import LayerScale

__all__ = ['LayerScale']
