"""``ever.module.dinov3.layers.rope_position_encoding``'s names in the port."""

from ever_tpu_torch.module.vit import RopePositionEmbedding

__all__ = ['RopePositionEmbedding']
