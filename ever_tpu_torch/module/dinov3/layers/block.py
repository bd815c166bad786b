"""``ever.module.dinov3.layers.block``'s names in the port."""

from ever_tpu_torch.module.vit import CausalSelfAttentionBlock, SelfAttentionBlock

__all__ = ['SelfAttentionBlock', 'CausalSelfAttentionBlock']
