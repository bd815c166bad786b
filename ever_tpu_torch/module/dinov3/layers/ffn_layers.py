"""``ever.module.dinov3.layers.ffn_layers``'s names in the port."""

from ever_tpu_torch.module.vit import ListForwardMixin, Mlp, SwiGLUFFN

__all__ = ['ListForwardMixin', 'Mlp', 'SwiGLUFFN']
