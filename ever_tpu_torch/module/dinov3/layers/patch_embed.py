"""``ever.module.dinov3.layers.patch_embed``'s names in the port."""

from ever_tpu_torch.module.vit import PatchEmbed, make_2tuple

__all__ = ['make_2tuple', 'PatchEmbed']
