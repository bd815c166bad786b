"""``ever.module.dinov3.models.vision_transformer``'s names in the port."""

from ever_tpu_torch.module.dinov3 import (vit_7b, vit_base, vit_giant2, vit_huge2,  # noqa: F401
                                          vit_large, vit_small, vit_so400m, vit7b16_sat493m,
                                          vitl16_sat493m)
from ever_tpu_torch.module.vit import (SAT_CONFIGS, VIT_SPECS, DinoVisionTransformer,  # noqa: F401
                                       init_weights_vit)

__all__ = ['init_weights_vit', 'DinoVisionTransformer', 'vit_small', 'vit_base', 'vit_large',
           'vit_so400m', 'vit_huge2', 'vit_giant2', 'vit_7b', 'vitl16_sat493m',
           'vit7b16_sat493m', 'VIT_SPECS', 'SAT_CONFIGS']
