"""``ever.module.dinov3.models`` in the port."""

from ever_tpu_torch.module.dinov3.models.convnext import ConvNeXt, get_convnext_arch  # noqa: F401
from ever_tpu_torch.module.dinov3.models.vision_transformer import (  # noqa: F401
    DinoVisionTransformer, vit_7b, vit_base, vit_giant2, vit_huge2, vit_large, vit_small,
    vit_so400m, vit7b16_sat493m, vitl16_sat493m)
