"""``ever.module.dinov3.layers`` in the port: the reference's layer names,
the fp8 (int8 on K7) and 2:4-sparse linears among them."""

from ever_tpu_torch.module.dinov3.layers.attention import (CausalSelfAttention,  # noqa: F401
                                                           LinearKMaskedBias, SelfAttention,
                                                           rope_apply, rope_rotate_half)
from ever_tpu_torch.module.dinov3.layers.block import (CausalSelfAttentionBlock,  # noqa: F401
                                                       SelfAttentionBlock)
from ever_tpu_torch.module.dinov3.layers.dino_head import DINOHead  # noqa: F401
from ever_tpu_torch.module.dinov3.layers.ffn_layers import (ListForwardMixin, Mlp,  # noqa: F401
                                                            SwiGLUFFN)
from ever_tpu_torch.module.dinov3.layers.fp8_linear import (Fp8Linear,  # noqa: F401
                                                            convert_linears_to_fp8)
from ever_tpu_torch.module.dinov3.layers.layer_scale import LayerScale  # noqa: F401
from ever_tpu_torch.module.dinov3.layers.patch_embed import PatchEmbed, make_2tuple  # noqa: F401
from ever_tpu_torch.module.dinov3.layers.rms_norm import RMSNorm  # noqa: F401
from ever_tpu_torch.module.dinov3.layers.rope_position_encoding import (  # noqa: F401
    RopePositionEmbedding)
from ever_tpu_torch.module.dinov3.layers.sparse_linear import LinearW24  # noqa: F401
