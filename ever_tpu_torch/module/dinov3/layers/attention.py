"""``ever.module.dinov3.layers.attention``'s names in the port (the
reference's ``dinov3/layers/attention.py``)."""

from ever_tpu_torch.module.vit import (CausalSelfAttention, LinearKMaskedBias, SelfAttention,
                                       rope_apply, rope_rotate_half)

__all__ = ['rope_rotate_half', 'rope_apply', 'LinearKMaskedBias', 'SelfAttention',
           'CausalSelfAttention']
