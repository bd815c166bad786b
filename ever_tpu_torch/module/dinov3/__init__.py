"""DINOv3's import surface (counterpart of ``ever_tpu/module/dinov3``).

The reference vendors Meta's DINOv3 as ``ever.module.dinov3``; the port's
trunk is ``module/vit.py`` and ``module/convnext.py``, and this package
keeps the reference's names over them (``layers``, ``models``, ``utils``),
so code written against ``from ever.module.dinov3.models.vision_transformer
import vit_large`` runs after an ``ever → ever_tpu_torch`` rename.  The
``layers`` package adds ``Fp8Linear`` (int8 on the kernel K7) and
``LinearW24`` (2:4 sparsity).
"""

from __future__ import annotations

from functools import partial

from ever_tpu_torch.module.convnext import CONVNEXT_SPECS, ConvNeXt
from ever_tpu_torch.module.vit import (SAT_CONFIGS, VIT_SPECS, CausalSelfAttention,  # noqa: F401
                                       CausalSelfAttentionBlock, DINOHead,
                                       DinoVisionTransformer, LayerScale, LinearKMaskedBias,
                                       ListForwardMixin, Mlp, PatchEmbed, RMSNorm,
                                       RopePositionEmbedding, SelfAttention,
                                       SelfAttentionBlock, SwiGLUFFN, cat_keep_shapes,
                                       init_weights_vit, make_2tuple, uncat_with_shapes)

__all__ = [
    'DinoVisionTransformer', 'DINOHead', 'RopePositionEmbedding', 'RMSNorm',
    'LayerScale', 'Mlp', 'SwiGLUFFN', 'SelfAttention', 'SelfAttentionBlock',
    'CausalSelfAttention', 'CausalSelfAttentionBlock', 'LinearKMaskedBias',
    'ListForwardMixin', 'init_weights_vit', 'make_2tuple',
    'PatchEmbed', 'cat_keep_shapes', 'uncat_with_shapes', 'get_convnext_arch',
    'vit_small', 'vit_base', 'vit_large', 'vit_so400m', 'vit_huge2',
    'vit_giant2', 'vit_7b', 'vitl16_sat493m', 'vit7b16_sat493m',
]


def _vit_factory(name):
    def factory(patch_size=16, **kwargs):
        return DinoVisionTransformer(vit_type=name, patch_size=patch_size, **kwargs)
    factory.__name__ = name
    factory.__doc__ = f'The ``{name}`` trunk (``VIT_SPECS``).'
    return factory


vit_small = _vit_factory('vit_small')
vit_base = _vit_factory('vit_base')
vit_large = _vit_factory('vit_large')
vit_so400m = _vit_factory('vit_so400m')
vit_huge2 = _vit_factory('vit_huge2')
vit_giant2 = _vit_factory('vit_giant2')
vit_7b = _vit_factory('vit_7b')


def _sat_factory(name):
    def factory(pretrained=None, **kwargs):
        """The satellite-pretrained trunk's configuration (``SAT_CONFIGS``).
        ``pretrained`` raises: load the reference's file with
        ``util.weight_io.load_weights`` (``convert_torch_dinov3_vit``)."""
        if pretrained:
            raise ValueError(
                'load pretrained torch weights with '
                'ever_tpu_torch.util.weight_io.load_weights (convert_torch_dinov3_vit) into '
                'the built model')
        return DinoVisionTransformer(**{**SAT_CONFIGS[name], **kwargs})
    factory.__name__ = name
    return factory


vitl16_sat493m = _sat_factory('vitl16_sat493m')
vit7b16_sat493m = _sat_factory('vit7b16_sat493m')


def get_convnext_arch(arch_name: str):
    """``'convnext_<size>…'`` → ``partial(ConvNeXt, model_name='convnext_<size>')``."""
    query = 'convnext_' + arch_name.split('_')[1]
    if query not in CONVNEXT_SPECS:
        raise NotImplementedError("didn't recognize vit size string")
    return partial(ConvNeXt, model_name=query)
