"""The flax → port weight converter, and its round trip through the JAX
package's ``convert_torch_dinov3_vit`` (the exact inverse: arrays compare
equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module.vit import DinoVisionTransformer as JaxViT
from ever_tpu.util.weight_io import convert_torch_dinov3_vit, flatten_tree
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module.vit import DinoVisionTransformer as TorchViT
from ever_tpu_torch.util.weight_io import (convert_flax_dinoseg,
                                           convert_flax_dinov3_vit, flatten_params)

TRUNKS = [
    dict(vit_type='vit_small', n_storage_tokens=4, layerscale_init=1e-5),
    # SwiGLU (w12 split), RMSNorm, an untied cls norm, no storage tokens,
    # no qkv bias
    dict(vit_type='vit_small', n_storage_tokens=0, ffn_layer='swiglu64',
         norm='rms', untie_cls_and_patch_norms=True, qkv_bias=False),
]


def _random_params(module, x_shape, seed):
    shapes = jax.eval_shape(lambda: module.init({'params': jax.random.key(0)},
                                                jnp.zeros(x_shape, jnp.float32)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        shapes['params'])


@pytest.mark.parametrize('kw', TRUNKS)
def test_trunk_round_trip_and_strict_load(kw):
    params = _random_params(JaxViT(**kw), (1, 32, 32, 3), seed=0)
    sd = convert_flax_dinov3_vit(params)
    model = TorchViT(**kw)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = convert_torch_dinov3_vit({k: v.numpy() for k, v in sd.items()})
    want = flatten_tree({'params': params})
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_dinoseg_strict_load_and_round_trip():
    from ever_tpu.core import builder as jbuilder

    cfg = dict(backbone=dict(name='vit_small'), classes=6,
               head=dict(hidden=32, n_taps=2))
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _random_params(jmodel, (1, 32, 32, 3), seed=1)
    sd = convert_flax_dinoseg({'params': params})
    model = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    np.testing.assert_array_equal(sd['head_classifier.weight'].numpy(),
                                  params['head_classifier']['kernel'].T)
    trunk = {k[len('vit.'):]: v.numpy() for k, v in sd.items() if k.startswith('vit.')}
    back = convert_torch_dinov3_vit(trunk)
    want = flatten_tree({'params': params['vit']})
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_flat_and_nested_inputs_agree_and_unknown_keys_raise():
    params = {'cls_token': np.ones((1, 1, 8), np.float32),
              'block0': {'attn': {'qkv': {'kernel': np.arange(24, dtype=np.float32).reshape(2, 12)}}}}
    flat = {'params/cls_token': params['cls_token'],
            'params/block0/attn/qkv/kernel': params['block0']['attn']['qkv']['kernel']}
    assert sorted(flatten_params({'params': params})) == sorted(flatten_params(flat))
    a, b = convert_flax_dinov3_vit(params), convert_flax_dinov3_vit(flat)
    assert sorted(a) == ['blocks.0.attn.qkv.weight', 'cls_token']
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(KeyError):
        convert_flax_dinov3_vit({'mystery': np.zeros(3)})
    with pytest.raises(KeyError):
        convert_flax_dinoseg({'head_other': {'kernel': np.zeros((2, 2))}})
