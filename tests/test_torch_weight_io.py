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


@pytest.mark.parametrize('variant', ['farseg_pp_se_gn', 'farseg_gc_ln', 'head_only'])
def test_flat_archives_of_the_new_variants_convert(variant):
    """The JAX package's flat ``params/…``/``batch_stats/…`` archive of a
    FarSeg++ with SE blocks and a GroupNorm decoder, of a FarSeg with GC
    blocks and a LayerNorm decoder, and of a bare FarSeg++ head:
    ``convert_flax_flat`` tells each apart, gives ``convert_flax_farseg``'s
    tensors, loads strictly, and the port's eval output is the JAX one's
    (1e-5; the JAX model under ``jax.jit``, about 6 times faster on a CPU
    than op by op)."""
    from ever_tpu.core import builder as jbuilder
    from ever_tpu_torch.util.weight_io import convert_flax_farseg, convert_flax_flat

    head = dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=64),
                fs_relation=dict(scene_embedding_channels=512, in_channels_list=(64,) * 4,
                                 out_channels=64),
                fpn_decoder=dict(in_channels=64, out_channels=32))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    if variant == 'head_only':
        cfg = dict(head, relation_type='v2', fpn_decoder=dict(
            head['fpn_decoder'], classifier_config=dict(num_classes=5, scale_factor=4.0)))
        kind = 'FarSegHead'
        inputs = [rng.normal(size=(1, 64 // s, 64 // s, c)).astype(np.float32)
                  for s, c in ((4, 64), (8, 128), (16, 256), (32, 512))]
    else:
        se = variant == 'farseg_pp_se_gn'
        cfg = dict(encoder=dict(resnet_type='resnet18', **(dict(se_ratio=8) if se
                                                            else dict(gc_ratio=0.25))),
                   classes=5, head=dict(head, relation_type='v2' if se else 'v1',
                                        fpn_decoder=dict(head['fpn_decoder'],
                                                         norm='gn' if se else 'ln')))
        kind, inputs = 'FarSeg', x
    jm = jbuilder.make_model({'type': kind, 'params': cfg})
    shapes = jax.eval_shape(lambda: jm.init({'params': jax.random.key(0)},
                                            jax.tree.map(jnp.asarray, inputs)))
    v = jax.tree.map(lambda s: (0.5 + rng.uniform(size=s.shape)).astype(np.float32), shapes)
    v['params'] = jax.tree.map(lambda a: (a - 1.0) * 0.3, v['params'])
    flat = {f'{c}/{k}': a for c in v for k, a in flatten_params(v[c]).items()}
    sd = convert_flax_flat(flat)
    tm = tbuilder.make_model({'type': kind, 'params': cfg}, device='cpu')
    tm.load_state_dict(sd, strict=True)
    if kind == 'FarSeg':
        want_sd = convert_flax_farseg(v)
        assert sd.keys() == want_sd.keys()
        assert any('.se.' in k or '.gc.' in k for k in sd)
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    else:
        assert any(k.startswith('fs_relation.project.') for k in sd)
        with torch.no_grad():
            got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in inputs])
        got = got.permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax.jit(jm.apply)(v, [jnp.asarray(f) for f in inputs]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
