"""DinoSeg and its layers in the PyTorch port against the JAX package.

The JAX model's weights go across through ``ever_tpu_torch.util.weight_io``,
and the same numpy inputs go through both models in float32.  The weights
are seeded random draws with O(1) LayerScale gammas, so that the attention
and FFN branches move the output (at their 1e-5 init value the blocks would
barely show).  Tolerances: 1e-4 on probabilities after 12
blocks of float32 arithmetic summed in different orders; 1e-5 on single
layers.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import vit as jvit
from ever_tpu.module.ops import resize as jresize
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.module.ops import resize as tresize
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg

SAT_STYLE = dict(name='vit_small', layerscale_init=1e-5, n_storage_tokens=4,
                 norm_eps=1e-5)


def _dinoseg_config(**backbone):
    return dict(backbone={**SAT_STYLE, **backbone}, classes=5, dtype='float32')


@pytest.fixture(scope='module')
def dinoseg_weights():
    """Seeded random weights in the JAX DinoSeg's parameter tree (shapes
    from ``eval_shape``, no compile): kernels ~N(0, 0.05²), norm scales and
    LayerScale gammas ~U(0.5, 1.5), biases and tokens ~N(0, 0.02²)."""
    model = jbuilder.make_model({'type': 'DinoSeg', 'params': _dinoseg_config(
        attn_impl='xla')})
    shapes = jax.eval_shape(
        lambda: model.init({'params': jax.random.key(0)},
                           jnp.zeros((1, 64, 64, 3), jnp.float32)))
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'gamma' in name or 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    return {'params': jax.tree_util.tree_map_with_path(draw, shapes['params'])}


@pytest.mark.parametrize('attn_impl', ['fused', 'xla'])
@pytest.mark.parametrize('pad_tokens', [False, True])
def test_dinoseg_probabilities_match_jax(dinoseg_weights, attn_impl, pad_tokens):
    """DinoSeg eval probabilities, port vs JAX, for the JAX fused kernel
    (interpret mode) and the XLA path, with and without stack padding (64²
    tiles: 21 tokens, padded to 128)."""
    cfg = _dinoseg_config(attn_impl=attn_impl, pad_tokens=pad_tokens)
    x = np.random.default_rng(11).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    want = np.asarray(jmodel.apply(dinoseg_weights, jnp.asarray(x), train=False))
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    tmodel.load_state_dict(convert_flax_dinoseg(dinoseg_weights), strict=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 64, 64, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('kw', [
    dict(),
    dict(rescale_coords=2.0, normalize_coords='max'),
    dict(base=None, min_period=0.5, max_period=80.0, normalize_coords='min'),
])
def test_rope_tables_match_jax(kw):
    jrope = jvit.RopePositionEmbedding(embed_dim=384, num_heads=6, **kw)
    jsin, jcos = jrope.apply({}, 6, 9)
    tsin, tcos = tvit.RopePositionEmbedding(384, 6, **kw)(6, 9)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=1e-5, atol=1e-5)


def test_mlp_uses_tanh_gelu_like_flax():
    """flax ``nn.gelu`` defaults to the tanh approximation."""
    rng = np.random.default_rng(1)
    x = rng.normal(scale=3.0, size=(4, 16)).astype(np.float32)
    jm = jvit.Mlp(hidden=32, out=16)
    v = jax.device_get(jm.init(jax.random.key(1), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tvit.Mlp(16, 32, 16)
    p = v['params']
    tm.load_state_dict({'fc1.weight': torch.tensor(np.asarray(p['fc1']['kernel']).T),
                        'fc1.bias': torch.tensor(np.asarray(p['fc1']['bias'])),
                        'fc2.weight': torch.tensor(np.asarray(p['fc2']['kernel']).T),
                        'fc2.bias': torch.tensor(np.asarray(p['fc2']['bias']))})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('mean,flax_tol', [(0.0, 1e-5), (30.0, 2e-3)])
def test_layernorm_against_flax_one_pass_variance(mean, flax_tol):
    """flax LayerNorm computes the variance in one pass, E[x²] − E[x]² in
    f32, which loses digits as the row mean grows (about 1e-3 at mean 30,
    width 1024).  The port's ``nn.LayerNorm`` stays within 1e-5 of the
    float64 answer at any mean; it meets flax to 1e-5 at mean 0 and within
    flax's own error at mean 30."""
    rng = np.random.default_rng(2)
    x = (mean + rng.normal(size=(4, 7, 1024))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 1024).astype(np.float32)
    bias = rng.normal(size=1024).astype(np.float32)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-5).apply(
        {'params': {'scale': scale, 'bias': bias}}, jnp.asarray(x)))
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True))
             / np.sqrt(x64.var(-1, keepdims=True) + 1e-5) * scale + bias)
    ln = torch.nn.LayerNorm(1024, eps=1e-5)
    ln.load_state_dict({'weight': torch.from_numpy(scale), 'bias': torch.from_numpy(bias)})
    block = tvit.SelfAttentionBlock(1024, 16, norm_eps=1e-5)
    assert isinstance(block.norm1, torch.nn.LayerNorm) and block.norm1.eps == 1e-5
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=flax_tol)


@pytest.mark.parametrize('method,shape', [('bilinear', (64, 48)),
                                          ('nearest', (64, 48)),
                                          ('nearest', (3, 5))])
def test_resize_matches_jax(method, shape):
    """DinoSeg's ×16 bilinear upsample (half-pixel centres, edge clamp) and
    nearest, against the JAX package's resize."""
    x = np.random.default_rng(3).normal(size=(2, 4, 3, 5)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), shape=shape, method=method))
    got = tresize(torch.from_numpy(x), shape=shape, method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_training_branch_not_ported_yet():
    m = tbuilder.make_model({'type': 'DinoSeg', 'params': _dinoseg_config()},
                            device='cpu')
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, dtype=torch.long), train=True)
    with pytest.raises(NotImplementedError):
        tbuilder.make_model({'type': 'DinoSeg', 'params': _dinoseg_config(remat='full')},
                            device='cpu')
