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
from ever_tpu_torch.ops.norm import FusedLayerNorm
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


def test_fused_layer_norm_dinoseg_probabilities_match_jax(dinoseg_weights, monkeypatch):
    """DinoSeg with ``EVER_FUSED_LN=1`` in both packages (the JAX module
    reads it when applied, the port when built): every LayerNorm of the
    trunk is the fused one, whose CPU math is the JAX kernel's one-pass
    statistics in both.  The probabilities agree within 5e-6 (6e-7
    measured: float32 sums in other orders), where the default LayerNorm's
    comparison above allows 1e-4 for torch's two-pass variance against
    flax's one-pass one."""
    monkeypatch.setenv('EVER_FUSED_LN', '1')
    cfg = _dinoseg_config(attn_impl='xla')
    x = np.random.default_rng(11).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    want = np.asarray(jmodel.apply(dinoseg_weights, jnp.asarray(x), train=False))
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    norms = [m for m in tmodel.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 12 + 1 and all(isinstance(m, FusedLayerNorm) for m in norms)
    tmodel.load_state_dict(convert_flax_dinoseg(dinoseg_weights), strict=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


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


@pytest.mark.parametrize('hw,shape', [((32, 32), (512, 512)), ((5, 7), (20, 21)),
                                      ((4, 3), (4, 48))])
def test_upsample_bilinear_matches_resize_and_jax(hw, shape):
    """DinoSeg's logits upsample as two matrix products: the JAX package's
    bilinear resize to 1e-5 and the port's ``resize`` (``F.interpolate``),
    forward and backward, to float32 rounding (sums in other orders)."""
    from ever_tpu_torch.module.ops import upsample_bilinear
    x = np.random.default_rng(4).normal(size=(2, *hw, 7)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), shape=shape, method='bilinear'))
    xt = torch.from_numpy(x).requires_grad_()
    got = upsample_bilinear(xt, shape)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    ref = tresize(xt, shape=shape, method='bilinear')
    g = torch.from_numpy(np.random.default_rng(5).normal(size=want.shape).astype(np.float32))
    (dgot,), (dref,) = torch.autograd.grad(got, xt, g), torch.autograd.grad(ref, xt, g)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dgot, dref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='shrinks'):
        upsample_bilinear(xt, (hw[0] - 1, shape[1]))


# -- training parts of the trunk -------------------------------------------------

_AUGS = {'shift': dict(shift_coords=0.5), 'jitter': dict(jitter_coords=1.5),
         'rescale': dict(rescale_coords=2.0),
         'all': dict(shift_coords=0.3, jitter_coords=1.4, rescale_coords=2.0)}


@pytest.mark.parametrize('kind', sorted(_AUGS))
def test_rope_augmentation_matches_jax_at_given_draws(monkeypatch, kind):
    """The train-time RoPE tables at fixed uniform draws: the JAX module's
    ``jax.random.uniform`` returns the given u, and the port gets the same u
    through its draw formula.  Float32 angles, tolerance 1e-5."""
    aug = _AUGS[kind]
    values = {'shift': [0.13, 0.71], 'jitter': [0.42, 0.95], 'rescale': [0.27]}
    order = [k for k in ('shift', 'jitter', 'rescale') if f'{k}_coords' in aug]
    jax_u = [np.array(values[k], np.float32) for k in order]

    def fake_uniform(key, shape, minval=0.0, maxval=1.0, **kw):
        draw = jax_u.pop(0)
        assert draw.shape == tuple(shape)
        return minval + jnp.asarray(draw) * (maxval - minval)

    monkeypatch.setattr(jax.random, 'uniform', fake_uniform)
    jrope = jvit.RopePositionEmbedding(embed_dim=384, num_heads=6, **aug)
    jsin, jcos = jrope.apply({}, 6, 9, train=True, rngs={'dropout': jax.random.key(0)})
    assert not jax_u
    trope = tvit.RopePositionEmbedding(384, 6, **aug)

    class Gen:          # a generator whose rand() returns the same u in turn
        device = torch.device('cpu')

    torch_u = [torch.tensor(values[k]) for k in order]
    monkeypatch.setattr(torch, 'rand', lambda n, generator, device: torch_u.pop(0))
    draws = trope.draw(Gen())
    assert set(draws) == {k for k in ('shift', 'jitter', 'rescale')
                          if f'{k}_coords' in aug}
    tsin, tcos = trope(6, 9, **draws)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=1e-5, atol=1e-5)


def _trunk(**kw):
    torch.manual_seed(0)
    return tvit.DinoVisionTransformer('vit_small', n_storage_tokens=4,
                                      layerscale_init=1.0, **kw)


def test_rope_augmentation_draws_anew_for_every_block():
    """In training every block gets its own tables, drawn from the given
    generator (the same seed gives the same tables); in eval every block
    gets the plain tables."""
    vit = _trunk(pos_embed_rope_rescale_coords=2.0)
    seen = []
    for blk in vit.blocks:
        blk.attn.register_forward_pre_hook(lambda m, a: seen.append(a[1][0].clone()))
    x = torch.randn(1, 32, 32, 3)
    with torch.no_grad():
        vit(x, train=True, generator=torch.Generator().manual_seed(1))
        first, seen[:] = list(seen), []
        vit(x, train=True, generator=torch.Generator().manual_seed(1))
        again, seen[:] = list(seen), []
        vit(x, train=False)
    assert len(first) == 12
    assert all(not torch.equal(a, b) for a, b in zip(first, first[1:]))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    plain = tvit.RopePositionEmbedding(384, 6)(2, 2)[0]
    assert all(torch.equal(t, plain) for t in seen)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_drop_path_with_the_mask_fed_in_matches_jax(rate):
    """Per-sample stochastic depth from the JAX package's Bernoulli mask,
    fed to the port: the same output (x·mask / keep)."""
    x = np.random.default_rng(4).normal(size=(16, 5, 8)).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(jvit.drop_path(jnp.asarray(x), rate, False, key))
    mask = np.array(jax.random.bernoulli(key, 1.0 - rate, (16, 1, 1)))[:, 0, 0]
    got = tvit.drop_path(torch.from_numpy(x), rate, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(tvit.drop_path(torch.from_numpy(x), rate, None), torch.from_numpy(x))


@pytest.mark.parametrize('rate', [0.1, 0.4])
def test_drop_path_keep_rate_over_many_draws(rate):
    """The masks keep each sample with probability 1 - rate: 40000 draws
    land within 4.5 standard deviations of it."""
    gen = torch.Generator().manual_seed(3)
    keep = torch.stack([tvit.drop_path_mask(400, rate, gen) for _ in range(100)])
    n = keep.numel()
    sd = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < 4.5 * sd
    assert keep.dtype == torch.bool


def test_training_draws_need_a_generator():
    vit = _trunk(drop_path_rate=0.2)
    with pytest.raises(ValueError, match='generator'):
        vit(torch.zeros(1, 32, 32, 3), train=True)
    vit(torch.zeros(1, 32, 32, 3), train=False)      # eval draws nothing


@pytest.mark.parametrize('mode', ['full', 'dots'])
def test_remat_grads_equal_plain_with_drop_path_and_rope_augmentation(mode):
    """Per-block remat recomputes the blocks in the backward.  The RoPE
    tables and drop-path masks are drawn outside the checkpointed blocks,
    so the recompute sees the same draws and the gradients equal those of
    the trunk without remat (a draw inside a block would take other numbers
    from the generator on recompute).  Same ops in the same order: 1e-6."""
    kw = dict(drop_path_rate=0.3, pos_embed_rope_rescale_coords=2.0,
              pos_embed_rope_shift_coords=0.2, attn_impl='fused')
    plain, remat = _trunk(**kw), _trunk(remat=mode, **kw)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    grads = []
    for m in (plain, remat):
        out = m(x, train=True, generator=torch.Generator().manual_seed(11))
        (out['x_norm_patchtokens'].square().mean() + out['x_norm_clstoken'].sum()).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize('mode', ['full', 'dots'])
def test_remat_with_fused_layer_norm_grads_equal_plain(monkeypatch, mode):
    """The same with ``EVER_FUSED_LN=1``: a recomputed block runs the
    LayerNorm's autograd Function again (under 'dots' inside a selective
    checkpoint), and the gradients still equal those without remat."""
    monkeypatch.setenv('EVER_FUSED_LN', '1')
    kw = dict(drop_path_rate=0.3, pos_embed_rope_rescale_coords=2.0, attn_impl='fused')
    plain, remat = _trunk(**kw), _trunk(remat=mode, **kw)
    assert isinstance(remat.blocks[0].norm1, FusedLayerNorm)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    grads = []
    for m in (plain, remat):
        out = m(x, train=True, generator=torch.Generator().manual_seed(11))
        (out['x_norm_patchtokens'].square().mean() + out['x_norm_clstoken'].sum()).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_remat_invalid_mode_raises():
    with pytest.raises(ValueError, match='remat'):
        tbuilder.make_model({'type': 'DinoSeg', 'params': _dinoseg_config(remat='bogus')},
                            device='cpu')


@pytest.mark.parametrize('dice', [None, dict(smooth_value=1.0, ignore_channel=0)])
def test_dinoseg_train_branch_matches_jax(dinoseg_weights, dice):
    """``forward(x, y, train=True)`` returns the JAX loss dict (cls_loss, and
    dice_loss when configured) on the same weights and labels; with
    ``y=None`` it returns probabilities.  Float32, 12 blocks: 1e-5."""
    cfg = dict(_dinoseg_config(attn_impl='xla'), loss=dict(ignore_index=255, dice=dice))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(2, 64, 64)).astype(np.int32)
    y[0, :8] = 255
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    want = jmodel.apply(dinoseg_weights, jnp.asarray(x), jnp.asarray(y), train=True)
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    tmodel.load_state_dict(convert_flax_dinoseg(dinoseg_weights), strict=True)
    got = tmodel(torch.from_numpy(x), torch.from_numpy(y), train=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    probs = tmodel(torch.from_numpy(x), None, train=True)
    assert probs.shape == (2, 64, 64, 5)
