"""DINOv3's multi-crop forward, ``DINOHead`` and the causal text-attention
family in the port against the JAX package, on the CPU.

A two-block, 64-wide ViT with 4 storage tokens, fed a list of crops of
three sizes (global, local, another): every crop's normalised cls, storage
and patch tokens against the JAX trunk's, with each untie flag, in train
and eval mode; ``local_cls_norm`` acts on crop index 1 alone, in training
alone, and only it sends ``local_cls_norm`` a gradient; the RoPE rescale
draws come from the generator crop after crop.  Then ``DINOHead``,
``cat_keep_shapes``/``uncat_with_shapes``, ``LinearKMaskedBias``,
``CausalSelfAttention`` and its block.  Weights are seeded draws in the JAX
tree carried over by the converters; tolerances 1e-5 (float32 sums in other
orders through two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import vit as jvit
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.util.weight_io import (convert_flax_dino_head, convert_flax_dinov3_vit,
                                           flatten_params)
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TINY = (2, 64, 2, 4.0, 'mlp')
TRUNK = dict(vit_type='vit_tiny_mc', patch_size=16, n_storage_tokens=4,
             layerscale_init=1e-5, qkv_bias=True, norm_eps=1e-5)


@pytest.fixture(autouse=True)
def tiny_spec(monkeypatch):
    for pkg in (jvit, tvit):
        monkeypatch.setitem(pkg.VIT_SPECS, 'vit_tiny_mc', TINY)


def _crops(seed=0):
    """A global batch of 2 at 64², a local batch of 3 at 32², and a third
    batch of 1 at 48²."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((2, 64, 64, 3), (3, 32, 32, 3), (1, 48, 48, 3))]


def _seeded(module, *args, seed=0, **kw):
    """Every leaf a seeded draw: norm scales and LayerScale gammas
    ~U(0.5, 1.5) (the local cls norm then differs from the final one),
    kernels ~N(0, 0.05²), the rest ~N(0, 0.02²)."""
    shapes = jax.eval_shape(lambda: module.init({'params': jax.random.key(0)}, *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'gamma' in name or 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _trunks(**flags):
    xs = _crops()
    jm = jvit.DinoVisionTransformer(**TRUNK, **flags)
    v = _seeded(jm, [jnp.asarray(x) for x in xs], train=True)
    tm = tvit.DinoVisionTransformer(**TRUNK, **flags)
    tm.load_state_dict(convert_flax_dinov3_vit(v['params']), strict=True)
    return jm, tm, v, xs


_KEYS = ('x_norm_clstoken', 'x_storage_tokens', 'x_norm_patchtokens')


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('flags', [dict(), dict(untie_global_and_local_cls_norm=True),
                                   dict(untie_cls_and_patch_norms=True),
                                   dict(untie_global_and_local_cls_norm=True,
                                        untie_cls_and_patch_norms=True)])
def test_list_forward_matches_jax(flags, train):
    """The list forward: one feature dict a crop, each crop's tokens and grid
    equal to the JAX trunk's within 1e-5."""
    jm, tm, v, xs = _trunks(**flags)
    want = jm.apply(v, [jnp.asarray(x) for x in xs], train=train)
    with torch.no_grad():
        got = tm([torch.from_numpy(x) for x in xs], train=train)
    assert isinstance(got, list) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g['grid'] == tuple(w['grid'])
        for k in _KEYS:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_local_cls_norm_acts_on_crop_one_in_training_only():
    """With ``untie_global_and_local_cls_norm``: the cls token of crop 1
    differs between train and eval (its own norm), those of crops 0 and 2
    do not; a single tensor never takes it; the gradient of a sum over the
    cls tokens reaches ``local_cls_norm`` from crop 1 alone."""
    _, tm, _, xs = _trunks(untie_global_and_local_cls_norm=True)
    crops = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
        tr, ev = tm(crops, train=True), tm(crops, train=False)
        one = tm(crops[1], train=True)
    assert not torch.allclose(tr[1]['x_norm_clstoken'], ev[1]['x_norm_clstoken'])
    for i in (0, 2):
        torch.testing.assert_close(tr[i]['x_norm_clstoken'], ev[i]['x_norm_clstoken'])
    torch.testing.assert_close(one['x_norm_clstoken'], ev[1]['x_norm_clstoken'])
    for only in (0, 1, 2):
        tm.zero_grad(set_to_none=True)
        sum(o['x_norm_clstoken'].sum() for i, o in enumerate(tm(crops, train=True))
            if i == only).backward()
        g = tm.local_cls_norm.weight.grad
        assert (g is not None and float(g.abs().sum()) > 0) == (only == 1)


def test_list_forward_draws_rope_augmentation_crop_after_crop():
    """With RoPE rescale on (the sat preset's) training needs a generator:
    the list forward from one seed is the same bits twice, and equals the
    crops run one by one on one generator in list order."""
    _, tm, _, xs = _trunks()
    tm.rope_embed.rescale_coords = 2.0
    crops = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
        a = tm(crops, train=True, generator=torch.Generator().manual_seed(5))
        b = tm(crops, train=True, generator=torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        c = [tm(x, train=True, generator=gen) for x in crops]
    for x, y, z in zip(a, b, c):
        torch.testing.assert_close(x['x_norm_patchtokens'], y['x_norm_patchtokens'],
                                   rtol=0, atol=0)
        torch.testing.assert_close(x['x_norm_patchtokens'], z['x_norm_patchtokens'],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match='generator'):
        tm(crops, train=True)


def test_converter_maps_local_cls_norm():
    _, tm, v, _ = _trunks(untie_global_and_local_cls_norm=True)
    sd = convert_flax_dinov3_vit(v['params'])
    np.testing.assert_array_equal(sd['local_cls_norm.weight'].numpy(),
                                  v['params']['local_cls_norm']['scale'])
    assert set(sd) == set(tm.state_dict())


@pytest.mark.parametrize('n_layers', [3, 1])
def test_dino_head_matches_jax(n_layers):
    """DINOHead (64 in, hidden 48, bottleneck 16, 300 prototypes) to 1e-6:
    the MLP with tanh GELU, the L2-normalised bottleneck, the column-
    normalised prototypes; one of the rows is zero (the 1e-6 floor)."""
    x = np.random.default_rng(1).normal(size=(5, 64)).astype(np.float32)
    jm = jvit.DINOHead(out_dim=300, hidden_dim=48, bottleneck_dim=16, n_layers=n_layers)
    v = _seeded(jm, jnp.asarray(x))
    tm = tvit.DINOHead(64, 300, 48, 16, n_layers)
    tm.load_state_dict(convert_flax_dino_head(v['params']), strict=True)
    assert tm.prototypes.shape == (16, 300)
    x[2] = 0.0
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(KeyError, match='unmapped'):
        convert_flax_dino_head({'extra': np.zeros(3)})


def test_cat_keep_shapes_round_trip():
    """``cat_keep_shapes`` flattens as the JAX function does, and
    ``uncat_with_shapes`` restores each tensor, also after a token-wise
    module changed the width."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((2, 5, 8), (3, 7, 8), (1, 1, 8))]
    flat, shapes, n = tvit.cat_keep_shapes([torch.from_numpy(x) for x in xs])
    jflat, jshapes, jn = jvit.cat_keep_shapes([jnp.asarray(x) for x in xs])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert list(n) == list(jn) == [10, 21, 1]
    for a, x in zip(tvit.uncat_with_shapes(flat, shapes, n), xs):
        np.testing.assert_array_equal(a.numpy(), x)
    lin = torch.nn.Linear(8, 3)
    with torch.no_grad():
        out = tvit.uncat_with_shapes(lin(flat), shapes, n)
        for o, x in zip(out, xs):
            torch.testing.assert_close(o, lin(torch.from_numpy(x)))


def _dense(sd, name, params):
    sd[f'{name}.weight'] = torch.from_numpy(np.asarray(params['kernel']).T.copy())
    if 'bias' in params:
        sd[f'{name}.bias'] = torch.from_numpy(np.asarray(params['bias']))


@pytest.mark.parametrize('is_causal', [True, False])
def test_causal_attention_block_matches_jax(is_causal):
    """CausalSelfAttentionBlock (LayerScale on) against the JAX block: the
    causal mask, the fused QKV projection, the tanh-GELU MLP: 1e-5."""
    x = np.random.default_rng(3).normal(size=(2, 9, 32)).astype(np.float32)
    jm = jvit.CausalSelfAttentionBlock(32, 4, ls_init_value=0.5, is_causal=is_causal)
    v = _seeded(jm, jnp.asarray(x))
    p = v['params']
    sd = {}
    for norm in ('attention_norm', 'ffn_norm'):
        sd[f'{norm}.weight'] = torch.from_numpy(np.asarray(p[norm]['scale']))
        sd[f'{norm}.bias'] = torch.from_numpy(np.asarray(p[norm]['bias']))
    for name in ('qkv', 'proj'):
        _dense(sd, f'attention.{name}', p['attention'][name])
    for name in ('fc1', 'fc2'):
        _dense(sd, f'feed_forward.{name}', p['feed_forward'][name])
    sd['ls1.gamma'] = torch.from_numpy(np.asarray(p['ls1']['gamma']))
    sd['ls2.gamma'] = torch.from_numpy(np.asarray(p['ls2']['gamma']))
    tm = tvit.CausalSelfAttentionBlock(32, 4, ls_init_value=0.5, is_causal=is_causal)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), rtol=0, atol=1e-5)


def test_linear_k_masked_bias_and_list_forward_match_jax():
    """LinearKMaskedBias: the bias multiplied by the ``bias_mask`` buffer
    (zero over the K third), against the JAX module: 1e-6; its
    ``forward_list`` through ``ListForwardMixin`` over crops of two token
    counts equals the per-tensor calls."""
    x = np.random.default_rng(4).normal(size=(3, 6, 16)).astype(np.float32)
    jm = jvit.LinearKMaskedBias(48)
    v = {'params': _seeded(jm, jnp.asarray(x))['params'],
         'constants': jm.init(jax.random.key(0), jnp.asarray(x))['constants']}
    assert set(flatten_params(v['params'])) == {'linear/kernel', 'bias'}

    class Masked(tvit.LinearKMaskedBias, tvit.ListForwardMixin):
        pass

    tm = Masked(16, 48)
    sd = {'weight': torch.from_numpy(np.asarray(v['params']['linear']['kernel']).T.copy()),
          'bias': torch.from_numpy(np.asarray(v['params']['bias'])),
          'bias_mask': torch.from_numpy(np.array(v['constants']['bias_mask'], np.float32))}
    tm.load_state_dict(sd, strict=True)
    assert float(tm.bias_mask[16:32].abs().sum()) == 0.0
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                                   rtol=0, atol=1e-6)
        parts = [torch.from_numpy(x[:2]), torch.from_numpy(x[2:, :4])]
        for a, b in zip(tm.forward_list(parts), parts):
            torch.testing.assert_close(a, tm(b))


def test_multicrop_gradients_with_dino_head_match_jax_grad(one_torch_thread):
    """The multi-crop forward and backward with ``DINOHead`` (the card's
    ``models`` f path, at small size): an untied trunk (2 blocks, width 64)
    over 2 global crops of 32² and 4 local crops of 16², the head (256
    out) on each crop's cls token, the sum of its outputs as the loss.
    Every gradient of the trunk and the head against ``jax.grad`` of the
    JAX model, float32: ‖Δg‖/‖g‖ ≤ 1e-5 for each tensor (float32 sums in
    other orders through two blocks and the head's normalisations)."""
    rng = np.random.default_rng(6)
    crops = [rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             rng.normal(size=(4, 16, 16, 3)).astype(np.float32)]
    flags = dict(untie_global_and_local_cls_norm=True)
    jm = jvit.DinoVisionTransformer(**TRUNK, **flags)
    jcrops = [jnp.asarray(x) for x in crops]
    v = _seeded(jm, jcrops, train=True)
    jh = jvit.DINOHead(out_dim=256, hidden_dim=96, bottleneck_dim=32)
    hv = _seeded(jh, jnp.zeros((1, 64), jnp.float32), seed=1)

    def loss(p, hp):
        outs = jm.apply({'params': p}, jcrops, train=True)
        return sum(jh.apply({'params': hp}, o['x_norm_clstoken']).sum() for o in outs)

    gv, gh = jax.jit(jax.grad(loss, argnums=(0, 1)))(v['params'], hv['params'])
    tm = tvit.DinoVisionTransformer(**TRUNK, **flags)
    tm.load_state_dict(convert_flax_dinov3_vit(v['params']), strict=True)
    th = tvit.DINOHead(64, 256, 96, 32)
    th.load_state_dict(convert_flax_dino_head(hv['params']), strict=True)
    outs = tm([torch.from_numpy(x) for x in crops], train=True)
    sum(th(o['x_norm_clstoken']).sum() for o in outs).backward()
    wants = [(tm, convert_flax_dinov3_vit(gv)), (th, convert_flax_dino_head(gh))]
    checked = 0
    for module, want in wants:
        for name, p in module.named_parameters():
            assert p.grad is not None, name
            w = want[name].numpy()
            rel = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-5, (name, rel)
            checked += 1
    assert checked == len(want) + len(wants[0][1])
    assert float(tm.local_cls_norm.weight.grad.abs().sum()) > 0
