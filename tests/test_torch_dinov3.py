"""The port's ``module.dinov3`` namespace against the JAX package's, on the CPU.

Every module of the namespace exports what the JAX module's ``__all__``
names; the ViT factories build the JAX package's geometry (on the meta
device: ``vit_7b`` has 6.7 B parameters) and the sat493m ones raise for
``pretrained``; ``Fp8Linear`` and ``Fp8LinearKMaskedBias`` equal the JAX
layers bit for bit on seeded inputs (the same int8 values, the exact int32
product, the same float32 rescale), with one int8 product a call, and
their straight-through gradients match ``jax.grad`` to 1e-6 of the scale
(float32 products summed in other orders); ``sparsify24`` keeps the
earlier index on ties, as the JAX one does, and ``LinearW24`` and
``update_24sparsity`` keep exactly 2 of every 4; the two converters raise,
as in the JAX package; the ``utils`` walk the module tree.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.module import vit as jvit
from ever_tpu.module.dinov3.layers import fp8_linear as jfp8
from ever_tpu.module.dinov3.layers import sparse_linear as jsp
from ever_tpu_torch.module import dinov3 as tdino
from ever_tpu_torch.module.dinov3.layers import fp8_linear as tfp8
from ever_tpu_torch.module.dinov3.layers import sparse_linear as tsp
from ever_tpu_torch.module.dinov3.utils import dtype as tdtype
from ever_tpu_torch.module.dinov3.utils import utils as tutils
from ever_tpu.util.weight_io import flatten_tree
from ever_tpu_torch.util.weight_io import convert_flax_linear, load_weights
from test_torch_resnet import close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MODULES = ['', '.layers', '.layers.attention', '.layers.block', '.layers.dino_head',
           '.layers.ffn_layers', '.layers.fp8_linear', '.layers.layer_scale',
           '.layers.patch_embed', '.layers.rms_norm', '.layers.rope_position_encoding',
           '.layers.sparse_linear', '.models', '.models.convnext',
           '.models.vision_transformer', '.utils', '.utils.cluster',
           '.utils.custom_callable', '.utils.dtype', '.utils.utils']


@pytest.mark.parametrize('sub', MODULES, ids=lambda s: s.lstrip('.') or 'dinov3')
def test_module_exports_the_jax_names(sub):
    """The JAX module's ``__all__`` (a package without one: its public
    names) is what the port's module has."""
    jm = importlib.import_module('ever_tpu.module.dinov3' + sub)
    tm = importlib.import_module('ever_tpu_torch.module.dinov3' + sub)
    names = getattr(jm, '__all__', None) or [n for n in vars(jm) if not n.startswith('_')]
    missing = [n for n in names if not hasattr(tm, n)]
    assert not missing, missing
    if hasattr(jm, '__all__'):
        assert list(tm.__all__) == list(jm.__all__)


FACTORIES = ['vit_small', 'vit_base', 'vit_large', 'vit_so400m', 'vit_huge2', 'vit_giant2',
             'vit_7b', 'vitl16_sat493m', 'vit7b16_sat493m']


@pytest.mark.parametrize('name', FACTORIES)
def test_factory_geometry(name):
    """Depth, width, heads, FFN and storage tokens of each factory's trunk
    are the JAX spec's (``VIT_SPECS``, the sat configs' own keys)."""
    from ever_tpu_torch.module.dinov3.models import vision_transformer as tvt
    with torch.device('meta'):
        m = getattr(tvt, name)()
    sat = jvit.SAT_CONFIGS.get(name, {})
    depth, dim, heads, ratio, ffn = jvit.VIT_SPECS[sat.get('vit_type', name)]
    assert (m.depth, m.embed_dim, m.num_heads) == (depth, dim, heads)
    ffn = sat.get('ffn_layer', ffn)
    mlp = m.blocks[0].mlp
    assert type(mlp).__name__ == ('SwiGLUFFN' if ffn.startswith('swiglu') else 'Mlp')
    assert m.n_storage_tokens == sat.get('n_storage_tokens', 4)
    assert m.patch_embed.proj.kernel_size == (16, 16)
    if sat:
        assert isinstance(m.blocks[0].ls1, tdino.LayerScale)
        assert m.blocks[0].norm1.eps == sat['norm_eps']
        with pytest.raises(ValueError, match='load_weights'):
            getattr(tvt, name)(pretrained='sat493m.pth')


def test_convnext_arch_and_drop_path():
    from ever_tpu_torch.module.dinov3.models import convnext as tcx
    with torch.device('meta'):
        m = tdino.get_convnext_arch('convnext_small_xyz')()
    assert sum(len(s) for s in m.stages) == 36
    with pytest.raises(NotImplementedError):
        tdino.get_convnext_arch('convnext_huge')
    dp = tcx.DropPath(0.5)
    x = torch.ones(64, 3, 2, 2)
    assert torch.equal(dp(x), x)
    y = dp(x, train=True, generator=torch.Generator().manual_seed(0))
    assert set(y.flatten(1).amax(1).tolist()) <= {0.0, 2.0}
    assert isinstance(tcx.LayerNorm(8), torch.nn.LayerNorm)


def _dense_variables(jm, x, seed):
    """Seeded variables of a JAX Dense-like layer from its shapes (no
    init run): kernel and bias ~N(0, 0.3²), a K-masked layer's default
    ``bias_mask``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    v = {'params': {k: rng.normal(scale=0.3, size=a.shape).astype(np.float32)
                    for k, a in shapes['params'].items()}}
    if 'constants' in shapes:
        third = shapes['constants']['bias_mask'].shape[0] // 3
        v['constants'] = {'bias_mask': np.concatenate(
            [np.ones(third), np.zeros(third), np.ones(third)]).astype(np.float32)}
    return v


def _fp8_case(seed, k_masked):
    x = np.random.default_rng(seed).normal(size=(3, 7, 64)).astype(np.float32)
    jm = (jfp8.Fp8LinearKMaskedBias(96) if k_masked else jfp8.Fp8Linear(48))
    return jm, _dense_variables(jm, x, seed + 20), x


@pytest.mark.parametrize('k_masked', [False, True], ids=['Fp8Linear', 'Fp8LinearKMaskedBias'])
@pytest.mark.parametrize('seed', [0, 1])
def test_fp8_linear_is_bit_equal_to_jax(k_masked, seed, monkeypatch):
    """The forward equal to the bit, one int8 product a call; the
    straight-through gradients of x, the weight and the bias against
    ``jax.grad``.  The forward is held against the JAX layer run op by op:
    under ``jax.jit`` XLA's simplifier rewrites ``(a / 127) · (b / 127)``
    as ``a · b / 127²``, which moves the float32 rescale by an ulp."""
    jm, v, x = _fp8_case(seed, k_masked)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    g = np.random.default_rng(seed + 9).normal(size=want.shape).astype(np.float32)

    def loss(params, x):
        return (jm.apply({**v, 'params': params}, x) * g).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    n_out = want.shape[-1]
    tm = (tfp8.Fp8LinearKMaskedBias(64, n_out) if k_masked else tfp8.Fp8Linear(64, n_out))
    tm.load_state_dict(convert_flax_linear(v), strict=True)
    calls = []
    real = tfp8.int8_matmul_t
    monkeypatch.setattr(tfp8, 'int8_matmul_t', lambda *a: calls.append(1) or real(*a))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    assert calls == [1]
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(g)).sum().backward()
    wgrad = convert_flax_linear({'params': gp})
    close(tm.weight.grad.numpy(), wgrad['weight'].numpy(), 1e-6)
    close(tm.bias.grad.numpy(), wgrad['bias'].numpy(), 1e-6)
    close(xt.grad.numpy(), np.asarray(gx), 1e-6)
    if k_masked:
        assert torch.equal(tm.bias_mask, torch.tensor([1.0] * 32 + [0.0] * 32 + [1.0] * 32))


@pytest.mark.parametrize('kind', ['Fp8LinearKMaskedBias', 'LinearW24'])
def test_npz_of_jax_layer_loads(tmp_path, kind):
    """A flat ``.npz`` of the JAX layer's variables (``params/kernel``,
    ``params/bias``, ``constants/bias_mask``) through ``load_weights``:
    the kernel transposed to ``weight``, the mask a buffer."""
    if kind == 'LinearW24':
        jm, tm = jsp.LinearW24(8), tsp.LinearW24(64, 8)
        v = _dense_variables(jm, np.zeros((1, 64), np.float32), 5)
    else:
        jm, v, _ = _fp8_case(2, True)
        tm = tfp8.Fp8LinearKMaskedBias(64, 96)
        v = {**v, 'constants': {'bias_mask': np.arange(96, dtype=np.float32) % 2}}
    flat = {f'{c}/{k}': np.asarray(a) for c in v for k, a in flatten_tree(v[c]).items()}
    np.savez(tmp_path / 'w.npz', **flat)
    report = load_weights(str(tmp_path / 'w.npz'), tm, device='cpu', log=False)
    assert not report.missing and not report.unexpected and not report.mismatched
    assert torch.equal(tm.weight, torch.from_numpy(np.array(v['params']['kernel']).T))
    if kind != 'LinearW24':
        assert torch.equal(tm.bias_mask, torch.from_numpy(flat['constants/bias_mask']))


def test_fp8_scale_rounds_half_to_even_like_jax():
    """Values on a half step (±0.5, ±1.5, ±2.5 after scaling) round to the
    even integer, as ``jnp.round``; the amax maps to ±127; a zero tensor's
    scale is the floor 1e-12/127."""
    t = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 3.49]], np.float32)
    q, s = tfp8.scale(torch.from_numpy(t), torch.tensor(127.0))
    jq, js = jfp8.scale(jnp.asarray(t), jnp.asarray(127.0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist() == [[0, 2, 2, 0, -2, 127, -127, 3]] and float(s) == float(js) == 1.0
    _, s0 = tfp8.scale(torch.zeros(2, 2), torch.tensor(0.0))
    assert float(s0) == np.float32(1e-12) / np.float32(127.0)


def test_sparsify24_matches_jax_on_ties_with_straight_through_gradient():
    """Rows of ties (all equal, pairs equal, signs mixed) keep the earlier
    indices, as the JAX ``sparsify24``; the gradient passes unchanged."""
    w = np.array([[1.0, 1.0, 1.0, 1.0, -2.0, 2.0, 1.0, 1.0],
                  [0.0, 0.0, 0.0, 0.0, 3.0, -1.0, 1.0, -3.0],
                  [0.5, -0.5, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0]], np.float32)
    rand = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)
    for a in (w, rand):
        t = torch.from_numpy(a).requires_grad_()
        got = tsp.sparsify24(t)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jsp.sparsify24(
            jnp.asarray(a))))
        assert ((got.detach().reshape(-1, 4) != 0).sum(1) <= 2).all()
        got.sum().backward()
        assert torch.equal(t.grad, torch.ones_like(t))
    assert tsp.sparsify24(torch.from_numpy(w))[0].tolist() == [1, 1, 0, 0, -2, 2, 0, 0]
    with pytest.raises(ValueError, match='divisible by 4'):
        tsp.sparsify24(torch.zeros(2, 6))


@pytest.mark.parametrize('enabled', [True, False])
def test_linear_w24_matches_jax(enabled):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    jm = jsp.LinearW24(12, sparsity_enabled=enabled)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tsp.LinearW24(32, 12, sparsity_enabled=enabled)
    tm.load_state_dict(convert_flax_linear(v), strict=True)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)).numpy(), want, 1e-6)


def test_update_24sparsity_keeps_two_of_four(caplog):
    m = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.LayerNorm(8),
                            torch.nn.Linear(8, 6), torch.nn.Linear(6, 4))
    sd = m.state_dict()
    with caplog.at_level(logging.INFO, logger='ever_tpu_torch'):
        out = tsp.update_24sparsity(sd, path_filter=lambda p: not p.startswith('2.'))
    assert 'update_24sparsity: 1 weights' in caplog.text
    w = out['0.weight']
    assert ((w.reshape(-1, 4) != 0).sum(1) == 2).all()
    assert torch.equal(w, tsp.sparsify24(sd['0.weight']))
    for k in ('1.weight', '2.weight', '3.weight', '0.bias'):
        assert torch.equal(out[k], sd[k]), k


def test_converters_raise_as_in_jax():
    with pytest.raises(NotImplementedError, match='Fp8Linear.*ptq_quantize'):
        tfp8.convert_linears_to_fp8(torch.nn.Linear(4, 4))
    with pytest.raises(NotImplementedError, match='LinearW24.*update_24sparsity'):
        tsp.replace_linears_with_sparse_linear(torch.nn.Linear(4, 4))
    with pytest.raises(NotImplementedError):
        jfp8.convert_linears_to_fp8(None)
    with pytest.raises(NotImplementedError):
        jsp.replace_linears_with_sparse_linear(None)


def test_utils_walk_the_module_tree():
    """``named_apply`` visits children first with dotted names;
    ``named_replace`` swaps modules in place; ``init_weights_vit`` through
    ``named_apply`` re-initialises a trunk's Linears; the dtype names; the
    counters."""
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Sequential(torch.nn.ReLU(),
                                                                      torch.nn.Linear(4, 2)))
    seen = []
    tutils.named_apply(lambda module, name: seen.append(name), m, include_root=True)
    assert seen == ['0', '1.0', '1.1', '1', '']
    tutils.named_replace(lambda module, name: torch.nn.GELU()
                         if isinstance(module, torch.nn.ReLU) else module, m)
    assert isinstance(m[1][0], torch.nn.GELU)
    with torch.no_grad():
        m[0].bias.fill_(3.0)
    tutils.named_apply(tdino.init_weights_vit, m)
    assert torch.equal(m[0].bias, torch.zeros(4))
    assert tutils.count_parameters(m) == 4 * 4 + 4 + 4 * 2 + 2
    assert not tutils.has_batchnorms(m)
    from ever_tpu_torch.module.ops import BatchNorm2d
    assert tutils.has_batchnorms(torch.nn.Sequential(BatchNorm2d(3)))
    assert tdtype.as_torch_dtype('bf16') is torch.bfloat16
    assert tdtype.as_jax_dtype('torch.float32') is torch.float32
    assert tdtype.as_torch_dtype(torch.int8) is torch.int8
    tutils.fix_random_seeds(5)
    a = torch.rand(3)
    tutils.fix_random_seeds(5)
    assert torch.equal(a, torch.rand(3))
