"""The port's building blocks against the JAX package's, on the CPU.

``Norm('gn'|'ln')`` (groups that do not divide the channels included),
``SEBlock`` and ``SCSEModule`` in its three modes, ``ContextBlock2d`` in
{att, avg} × {add, mul, both} and its identity at initialisation, lax's
asymmetric strided ``'SAME'`` padding in ``Conv2d``, ``resize`` with
``align_corners=True`` (the size-1 cases too), and the two dropouts: mask
shape, scale, bits from a generator, and a 2-rank data-parallel draw that
makes up the 1-rank one.  Inputs and weights are seeded numpy draws; each
tolerance states its reason.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import context_block as jgc
from ever_tpu.module import ops as jops
from ever_tpu.module import se_block as jse
from ever_tpu_torch.module import context_block as tgc
from ever_tpu_torch.module import ops as tops
from ever_tpu_torch.module import se_block as tse
from ever_tpu_torch.util.weight_io import flatten_params


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _variables(module, x, seed=0):
    """The JAX module's variables, every leaf a seeded draw: kernels
    ~N(0, 1/fan_in), norm scales ~U(0.5, 1.5), biases ~N(0, 0.1²) (so zero
    initialisations are not what the comparison sees)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.asarray(x)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(scale=fan_in ** -0.5, size=s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(scale=0.1, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load(module, params, names):
    """flax params (``{jax module: {leaf: array}}``) into a port module,
    ``names`` mapping the JAX module path to the port's; conv kernels HWIO
    → OIHW, norm ``scale`` → ``weight``.  Strict: every tensor set."""
    sd = {}
    for key, v in flatten_params(params).items():
        path, leaf = key.rsplit('/', 1)
        if leaf == 'kernel':
            v = np.transpose(v, (3, 2, 0, 1))
        sd[f'{names[path]}.{"weight" if leaf in ("kernel", "scale") else "bias"}'] = (
            torch.from_numpy(np.ascontiguousarray(v)))
    module.load_state_dict(sd, strict=True)
    return module


def _apply(jmodule, variables, x):
    return np.asarray(jax.jit(jmodule.apply)(variables, jnp.asarray(x)))


# -- norms --------------------------------------------------------------------

@pytest.mark.parametrize('kind,c', [('gn', 64), ('gn', 48), ('gn', 20), ('ln', 24)])
def test_norm_gn_ln_match_flax(kind, c):
    """GroupNorm (48 channels: 32 groups do not divide them, 24 do; 20
    channels: 20 groups) and the channel LayerNorm against flax's, to 1e-5:
    flax takes one-pass statistics (E[x²] − μ²), the port two-pass ones,
    which differ at float32 rounding of values of mean ~3 and variance ~4."""
    x = _x((2, 6, 5, c), seed=c) * 2 + 3
    jm = jops.Norm(kind)
    v = _variables(jm, x)
    tm = tops.Norm(kind, c)
    tm.load_state_dict({('weight' if k.endswith('scale') else 'bias'):
                        torch.from_numpy(np.asarray(a))
                        for k, a in flatten_params(v['params']).items()}, strict=True)
    if kind == 'gn':
        g = min(32, c)
        while c % g:
            g -= 1
        assert tm.num_groups == g and tm.eps == 1e-5
    else:
        assert tm.eps == 1e-6
    want = _apply(jm, v, x)
    got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_norms_keep_bf16_and_float64():
    x = nchw(_x((2, 4, 4, 16)))
    for m in (tops.Norm('gn', 16), tops.Norm('ln', 16)):
        assert m(x.bfloat16()).dtype == torch.bfloat16
        assert m(x.double()).dtype == torch.float64
        assert all(p.dtype == torch.float32 for p in m.parameters())


# -- SE and GC ------------------------------------------------------------------

def test_se_block_matches_jax():
    """SEBlock (inv_ratio 4 of 32 channels) to 1e-6: float32 products."""
    x = _x((2, 7, 6, 32))
    jm = jse.SEBlock(4)
    v = _variables(jm, x)
    tm = _load(tse.SEBlock(32, 4), v['params'], {'Conv_0': 'fc1', 'Conv_1': 'fc2'})
    np.testing.assert_allclose(nhwc(tm(nchw(x))), _apply(jm, v, x), rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode', ['concat', 'maxout', 'add'])
def test_scse_matches_jax(mode):
    """SCSEModule in each mode (concat gives 2C channels) to 1e-6."""
    x = _x((2, 5, 6, 16))
    jm = jse.SCSEModule(4, mode)
    v = _variables(jm, x)
    tm = _load(tse.SCSEModule(16, 4, mode), v['params'],
               {'Conv_0': 'fc1', 'Conv_1': 'fc2', 'Conv_2': 'spatial'})
    want = _apply(jm, v, x)
    assert want.shape[-1] == (32 if mode == 'concat' else 16)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, rtol=0, atol=1e-6)


_GC_NAMES = {'Conv_0': 'conv_mask'}
for _f in ('channel_add', 'channel_mul'):
    _GC_NAMES.update({f'{_f}_reduce': f'{_f}_conv.0', f'{_f}_ln': f'{_f}_conv.1',
                      f'{_f}_expand': f'{_f}_conv.3'})


@pytest.mark.parametrize('fusions', [('channel_add',), ('channel_mul',),
                                     ('channel_add', 'channel_mul')])
@pytest.mark.parametrize('pool', ['att', 'avg'])
def test_context_block_matches_jax(pool, fusions):
    """ContextBlock2d against the JAX block with seeded weights, the inner
    width 64/16 = 4.  x is small (std 0.1), so the pooled context's
    transform feeds the LayerNorm values of small variance and its eps
    shows: flax's default 1e-6 here, where torch's default 1e-5 moves the
    output by ~8e-4, far past the tolerance.  Tolerance 1e-6: float32 sums
    in other orders."""
    x = _x((2, 6, 7, 64), seed=3, scale=0.1)
    jm = jgc.ContextBlock2d(1 / 16, pool, fusions)
    v = _variables(jm, x)
    tm = _load(tgc.ContextBlock2d(64, 1 / 16, pool, fusions), v['params'], _GC_NAMES)
    want = _apply(jm, v, x)
    assert np.abs(want - x).max() > 1e-2                  # the branch acts
    np.testing.assert_allclose(nhwc(tm(nchw(x))), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('fusions,gain', [(('channel_add',), 1.0),
                                          (('channel_add', 'channel_mul'), 0.5)])
@pytest.mark.parametrize('pool', ['att', 'avg'])
def test_context_block_starts_as_identity(pool, fusions, gain):
    """Both packages zero-initialise the last conv of each transform, so a
    fresh ``channel_add`` block returns x exactly; with ``channel_mul`` the
    zero transform gates by sigmoid(0) = 1/2 in both (GCNet's
    ``last_zero_init``)."""
    x = _x((2, 5, 5, 32))
    tm = tgc.ContextBlock2d(32, 1 / 8, pool, fusions)
    torch.testing.assert_close(nhwc(tm(nchw(x))), gain * x, rtol=0, atol=0)
    jm = jgc.ContextBlock2d(1 / 8, pool, fusions)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    np.testing.assert_array_equal(_apply(jm, v, x), gain * x)


def test_context_block_pools_in_float32_under_bf16():
    """The attention pool sums in float32 and casts to bf16: the bf16 block
    stays within bf16 rounding of the float32 block (2^-7 of the scale),
    and returns bf16."""
    x = _x((2, 16, 16, 32), seed=5)
    jm = jgc.ContextBlock2d(1 / 8, 'att', ('channel_add',))
    v = _variables(jm, x)
    tm = _load(tgc.ContextBlock2d(32, 1 / 8), v['params'], _GC_NAMES)
    with torch.no_grad():
        y32 = tm(nchw(x))
        y16 = tm(nchw(x).bfloat16())
    assert y16.dtype == torch.bfloat16
    err = float((y16.float() - y32).abs().max())
    assert err <= 2 ** -7 * float(y32.abs().max()), err


# -- padding and resizing --------------------------------------------------------

@pytest.mark.parametrize('size', [(9, 12), (16, 16), (7, 5)])
@pytest.mark.parametrize('k,d', [(1, 1), (3, 1), (3, 2)])
def test_conv_same_padding_matches_flax(size, k, d):
    """``Conv2d(padding='same')`` at stride 2 against flax's
    ``nn.Conv(padding='SAME')`` (lax pads ⌈n/s⌉-positioned outputs with the
    odd pixel after): even and odd sizes, k 1 and 3, dilation 2; and at
    stride 1 with dilation 2 (symmetric).  Tolerance 1e-5 (float32 sums)."""
    x = _x((2, *size, 5), seed=k + d)
    for stride in (2, 1):
        jm = fnn.Conv(4, (k, k), strides=stride, kernel_dilation=d, padding='SAME')
        v = _variables(jm, x)
        tm = tops.Conv2d(5, 4, k, stride, 'same', d, bias=True)
        tm.load_state_dict({'weight': torch.from_numpy(np.transpose(
            np.asarray(v['params']['kernel']), (3, 2, 0, 1)).copy()),
            'bias': torch.from_numpy(np.asarray(v['params']['bias']))}, strict=True)
        want = _apply(jm, v, x)
        got = nhwc(tm(nchw(x)))
        assert got.shape == want.shape == (2, -(-size[0] // stride), -(-size[1] // stride), 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('src,dst', [((5, 7), (9, 13)), ((1, 4), (3, 8)), ((6, 1), (1, 5)),
                                     ((4, 4), (1, 1)), ((8, 6), (16, 12))])
def test_resize_align_corners_matches_jax(src, dst):
    """``resize(..., align_corners=True)`` against the JAX package's
    ``_resize_align_corners`` (both float32 matrix products with the same
    weights), the size-1 input and output cases included: 1e-6.  bf16 in,
    bf16 out."""
    x = _x((2, *src, 3))
    want = np.asarray(jops._resize_align_corners(jnp.asarray(x), *dst))
    got = tops.resize(torch.from_numpy(x), shape=dst, method='bilinear',
                      align_corners=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tops.resize(torch.from_numpy(x).bfloat16(), shape=dst, method='bilinear',
                       align_corners=True).dtype == torch.bfloat16


def test_resize_align_corners_backward_is_two_products():
    """The gradient of the corner-aligned resize is the transposed matrix
    products: the same bits on every call (no atomics on the card)."""
    x = torch.from_numpy(_x((2, 6, 5, 3))).requires_grad_()
    g = torch.from_numpy(_x((2, 12, 10, 3), seed=9))
    grads = []
    for _ in range(2):
        (y,) = torch.autograd.grad((tops.resize(x, shape=(12, 10), method='bilinear',
                                                align_corners=True) * g).sum(), x)
        grads.append(y)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


# -- dropout --------------------------------------------------------------------

@pytest.mark.parametrize('fn,mask_shape', [(tops.dropout, (4, 6, 5, 3)),
                                           (tops.channel_dropout, (4, 6, 1, 1))])
def test_dropout_masks(fn, mask_shape):
    """The mask's shape (one draw per element, or per sample and channel),
    the 1/(1−p) scale of what is kept, the same bits from the same seed and
    other bits from another, the identity outside training, and a
    generator required in training."""
    x = torch.ones(4, 6, 5, 3)
    y = fn(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert set(torch.unique(y).tolist()) <= {0.0, float(torch.tensor(1.0) / 0.75)}
    if mask_shape[2:] == (1, 1):
        assert bool((kept == kept[:, :, :1, :1]).all())
    assert 0.5 < float(kept.float().mean()) < 0.95
    torch.testing.assert_close(fn(x, 0.25, True, torch.Generator().manual_seed(0)), y,
                               rtol=0, atol=0)
    assert not torch.equal(fn(x, 0.25, True, torch.Generator().manual_seed(1)), y)
    assert fn(x, 0.25, False, None) is x and fn(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match='generator'):
        fn(x, 0.25, True, None)


@pytest.mark.parametrize('fn', [tops.dropout, tops.channel_dropout])
def test_dropout_under_two_ranks_is_the_global_draw(fn, monkeypatch):
    """Inside a data-parallel step over 2 ranks each rank draws the global
    batch's mask from its copy of the step's generator and keeps its rows:
    the two ranks' halves make up the 1-rank mask of the whole batch."""
    x = torch.ones(6, 4, 3, 3)
    whole = fn(x, 0.5, True, torch.Generator().manual_seed(3))
    parts = []
    for rank in range(2):
        monkeypatch.setattr(tops, 'data_shard', lambda r=rank: (r, 2))
        parts.append(fn(x[:3], 0.5, True, torch.Generator().manual_seed(3)))
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)
