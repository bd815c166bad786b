"""The port's int8 quantization (K6), int8 matmul (K7) and ``QuantDense``
against the JAX package, on the CPU.

Off the TPU the JAX ``quantize_int8`` rounds to nearest; the port's CPU
path does the same, and must give the same values and scale.  The
stochastic mode's plain version (what the CUDA kernel is held to on the
card) is checked for its contract: within one step of x, unbiased, the
same per seed and different across seeds, with the bits of the documented
hash.  The int8 matmul's plain version equals the JAX kernel in interpret
mode exactly.  Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.ops import quant as jq
from ever_tpu_torch.ops import quant as Q


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize('shape', [(300, 130), (64, 256), (7, 1)])
def test_quantize_to_nearest_equals_jax(shape):
    """Values and scale equal to the JAX quantize_int8 on the CPU (round to
    nearest even of x / scale, the same float32 division)."""
    x = _normal(shape, seed=shape[0], scale=3.0)
    want_q, want_s = jq.quantize_int8(jnp.asarray(x), seed=0)
    q, s = Q.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (1, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_stochastic_rounding_is_within_one_step_and_unbiased():
    """Each value is the floor or the ceiling of x / s, so |q·s - x| < s
    (plus float32 rounding below 2⁻¹⁵·s), and the mean error lies within 5σ
    of 0, where one element's error has variance f(1 - f)·s² for the
    fraction f of x / s."""
    x = torch.from_numpy(_normal((512, 768), seed=1))
    q, s = Q.quantize_int8(x, seed=5, stochastic=True)
    s = float(s)
    v = x / s
    assert bool(((q.float() == torch.floor(v)) | (q.float() == torch.ceil(v))).all())
    err = (q.float() * s - x).double()
    assert float(err.abs().max()) <= s * (1 + 2 ** -15)
    frac = (v - torch.floor(v)).double()
    sigma = s * float((frac * (1 - frac)).mean() / x.numel()) ** 0.5
    assert abs(float(err.mean())) <= 5 * sigma


def test_stochastic_rounding_repeats_per_seed_and_differs_across_seeds():
    x = torch.from_numpy(_normal((64, 96), seed=2))
    a = Q.quantize_int8(x, seed=3, stochastic=True)[0]
    assert torch.equal(a, Q.quantize_int8(x, seed=3, stochastic=True)[0])
    b = Q.quantize_int8(x, seed=4, stochastic=True)[0]
    assert 0.2 < (a != b).float().mean().item() < 0.5     # 2·E[f(1-f)] = 1/3
    nearest = Q.quantize_int8(x)[0]
    assert not torch.equal(a, nearest) and torch.equal(nearest, Q.quantize_int8_reference(x)[0])


def _mix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_uniform_draws_are_the_documented_hash():
    """u of element i is ((mix(mix(lo32(i) ^ key) ^ hi32(i))) >> 8) · 2⁻²⁴,
    key = mix(seed ^ 0x9E3779B9), with mix murmur3's finaliser: the stream
    that csrc/quant_int8.cu computes, here in Python integers, also past
    2³² elements."""
    for seed in (0, 1, 12345):
        key = _mix((seed ^ 0x9E3779B9) & 0xFFFFFFFF)
        assert Q._key(seed) == key
        u = Q._uniform(key, 1000, 'cpu')
        want = [(_mix(_mix(i ^ key)) >> 8) * 2.0 ** -24 for i in range(1000)]
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(), np.array(want, np.float32))
        i = torch.tensor([2 ** 32 + 7, 3 * 2 ** 32 + 2 ** 31], dtype=torch.int64)
        got = Q._mix32(Q._mix32((i & Q._MASK32) ^ key) ^ (i >> 32))
        assert got.tolist() == [_mix(_mix((j & 0xFFFFFFFF) ^ key) ^ (j >> 32))
                                for j in i.tolist()]


@pytest.mark.parametrize('m,k,n', [(300, 128, 130), (64, 256, 64), (512, 128, 512)])
def test_int8_matmul_equals_jax_interpret(m, k, n):
    """Exactly the JAX kernel's result (interpret mode): the integer
    product is exact in both, and both multiply float32(acc) by the scales'
    float32 product."""
    rng = np.random.default_rng(m + n)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs, ws = np.array([[0.0131]], np.float32), np.array([[0.00217]], np.float32)
    want = np.asarray(jq.int8_matmul(*(jnp.asarray(a) for a in (xq, xs, wq, ws)),
                                     interpret=True))
    args = [torch.from_numpy(a) for a in (xq, xs, wq, ws)]
    got = Q.int8_matmul(*args)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(Q.int8_matmul_reference(*args).numpy(), want)
    np.testing.assert_array_equal(
        Q.int8_matmul_t(args[0], args[1], args[2].t().contiguous(), args[3]).numpy(), want)


@pytest.mark.parametrize('with_bias', [True, False])
def test_quant_dense_matches_jax(with_bias):
    """QuantDense.from_params of the same flax Dense params, applied to the
    same 3-D input, within 1e-6 of the JAX QuantDense (both round to
    nearest on the CPU; the int8 product is exact)."""
    params = {'kernel': _normal((48, 24), seed=3, scale=0.05)}
    if with_bias:
        params['bias'] = _normal((24,), seed=4, scale=0.02)
    x = _normal((2, 5, 48), seed=5)
    want = np.asarray(jq.QuantDense.from_params(
        {k: jnp.asarray(v) for k, v in params.items()})(jnp.asarray(x)))
    layer = Q.QuantDense.from_params(params, device='cpu')
    got = layer(torch.from_numpy(x))
    assert got.shape == (2, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    buffers = dict(layer.named_buffers())
    assert set(buffers) == {'weight_t', 'w_scale'} | ({'bias'} if with_bias else set())
    assert buffers['weight_t'].dtype == torch.int8 and buffers['weight_t'].shape == (24, 48)
    want_q = jq.quantize_params(jnp.asarray(params['kernel']))
    got_q = Q.quantize_params(torch.from_numpy(params['kernel']))
    np.testing.assert_array_equal(got_q['kernel_q'].numpy(), np.asarray(want_q['kernel_q']))
    np.testing.assert_array_equal(layer.weight_t.t().numpy(), np.asarray(want_q['kernel_q']))


def test_quant_dense_is_its_parts_composed():
    """The layer is quantize_params of the kernel, quantize_int8 of the
    activation with the forward's seed, and int8_matmul, composed by hand
    (the way the card's check builds the round-to-nearest product)."""
    params = {'kernel': _normal((48, 24), seed=7, scale=0.05)}
    x = torch.from_numpy(_normal((6, 48), seed=8))
    layer = Q.QuantDense.from_params(params, seed=2, device='cpu')
    wq, ws = Q.quantize_int8(torch.from_numpy(params['kernel']), 2)
    assert torch.equal(layer.weight_t, wq.t()) and torch.equal(layer.w_scale, ws)
    xq, xs = Q.quantize_int8(x, 1)
    assert torch.equal(layer(x), Q.int8_matmul(xq, xs, wq, ws))
    assert torch.equal(layer(x, seed=5), Q.int8_matmul_t(xq, xs, wq.t().contiguous(), ws))


def test_quant_dense_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Q.QuantDense.from_params({'kernel': np.zeros((4, 2), np.float32)})


def test_cpu_wrappers_count_no_launch_and_bad_inputs_raise():
    before = (Q.quantize_int8_values.launches, Q.int8_matmul_t.launches)
    layer = Q.QuantDense.from_params({'kernel': _normal((8, 4), seed=6)}, device='cpu')
    layer(torch.ones(3, 8))
    assert (Q.quantize_int8_values.launches, Q.int8_matmul_t.launches) == before
    with pytest.raises(ValueError, match='2-D'):
        Q.quantize_int8(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match='int8'):
        Q.int8_matmul(torch.zeros(2, 3), torch.ones(1, 1), torch.zeros(3, 2), torch.ones(1, 1))
    with pytest.raises(ValueError, match='contraction'):
        Q.int8_matmul(torch.zeros(2, 3, dtype=torch.int8), torch.ones(1, 1),
                      torch.zeros(4, 2, dtype=torch.int8), torch.ones(1, 1))
    meta = torch.empty(4, 8, device='meta')
    with pytest.raises(RuntimeError, match='no quantize kernel'):
        Q.quantize_int8_values(meta, torch.ones(1, 1, device='meta'))
    with pytest.raises(RuntimeError, match='no int8 matmul kernel'):
        Q.int8_matmul_t(meta.to(torch.int8), torch.ones(1, 1), meta.to(torch.int8),
                        torch.ones(1, 1))


def _int8_at(shape, offset):
    """An int8 tensor of ``shape`` whose data starts ``offset`` bytes into a
    16-byte-aligned buffer."""
    rows, cols = shape
    buf = torch.zeros(rows * cols + 64, dtype=torch.int8)
    start = (-buf.data_ptr()) % 16 + offset
    return buf[start:start + rows * cols].view(rows, cols)


@pytest.mark.parametrize('k,x_off,w_off,path', [
    (4096, 0, 0, 'wgmma'),          # fc2: the main path
    (128, 0, 0, 'wgmma'),
    (80, 0, 0, 'wgmma'),            # a multiple of 16, not of TMA's 128-byte slice
    (16, 0, 0, 'wgmma'),
    (45, 0, 0, 'mma_sync'),         # K off 16 bytes: rows not addressable by TMA
    (100, 0, 0, 'mma_sync'),
    (0, 0, 0, 'mma_sync'),          # an empty contraction
    (128, 1, 0, 'mma_sync'),        # x_q off 16 bytes
    (128, 0, 8, 'mma_sync'),        # w_t off 16 bytes
])
def test_int8_matmul_path_follows_the_shapes_and_alignment(k, x_off, w_off, path):
    """K7 takes TMA and wgmma exactly when TMA can address both operands: K a
    positive multiple of 16 and both starting on 16 bytes; else the
    mma.sync kernel with byte loads."""
    x_q, w_t = _int8_at((3, k), x_off), _int8_at((5, k), w_off)
    assert (x_q.data_ptr() % 16, w_t.data_ptr() % 16) == (x_off, w_off)
    assert Q.int8_matmul_path(x_q, w_t) == path
    assert path in Q.MM_PATHS


@pytest.mark.parametrize('change,error', [
    (dict(x_contiguous=False), ValueError),
    (dict(w_contiguous=False), ValueError),
    (dict(scale_device='meta'), ValueError),
])
def test_int8_matmul_launcher_rejects_before_loading_the_kernel(monkeypatch, change, error):
    """K7's launcher checks run before the kernel library is built or
    loaded."""
    def no_load(*args):
        raise AssertionError('the kernel library was loaded before the checks')

    monkeypatch.setattr(Q, '_load', no_load)
    p = dict(x_contiguous=True, w_contiguous=True, scale_device='cpu')
    p.update(change)
    x_q = torch.zeros(8, 32, dtype=torch.int8)
    w_t = torch.zeros(4, 32, dtype=torch.int8)
    if not p['x_contiguous']:
        x_q = torch.zeros(32, 8, dtype=torch.int8).t()
    if not p['w_contiguous']:
        w_t = torch.zeros(32, 4, dtype=torch.int8).t()
    scale = torch.ones(1, 1, device=p['scale_device'])
    with pytest.raises(error):
        Q._launch_mm(x_q, scale, w_t, torch.ones(1, 1))
