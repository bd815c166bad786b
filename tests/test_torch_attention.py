"""Attention in the PyTorch port against the JAX package.

Inputs come from one numpy generator and go to both packages.  The JAX
fused kernel runs in Pallas interpret mode on the CPU.  Everything is
float32, so the two sides agree to 1e-5 (the only differences are the order
of float32 sums).  Rows past ``n_valid`` are garbage by contract and are not
compared.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu_torch.ops import attention as TA

# the package re-exports the function under the module's name
JA = importlib.import_module('ever_tpu.ops.attention')
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, h, s, d, rope):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    tables = None
    if rope:
        ang = np.tile(rng.uniform(0, 2 * np.pi, size=(s, d // 2)), (1, 2))
        ang[:3] = 0.0                    # identity prefix rows (sin=0, cos=1)
        tables = (np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32))
    return q, k, v, tables


def _jax_fused_fwd(q, k, v, tables, n):
    """The JAX kernel launcher on the inputs ``_fused`` would give it:
    [B,H,S,D], q pre-scaled, padded to ``pad_target``, sign-folded tables."""
    b, s, h, d = q.shape
    target = JA.pad_target(s)
    pad = ((0, 0), (0, 0), (0, target - s), (0, 0))
    qt, kt, vt = (jnp.pad(jnp.swapaxes(jnp.asarray(t), 1, 2), pad) for t in (q, k, v))
    qt = qt * (1.0 / d ** 0.5)
    rope = None
    if tables is not None:
        sign = np.where(np.arange(d) < d // 2, -1.0, 1.0).astype(np.float32)
        sinp = np.concatenate([tables[0] * sign, np.zeros((target - s, d), np.float32)])
        cosp = np.concatenate([tables[1], np.ones((target - s, d), np.float32)])
        rope = (jnp.asarray(sinp), jnp.asarray(cosp))
    o, lse = JA._fused_fwd_impl(qt, kt, vt, rope, n, interpret=True)
    return np.asarray(o)[:, :, :s], np.asarray(lse)[:, :, :s, 0]


@pytest.mark.parametrize('s,d', [(40, 16), (77, 64)])
@pytest.mark.parametrize('rope', [False, True])
@pytest.mark.parametrize('short', [False, True])
def test_reference_matches_jax_fused_kernel(s, d, rope, short):
    """o and lse of the port's kernel function (its plain version on the
    CPU) against the JAX fused kernel, with and without RoPE and n_valid."""
    q, k, v, tables = _inputs(s * d + rope + 2 * short, 2, 2, s, d, rope)
    n = s - 7 if short else s
    n_valid = n if short else None
    jo, jlse = _jax_fused_fwd(q, k, v, tables, n)
    to, tlse = TA.fused_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), n_valid=n_valid,
        rope=None if tables is None else tuple(map(torch.from_numpy, tables)))
    np.testing.assert_allclose(to.numpy()[:, :n], np.swapaxes(jo, 1, 2)[:, :n], **TOL)
    np.testing.assert_allclose(tlse.numpy()[..., :n], jlse[..., :n], **TOL)
    # the JAX dispatcher's wrapper around the same kernel (pads, rotates)
    jw = JA._fused(*map(jnp.asarray, (q, k, v)), interpret=True,
                   n_valid=n_valid,
                   rope=None if tables is None else tuple(map(jnp.asarray, tables)))
    np.testing.assert_allclose(to.numpy()[:, :n], np.asarray(jw)[:, :n], **TOL)


@pytest.mark.parametrize('impl', ['xla', 'fused', 'flash', None])
@pytest.mark.parametrize('layout', ['bnhd', 'bhnd'])
def test_attention_matches_jax_xla(impl, layout):
    """Every port impl on the CPU against JAX ``attention(impl='xla')``."""
    q, k, v, tables = _inputs(3, 2, 3, 33, 16, rope=True)
    n_valid = 30
    if layout == 'bhnd':
        q, k, v = (np.ascontiguousarray(np.swapaxes(t, 1, 2)) for t in (q, k, v))
    want = np.asarray(JA.attention(*map(jnp.asarray, (q, k, v)), impl='xla',
                                   layout=layout, n_valid=n_valid,
                                   rope=tuple(map(jnp.asarray, tables))))
    got = TA.attention(*(torch.from_numpy(t) for t in (q, k, v)), impl=impl,
                       layout=layout, n_valid=n_valid,
                       rope=tuple(map(torch.from_numpy, tables))).numpy()
    real = (slice(None), slice(0, n_valid)) if layout == 'bnhd' else (
        slice(None), slice(None), slice(0, n_valid))
    np.testing.assert_allclose(got[real], want[real], **TOL)


def test_pad_target_matches_jax():
    for n in list(range(1, 300, 7)) + [1029, 4101, 16389]:
        assert TA.pad_target(n) == JA.pad_target(n, 'auto'), n
        assert TA.pad_target(n, '128') == JA.pad_target(n, '128'), n


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v, _ = _inputs(5, 1, 2, 600, 64, rope=False)
    before = TA.fused_attention.launches
    o, lse = TA.fused_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert TA.fused_attention.launches == before
    ref, rlse = TA.attention_reference(*(torch.from_numpy(t) for t in (q, k, v)),
                                       return_lse=True)
    assert torch.equal(o, ref) and torch.equal(lse, rlse)
    assert lse.shape == (1, 2, 600)


def test_wrapper_raises_off_cpu_and_cuda():
    q = torch.empty((1, 8, 1, 64), device='meta')
    with pytest.raises(RuntimeError, match='no attention kernel'):
        TA.fused_attention(q, q, q)


def test_auto_dispatch_keeps_cpu_and_float32_on_plain_path():
    """A CPU tensor (float32 here) takes the plain path under auto dispatch,
    even past the threshold: no launch."""
    q, k, v, _ = _inputs(6, 1, 1, TA.FUSED_TOKEN_THRESHOLD, 16, rope=False)
    before = TA.fused_attention.launches
    out = TA.attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert TA.fused_attention.launches == before
    np.testing.assert_allclose(
        out.numpy(), TA.attention_reference(*(torch.from_numpy(t) for t in (q, k, v))).numpy())
    with pytest.raises(ValueError, match='impl'):
        TA.attention(*(torch.from_numpy(t) for t in (q, k, v)), impl='cudnn')


class _CudaStub:
    """Stands for a CUDA tensor: what the dispatch reads, nothing more."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype
        self.device = torch.device('cuda')
        self.requires_grad = False


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize('impl', [None, 'fused', 'flash'])
def test_cuda_tensors_reach_the_kernel_wrapper_whatever_their_type(
        monkeypatch, dtype, impl):
    """On the card, auto dispatch past the threshold (and 'fused'/'flash')
    goes to the kernel launcher for every dtype, which launches or raises;
    the plain path is never taken there."""
    calls = []

    def launch(q, k, v, layout, n_valid, rope):
        calls.append((q.dtype, layout, n_valid))
        return 'o', 'lse'

    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain path')

    monkeypatch.setattr(TA, '_launch_fwd', launch)
    monkeypatch.setattr(TA, 'attention_reference', plain)
    q = _CudaStub((2, TA.FUSED_TOKEN_THRESHOLD, 4, 64), dtype)
    assert TA.attention(q, q, q, impl=impl, n_valid=500) == 'o'
    assert calls == [(dtype, 'bnhd', 500)]


@pytest.mark.parametrize('change,error', [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=32), ValueError),
    (dict(n_valid=0), ValueError),
    (dict(n_valid=9), ValueError),
    (dict(layout='nbhd'), ValueError),
    (dict(rope_rows=7), ValueError),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    """The launcher's checks run before the kernel library is built or
    loaded, so they hold on any device."""
    p = dict(dtype=torch.bfloat16, d=64, n_valid=None, layout='bnhd', rope_rows=8)
    p.update(change)
    q = torch.zeros((1, 8, 2, p['d']), dtype=p['dtype'])
    rope = (torch.zeros(p['rope_rows'], p['d']), torch.ones(p['rope_rows'], p['d']))
    with pytest.raises(error):
        TA._launch_fwd(q, q, q, p['layout'], p['n_valid'], rope)


def test_kernel_view_keeps_aligned_strided_views_and_copies_the_rest():
    qkv = torch.zeros((2, 8, 3, 2, 64), dtype=torch.bfloat16)
    q = qkv.unbind(2)[1]                   # a strided view of the packed projection
    assert TA._kernel_view(q) is q
    odd = torch.zeros((2, 8, 3, 2, 60), dtype=torch.bfloat16)[..., :56].unbind(2)[0]
    copy = TA._kernel_view(odd)
    assert copy is not odd and copy.is_contiguous() and torch.equal(copy, odd)


# -- the backward: K2's plain version and the autograd Function ---------------

def _jax_fused_bwd(q, k, v, tables, n, do):
    """The JAX backward kernel launcher on the inputs ``_fused`` would give
    it (see ``_jax_fused_fwd``), with ``do`` zero on the pad rows.  Returns
    dq with respect to the UNscaled q, dk and dv, as [B,S,H,D]."""
    b, s, h, d = q.shape
    target = JA.pad_target(s)
    pad = ((0, 0), (0, 0), (0, target - s), (0, 0))
    qt, kt, vt, dot = (jnp.pad(jnp.swapaxes(jnp.asarray(t), 1, 2), pad)
                       for t in (q, k, v, do))
    scale = 1.0 / d ** 0.5
    qt = qt * scale
    rope = None
    if tables is not None:
        sign = np.where(np.arange(d) < d // 2, -1.0, 1.0).astype(np.float32)
        sinp = np.concatenate([tables[0] * sign, np.zeros((target - s, d), np.float32)])
        cosp = np.concatenate([tables[1], np.ones((target - s, d), np.float32)])
        rope = (jnp.asarray(sinp), jnp.asarray(cosp))
    o, lse = JA._fused_fwd_impl(qt, kt, vt, rope, n, interpret=True)
    dq, dk, dv = JA._fused_bwd_impl(qt, kt, vt, rope, o, lse, dot, n, interpret=True)
    back = lambda t: np.array(np.swapaxes(np.asarray(t), 1, 2)[:, :s])  # noqa: E731
    return (back(o), np.asarray(lse)[:, :, :s, 0],
            back(dq) * scale, back(dk), back(dv))


# float32 on both sides; the gradients sum over all keys or all queries in
# different orders, so they agree to a few 1e-6 at O(1) values
BWD_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize('s,d', [(40, 16), (77, 64)])
@pytest.mark.parametrize('rope', [False, True])
@pytest.mark.parametrize('short', [False, True])
def test_bwd_reference_matches_jax_fused_kernel(s, d, rope, short):
    """dq, dk, dv of the port's plain backward against the JAX backward
    kernel (interpret mode) from the same o, lse and do, with and without
    RoPE and n_valid.  dq rows past n_valid are garbage by contract; dk and
    dv past it are zero in both."""
    q, k, v, tables = _inputs(s * d + rope + 2 * short + 1, 2, 2, s, d, rope)
    do = np.random.default_rng(s + d).normal(size=q.shape).astype(np.float32)
    n = s - 7 if short else s
    jo, jlse, jdq, jdk, jdv = _jax_fused_bwd(q, k, v, tables, n, do)
    dq, dk, dv = TA.attention_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v, jo, jlse, do)),
        n_valid=n if short else None,
        rope=None if tables is None else tuple(map(torch.from_numpy, tables)))
    np.testing.assert_allclose(dq.numpy()[:, :n], jdq[:, :n], **BWD_TOL)
    np.testing.assert_allclose(dk.numpy(), jdk, **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), jdv, **BWD_TOL)
    if short:
        assert not dk[:, n:].any() and not dv[:, n:].any()


@pytest.mark.parametrize('rope', [False, True])
@pytest.mark.parametrize('layout', ['bnhd', 'bhnd'])
@pytest.mark.parametrize('short', [False, True])
def test_bwd_reference_matches_autograd(rope, layout, short):
    """The written-out backward against autograd of the plain forward
    (half-tiled tables, where the inverse rotation is the transpose)."""
    q, k, v, tables = _inputs(11 + rope, 2, 3, 33, 16, rope)
    if layout == 'bhnd':
        q, k, v = (np.ascontiguousarray(np.swapaxes(t, 1, 2)) for t in (q, k, v))
    n_valid = 29 if short else None
    rope_t = None if tables is None else tuple(map(torch.from_numpy, tables))
    qkv = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = TA.attention_reference(*qkv, layout=layout, n_valid=n_valid, rope=rope_t)
    do = torch.from_numpy(np.random.default_rng(5).normal(size=o.shape).astype(np.float32))
    want = torch.autograd.grad(o, qkv, do)
    o2, lse = TA.attention_reference(*(t.detach() for t in qkv), layout=layout,
                                     n_valid=n_valid, rope=rope_t, return_lse=True)
    got = TA.attention_bwd_reference(*(t.detach() for t in qkv), o2, lse, do,
                                     layout=layout, n_valid=n_valid, rope=rope_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('layout', ['bnhd', 'bhnd'])
@pytest.mark.parametrize('impl', ['fused', 'flash'])
def test_kernel_path_gradient_is_the_plain_backward_on_cpu(layout, impl):
    """attention(impl='fused'/'flash') with requires_grad on CPU tensors goes
    through the autograd Function: the plain forward and the written-out
    backward, bit for bit, with no launch counted and no table gradient."""
    q, k, v, tables = _inputs(13, 2, 2, 40, 16, rope=True)
    if layout == 'bhnd':
        q, k, v = (np.ascontiguousarray(np.swapaxes(t, 1, 2)) for t in (q, k, v))
    sin, cos = (torch.from_numpy(t).requires_grad_() for t in tables)
    qkv = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = (TA.fused_attention.launches, TA.fused_attention_bwd.launches)
    o = TA.attention(*qkv, impl=impl, layout=layout, n_valid=37, rope=(sin, cos))
    assert o.grad_fn is not None and 'FusedAttention' in type(o.grad_fn).__name__
    do = torch.from_numpy(np.random.default_rng(2).normal(size=o.shape).astype(np.float32))
    o.backward(do)
    o2, lse = TA.attention_reference(*(t.detach() for t in qkv), layout=layout,
                                     n_valid=37, rope=(sin.detach(), cos.detach()),
                                     return_lse=True)
    want = TA.attention_bwd_reference(*(t.detach() for t in qkv), o2, lse, do,
                                      layout=layout, n_valid=37,
                                      rope=(sin.detach(), cos.detach()))
    assert torch.equal(o.detach(), o2)
    for t, w in zip(qkv, want):
        assert torch.equal(t.grad, w)
    assert sin.grad is None and cos.grad is None
    assert (TA.fused_attention.launches, TA.fused_attention_bwd.launches) == before


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32, torch.float16])
def test_cuda_gradients_reach_the_backward_kernel_launcher(monkeypatch, dtype):
    """On the card the Function's backward goes to the K2 launcher (which
    launches or raises) with the saved unrotated q/k/v, tables, o and lse;
    the plain backward is never taken there."""
    calls = []

    def launch(q, k, v, o, lse, do, layout, n_valid, rope):
        calls.append((q.dtype, layout, n_valid, rope is not None, o, lse, do))
        return 'dq', 'dk', 'dv'

    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain backward')

    monkeypatch.setattr(TA, '_launch_bwd', launch)
    monkeypatch.setattr(TA, 'attention_bwd_reference', plain)
    q = _CudaStub((2, TA.FUSED_TOKEN_THRESHOLD, 4, 64), dtype)
    ctx = type('Ctx', (), dict(saved_tensors=(q, q, q, 'sin', 'cos', 'o', 'lse'),
                               layout='bnhd', n_valid=500))()
    grads = TA._FusedAttention.backward(ctx, 'do')
    assert grads == ('dq', 'dk', 'dv', None, None, None, None)
    assert calls == [(dtype, 'bnhd', 500, True, 'o', 'lse', 'do')]


@pytest.mark.parametrize('change,error', [
    (dict(dtype=torch.float16), TypeError),
    (dict(do_dtype=torch.float32), TypeError),
    (dict(d=32), ValueError),
    (dict(n_valid=0), ValueError),
    (dict(n_valid=9), ValueError),
    (dict(layout='nbhd'), ValueError),
    (dict(rope_rows=7), ValueError),
    (dict(lse_shape=(1, 2, 7)), ValueError),
    (dict(lse_dtype=torch.bfloat16), ValueError),
])
def test_backward_launcher_rejects_what_the_kernel_does_not_take(
        monkeypatch, change, error):
    """The K2 launcher's checks (the forward's, plus o, do and lse) run
    before the kernel library is built or loaded."""
    def no_load(name):
        raise AssertionError('the kernel library was loaded before the checks')

    monkeypatch.setattr(TA, '_load', no_load)
    p = dict(dtype=torch.bfloat16, do_dtype=None, d=64, n_valid=None,
             layout='bnhd', rope_rows=8, lse_shape=(1, 2, 8),
             lse_dtype=torch.float32)
    p.update(change)
    q = torch.zeros((1, 8, 2, p['d']), dtype=p['dtype'])
    do = q if p['do_dtype'] is None else q.to(p['do_dtype'])
    lse = torch.zeros(p['lse_shape'], dtype=p['lse_dtype'])
    rope = (torch.zeros(p['rope_rows'], p['d']), torch.ones(p['rope_rows'], p['d']))
    with pytest.raises(error):
        TA._launch_bwd(q, q, q, q, lse, do, p['layout'], p['n_valid'], rope)


@pytest.mark.parametrize('s,s_pad', [(1029, 1088), (64, 64), (1, 64), (16389, 16448)])
@pytest.mark.parametrize('rope,f32', [(False, False), (True, False), (False, True),
                                      (True, True)])
def test_backward_scratch_shapes_and_types(s, s_pad, rope, f32):
    """K2's scratch: bf16 [B, H, S, D] copies of q always, of k with RoPE or
    float32, of v and do with float32; the float32 [B, H, 2, S_pad] table of
    lse·log2(e) and delta, S_pad a multiple of 64 (TMA reads its rows from
    16-byte boundaries)."""
    qbuf, kbuf, vbuf, dobuf, stats = TA._bwd_scratch(2, 3, s, 64, rope, f32, 'cpu')
    assert qbuf.shape == (2, 3, s, 64) and qbuf.dtype == torch.bfloat16
    assert (kbuf is not None) == (rope or f32)
    assert (vbuf is not None) == f32 and (dobuf is not None) == f32
    for t in (kbuf, vbuf, dobuf):
        assert t is None or (t.shape == qbuf.shape and t.dtype == torch.bfloat16)
    assert stats.shape == (2, 3, 2, s_pad) and stats.dtype == torch.float32
    assert stats.is_contiguous() and (s_pad * 4) % 16 == 0


# -- the forward's rules in plain Python ---------------------------------------

@pytest.mark.parametrize('s', [1029, 64, 1, 16389])
@pytest.mark.parametrize('rope,f32', [(False, False), (True, False), (False, True),
                                      (True, True)])
def test_forward_scratch_shapes_and_types(s, rope, f32):
    """K1's scratch: a bf16 [B, H, S, D] buffer for K (rotated or rounded)
    with RoPE or float32 inputs, and one for V with float32 inputs; bf16
    inputs without RoPE stream K and V in place (None)."""
    kbuf, vbuf = TA._fwd_scratch(2, 3, s, 64, rope, f32, 'cpu')
    assert (kbuf is not None) == (rope or f32) and (vbuf is not None) == f32
    for t in (kbuf, vbuf):
        assert t is None or (t.shape == (2, 3, s, 64) and t.dtype == torch.bfloat16
                             and t.is_contiguous())


@pytest.mark.parametrize('change,error', [
    (dict(dtype=torch.float16), TypeError),
    (dict(k_dtype=torch.float32), TypeError),
    (dict(d=32), ValueError),
    (dict(d=96), ValueError),
    (dict(n_valid=0), ValueError),
    (dict(n_valid=9), ValueError),
    (dict(layout='nbhd'), ValueError),
    (dict(rope_rows=7), ValueError),
    (dict(v_shape=(1, 8, 2, 32)), ValueError),
])
def test_forward_launcher_checks_before_loading_the_library(monkeypatch, change, error):
    """K1's launcher raises on what its kernel does not take before the
    kernel library is built or loaded."""
    def no_load(name):
        raise AssertionError('the kernel library was loaded before the checks')

    monkeypatch.setattr(TA, '_load', no_load)
    p = dict(dtype=torch.bfloat16, k_dtype=None, d=64, n_valid=None, layout='bnhd',
             rope_rows=8, v_shape=None)
    p.update(change)
    q = torch.zeros((1, 8, 2, p['d']), dtype=p['dtype'])
    k = q if p['k_dtype'] is None else q.to(p['k_dtype'])
    v = q if p['v_shape'] is None else torch.zeros(p['v_shape'], dtype=p['dtype'])
    rope = (torch.zeros(p['rope_rows'], p['d']), torch.ones(p['rope_rows'], p['d']))
    with pytest.raises(error):
        TA._launch_fwd(q, k, v, p['layout'], p['n_valid'], rope)


@pytest.mark.parametrize('offset,copied', [(0, False), (8, False), (4, True), (1, True)])
def test_kernel_view_copies_a_start_off_sixteen_bytes(offset, copied):
    """TMA reads K and V from a 16-byte-aligned start: a bf16 view that
    starts ``offset`` elements into an aligned buffer is kept at a multiple
    of 8 elements and copied otherwise."""
    buf = torch.zeros(offset + 2 * 8 * 2 * 64, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset:offset + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    view = TA._kernel_view(t)
    assert (view is not t) == copied and torch.equal(view, t)
    assert view.data_ptr() % 16 == 0
