"""The port's fused LayerNorm (K4 forward, K5 backward) against the JAX
package, on the CPU.

The plain versions (what the wrappers run on CPU tensors) against the JAX
Pallas kernels in interpret mode and their ``jax.grad``, at the shapes of
``tests/test_norm.py``: rows 256 (whole row blocks) and 515 (a padded
tail), width 256; a 3-D bf16 case; the module against the JAX
``FusedLayerNorm`` (flax's one-pass math on the CPU) and ``nn.LayerNorm``'s
``state_dict``.  Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.ops import norm as jnorm
from ever_tpu_torch.ops import norm as N

EPS = 1e-5


def _inputs(rows, width=256, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, width)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=width).astype(np.float32)
    b = rng.normal(size=width).astype(np.float32)
    w = rng.normal(size=(rows, width)).astype(np.float32)     # upstream gradient
    return x, g, b, w


@pytest.mark.parametrize('rows', [256, 515])
def test_forward_matches_pallas_interpret(rows):
    """y, mean and rstd against the Pallas forward kernel in interpret
    mode: the same float32 one-pass arithmetic, sums in other orders
    (1e-5, as tests/test_norm.py holds the kernel against flax)."""
    x, g, b, _ = _inputs(rows)
    want_y, want_mu, want_rs = (np.asarray(a) for a in jnorm._fwd_impl(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS, True))
    y, mu, rs = N.layer_norm_fwd(*(torch.from_numpy(a) for a in (x, g, b)), EPS)
    assert y.dtype == mu.dtype == rs.dtype == torch.float32 and mu.shape == (rows,)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mu.numpy(), want_mu[:rows, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rs.numpy(), want_rs[:rows, 0], rtol=1e-5)


@pytest.mark.parametrize('rows', [256, 515])
def test_backward_matches_pallas_interpret(rows):
    """dx, dγ and dβ against the Pallas backward kernel given the same mean
    and rstd.  dγ and dβ sum over all rows (dβ ~ √rows·|dy|): 1e-5 relative,
    1e-4 absolute."""
    x, g, b, w = _inputs(rows, seed=1)
    _, mu, rs = jnorm._fwd_impl(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS, True)
    want = jnorm._bwd_impl(jnp.asarray(x), jnp.asarray(g), mu, rs, jnp.asarray(w), EPS, True)
    got = N.layer_norm_bwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
                           torch.from_numpy(np.array(mu)[:rows, 0]),
                           torch.from_numpy(np.array(rs)[:rows, 0]))
    for a, r, name in zip(got, want, ('dx', 'dgamma', 'dbeta')):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize('rows', [256, 515])
def test_autograd_function_matches_jax_grad(rows):
    """layer_norm's forward and its dx, dγ, dβ against the JAX layer_norm
    (interpret mode) and jax.grad of a weighted sum: forward 1e-5, grads
    2e-4 (tests/test_norm.py's limits)."""
    x, g, b, w = _inputs(rows, seed=2)
    want_y = np.asarray(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                         EPS, interpret=True))
    want = jax.grad(lambda x, g, b: jnp.sum(jnorm.layer_norm(x, g, b, EPS, interpret=True)
                                            * jnp.asarray(w)),
                    (0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = N.layer_norm(xt, gt, bt, EPS)
    assert 'ever_tpu_torch_layer_norm_fwd' in y.grad_fn.next_functions[0][0].name()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5, atol=1e-5)
    (y * torch.from_numpy(w)).sum().backward()
    for t, r, name in zip((xt, gt, bt), want, ('dx', 'dgamma', 'dbeta')):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_3d_bf16_matches_pallas_interpret():
    """A [2, 70, 128] bf16 input: y in bf16, as the JAX kernel gives it
    (both round the same float32 value once: at most one bf16 ulp apart);
    the backward gives dx in bf16 and dγ, dβ in float32, equal to the
    plain backward on the same saved statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 70, 128)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 128).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    want = np.asarray(jnorm.layer_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g),
                                       jnp.asarray(b), 1e-6, interpret=True), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    gt, bt = (torch.from_numpy(a).requires_grad_() for a in (g, b))
    y = N.layer_norm(xt, gt, bt, 1e-6)
    assert y.shape == xt.shape and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(torch.bfloat16)
    y.backward(dy)
    assert xt.grad.dtype == torch.bfloat16 and gt.grad.dtype == bt.grad.dtype == torch.float32
    x2 = xt.detach().reshape(-1, 128)
    _, mu, rs = N.layer_norm_reference(x2, gt.detach(), bt.detach(), 1e-6)
    dx, dg, db = N.layer_norm_bwd_reference(x2, dy.reshape(-1, 128), gt.detach(), mu, rs)
    assert torch.equal(xt.grad.reshape(-1, 128), dx)
    assert torch.equal(gt.grad, dg) and torch.equal(bt.grad, db)


def test_module_matches_jax_fused_layer_norm_and_loads_layer_norm_weights():
    """FusedLayerNorm takes nn.LayerNorm's state_dict (float32 weight and
    bias) and gives the JAX FusedLayerNorm's output (flax one-pass math on
    the CPU) on a 3-D input with row mean 2 within 1e-5: the one-pass
    variance keeps fewer digits as the mean grows, and XLA and torch sum
    the rows in other orders."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 33, 256)) + 2).astype(np.float32)
    scale = rng.normal(size=256).astype(np.float32)
    bias = rng.normal(size=256).astype(np.float32)
    want = np.asarray(jnorm.FusedLayerNorm(epsilon=EPS).apply(
        {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}}, jnp.asarray(x)))
    plain = torch.nn.LayerNorm(256, eps=EPS)
    plain.load_state_dict({'weight': torch.from_numpy(scale), 'bias': torch.from_numpy(bias)})
    fused = N.FusedLayerNorm(256, EPS)
    fused.load_state_dict(plain.state_dict())
    assert isinstance(fused, torch.nn.LayerNorm) and fused.weight.dtype == torch.float32
    assert list(fused.state_dict()) == ['weight', 'bias']
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    x, g, b, w = (torch.from_numpy(a) for a in _inputs(40, 64, seed=5))
    before = (N.layer_norm_fwd.launches, N.layer_norm_bwd.launches)
    y, mu, rs = N.layer_norm_fwd(x, g, b, EPS)
    got = N.layer_norm_bwd(x, w, g, mu, rs)
    assert (N.layer_norm_fwd.launches, N.layer_norm_bwd.launches) == before
    for a, r in zip((y, mu, rs) + got, N.layer_norm_reference(x, g, b, EPS)
                    + N.layer_norm_bwd_reference(x, w, g, mu, rs)):
        assert torch.equal(a, r)


def test_wrong_shapes_and_devices_raise():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match='weight and bias'):
        N.layer_norm_fwd(x, torch.ones(7), torch.zeros(8), EPS)
    with pytest.raises(ValueError, match=r'\[R, C\]'):
        N.layer_norm_fwd(torch.zeros(2, 4, 8), torch.ones(8), torch.zeros(8), EPS)
    with pytest.raises(TypeError, match='float'):
        N.layer_norm_fwd(x.long(), torch.ones(8), torch.zeros(8), EPS)
    meta = torch.empty(4, 8, device='meta')
    with pytest.raises(RuntimeError, match='no LayerNorm kernel'):
        N.layer_norm_fwd(meta, torch.ones(8, device='meta'), torch.zeros(8, device='meta'),
                         EPS)


@pytest.mark.parametrize('rows,width,dtype,offset,path', [
    (8232, 1024, torch.bfloat16, 0, 'one_pass'),     # DinoSeg ViT-L/16
    (8232, 1024, torch.float32, 0, 'one_pass'),
    (517, 768, torch.bfloat16, 0, 'one_pass'),       # ViT-B
    (64, 1280, torch.bfloat16, 0, 'one_pass'),       # ViT-H, the widest in registers
    (64, 1280, torch.float32, 0, 'one_pass'),
    (64, 384, torch.float32, 0, 'one_pass'),         # ViT-S in float32 (3 vectors of 4)
    (64, 384, torch.bfloat16, 0, 'two_sweep'),       # not 32 vectors of 8
    (64, 1536, torch.bfloat16, 0, 'two_sweep'),      # past the registers
    (300, 4096, torch.bfloat16, 0, 'two_sweep'),     # ViT-g
    (37, 203, torch.bfloat16, 0, 'elementwise'),     # off the 16-byte vector
    (64, 768, torch.bfloat16, 8, 'one_pass'),        # x starts 16 bytes in: aligned
    (64, 768, torch.bfloat16, 3, 'elementwise'),     # x off 16 bytes
])
def test_backward_path_rule(rows, width, dtype, offset, path):
    """K5's path from the width and the pointers: one pass for widths of 32
    16-byte vectors up to 1280, two sweeps for other multiples of the
    vector, element by element off the vector or off 16 bytes."""
    buf = torch.zeros(offset + rows * width, dtype=dtype)
    x = buf[offset:].view(rows, width)
    dy = torch.zeros(rows, width, dtype=dtype)
    assert N.layer_norm_bwd_path(x, dy, torch.ones(width)) == path


@pytest.mark.parametrize('rows,width,partial_shape', [
    (1, 8, (1, 16)), (32, 8, (1, 16)), (33, 203, (2, 406)), (517, 768, (17, 1536)),
    (8232, 1024, (258, 2048)), (32808, 1024, (1026, 2048))])
def test_backward_partial_sums_shape(rows, width, partial_shape):
    """K5's scratch: one float32 [2C] row of partial sums (dγ | dβ) per CTA
    of 32 rows, the same on every path."""
    partial = N._bwd_partial(rows, width, 'cpu')
    assert partial.shape == partial_shape and partial.dtype == torch.float32
    assert partial.is_contiguous()


@pytest.mark.parametrize('change,error', [
    (dict(dtype=torch.float16), TypeError),
    (dict(dy_dtype=torch.float32), TypeError),
    (dict(strided=True), ValueError),
])
def test_backward_launcher_checks_before_loading_the_library(monkeypatch, change, error):
    """K5's launcher raises on what its kernels do not take (a type, dy of
    another type, a non-contiguous x) before the library is loaded."""
    def no_load(*args, **kwargs):
        raise AssertionError('the kernel library was loaded before the checks')

    monkeypatch.setattr(N, '_kernel', no_load)
    p = dict(dtype=torch.bfloat16, dy_dtype=None, strided=False)
    p.update(change)
    x = torch.zeros(16, 256, dtype=p['dtype'])
    if p['strided']:
        x = torch.zeros(16, 512, dtype=p['dtype'])[:, ::2]
    dy = torch.zeros(16, 256, dtype=p['dy_dtype'] or p['dtype'])
    with pytest.raises(error):
        N._launch_bwd(x, dy, torch.ones(256), torch.zeros(16), torch.ones(16))
