"""The port's max pool and its backward (K8) against the JAX package, on
the CPU in float32.

The plain version of K8 (``max_pool_32_bwd_reference``, what the wrapper
runs on CPU tensors) against the JAX Pallas kernel in interpret mode, on
random inputs and on inputs with ties, where every tied maximum must get
its window's gradient; the autograd Function against ``jax.grad`` of the
JAX ``max_pool(impl='pallas')``; and ``max_pool``'s routing.  Inputs come
from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ever_tpu.module.ops import max_pool as jax_max_pool
from ever_tpu.ops.pool import max_pool_32_pallas
from ever_tpu_torch.module.ops import max_pool
from ever_tpu_torch.ops import pool as P

PAD = ((1, 1), (1, 1))


def _inputs(shape, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:            # small integers: many exact ties inside a window
        x = rng.integers(-2, 3, size=shape).astype(np.float32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
    out = np.asarray(jax_max_pool(jnp.asarray(x), 3, 2, PAD))
    g = rng.normal(size=out.shape).astype(np.float32)
    return x, out, g


@pytest.mark.parametrize('shape', [(2, 64, 48, 5), (1, 30, 22, 3), (2, 8, 6, 16)])
@pytest.mark.parametrize('ties', [False, True])
def test_plain_bwd_matches_pallas_interpret(shape, ties):
    """Same dx as the Pallas kernel in interpret mode.  Both compare exactly
    and add at most four float32 terms (the port in float32, the kernel in
    g's type, float32 here), in other orders: 1e-6."""
    x, out, g = _inputs(shape, seed=sum(shape), ties=ties)
    want = np.asarray(max_pool_32_pallas(jnp.asarray(x), jnp.asarray(out),
                                         jnp.asarray(g), interpret=True))
    got = P.max_pool_32_bwd(*(torch.from_numpy(a) for a in (x, out, g)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_every_tied_maximum_gets_the_gradient():
    """One 4×4 input whose first window holds three equal maxima: each gets
    that window's gradient, where F.max_pool2d's backward picks one."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 0] = x[0, 0, 1] = x[0, 1, 0] = 5.0      # window (0, 0) covers rows/cols 0-1
    x[0, 3, 3] = 1.0
    out = np.asarray(jax_max_pool(jnp.asarray(x), 3, 2, PAD))
    g = np.zeros(out.shape, np.float32)
    g[0, 0, 0] = 2.0
    dx = P.max_pool_32_bwd(*(torch.from_numpy(a) for a in (x, out, g)))[0, :, :, 0]
    assert dx[0, 0] == dx[0, 1] == dx[1, 0] == 2.0 and float(dx.sum()) == 6.0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    F.max_pool2d(xt, 3, 2, 1).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert float(xt.grad.sum()) == 2.0                  # one winner per window


@pytest.mark.parametrize('shape', [(2, 16, 12, 5), (1, 30, 22, 3)])
def test_autograd_function_matches_jax_grad(shape):
    """max_pool(impl='pallas'): forward equal to the JAX pool, dx equal to
    jax.grad through the JAX Pallas path (interpret mode), for a weighted
    sum of the output (1e-6, as above)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(shape[0], shape[1] // 2, shape[2] // 2, shape[3])).astype(np.float32)

    def jloss(a):
        return jnp.sum(jax_max_pool(a, 3, 2, PAD, impl='pallas') * jnp.asarray(w))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = max_pool(xt, 3, 2, PAD, impl='pallas')
    assert out.grad_fn.name() == 'MaxPool32Backward'
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jax_max_pool(jnp.asarray(x), 3, 2, PAD)))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape,window,stride,padding,impl,routed', [
    ((1, 8, 8, 2), 3, 2, PAD, 'pallas', True),
    ((1, 8, 8, 2), 3, 2, PAD, 'planes', True),
    ((1, 8, 8, 2), 3, 2, PAD, 'reduce_window', False),
    ((1, 8, 8, 2), 3, 2, PAD, 'separable', False),
    ((1, 9, 8, 2), 3, 2, PAD, 'pallas', False),       # odd H
    ((1, 8, 8, 2), 3, 2, 'SAME', 'pallas', False),    # lax SAME pads (0, 1)
    ((1, 8, 8, 2), 2, 2, 'VALID', 'pallas', False),
    ((1, 15, 15, 3), 3, 2, 'SAME', 'reduce_window', False),
    ((1, 9, 7, 3), 1, 2, 'VALID', 'reduce_window', False),
])
def test_max_pool_routes_and_values_match_jax(shape, window, stride, padding, impl,
                                              routed):
    """The autograd Function only for 3×3/2, padding ((1,1),(1,1)), even H
    and W and a float type; every case's values equal the JAX pool's."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = max_pool(xt, window, stride, padding, impl=impl)
    assert (out.grad_fn.name() == 'MaxPool32Backward') == routed
    want = np.asarray(jax_max_pool(jnp.asarray(x), window, stride, padding, impl=impl))
    np.testing.assert_array_equal(out.detach().numpy(), want)


def test_unknown_impl_and_odd_shapes_raise():
    with pytest.raises(ValueError, match='impl'):
        max_pool(torch.zeros(1, 4, 4, 1), impl='fast')
    with pytest.raises(ValueError, match='even'):
        P.max_pool_32_bwd(torch.zeros(1, 5, 4, 1), torch.zeros(1, 2, 2, 1),
                          torch.zeros(1, 2, 2, 1))
    with pytest.raises(ValueError, match='out and g'):
        P.max_pool_32_bwd(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2, 1),
                          torch.zeros(1, 2, 3, 1))
