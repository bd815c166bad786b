"""``Fusion`` and ``BiFPN`` in the port against the JAX package, on the CPU.

``Fusion`` in both modes (softmax, fast-normalize): the weighted sum and
the gradients of its weights and of every input.  ``BiFPN`` at width 16 in
a train-mode forward: over strides (4, 8, 16, 32) with ``'conv'`` and
``'maxpool'`` downsampling, with softmax fusions, over a duplicate-stride
config (8, 16, 32, 32) whose last pairs go through the 1×1 adapters, and
at an odd size (levels 18, 9, 5, 3 of a 72² input: the top-down nearest
resizes are 3 → 5 and 5 → 9, at sample positions that are never whole
numbers, where the JAX package's CPU resize and the port's agree); the
outputs, every BatchNorm's running statistics and the gradients of every
parameter and input for a seeded cotangent on each output.  Then
``conv_with_kaiming_uniform``'s bound and the reference spellings.

Weights are seeded draws in the JAX tree carried across by
``convert_flax_bifpn`` (the fusion weights drawn in [0.5, 1.5], so no
ReLU of fast-normalize sits at 0); inputs are seeded numpy draws; float64
on both sides, the JAX side under ``jax.jit``.  Tolerance 1e-10 of the
scale: both compute in float64 throughout.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import fpn as jfpn
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.module import fpn as tfpn
from ever_tpu_torch.util.weight_io import convert_flax_bifpn
from test_torch_efficientnet import compare, jax_train_grads, port_train_grads
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _nchw, _nhwc, _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64 = 1e-10
WIDTH = 16


@pytest.mark.parametrize('mode', ['softmax', 'fast_normalize'])
def test_fusion_matches_jax(mode):
    xs = [_x((2, 5, 6, 4), seed=i) for i in range(3)]
    w = np.random.default_rng(7).uniform(-0.5, 1.5, 3)
    w[1] = -0.25 if mode == 'fast_normalize' else w[1]     # a weight the ReLU zeroes
    g = _x((2, 5, 6, 4), seed=9)
    with jax.enable_x64(True):
        jm = jfpn.Fusion(3, mode)

        def f(w, xs):
            return (jm.apply({'params': {'weights': w}}, xs) * g).sum(), jm.apply(
                {'params': {'weights': w}}, xs)

        (_, want), (gw, gxs) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jnp.asarray(w), [jnp.asarray(a) for a in xs])
    tm = tfpn.Fusion(3, mode).double()
    default = tfpn.Fusion(3, mode)
    assert torch.equal(default.weights, (torch.zeros if mode == 'softmax' else torch.ones)(3))
    with torch.no_grad():
        tm.weights.copy_(torch.from_numpy(w))
    txs = [_nchw(a).requires_grad_() for a in xs]
    got = tm(txs)
    (got * _nchw(g)).sum().backward()
    close(_nhwc(got), want, F64)
    close(tm.weights.grad.numpy(), gw, F64)
    for t, w_ in zip(txs, gxs):
        close(_nhwc(t.grad), w_, F64)


def _fusion_weights_positive(v):
    """The variables with every fusion's weights drawn in [0.5, 1.5]."""
    rng = np.random.default_rng(11)

    def draw(path, a):
        return rng.uniform(0.5, 1.5, a.shape) if jax.tree_util.keystr(path).endswith(
            "['weights']") else a
    return jax.tree_util.tree_map_with_path(draw, v)


def _sides(size, strides):
    return [-(-size // s) for s in strides]


# name → (strides, input size, downsample_op, fusion)
CASES = {
    'conv': ((4, 8, 16, 32), 64, 'conv', 'fast_normalize'),
    'maxpool': ((4, 8, 16, 32), 64, 'maxpool', 'fast_normalize'),
    'softmax': ((4, 8, 16, 32), 64, 'conv', 'softmax'),
    'duplicate_stride': ((8, 16, 32, 32), 64, 'conv', 'fast_normalize'),
    'odd_size': ((4, 8, 16, 32), 72, 'conv', 'fast_normalize'),
    'odd_size_maxpool': ((4, 8, 16, 32), 72, 'maxpool', 'softmax'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_bifpn_matches_jax(case):
    strides, size, down, fusion = CASES[case]
    feats = [_x((2, n, n, WIDTH), seed=i) for i, n in enumerate(_sides(size, strides))]
    jm = jfpn.BiFPN(WIDTH, strides, fusion, down, dtype=jnp.float64)
    ref = jax_train_grads(jm, feats, fix=_fusion_weights_positive)
    tm = tfpn.BiFPN(WIDTH, strides, fusion, down).double()
    tm.load_state_dict(convert_flax_bifpn(ref['v']), strict=True)
    outs, xs = port_train_grads(tm, feats, ref['gs'], nhwc_in=False)
    assert [tuple(o.shape[2:]) for o in outs] == [(n, n) for n in _sides(size, strides)]
    names = set(tm.state_dict())
    adapters = {n.split('.')[0] for n in names if '_adapter' in n}
    assert adapters == ({'up0_adapter', 'down2_adapter'} if case == 'duplicate_stride'
                        else set())
    assert any('down0_bn' in n for n in names) == (down == 'maxpool')
    compare(tm, ref, convert_flax_bifpn, outs, xs, F64, nhwc_in=False)


def test_stacked_bifpn_layers_and_the_registry():
    """Three layers over B0's reduced levels, as EfficientDet-D0 stacks
    them, built from the port's ``OP`` registry: each output keeps its
    level's shape; the layers take their parts' names from the JAX
    package's (``bin_fusion{i}``, ``tri_fusion{i}``, ``down{i}``)."""
    layers = [tregistry.OP['BiFPN'](WIDTH, (4, 8, 16, 32)) for _ in range(3)]
    feats = [torch.randn(2, WIDTH, n, n) for n in (16, 8, 4, 2)]
    for layer in layers:
        feats = layer(feats, train=True)
    assert [tuple(f.shape) for f in feats] == [(2, WIDTH, n, n) for n in (16, 8, 4, 2)]
    jnames = jax.eval_shape(lambda: jfpn.BiFPN(WIDTH, (4, 8, 16, 32)).init(
        jax.random.key(0), [jnp.zeros((1, n, n, WIDTH)) for n in (16, 8, 4, 2)]))['params']
    assert {n.split('.')[0] for n, _ in layers[0].named_parameters()} == set(jnames)
    with pytest.raises(ValueError, match='widths'):
        layers[0]([torch.randn(1, 8, n, n) for n in (16, 8, 4, 2)])


@pytest.mark.parametrize('use_bn,use_relu', [(False, False), (True, True)])
def test_conv_with_kaiming_uniform_bound(use_bn, use_relu):
    """FPN's conv factory: the weight uniform in ±√(3 / fan_in) (torch's
    ``kaiming_uniform_(a=1)``, the JAX package's ``variance_scaling(1,
    'fan_in', 'uniform')``), bias-free, with BN and ReLU as asked."""
    torch.manual_seed(0)
    block = tfpn.conv_with_kaiming_uniform(use_bn, use_relu)(64, 128, 3)
    w = block[0].weight.detach()
    bound = math.sqrt(3.0 / (64 * 9))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
    assert abs(float(w.std()) - bound / math.sqrt(3)) < 0.02 * bound
    assert block[0].bias is None
    assert [type(m).__name__ for m in block] == (['Conv2d', 'BatchNorm2d', 'ReLU'] if use_bn
                                                 else ['Conv2d'])
    jblock = jfpn.conv_with_kaiming_uniform(use_bn, use_relu)(128, 3)
    jv = jblock.init(jax.random.key(0), jnp.zeros((1, 8, 8, 64)))
    jk = np.asarray(jv['params']['Conv_0']['kernel'])
    assert jk.shape == (3, 3, 64, 128) and np.abs(jk).max() <= bound
    assert np.abs(jk).max() > 0.99 * bound
    assert (jblock.norm == 'bn') == use_bn and (jblock.act is not None) == use_relu


def test_fused_conv_spellings():
    """The reference's two fused-conv classes: fast-normalize and softmax
    fusions by default."""
    assert tfpn.FastNormalizedFusionConv3x3(2, 8, 8).fusion.norm_method == 'fast_normalize'
    assert tfpn.NormalizedFusionConv3x3(3, 8, 8).fusion.norm_method == 'softmax'
    assert jfpn.NormalizedFusionConv3x3.norm_method == 'softmax'
    assert set(tregistry.OP) >= {'Fusion', 'BiFPN', 'FPN', 'AssymetricDecoder'}
