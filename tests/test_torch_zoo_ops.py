"""The ``module/ops.py`` functions and blocks that the heads and HRNet use,
in the port against the JAX package, on the CPU.

The functions on NHWC arrays (``channel_concat``, ``channel_sum``,
``list_index``, ``upsample``, ``adaptive_avg_pool`` at uneven bins,
``avg_pool``), forward and gradient against ``jax.vjp``; the blocks on NCHW
tensors (``DepthwiseConv2d``, ``SeparableConv2d``, ``SeparableConvBlock``,
``PoolBlock``, ``ResidualBlock``, ``ConvUpsampling``, ``ChannelReduction``)
in float64, eval and train mode: outputs, running statistics and the
gradients of every parameter and input; the list modules; and
``Bf16compatible`` under bfloat16.  Weights are seeded draws in the JAX
tree, renamed into the port's; inputs are seeded numpy draws.

Tolerances: 1e-12 of the scale where both sides compute in float64
throughout; 1e-6 where the JAX package pools or resizes in float32
whatever the input (``adaptive_avg_pool``, ``global_avg_pool``, the
bilinear resizes): both round there, in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import ops as jops
from ever_tpu_torch.module import ops as tops
from ever_tpu_torch.util import weight_io as twio
from test_torch_resnet import close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64, F32_POOL = 1e-12, 1e-6


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_vjp(f, *primals, has_aux=False, seed=9):
    """``f``'s output at ``primals``, its gradients for a seeded cotangent
    (of the output's shape and dtype), f's aux output (or None) and the
    cotangent, all under one ``jax.jit``: for these small graphs one
    compilation costs a fraction of running them op by op."""
    out = jax.eval_shape(f, *primals)
    out = out[0] if has_aux else out
    g = jnp.asarray(_x(out.shape, seed).astype(out.dtype))

    def both(*p):
        if has_aux:
            y, vjp, aux = jax.vjp(f, *p, has_aux=True)
        else:
            (y, vjp), aux = jax.vjp(f, *p), None
        return y, vjp(g), aux

    y, grads, aux = jax.jit(both)(*primals)
    return y, grads, aux, np.asarray(g)


# -- the functions --------------------------------------------------------------

FUNCTIONS = {
    'channel_concat': (lambda m, xs: m.channel_concat(xs), [(2, 5, 5, 3), (2, 5, 5, 4)]),
    'channel_concat_one': (lambda m, xs: m.channel_concat(xs), [(2, 5, 5, 3)]),
    'channel_sum': (lambda m, xs: m.channel_sum(xs), [(2, 5, 5, 3)] * 3),
    'list_index_one': (lambda m, xs: m.list_index(xs, 1), [(2, 4, 4, 3)] * 3),
    'list_index_two': (lambda m, xs: m.channel_concat(m.list_index(xs, 2, 0)),
                       [(2, 4, 4, 3)] * 3),
    'upsample_nearest': (lambda m, xs: m.upsample(xs[0], 2), [(2, 5, 6, 3)]),
    'upsample_bilinear': (lambda m, xs: m.upsample(xs[0], 2, 'bilinear'), [(2, 5, 6, 3)]),
    'adaptive_13_to_3': (lambda m, xs: m.adaptive_avg_pool(xs[0], 3), [(2, 13, 13, 4)]),
    'adaptive_64_to_6': (lambda m, xs: m.adaptive_avg_pool(xs[0], 6), [(2, 64, 64, 3)]),
    'adaptive_10x7_to_3x2': (lambda m, xs: m.adaptive_avg_pool(xs[0], (3, 2)),
                             [(2, 10, 7, 3)]),
    'adaptive_global': (lambda m, xs: m.adaptive_avg_pool(xs[0], 1), [(2, 9, 7, 3)]),
    'adaptive_identity': (lambda m, xs: m.adaptive_avg_pool(xs[0], (5, 4)), [(2, 5, 4, 3)]),
    'avg_pool_same': (lambda m, xs: m.avg_pool(xs[0], 3, 2), [(2, 9, 8, 3)]),
    'avg_pool_valid': (lambda m, xs: m.avg_pool(xs[0], 2, 2, 'VALID'), [(2, 8, 8, 3)]),
    'avg_pool_explicit': (lambda m, xs: m.avg_pool(xs[0], 3, 1, ((1, 1), (0, 2))),
                          [(2, 6, 5, 3)]),
}


@pytest.mark.parametrize('case', sorted(FUNCTIONS))
def test_functions_match_jax_forward_and_gradient(case):
    """Each function on seeded float32 NHWC inputs against the JAX
    package's, and its gradient for a seeded cotangent against
    ``jax.vjp``: 1e-6 of the scale (float32 sums in other orders; the
    adaptive pool's bins are torch's, uneven ones included)."""
    fn, shapes = FUNCTIONS[case]
    xs = [_x(s, seed=i).astype(np.float32) for i, s in enumerate(shapes)]
    want, dwant, _, g = jax_vjp(lambda *a: fn(jops, list(a)), *[jnp.asarray(a) for a in xs])
    txs = [torch.from_numpy(a).requires_grad_() for a in xs]
    got = fn(tops, txs)
    dgot = torch.autograd.grad(got, txs, torch.from_numpy(g), allow_unused=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got.detach().numpy(), want, 1e-6)
    for d, w in zip(dgot, dwant):
        close(np.zeros_like(np.asarray(w)) if d is None else d.numpy(), w, 1e-6)


def test_adaptive_avg_pool_keeps_dtype_and_pools_in_float32():
    """bfloat16 in, bfloat16 out, pooled in float32: the float32 pool of the
    same values rounded once, as the JAX package's."""
    x = torch.from_numpy(_x((2, 13, 13, 4)).astype(np.float32)).bfloat16()
    got = tops.adaptive_avg_pool(x, 3)
    want = tops.adaptive_avg_pool(x.float(), 3).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    jwant = jops.adaptive_avg_pool(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), 3)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jwant.astype(jnp.float32)))


# -- the blocks -----------------------------------------------------------------

def _seeded(module, *args, seed=0, **kw):
    """Every leaf of the JAX module's variables a seeded draw: kernels
    ~N(0, 1/fan_in), scales and variances ~U(0.5, 1.5), the rest ~N(0, 0.1²);
    float64."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return rng.normal(scale=int(np.prod(s.shape[:-1])) ** -0.5, size=s.shape)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(scale=0.1, size=s.shape)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_state(variables, rules):
    """The JAX block's variables under the port's names: ``rules`` map the
    block's module paths (below a ``b/`` root) to the port's (below ``b.``)."""
    flat = twio._variables({'b': variables.get('params', {})},
                           {'b': variables['batch_stats']} if 'batch_stats' in variables
                           else None)
    sd = twio._convert_conv_net(flat, [('', '', rules)], 'block')
    return {k[2:]: v for k, v in sd.items()}


D64 = jnp.float64
BN = '/BatchNorm_0'
# name → (JAX module, port module, JAX → port path rules below 'b', input
# shapes NHWC, takes train, tolerance)
BLOCKS = {
    'depthwise': (lambda: jops.DepthwiseConv2d(3, 2, dtype=D64),
                  lambda: tops.DepthwiseConv2d(6, 3, 2),
                  [('b/Conv_0', 'b')], [(2, 9, 8, 6)], False, F64),
    'depthwise_dilated': (lambda: jops.DepthwiseConv2d(3, 1, 2, use_bias=False, dtype=D64),
                          lambda: tops.DepthwiseConv2d(6, 3, 1, 2, use_bias=False),
                          [('b/Conv_0', 'b')], [(2, 9, 8, 6)], False, F64),
    'separable': (lambda: jops.SeparableConv2d(5, dtype=D64),
                  lambda: tops.SeparableConv2d(6, 5),
                  [('b/DepthwiseConv2d_0/Conv_0', 'b.0'), ('b/Conv_0', 'b.1')],
                  [(2, 9, 8, 6)], False, F64),
    'separable_block': (lambda: jops.SeparableConvBlock(5, dilation=2, dtype=D64),
                        lambda: tops.SeparableConvBlock(6, 5, dilation=2),
                        [('b/SeparableConv2d_0/DepthwiseConv2d_0/Conv_0', 'b.0.0'),
                         ('b/SeparableConv2d_0/Conv_0', 'b.0.1'), ('b/Norm_0' + BN, 'b.1')],
                        [(2, 9, 8, 6)], True, F64),
    'pool_block_1': (lambda: jops.PoolBlock(1, 5, dtype=D64),
                     lambda: tops.PoolBlock(6, 1, 5),
                     [('b/ConvBlock_0/Conv_0', 'b.conv.0'),
                      ('b/ConvBlock_0/Norm_0' + BN, 'b.conv.1')],
                     [(3, 9, 8, 6)], True, F32_POOL),
    'pool_block_3_uneven': (lambda: jops.PoolBlock(3, 5, dtype=D64),
                            lambda: tops.PoolBlock(6, 3, 5),
                            [('b/ConvBlock_0/Conv_0', 'b.conv.0'),
                             ('b/ConvBlock_0/Norm_0' + BN, 'b.conv.1')],
                            [(2, 13, 13, 6)], True, F32_POOL),
    'pool_block_6': (lambda: jops.PoolBlock(6, 5, dtype=D64),
                     lambda: tops.PoolBlock(6, 6, 5),
                     [('b/ConvBlock_0/Conv_0', 'b.conv.0'),
                      ('b/ConvBlock_0/Norm_0' + BN, 'b.conv.1')],
                     [(2, 16, 16, 6)], True, F32_POOL),
    'residual': (lambda: jops.ResidualBlock(6, dtype=D64),
                 lambda: tops.ResidualBlock(6),
                 [(r'b/ConvBlock_(\d)/Conv_0', r'b.\1.0'),
                  (r'b/ConvBlock_(\d)/Norm_0' + BN, r'b.\1.1')],
                 [(2, 7, 6, 6)], True, F64),
    'conv_upsampling': (lambda: jops.ConvUpsampling(4, dtype=D64),
                        lambda: tops.ConvUpsampling(6, 4),
                        [('b/ConvBlock_0/Conv_0', 'b.conv')], [(2, 5, 7, 6)], True, F32_POOL),
    'conv_upsampling_half_pixel': (
        lambda: jops.ConvUpsampling(4, 4, 1, align_corners=False, dtype=D64),
        lambda: tops.ConvUpsampling(6, 4, 4, 1, align_corners=False),
        [('b/ConvBlock_0/Conv_0', 'b.conv')], [(2, 5, 7, 6)], True, F32_POOL),
    'conv_upsampling_nearest': (lambda: jops.ConvUpsampling(4, method='nearest', dtype=D64),
                                lambda: tops.ConvUpsampling(6, 4, method='nearest'),
                                [('b/ConvBlock_0/Conv_0', 'b.conv')], [(2, 5, 7, 6)],
                                True, F64),
}


def _flat_grads(tree):
    return {k: np.asarray(v) for k, v in twio.flatten_params(tree).items()}


@pytest.mark.parametrize('case,train', [(c, t) for c in sorted(BLOCKS)
                                         for t in ((False, True) if BLOCKS[c][4] else (False,))])
def test_blocks_match_jax(case, train):
    """Each block in float64 on seeded weights: the output, the running
    statistics after a train forward, and the gradients of every
    parameter and of the input for a seeded cotangent, against
    ``jax.vjp``; the tolerance is the case's (module docstring)."""
    make_j, make_t, rules, shapes, takes_train, tol = BLOCKS[case]
    xs = [_x(s, seed=i) for i, s in enumerate(shapes)]
    kw = {'train': train} if takes_train else {}
    with jax.enable_x64(True):
        jm = make_j()
        v = _seeded(jm, *[jnp.asarray(a) for a in xs], **kw)

        def f(params, *a):
            out = jm.apply({**v, 'params': params}, *a, mutable=['batch_stats'], **kw)
            return out[0], out[1]

        want, dwant, mut, g = jax_vjp(f, v['params'], *[jnp.asarray(a) for a in xs],
                                      has_aux=True)
    tm = make_t().double()
    tm.load_state_dict(_port_state(v, rules), strict=True)
    txs = [_nchw(a).requires_grad_() for a in xs]
    got = tm(*txs, **kw)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(got, list(params.values()) + txs, _nchw(g))
    close(_nhwc(got), want, tol)
    jgrads = _port_state({'params': dwant[0]}, rules)
    for (name, _), d in zip(params.items(), grads):
        close(d.numpy(), jgrads[name].numpy(), tol)
    for d, w in zip(grads[len(params):], dwant[1:]):
        close(_nhwc(d), w, tol)
    moved = _port_state(mut, rules) if mut else {}
    sd = tm.state_dict()
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), tol)


def test_channel_reduction_matches_jax():
    """``ChannelReduction`` over a list of three widths, train mode, float64:
    each projection and its running statistics (1e-12)."""
    shapes = [(2, 8, 8, 3), (2, 4, 4, 5), (2, 2, 2, 7)]
    xs = [_x(s, seed=i) for i, s in enumerate(shapes)]
    rules = [(r'b/reduce(\d)/Conv_0', r'b.reduce\1.0'), (r'b/reduce(\d)/Norm_0' + BN,
                                                          r'b.reduce\1.1')]
    with jax.enable_x64(True):
        jm = jops.ChannelReduction(4, dtype=D64)
        v = _seeded(jm, [jnp.asarray(a) for a in xs], train=True)
        want, mut = jm.apply(v, [jnp.asarray(a) for a in xs], train=True,
                             mutable=['batch_stats'])
    tm = tops.ChannelReduction([3, 5, 7], 4).double()
    tm.load_state_dict(_port_state(v, rules), strict=True)
    got = tm([_nchw(a) for a in xs], train=True)
    for g, w in zip(got, want):
        close(_nhwc(g), w, F64)
    sd = tm.state_dict()
    for k, w in _port_state(mut, rules).items():
        close(sd[k].numpy(), w.numpy(), F64)


LIST_MODULES = {
    'concat': (lambda: jops.ChannelConcat(), lambda: tops.ChannelConcat()),
    'sum': (lambda: jops.Sum(), lambda: tops.Sum()),
    'index_one': (lambda: jops.ListIndex((1,)), lambda: tops.ListIndex((1,))),
    'index_two': (lambda: jops.ListIndex((2, 0)), lambda: tops.ListIndex((2, 0))),
}


@pytest.mark.parametrize('case', sorted(LIST_MODULES))
def test_list_modules_match_jax(case):
    """The module spellings on a list of three NCHW tensors against the JAX
    modules on NHWC: the same values (exact: no arithmetic, or one sum in
    the same order)."""
    make_j, make_t = LIST_MODULES[case]
    xs = [_x((2, 4, 5, 3), seed=i).astype(np.float32) for i in range(3)]
    want = make_j().apply({}, [jnp.asarray(a) for a in xs])
    got = make_t()([_nchw(a) for a in xs])
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_nhwc(g), np.asarray(w))


def test_squeeze_matches_jax():
    x = _x((2, 1, 5, 1)).astype(np.float32)
    for dim in (1, -1):
        want = jops.Squeeze(dim).apply({}, jnp.asarray(x))
        np.testing.assert_array_equal(tops.Squeeze(dim)(torch.from_numpy(x)).numpy(),
                                      np.asarray(want))


def test_bf16compatible_runs_the_inner_module_in_float32():
    """``Bf16compatible(ConvBlock)`` on bfloat16 input: a bfloat16 output that
    is the float32 run rounded once (exactly, in the port), within one
    bfloat16 rounding step (2⁻⁸ of the scale) of the JAX package's, whose
    float32 sums run in another order; float32 input passes through as it
    is."""
    x = _x((2, 6, 5, 4)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm = jops.Bf16compatible(jops.ConvBlock(3, 3))
    v = _seeded(jops.ConvBlock(3, 3), jnp.asarray(x))
    v = jax.tree.map(lambda a: a.astype(np.float32), v)
    want = jm.apply({'params': {'inner': v['params']},
                     'batch_stats': {'inner': v['batch_stats']}}, xb)
    inner = tops.ConvBlock(4, 3, 3)
    inner.load_state_dict(_port_state(v, [('b/Conv_0', 'b.0'), ('b/Norm_0' + BN, 'b.1')]))
    tm = tops.Bf16compatible(inner)
    tx = _nchw(x).bfloat16()
    got = tm(tx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, inner(tx.float()).bfloat16())
    assert torch.equal(tm(_nchw(x)), inner(_nchw(x)))
    close(_nhwc(got.float()), np.asarray(want.astype(jnp.float32)), 2.0 ** -8)


def test_registered_blocks_build_through_the_op_registry():
    """The heads' blocks are in ``registry.OP`` under the JAX names."""
    from ever_tpu.core import registry as jregistry
    from ever_tpu_torch.core import registry as tregistry
    import ever_tpu.module  # noqa: F401
    import ever_tpu_torch.module  # noqa: F401
    for name in ('AtrousSpatialPyramidPool', 'PyramidPoolModule', 'Deeplabv3pDecoder',
                 'SimpleFusion'):
        assert name in jregistry.OP and name in tregistry.OP
        assert tregistry.OP[name].__name__ == name
