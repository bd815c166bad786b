"""EfficientNet in the port against the JAX package, on the CPU.

``MBConv`` (expand 1 and 6, stride 1 and 2, kernels 3 and 5, dilated, at
an odd size) and the B0 trunk at 64² (at 72², a size that 32 does not
divide, in ``test_torch_efficientnet_odd.py``), in float64 from the same
seeded weights in both
packages, in a train-mode forward: the five taps, every BatchNorm's
running statistics after it and the gradient of every parameter and of
the input for a seeded cotangent on each tap; the JAX side under
``jax.jit``.  Then ``nostride_dilate``; ``out_channels``, ``_round_filters`` and the stages'
block counts for b0-b7; drop-connect's draws.

Drop-connect is on by default in both packages, and the two draw other
masks: the parity runs set every rate to 0 on both sides (a test-local
subclass of the JAX trunk, the port's blocks' ``drop_connect_rate``);
drop-connect itself is held on its own (whole samples, the keep share
within binomial bounds, the 1/(1 − p) scale, the rate schedule).

Tolerances: 1e-10 of the scale where both sides compute in float64 to that
point; 1e-6 for what lies after a squeeze-excitation, whose global pool
accumulates in float32 in both packages whatever the input
(``ever_tpu/module/ops.py`` ``global_avg_pool``): both round there, in
other summation orders, about 6e-8 relative a pool.  Every tap of a trunk
lies after one, and so does every gradient; through B0's 16 blocks the
roundings add up (the os32 tap measured 1.3e-6, the worst gradient 4e-6),
so the trunk is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.module import efficientnet as jeff
from ever_tpu_torch.module import efficientnet as teff
from ever_tpu_torch.util.weight_io import convert_flax_efficientnet
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _nchw, _nhwc, _seeded, _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64, AFTER_POOL, TRUNK = 1e-10, 1e-6, 1e-5


class _NoDropEfficientNet(jeff.EfficientNet):
    drop_connect_rate: float = 0.0


@pytest.fixture
def no_drop_connect(monkeypatch):
    """The JAX ``EFNetEncoder`` builds its trunk without drop-connect."""
    monkeypatch.setattr(jeff, 'EfficientNet', _NoDropEfficientNet)


def _flat(tree):
    return tree if isinstance(tree, (list, tuple)) else [tree]


def jax_train_grads(jm, x, seed=0, fix=None, grads=True, x64=True):
    """The JAX module's train forward on ``x`` (an array or a list) in
    float64 (float32 without ``x64``) from seeded variables (``fix`` edits
    them), under ``jax.jit``:
    the variables, the outputs, the new batch statistics, and the gradients
    of Σ output · cotangent for the params and ``x`` with the cotangents
    (seeded, one per output)."""
    with jax.enable_x64(x64):
        x = jax.tree_util.tree_map(jnp.asarray, x)
        v = _seeded(jm, x, seed=seed)
        if fix is not None:
            v = fix(v)
        shapes = jax.eval_shape(
            lambda: jm.apply(v, x, train=True, mutable=['batch_stats'])[0])
        gs = [_x(s.shape, seed=50 + i) for i, s in enumerate(_flat(shapes))]

        def loss(params, x):
            outs, mut = jm.apply({**v, 'params': params}, x, train=True,
                                 mutable=['batch_stats'])
            return sum((o * g).sum() for o, g in zip(_flat(outs), gs)), (outs, mut)

        if grads:
            (_, (outs, mut)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(v['params'], x)
        else:
            (_, (outs, mut)), gp, gx = jax.jit(loss)(v['params'], x), None, None
    return dict(v=v, outs=[np.asarray(o) for o in _flat(outs)],
                stats=mut.get('batch_stats', {}), gp=gp,
                gx=None if gx is None else [np.asarray(g) for g in _flat(gx)], gs=gs)


def port_train_grads(tm, x, gs, nhwc_in=True):
    """The port's train forward on ``x`` (NHWC for an encoder, else NCHW
    arrays) with the cotangents' Σ output · cotangent backpropagated:
    (outputs, input tensors)."""
    xs = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() if nhwc_in
          else _nchw(a).requires_grad_() for a in _flat(x)]
    outs = tm(xs if isinstance(x, (list, tuple)) else xs[0], train=True)
    sum((o * _nchw(g)).sum() for o, g in zip(_flat(outs), gs)).backward()
    return _flat(outs), xs


def compare(tm, ref, convert, outs, xs, tol, stat_tol=None, grad_tol=None, nhwc_in=True):
    """Outputs, running statistics, parameter and input gradients of the
    port against the JAX reference, each to its tolerance of the scale."""
    stat_tol = tol if stat_tol is None else stat_tol
    grad_tol = tol if grad_tol is None else grad_tol
    assert len(outs) == len(ref['outs'])
    for got, want in zip(outs, ref['outs']):
        close(_nhwc(got), want, tol)
    sd = tm.state_dict()
    moved = convert({}, ref['stats']) if ref['stats'] else {}
    assert len(moved) == 2 * sum(hasattr(m, 'running_mean') for m in tm.modules())
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), stat_tol)
    if ref['gp'] is None:
        return
    want = convert(ref['gp'])
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for k, p in named.items():
        close(p.grad.numpy(), want[k].numpy(), grad_tol)
    for t, w in zip(xs, ref['gx']):
        close(t.grad.permute(0, 2, 3, 1).numpy() if not nhwc_in else t.grad.numpy(), w,
              grad_tol)


# -- MBConv -----------------------------------------------------------------------

# (in_channels, features, expand, kernel, stride, dilation, size)
MBCONV = {
    'expand1_residual': (16, 16, 1, 3, 1, 1, 12),
    'expand6_stride2': (8, 12, 6, 3, 2, 1, 12),
    'expand6_k5_residual': (8, 8, 6, 5, 1, 1, 10),
    'dilated_k3': (8, 8, 6, 3, 1, 2, 10),
    'stride2_k5_odd': (8, 16, 6, 5, 2, 1, 11),
}


@pytest.mark.parametrize('case', sorted(MBCONV))
def test_mbconv_matches_jax(case):
    """One block in a train forward, float64: the output, the running
    statistics of its three BatchNorms and the gradients of every
    parameter and of the input."""
    cin, feat, expand, k, s, d, size = MBCONV[case]
    x = _x((2, size, size, cin), seed=3)
    ref = jax_train_grads(jeff.MBConv(feat, expand, k, s, d, dtype=jnp.float64), x)
    tm = teff.MBConv(cin, feat, expand, k, s, d).double()

    def convert(params, batch_stats=None):
        """The block's tree as B0's first block, under the port's names."""
        sd = convert_flax_efficientnet(
            {'stage0_block0': params},
            None if batch_stats is None else {'stage0_block0': batch_stats}, 'efficientnet-b0')
        return {k[len('_blocks.0.'):]: v for k, v in sd.items()}

    tm.load_state_dict(convert(ref['v']['params'], ref['v']['batch_stats']), strict=True)
    outs, xs = port_train_grads(tm, x, ref['gs'], nhwc_in=False)
    assert tm.residual == (s == 1 and cin == feat)
    sd = tm.state_dict()
    moved = convert({}, ref['stats'])
    assert len(moved) == 2 * (3 if expand != 1 else 2)
    for k, w in moved.items():
        # the expand and depthwise BatchNorms come before the SE pool
        close(sd[k].numpy(), w.numpy(), AFTER_POOL if k.startswith('_bn2') else F64)
    close(_nhwc(outs[0]), ref['outs'][0], AFTER_POOL)
    want = convert(ref['gp'])
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for k, p in named.items():
        close(p.grad.numpy(), want[k].numpy(), AFTER_POOL)
    close(_nhwc(xs[0].grad), ref['gx'][0], AFTER_POOL)


# -- the trunk ----------------------------------------------------------------------

def _port_encoder(cfg, v, dtype=torch.float64):
    tm = teff.EFNetEncoder(dict(cfg, dtype=str(dtype).split('.')[1])).to(dtype)
    for blk in tm.net._blocks:
        blk.drop_connect_rate = 0.0
    tm.load_state_dict(convert_flax_efficientnet(v['params'], v['batch_stats']), strict=True)
    return tm


@pytest.mark.usefixtures('no_drop_connect')
@pytest.mark.parametrize('size', [64])
def test_b0_taps_statistics_and_gradients_match_jax(size):
    """B0 (16 blocks) at B=2: the five taps (16, 24, 40, 112, 320 wide at
    output strides 2-32; at 72² the SAME padding makes them 36, 18, 9, 5
    and 3 wide), the 49 BatchNorms' statistics and every gradient."""
    x = _x((2, size, size, 3), seed=size)
    cfg = dict(efficientnet_type='efficientnet-b0')
    ref = jax_train_grads(jeff.EFNetEncoder(dict(cfg, dtype='float64')), x)
    tm = _port_encoder(cfg, ref['v'])
    outs, xs = port_train_grads(tm, x, ref['gs'])
    n = -(-size // 2)
    sides = [n]
    for _ in range(4):
        sides.append(-(-sides[-1] // 2))
    assert [tuple(o.shape[1:]) for o in outs] == [
        (c, s, s) for c, s in zip(tm.out_channels, sides)]
    compare(tm, ref, convert_flax_efficientnet, outs, xs, TRUNK)


def test_nostride_dilate_reconfigures_as_jax():
    for dilate, os_ in ((2, 16), (4, 8), (8, 8)):
        jm = jeff.nostride_dilate(jeff.EFNetEncoder(dict(ef_name='efficientnet-b1')), dilate)
        tm = teff.nostride_dilate(teff.EFNetEncoder(dict(ef_name='efficientnet-b1')), dilate)
        assert tm.config.to_dict() == jm.config.to_dict()
        assert tm.config.output_stride == os_ and tm.net.model_name == 'efficientnet-b1'


@pytest.mark.parametrize('name', sorted(jeff.EFFICIENTNET_SPECS))
def test_widths_and_depths_match_jax(name):
    """``out_channels`` (``ef_name`` winning over ``efficientnet_type``),
    ``_round_filters`` and the stages' block counts, and the built trunk's
    tap widths equal to ``out_channels``."""
    wm, _ = jeff.EFFICIENTNET_SPECS[name]
    assert teff.EFFICIENTNET_SPECS[name] == jeff.EFFICIENTNET_SPECS[name]
    for c in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert teff._round_filters(c, wm) == jeff._round_filters(c, wm)
    assert list(teff.stage_repeats(name)) == list(jeff.stage_repeats(name))
    cfg = dict(efficientnet_type='efficientnet-b0', ef_name=name)
    jm, tm = jeff.EFNetEncoder(cfg), teff.EFNetEncoder(cfg)
    assert tuple(tm.out_channels) == tuple(jm.out_channels)
    net = tm.net
    widths = [net._bn0.weight.numel() if i == 0 else net._blocks[i - 1]._bn2.weight.numel()
              for i in net.tap_before] + [net._blocks[-1]._bn2.weight.numel()]
    assert tuple(widths) == tuple(tm.out_channels)
    assert len(net._blocks) == sum(jeff.stage_repeats(name))


def test_drop_connect_draws_whole_samples_at_its_rate():
    """Drop-connect on its own: block i of n drops at 0.2·i/n (block 0
    never); in training a residual block keeps or drops its whole branch
    per sample, each kept with probability 1 − p (the keep share of 4000
    samples within 4.5 binomial standard deviations) and scaled by
    1/(1 − p); the draws come from the generator (the same seed, the
    same samples); evaluation and rate 0 draw nothing."""
    net = teff.EfficientNet('efficientnet-b0')
    rates = [b.drop_connect_rate for b in net._blocks]
    assert rates == [0.2 * i / 16 for i in range(16)] and rates[0] == 0.0
    torch.manual_seed(0)
    blk = teff.MBConv(8, 8, 6, 3, drop_connect_rate=0.3).double()
    x = torch.randn(4000, 8, 3, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match='generator'):
        blk(x, train=True)
    with torch.no_grad():
        blk.drop_connect_rate = 0.0
        plain = blk(x, train=True) - x
        blk.drop_connect_rate = 0.3
        dropped = blk(x, train=True, generator=torch.Generator().manual_seed(5)) - x
        again = blk(x, train=True, generator=torch.Generator().manual_seed(5)) - x
        assert torch.equal(blk(x, train=False), blk(x, train=False, generator=None))
    kept = dropped.flatten(1).abs().amax(1) > 0
    p = 0.3
    share, sd = kept.double().mean().item(), (p * (1 - p) / 4000) ** 0.5
    assert abs(share - (1 - p)) < 4.5 * sd
    np.testing.assert_allclose(dropped[kept].numpy(), (plain[kept] / (1 - p)).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(dropped[~kept], torch.zeros_like(dropped[~kept]))
    assert torch.equal(dropped, again)
