"""DenseNet and ResNeSt in the port against the JAX package, on the CPU.

Both trunks at cut depth, from test-local spec entries patched into both
packages' spec dicts: ``densenet_tiny`` (growth 8, blocks (2, 2, 2, 2), 16
initial maps) and ``resnest_tiny`` (one block a stage; its stem is 64
wide, as every ResNeSt's but ``resnest50``'s).  Every kind of layer stays:
the stem and its max pool, the dense layers' concatenations and the
transitions' average pools; the split-attention convs at radix 1 (a
sigmoid gate) and 2 (a softmax over the radix), the avd pools (a stage's
stride, and stride 1 in a dilated first block at output stride 8) and the
average-pool shortcuts.  Each in float64 from the same seeded weights in
both packages, B=2 at 64², in a train-mode forward: the four features,
every BatchNorm's running statistics and the gradient of every parameter
and of the input for a seeded cotangent on each feature; the JAX side
under ``jax.jit``.  The published widths' names and shapes are held by
``tests/test_torch_weights.py``.  Then ``memory_efficient`` against the
plain DenseNet, and each encoder's ``out_channels`` spelling.

Tolerances: DenseNet 1e-10 of the scale (float64 throughout).  ResNeSt's
split attention pools in float32 in both packages whatever the input
(``ever_tpu/module/ops.py`` ``global_avg_pool``), both rounding there
(about 6e-8 relative) in other summation orders, and every feature and
gradient lies after one.  The train-mode BatchNorm over the attention's
[2, C, 1, 1] input (two samples a channel) scales those roundings up: at
B=2 the features measured 1.5e-5 of their scale and the gradients 3e-4.
So each case runs twice: with the pools as they are, the features (5e-5)
and running statistics (1e-6) of a train forward; and with both
packages' pool taken in float64 (the test patches the module-level
``global_avg_pool`` of each ``resnest`` module), the features and
statistics to 1e-10 and every gradient to 2e-9: ``fc1``'s bias feeds a
train-mode BatchNorm, so its true gradient is 0 and both packages' are
rounding noise (up to 6.4e-10; every other gradient measured 4e-11).
"""

import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.module import densenet as jdense
from ever_tpu.module import resnest as jrest
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.module import _densenet as tshim
from ever_tpu_torch.module import densenet as tdense
from ever_tpu_torch.module import resnest as trest
from ever_tpu_torch.util.weight_io import convert_flax_densenet, convert_flax_resnest
from test_torch_efficientnet import compare, jax_train_grads, port_train_grads
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64, F32_POOL_FEATURES, F32_POOL_STATS, F64_GRADS = 1e-10, 5e-5, 1e-6, 2e-9
DENSE_TINY = ('densenet_tiny', (8, (2, 2, 2, 2), 16))
RESNEST_TINY = ('resnest_tiny', (1, 1, 1, 1))


@pytest.fixture(scope='module', autouse=True)
def tiny_specs():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdense, tdense):
            mp.setitem(mod.DENSENET_SPECS, *DENSE_TINY)
        for mod in (jrest, trest):
            mp.setitem(mod.RESNEST_SPECS, *RESNEST_TINY)
        yield


def _port(cls, cfg, convert, v):
    tm = cls(dict(cfg, dtype='float64')).double()
    tm.load_state_dict(convert(v['params'], v['batch_stats']), strict=True)
    return tm


def test_densenet_matches_jax():
    cfg = dict(densenet_type='densenet_tiny')
    x = _x((2, 64, 64, 3), seed=1)
    ref = jax_train_grads(jdense.DenseNetEncoder(dict(cfg, dtype='float64')), x)
    tm = _port(tdense.DenseNetEncoder, cfg, convert_flax_densenet, ref['v'])
    outs, xs = port_train_grads(tm, x, ref['gs'])
    assert [tuple(o.shape[1:]) for o in outs] == [
        (c, s, s) for c, s in zip(tm.out_channels(), (16, 8, 4, 2))]
    assert tm.out_channels() == (32, 32, 32, 32)
    compare(tm, ref, convert_flax_densenet, outs, xs, F64)


def test_densenet_memory_efficient_equals_the_plain_run():
    """``memory_efficient`` recomputes each dense layer in the backward:
    the features, gradients and running statistics are the plain run's
    bits, the statistics moved once."""
    torch.manual_seed(0)
    runs = []
    x = torch.from_numpy(_x((2, 64, 64, 3), seed=2))
    init = None
    for me in (False, True):
        tm = tdense.DenseNetEncoder(dict(densenet_type='densenet_tiny', memory_efficient=me,
                                         dtype='float64')).double()
        if init is None:
            init = {k: v.clone() for k, v in tm.state_dict().items()}
        tm.load_state_dict(init)
        feats = tm(x, train=True)
        sum((f * (i + 1)).sum() for i, f in enumerate(feats)).backward()
        runs.append(([f.detach() for f in feats], {n: p.grad for n, p in tm.named_parameters()},
                     {k: v.clone() for k, v in tm.state_dict().items()}))
    (fa, ga, sa), (fb, gb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(fa, fb))
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['densenet.features.norm0.running_mean'],
                           init['densenet.features.norm0.running_mean'])


def _f64_pool(x, keepdims=True):
    """The spatial mean of an NHWC array in its own type (float64 here)."""
    return x.mean(axis=(1, 2), keepdims=keepdims) if isinstance(x, np.ndarray) or not hasattr(
        x, 'dim') else x.mean(dim=(1, 2), keepdim=keepdims)


@pytest.mark.parametrize('radix,output_stride', [(2, 32), (1, 8)])
def test_resnest_matches_jax(radix, output_stride, monkeypatch):
    cfg = dict(resnest_type='resnest_tiny', radix=radix, output_stride=output_stride)
    x = _x((2, 64, 64, 3), seed=radix + output_stride)
    jm = jrest.ResNeStEncoder(dict(cfg, dtype='float64'))
    ref = jax_train_grads(jm, x, grads=False)
    tm = _port(trest.ResNeStEncoder, cfg, convert_flax_resnest, ref['v'])
    with torch.no_grad():
        outs = tm(torch.from_numpy(x), train=True)
    sides = (16, 8, 4, 2) if output_stride == 32 else (16, 8, 8, 8)
    assert [tuple(o.shape[1:]) for o in outs] == [
        (c, s, s) for c, s in zip(tm.out_channels, sides)]
    compare(tm, ref, convert_flax_resnest, outs, [], F32_POOL_FEATURES, F32_POOL_STATS)
    sd = tm.state_dict()
    for k, w in convert_flax_resnest({}, ref['stats']).items():
        if k.startswith(('net.conv1.', 'net.bn1.')):
            close(sd[k].numpy(), w.numpy(), F64)

    monkeypatch.setattr(jrest, 'global_avg_pool', _f64_pool)
    monkeypatch.setattr(trest, 'global_avg_pool', _f64_pool)
    ref = jax_train_grads(jm, x)
    tm = _port(trest.ResNeStEncoder, cfg, convert_flax_resnest, ref['v'])
    outs, xs = port_train_grads(tm, x, ref['gs'])
    compare(tm, ref, convert_flax_resnest, outs, xs, F64, grad_tol=F64_GRADS)
    avd = [(i, b.stride, b.avd) for i in range(1, 5) for b in getattr(tm.net, f'layer{i}')]
    assert [a for _, _, a in avd] == [False, True, True, True]
    assert tm.net.layer1[0].conv2.radix == radix
    if output_stride == 8:
        assert [s for _, s, _ in avd] == [1, 2, 1, 1]
        assert tm.net.layer4[0].conv2.conv.dilation == (2, 2)


def test_out_channels_spellings_and_names():
    """``DenseNetEncoder.out_channels()`` a method (also registered as
    ``densenet_encoder``), ``ResNeStEncoder.out_channels`` a property with
    ``name`` winning over ``resnest_type``, as in the JAX package; the
    registry names, the shim's factories and ``CollectibleSequential``."""
    for name in ('densenet121', 'densenet161', 'densenet169', 'densenet201'):
        cfg = dict(densenet_type=name)
        assert tdense.DenseNetEncoder(cfg).out_channels() == \
            jdense.DenseNetEncoder(cfg).out_channels()
    assert tdense.DenseNetEncoder({}).out_channels() == (256, 512, 1024, 1024)
    assert tregistry.MODEL['densenet_encoder'] is tdense.DenseNetEncoder
    enc = tbuilder.make_model({'type': 'ResNeStEncoder', 'params': dict(
        resnest_type='resnest101', name='resnest50')}, device='cpu')
    assert enc.out_channels == jrest.ResNeStEncoder({}).out_channels == [256, 512, 1024, 2048]
    assert enc.net.conv1[0].out_channels == 32          # resnest50's stem width
    assert trest.ResNeSt('resnest101').conv1[0].out_channels == 64
    assert isinstance(tregistry.MODEL['resnest200'](), trest.ResNeSt)
    assert isinstance(tshim.densenet169(pretrained=True), tdense.DenseNet)
    seq = tshim.CollectibleSequential(torch.nn.Identity(), torch.nn.ReLU())
    out = seq(torch.tensor([-1.0, 2.0]))
    assert [o.tolist() for o in out] == [[-1.0, 2.0], [0.0, 2.0]]
