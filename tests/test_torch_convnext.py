"""ConvNeXt in the port against the JAX package, on the CPU.

The trunk cut to ``convnext_test`` (depths (1, 1, 2, 1), widths (16, 32,
48, 64)), a test-local entry patched into both packages'
``CONVNEXT_SPECS``: every kind of layer stays (the 4×4/4 stem and its
LayerNorm, the LayerNorm-2×2/2 downsamples, the blocks' depthwise 7×7,
LayerNorm, the tanh-GELU MLP and the layer scale).  In float64 from the
same seeded weights in both packages (the layer scale drawn at O(1), not
1e-6, so the blocks' branches count), B=2 at 64² and at 72² (the stem
divides 72 but 18 → 9 → 5 → 3 pad as lax's ``'SAME'``, the odd pixel
after): the four features and the gradient of every parameter and of the
input for a seeded cotangent on each feature; the JAX side under
``jax.jit``.  Drop-path is held on its own, as the two packages draw
other masks; ``out_channels()`` is a method, as in the JAX package.
Tolerance 1e-10 of the scale: both compute in float64 throughout.
"""

import jax
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.module import convnext as jcnx
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.module import convnext as tcnx
from ever_tpu_torch.util.weight_io import convert_flax_convnext
from test_torch_efficientnet import compare, jax_train_grads, port_train_grads
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64 = 1e-10
TEST_SPEC = ('convnext_test', ((1, 1, 2, 1), (16, 32, 48, 64)))


@pytest.fixture(scope='module', autouse=True)
def test_spec():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcnx, tcnx):
            mp.setitem(mod.CONVNEXT_SPECS, *TEST_SPEC)
        yield


def _big_gamma(v):
    rng = np.random.default_rng(5)

    def draw(path, a):
        return rng.uniform(0.5, 1.5, a.shape) if "['gamma']" in jax.tree_util.keystr(path) else a
    return jax.tree_util.tree_map_with_path(draw, v)


@pytest.mark.parametrize('size', [64, 72])
def test_convnext_matches_jax(size):
    cfg = dict(convnext_type='convnext_test')
    x = _x((2, size, size, 3), seed=size)
    ref = jax_train_grads(jcnx.ConvNeXtEncoder(dict(cfg, dtype='float64')), x, fix=_big_gamma)
    tm = tcnx.ConvNeXtEncoder(dict(cfg, dtype='float64')).double()
    tm.load_state_dict(convert_flax_convnext(ref['v']), strict=True)
    outs, xs = port_train_grads(tm, x, ref['gs'])
    sides = [size // 4]
    for _ in range(3):
        sides.append(-(-sides[-1] // 2))
    assert [tuple(o.shape[1:]) for o in outs] == [
        (c, s, s) for c, s in zip(tm.out_channels(), sides)]
    compare(tm, ref, lambda p, bs=None: convert_flax_convnext(p), outs, xs, F64)


def test_drop_path_schedule_and_draws():
    """The rate rises linearly over the blocks, ``rate·i/(n − 1)`` (the
    first block never drops); in training a block drops its branch for
    whole samples, each kept with probability 1 − p (the keep share of 4000
    samples within 4.5 binomial standard deviations) and scaled by
    1/(1 − p), from the generator; evaluation draws nothing."""
    net = tcnx.ConvNeXt('convnext_tiny', drop_path_rate=0.1)
    rates = [b.drop_path_rate for s in net.stages for b in s]
    assert rates == [0.1 * i / 17 for i in range(18)]
    blk = tcnx.ConvNeXtBlock(8, layerscale_init=1.0, drop_path_rate=0.4).double()
    x = torch.randn(4000, 8, 3, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match='generator'):
        blk(x, train=True)
    with torch.no_grad():
        plain = blk(x, train=False) - x
        dropped = blk(x, train=True, generator=torch.Generator().manual_seed(3)) - x
        again = blk(x, train=True, generator=torch.Generator().manual_seed(3)) - x
    kept = dropped.flatten(1).abs().amax(1) > 0
    p = 0.4
    assert abs(kept.double().mean().item() - (1 - p)) < 4.5 * (p * (1 - p) / 4000) ** 0.5
    np.testing.assert_allclose(dropped[kept].numpy(), (plain[kept] / (1 - p)).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(dropped[~kept], torch.zeros_like(dropped[~kept]))
    assert torch.equal(dropped, again)


def test_out_channels_and_registry():
    for name in ('convnext_tiny', 'convnext_small', 'convnext_base', 'convnext_large'):
        cfg = dict(convnext_type=name)
        assert tcnx.ConvNeXtEncoder(cfg).out_channels() == jcnx.ConvNeXtEncoder(cfg).out_channels()
        assert isinstance(tregistry.MODEL[name](), tcnx.ConvNeXt)
    assert tregistry.MODEL['ConvNeXtEncoder'] is tcnx.ConvNeXtEncoder
    blk = tcnx.ConvNeXt('convnext_tiny').stages[0][0]
    assert torch.equal(blk.gamma, torch.full((96,), 1e-6))
    assert set(n.split('.')[0] for n, _ in blk.named_parameters()) == {
        'dwconv', 'norm', 'pwconv1', 'pwconv2', 'gamma'}
