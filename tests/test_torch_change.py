"""The change detectors in the port against the JAX package, on the CPU:
``split_bitemporal``, ``ChangeMixin`` (``order_stacked`` either way) and
ChangeStar in eval and one step (its other label forms:
``tests/test_torch_changestar_labels.py``; ChangeMask:
``tests/test_torch_change_decoders.py``; ChangeOS:
``tests/test_torch_changeos.py``).

Narrow models (the ResNet-18 trunk with one block a stage of
``tests/test_torch_factseg.py``, FPN and decoders 16 wide, ChangeMixin 8
wide) over bi-temporal pairs of 64², batch 2, weights seeded in the JAX
tree and carried over by ``convert_flax_change``, inputs and labels from
numpy with a seed.  Eval runs in float32 (outputs within 1e-5); the
losses and one SGD step run in float64 in both packages, for the reason
``tests/test_torch_factseg.py`` gives (losses within rtol 1e-6, every
parameter and running statistic within 1e-6 after the step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module.change import ChangeMixin as JaxChangeMixin
from ever_tpu.module.change import split_bitemporal as jax_split
from ever_tpu_torch.module.change import ChangeMixin, split_bitemporal
from ever_tpu_torch.util.weight_io import convert_flax_change
from test_torch_factseg import both, one_step_matches, small_cpu_models  # noqa: F401
from test_torch_resnet import seeded_variables

TRUNK = dict(encoder=dict(resnet_type='resnet_basic_tiny'),
             fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=16),
             decoder=dict(in_channels=16, out_channels=16))
STAR = dict(TRUNK, changemixin=dict(inner_channels=8))


def pairs(n=2, size=64, seed=5):
    """Seeded ``[n, size, size, 6]`` pairs and every label the detectors
    take, each with some ignored pixels."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 6))

    def labels(high, shape=(n, size, size)):
        y = rng.integers(0, high, size=shape).astype(np.int32)
        y[:, 0, :5] = 255
        return y

    return x, dict(masks=labels(2, (n, size, size, 2)), change=labels(2),
                   classes=labels(3, (n, size, size, 2)), loc=labels(2), damage=labels(4))


def eval_matches(model_type, cfg, x):
    """The eval outputs of both packages in float32, within 1e-5."""
    jm, tm, v = both(model_type, cfg, x, convert_flax_change)
    x = x.astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and float(np.std(w)) > 1e-3
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    return got


def train_losses(jm, tm, v, x, forms):
    """The train-mode losses of each label form in ``forms`` through both
    packages in float64."""
    run = jax.jit(lambda v, y: jm.apply(v, jnp.asarray(x), y, train=True,
                                        mutable=['batch_stats'])[0])
    want = [run(v, jax.tree.map(jnp.asarray, y)) for y in forms]
    got = []
    for y in forms:
        with torch.no_grad():
            got.append(tm(torch.from_numpy(x), jax.tree.map(torch.from_numpy, y), train=True))
    return got, want


def test_split_bitemporal_matches_jax():
    x = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)
    for a, b in zip(split_bitemporal(torch.from_numpy(x)), jax_split(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pair = (torch.zeros(1), torch.ones(1))
    assert split_bitemporal(pair) == pair and split_bitemporal(list(pair)) == pair


@pytest.mark.parametrize('order_stacked', [True, False])
def test_changemixin_matches_jax(order_stacked):
    """``ChangeMixin`` against the JAX module built each way (the
    order-stacked conv0 has the plain conv0's parameters): float32
    logits in eval and in train mode within 1e-5, and the running
    statistics after the train forward within 1e-6."""
    rng = np.random.default_rng(1)
    f1, f2 = (rng.normal(size=(2, 12, 10, 16)).astype(np.float32) for _ in range(2))
    jmod = JaxChangeMixin(inner_channels=8, num_convs=3, scale_factor=2.0,
                          order_stacked=order_stacked)
    v = seeded_variables(jmod, f1, f2=jnp.asarray(f2))
    tmod = ChangeMixin(16, inner_channels=8, num_convs=3, scale_factor=2.0,
                       order_stacked=order_stacked)
    sd = convert_flax_change({'params': {'changemixin': v['params']},
                              'batch_stats': {'changemixin': v['batch_stats']}})
    tmod.load_state_dict({k[len('changemixin.'):]: t for k, t in sd.items()}, strict=True)
    t1, t2 = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in (f1, f2))
    want = jmod.apply(v, jnp.asarray(f1), jnp.asarray(f2))
    (jt1, jt2), mut = jmod.apply(v, jnp.asarray(f1), jnp.asarray(f2), train=True,
                                 mutable=['batch_stats'])
    with torch.no_grad():
        got = tmod(t1, t2)
        got_train = tmod(t1, t2, train=True)
    for g, w in zip(got + got_train, tuple(want) + (jt1, jt2)):
        assert g.shape == (2, 24, 20, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    moved = convert_flax_change({'batch_stats': {'changemixin': mut['batch_stats']}})
    for k, w in moved.items():
        np.testing.assert_allclose(tmod.state_dict()[k[len('changemixin.'):]].numpy(),
                                   w.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_changestar_eval_matches_jax():
    """Eval mode, float32: ChangeStar's (σ(s1), σ(s2), ½(σ(c12) + σ(c21)))."""
    x, _ = pairs()
    eval_matches('ChangeStar', STAR, x)


def test_changestar_one_step_matches_jax():
    """Dict labels with 4-D masks: seg_loss and the symmetric change_loss,
    then one SGD step (parameters and running statistics)."""
    x, y = pairs()
    with jax.enable_x64(True):
        jm, tm, v = both('ChangeStar', STAR, x, convert_flax_change, dtype='float64')
        one_step_matches(jm, tm, v, (x, dict(masks=y['masks'], change=y['change'])),
                         convert_flax_change, ['seg_loss', 'change_loss'])
