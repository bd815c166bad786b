"""FactSeg and the masked BCE in the port against the JAX package, on the
CPU.

A narrow FactSeg (a ResNet-18 trunk with one block a stage, FPNs 16 wide, decoders 16 wide, 5
classes) at 64², batch 2, weights seeded in the JAX tree and carried over
by ``convert_flax_factseg``, inputs from numpy with a seed.  Eval runs in
float32 (joint probabilities within 1e-5); the losses and one SGD step run
in float64 in both packages (the losses themselves are float32 in both, as
the models cast their logits): at 64² BatchNorm's one-pass (flax) and
two-pass (PyTorch) variances round apart in float32 and flip ReLU masks,
which float64 avoids (``tests/test_torch_farseg.py``).  Each tolerance
states its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import loss as JL
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import loss as TL
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_factseg, convert_flax_flat, flatten_params
from ever_tpu.module import resnet as jres
from ever_tpu_torch.module import resnet as tres
from test_torch_resnet import one_torch_thread, seeded_variables, torch_threads  # noqa: F401

CLASSES = 5
NARROW = dict(encoder=dict(resnet_type='resnet_basic_tiny'),
              fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=16),
              decoder=dict(in_channels=16, out_channels=16), classes=CLASSES)


def batch(n=2, size=64, seed=3, channels=3):
    """Seeded inputs and int labels over ``CLASSES`` with some ignored."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, channels))
    y = rng.integers(0, CLASSES, size=(n, size, size)).astype(np.int32)
    y[:, 0, :7] = 255
    return x, y


@pytest.fixture(scope='module', autouse=True)
def small_cpu_models():
    """``resnet_basic_tiny`` in both packages' ``RESNET_SPECS`` (ResNet-18's
    stem, blocks and widths with one block a stage: the JAX traces of the
    models' gradients are most of these tests' time), and one torch
    thread, as :func:`one_torch_thread`."""
    with pytest.MonkeyPatch.context() as mp, torch_threads(1):
        for pkg in (jres, tres):
            mp.setitem(pkg.RESNET_SPECS, 'resnet_basic_tiny',
                       (pkg.BasicBlock, (1, 1, 1, 1), 1, 64, False))
        yield


_VARIABLES = {}


def variables(model_type, cfg, x, seed=0):
    """Seeded float32 variables of the JAX model, drawn once per
    architecture (the loss config and dtype leave the tree as it is): the
    init trace is the dearest part of building a model here."""
    arch = {k: v for k, v in cfg.items() if k not in ('loss', 'dtype')}
    key = (model_type, repr(sorted(arch.items())), x.shape, seed)
    if key not in _VARIABLES:
        jm = jbuilder.make_model({'type': model_type, 'params': arch})
        _VARIABLES[key] = seeded_variables(jm, x.astype(np.float32), seed)
    return _VARIABLES[key]


def both(model_type, cfg, x, convert, seed=0, dtype='float32'):
    """The model in both packages from one set of seeded JAX variables,
    computing in ``dtype`` (float64 under ``jax.enable_x64``)."""
    cfg = dict(cfg, dtype=dtype)
    jm = jbuilder.make_model({'type': model_type, 'params': cfg})
    v = variables(model_type, cfg, x, seed)
    tm = tbuilder.make_model({'type': model_type, 'params': cfg}, device='cpu')
    if dtype == 'float64':
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        tm = tm.double()
    tm.load_state_dict(convert(v), strict=True)
    return jm, tm, v


def sgd(which):
    b = jbuilder if which == 'jax' else tbuilder
    sched = b.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.05, power=0.9, max_iters=20)})
    factory, _ = b.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9,
                                                                 weight_decay=1e-4)})
    return sched, factory.build(sched)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def jax_one_step(jm, v, batch_np):
    """One SGD step of the JAX model, jitted whole: its gradients of the
    summed losses put through the JAX package's optimizer.  Returns
    (metrics: the losses, ``total_loss`` and ``grad_norm``; the new params;
    the new running statistics)."""
    _, jtx = sgd('jax')

    def step(params, stats, x, y):
        def loss(p):
            out, mut = jm.apply({'params': p, 'batch_stats': stats}, x, y, train=True,
                                mutable=['batch_stats'])
            return sum(out.values()), (out, mut['batch_stats'])

        (total, (met, stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        updates, _ = jtx.update(grads, jtx.init(params), params)
        return (dict(met, total_loss=total, grad_norm=optax.global_norm(grads)),
                optax.apply_updates(params, updates), stats)

    return jax.jit(step)(v['params'], v['batch_stats'], *to_jax(batch_np))


def one_step_matches(jm, tm, v, batch_np, convert, keys, loss_rtol=1e-6, atol=1e-6,
                     jax_step=None):
    """One SGD step (momentum, weight decay, poly) on ``batch_np`` (x,
    labels: an array or a dict): the port's ``build_train_step`` against
    :func:`jax_one_step` (or its given result).  The losses, ``total_loss``
    and ``grad_norm`` within ``loss_rtol``, then every parameter and
    running statistic within ``atol``.  Returns the port's metrics."""
    jmet, params, stats = jax_step or jax_one_step(jm, v, batch_np)
    tsched, ttx = sgd('torch')
    tstate = tspmd.create_train_state(tm, ttx)
    tstate, tmet = tspmd.build_train_step(tm, ttx, tsched)(tstate, to_torch(batch_np))
    assert set(tmet) == set(jmet) | {'learning_rate'} and set(keys) <= set(tmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=loss_rtol, err_msg=k)
    sd = tm.state_dict()
    for k, w in convert(params, stats).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)
    return tmet


def test_factseg_eval_joint_matches_jax():
    """The joint probabilities in eval mode (running statistics), float32:
    within 1e-5 (float32 sums in other orders through the trunk and both
    branches), each pixel's summing to 1."""
    x, _ = batch()
    jm, tm, v = both('FactSeg', NARROW, x, convert_flax_factseg)
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, CLASSES) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.fixture(scope='module')
def fact64():
    """The narrow FactSeg in both packages in float64 from one set of
    variables, and the JAX model's SGD step on the batch."""
    x, y = batch()
    with jax.enable_x64(True):
        jm, tm, v = both('FactSeg', NARROW, x, convert_flax_factseg, dtype='float64')
        yield jm, tm, v, x, y, jax_one_step(jm, v, (x, y))


def test_factseg_losses_and_one_sgd_step_match_jax(fact64):
    """The train losses (``cls_loss`` on the log joint probability,
    ``fa_loss``, ``dice_loss``) and one SGD step in float64: losses and
    grad_norm within rtol 1e-6 (the float32 losses summed in other
    orders), every parameter and running statistic within 1e-6 after the
    step."""
    jm, tm, v, x, y, step = fact64
    tm.load_state_dict(convert_flax_factseg(v), strict=True)
    with jax.enable_x64(True):
        one_step_matches(jm, tm, v, (x, y), convert_flax_factseg,
                         ['cls_loss', 'fa_loss', 'dice_loss'], jax_step=step)


@pytest.mark.parametrize('off', ['fa', 'dice'])
def test_factseg_optional_losses_match_jax(fact64, off):
    """``loss.fa=None`` or ``loss.dice=None`` drops that loss alone (the JAX
    model's gates: ``is not None``, so ``dice=dict()`` keeps the dice);
    the other losses are the JAX default run's within rtol 1e-6."""
    _, _, v, x, y, (want, _, _) = fact64
    want = {k: float(w) for k, w in want.items() if k.endswith('_loss') and k != 'total_loss'}
    cfg = dict(NARROW, dtype='float64', loss=dict(ignore_index=255, **{off: None}))
    tm = tbuilder.make_model({'type': 'FactSeg', 'params': cfg}, device='cpu').double()
    tm.load_state_dict(convert_flax_factseg(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(y), train=True)
    assert set(got) == set(want) - {f'{off}_loss'}
    for k in got:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-6, err_msg=k)


def test_converters_cover_every_variable_and_the_flat_archive():
    """Every JAX variable of FactSeg maps to one port key and the port has
    no key left without one; the flat ``params/``/``batch_stats/`` archive
    is recognised as FactSeg; a stray variable raises."""
    x, _ = batch()
    _, tm, v = both('FactSeg', NARROW, x, convert_flax_factseg)
    sd = convert_flax_factseg(v)
    n_jax = len(flatten_params(v['params'])) + len(flatten_params(v['batch_stats']))
    assert len(sd) == n_jax and set(sd) == set(tm.state_dict())
    flat = {f'params/{k}': a for k, a in flatten_params(v['params']).items()}
    flat.update({f'batch_stats/{k}': a for k, a in flatten_params(v['batch_stats']).items()})
    got = convert_flax_flat(flat)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(KeyError, match='unmapped'):
        convert_flax_factseg({'fa_cls': {'extra': np.zeros(1)}})


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('pos_weight', [None, 2.0])
@pytest.mark.parametrize('ignored', ['some', 'all'])
def test_bce_matches_jax(reduction, pos_weight, ignored):
    """The masked BCE against the JAX package's, and its input gradient
    against ``jax.grad``: within 1e-6 relative (float32 sums in other
    orders).  All labels ignored: the mean is 0 with a zero gradient, not
    NaN."""
    rng = np.random.default_rng(7)
    z = (3 * rng.normal(size=(2, 16, 12))).astype(np.float32)
    t = rng.integers(0, 2, size=(2, 16, 12)).astype(np.float32)
    t[0, :3] = 255
    if ignored == 'all':
        t[:] = 255

    def jloss(z):
        out = JL.binary_cross_entropy_with_logits(z, jnp.asarray(t), reduction=reduction,
                                                  pos_weight=pos_weight)
        return jnp.sum(out * 1.5), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_(True)
    got = TL.binary_cross_entropy_with_logits(tz, torch.from_numpy(t), reduction=reduction,
                                              pos_weight=pos_weight)
    (got * 1.5).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    if ignored == 'all':
        assert float(got.detach().sum()) == 0.0 and not bool(tz.grad.any())
