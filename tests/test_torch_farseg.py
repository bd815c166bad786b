"""FarSeg in the port against the JAX package, on the CPU.

The slice as a whole: FarSeg-R50's eval probabilities at 64² in float32;
the train step on a narrow FarSeg (ResNet-18 trunk, head width 32, the
stem's max pool backward through K8's plain version, the JAX side through
the Pallas kernel in interpret mode): first-step gradients, three SGD +
momentum steps with a poly schedule (metrics, parameters and running
statistics), and microbatches; the weight converter; and whole-scene tiled
inference.  Weights are seeded random draws in the JAX tree carried over by
``convert_flax_farseg``; inputs come from numpy with a seed.  Each
tolerance states its reason.

The narrow model's tests compute in float64 in both packages (the loss
itself stays float32 in both, as the models cast their logits).  At 64²
and batch 2 the coarsest BatchNorms normalise 8 to 32 values per channel,
so some pre-activations lie within float32 rounding of a ReLU's kink; the
two packages round differently (flax's one-pass variance against
PyTorch's two-pass one), a mask element flips, and that layer's gradient
moves by one element's share of a small sum.  In float64 no such flip
occurs, and the comparison checks the algorithm; the port's own float32
gradients are held against its float64 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.magic.tiled import tiled_inference as jax_tiled
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.magic.tiled import tiled_inference as torch_tiled
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_farseg, flatten_params
from test_torch_resnet import close, one_torch_thread, seeded_variables, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
# torch's default intra-op pool, read when the module is imported
DEFAULT_THREADS = torch.get_num_threads()

CLASSES = 5
# the narrow FarSeg of the train-step tests
NARROW = dict(
    encoder=dict(resnet_type='resnet18', maxpool_impl='pallas'),
    head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=32),
              fs_relation=dict(scene_embedding_channels=512,
                               in_channels_list=(32,) * 4, out_channels=32),
              fpn_decoder=dict(in_channels=32, out_channels=32)),
    classes=CLASSES)


def _batch(n, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(n, size, size)).astype(np.int32)
    y[:, 0, :5] = 255                                    # some ignored pixels
    return x, y


def _models(cfg, x, seed=0):
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': cfg})
    v = seeded_variables(jm, x, seed)
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    return jm, tm, v


@pytest.fixture(scope='module')
def narrow():
    """The narrow FarSeg in both packages, computing in float64, from one
    set of variables; the JAX side runs under ``jax.enable_x64``."""
    cfg = dict(NARROW, dtype='float64')
    x, y = _batch(2, 64, seed=3)
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': cfg})
        v = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(jm, x))
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu').double()
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    return jm, tm, v, x, y


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def test_farseg_r50_eval_matches_jax():
    """FarSeg-R50 (default widths, 7 classes) at 64², B=2: the class
    probabilities (eval mode, running statistics) agree to 1e-5 (float32
    sums in other orders through 53 convs)."""
    cfg = dict(classes=7)
    x, _ = _batch(2, 64, seed=1)
    jm, tm, v = _models(cfg, x)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, 7) and want.std() > 1e-2      # not uniform
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_converter_covers_every_variable(narrow):
    """Every JAX param and batch statistic maps to one port key, and the
    port has no key left without a value; a stray variable raises."""
    _, tm, v, _, _ = narrow
    sd = convert_flax_farseg(v)
    n_jax = len(flatten_params(v['params'])) + len(flatten_params(v['batch_stats']))
    assert len(sd) == n_jax and set(sd) == set(tm.state_dict())
    assert convert_flax_farseg(v['params'], v['batch_stats']).keys() == sd.keys()
    with pytest.raises(KeyError, match='unmapped'):
        convert_flax_farseg({'head': {'extra': {'kernel': np.zeros((1, 1, 1, 1))}}})


def _grads_close(tm, jgrads, rtol, atol):
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_first_step_gradients_match_jax(narrow, x64):
    """Every parameter's gradient of cls_loss in train mode, and the running
    statistics after the forward.  rtol 1e-5 / atol 1e-7: the gradients
    start from the float32 loss (summed in other orders), the rest is
    float64; the JAX kernel compares its max-pool candidates in float32,
    which can tie two float64 values that the port keeps apart."""
    jm, tm, v, x, y = narrow

    def jloss(p):
        out, mut = jm.apply({'params': p, 'batch_stats': v['batch_stats']},
                            jnp.asarray(x), jnp.asarray(y), train=True,
                            mutable=['batch_stats'])
        return out['cls_loss'], mut

    (loss, mut), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v['params'])
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x), torch.from_numpy(y), train=True)
    out['cls_loss'].backward()
    np.testing.assert_allclose(float(out['cls_loss']), float(loss), rtol=1e-6)
    _grads_close(tm, convert_flax_farseg(g), rtol=1e-5, atol=1e-7)
    moved = convert_flax_farseg({}, mut['batch_stats'])
    sd = tm.state_dict()
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), 1e-8)
    tm.zero_grad(set_to_none=True)


def test_float32_gradients_match_a_float64_run(narrow):
    """The port's float32 train-mode gradients against its own float64 run
    of the same weights and batch: every tensor within ‖Δ‖/‖ref‖ ≤ 2e-4
    (float32 sums through the trunk and the head, two-pass BatchNorm
    variance).  This is why the JAX comparisons above run in float64: the
    port's float32 gradients stay at rounding level of the exact ones.  It
    runs with torch's default thread pool, as it always has: under one
    intra-op thread the float32 run's gradients leave the float64 run's by
    9.4e-3 (layer3's BatchNorm biases; 3.5e-5 with eight threads)."""
    _, tm64, v, x, y = narrow
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': NARROW}, device='cpu')
    grads = []
    with torch_threads(DEFAULT_THREADS):
        for model, xx in ((tm, torch.from_numpy(x).float()), (tm64, torch.from_numpy(x))):
            model.load_state_dict(convert_flax_farseg(v), strict=True)   # cast on copy
            model.zero_grad(set_to_none=True)
            model(xx, torch.from_numpy(y), train=True)['cls_loss'].backward()
            grads.append({n: p.grad.double() for n, p in model.named_parameters()})
            model.zero_grad(set_to_none=True)
    worst = max(float((grads[0][n] - g).norm() / g.norm()) for n, g in grads[1].items())
    assert worst <= 2e-4, worst


def _sgd(which):
    b = jbuilder if which == 'jax' else tbuilder
    sched = b.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.05, power=0.9, max_iters=20)})
    factory, _ = b.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    return sched, factory.build(sched)


def _close_state(tm, params, batch_stats, atol):
    sd = tm.state_dict()
    for k, w in convert_flax_farseg(params, batch_stats).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def test_three_sgd_steps_match_jax(narrow, x64):
    """Three SGD + momentum steps with a poly schedule through both train
    steps: cls_loss, total_loss, grad_norm and learning_rate each step
    (rtol 1e-5, the float32 loss's rounding carried through three steps),
    then every parameter and running statistic (1e-6 absolute after three
    updates of at most lr·|momentum sum| ≈ 0.05 · O(1))."""
    jm, tm, v, x, y = narrow
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    jsched, tx = _sgd('jax')
    jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                              batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
    jstep = jspmd.build_train_step(jm, tx, jsched, donate=False)
    tsched, rule = _sgd('torch')
    tstate = tspmd.create_train_state(tm, rule)
    tstep = tspmd.build_train_step(tm, rule, tsched)
    for _ in range(3):
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tmet = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        assert set(tmet) == set(jmet) == {'cls_loss', 'total_loss', 'grad_norm',
                                          'learning_rate'}
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    _close_state(tm, jstate.params, jstate.batch_stats, atol=1e-6)


def test_microbatches_match_jax(narrow, x64):
    """forward_times=2: the two microbatches' gradients and metrics averaged
    and the running statistics moved once per microbatch, in order, as the
    JAX step's scan carries them.  Metrics rtol 1e-5, state 1e-6 absolute
    after one step (as above)."""
    jm, tm, v, _, _ = narrow
    x, y = _batch(4, 64, seed=5)
    x = x.astype(np.float64)
    xs, ys = x.reshape(2, 2, *x.shape[1:]), y.reshape(2, 2, *y.shape[1:])
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    jsched, tx = _sgd('jax')
    jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                              batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
    jstate, jmet = jspmd.build_train_step(jm, tx, jsched, forward_times=2, donate=False)(
        jstate, (jnp.asarray(xs), jnp.asarray(ys)))
    tsched, rule = _sgd('torch')
    tstate = tspmd.create_train_state(tm, rule)
    tstate, tmet = tspmd.build_train_step(tm, rule, tsched, forward_times=2)(
        tstate, (torch.from_numpy(xs), torch.from_numpy(ys)))
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    _close_state(tm, jstate.params, jstate.batch_stats, atol=1e-6)


def test_farseg_scene_matches_jax(narrow, x64):
    """Whole-scene tiled inference with the narrow FarSeg: a 96×80 scene,
    64² tiles at stride 32 in batches of 3 (4 tiles and 2 pads), JAX
    package against the port with the same variables.  Tolerance 1e-6
    (float32 probabilities from float64 models)."""
    jm, tm, v, _, _ = narrow
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    image = np.random.default_rng(4).normal(size=(96, 80, 3))
    predict = jax.jit(lambda v, t: jm.apply(v, t, train=False))
    want = np.asarray(jax_tiled(predict, jnp.asarray(image), 64, 32, CLASSES,
                                tile_batch=3, variables=v))
    got = torch_tiled(tm, image, 64, 32, CLASSES, tile_batch=3, device='cpu').numpy()
    assert got.shape == (96, 80, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_bf16_compute_keeps_f32_params_and_bf16_features():
    """dtype='bfloat16': the trunk's features and the decoder are bf16,
    while the parameters, their gradients and the running statistics stay
    float32, and the loss is float32."""
    cfg = dict(NARROW, dtype='bfloat16')
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
    x, y = _batch(2, 64, seed=6)
    feats = tm.encoder(torch.from_numpy(x))
    assert all(f.dtype == torch.bfloat16 for f in feats)
    out = tm(torch.from_numpy(x), torch.from_numpy(y), train=True)
    assert out['cls_loss'].dtype == torch.float32 and torch.isfinite(out['cls_loss'])
    out['cls_loss'].backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 and torch.isfinite(b).all() for b in tm.buffers())


def test_widths_must_match_the_config():
    cfg = dict(NARROW, head=dict(NARROW['head'], fpn=dict(
        in_channels_list=(256, 512, 1024, 2048), out_channels=32)))
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
    with pytest.raises(ValueError, match='widths'):
        tm(torch.zeros(1, 64, 64, 3))
