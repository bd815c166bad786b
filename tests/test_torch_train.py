"""The port's training slice against the JAX package, on the CPU in float32.

Losses, LR schedules, optimizers and the gradient clip against their JAX
counterparts (optax); the train step's metrics with microbatches; and the
slice as a whole: a small DinoSeg with the fused attention kernels forced
in both packages (the JAX Pallas forward and backward in interpret mode,
the port's autograd Function with its plain forward and written-out
backward) from the same weights, its first step's gradients, and three
AdamW + cosine steps with warmup and clip.  Inputs come from numpy with a
seed.  Each tolerance states its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import loss as jloss
from ever_tpu.module import vit as jvit
from ever_tpu.opt import learning_rate as jlr
from ever_tpu.opt import optimizer as jopt
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.opt import learning_rate as tlr
from ever_tpu_torch.opt import optimizer as topt
from ever_tpu_torch.ops.norm import FusedLayerNorm
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg

# -- losses -------------------------------------------------------------------


def _seg_data(seed, n=2, h=6, w=5, c=4, ignore_frac=0.2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=2.0, size=(n, h, w, c)).astype(np.float32)
    labels = rng.integers(0, c, size=(n, h, w)).astype(np.int32)
    labels[rng.random((n, h, w)) < ignore_frac] = 255
    return logits, labels


@pytest.mark.parametrize('kw', [dict(), dict(class_weight=[0.5, 1.0, 2.0, 1.5]),
                                dict(reduction='sum'), dict(ignore_index=3)])
def test_softmax_ce_matches_jax(kw):
    logits, labels = _seg_data(1)
    if 'ignore_index' in kw:      # labels stay in range: class 3 is the ignored one
        labels[labels == 255] = kw['ignore_index']
    want = np.asarray(jloss.softmax_ce_loss_with_logits(
        jnp.asarray(logits), jnp.asarray(labels), **kw))
    got = tloss.softmax_ce_loss_with_logits(
        torch.from_numpy(logits), torch.from_numpy(labels).long(), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_all_ignored_batch_gives_zero_loss_not_nan():
    logits, _ = _seg_data(2)
    labels = np.full(logits.shape[:-1], 255, np.int32)
    want = float(jloss.softmax_ce_loss_with_logits(jnp.asarray(logits),
                                                   jnp.asarray(labels)))
    got = tloss.softmax_ce_loss_with_logits(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    assert want == 0.0 and float(got) == 0.0
    d = tloss.dice_loss_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    assert torch.isfinite(d)


@pytest.mark.parametrize('kw,c', [(dict(), 4), (dict(smooth_value=0.5), 4),
                                  (dict(ignore_channel=1), 4), (dict(), 1)])
def test_dice_matches_jax(kw, c):
    logits, labels = _seg_data(3, c=c)
    if c == 1:
        labels = np.where(labels == 255, 255, labels % 2).astype(np.int32)
    want = np.asarray(jloss.dice_loss_with_logits(jnp.asarray(logits),
                                                  jnp.asarray(labels), **kw))
    got = tloss.dice_loss_with_logits(torch.from_numpy(logits),
                                      torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sum_losses_stays_on_the_losses_device():
    """The objective is summed where the losses live: no tensor is made on
    another device (on the card a host-made zero copied over made the host
    wait for every step's forward).  Recorded with a dispatch mode over
    losses on the meta device; the values as the JAX sum's on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from ever_tpu_torch.interface.module import sum_losses

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.device.type)
            return out

    losses = {'cls_loss': torch.ones((), device='meta', dtype=torch.bfloat16),
              'dice_loss': torch.ones((), device='meta'), 'acc': torch.ones((), device='meta')}
    with Devices() as mode:
        total = sum_losses(losses)
    assert total.device.type == 'meta' and total.dtype == torch.float32
    assert mode.seen == {'meta'}
    cpu = {'cls_loss': torch.tensor(0.7, dtype=torch.bfloat16), 'dice_loss': torch.tensor(0.25),
           'acc': torch.tensor(3.0)}
    assert float(sum_losses(cpu)) == float(torch.tensor(0.7, dtype=torch.bfloat16)) + 0.25


def test_losses_are_registered_under_the_jax_names():
    from ever_tpu_torch.core import registry
    assert registry.LOSS['softmax_ce'] is tloss.softmax_ce_loss_with_logits
    assert registry.LOSS['dice'] is tloss.dice_loss_with_logits


# -- LR schedules ---------------------------------------------------------------

_WARMUPS = [None, dict(type='linear', step=5, ratio=0.1),
            dict(type='exp', step=5, ratio=0.01), dict(type='constant', step=5, ratio=0.3)]


@pytest.mark.parametrize('warmup', _WARMUPS)
@pytest.mark.parametrize('name,params', [
    ('multistep', dict(steps=[8, 14], base_lr=0.1, gamma=0.5)),
    ('poly', dict(base_lr=0.01, power=0.9, max_iters=20)),
    ('cosine', dict(base_lr=1e-3, max_iters=20, eta_min=1e-5)),
])
def test_schedules_match_jax(name, params, warmup):
    """Every step of 0..24 (past max_iters too); the JAX schedules compute
    in float32, hence rtol 1e-6."""
    cfg = {'type': name, 'params': dict(params, warmup=warmup)}
    j, t = jbuilder.make_learningrate(cfg), tbuilder.make_learningrate(cfg)
    steps = np.arange(25)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    got = np.array([t(int(s)) for s in steps])
    assert all(isinstance(t(int(s)), float) for s in steps)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize('name,params', [('constant', dict(base_lr=0.02)),
                                         ('search', dict(init_lr=1e-5, final_lr=1.0,
                                                         max_iters=30))])
def test_constant_and_search_match_jax(name, params):
    cfg = {'type': name, 'params': params}
    j, t = jbuilder.make_learningrate(cfg), tbuilder.make_learningrate(cfg)
    for s in range(0, 31, 3):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6)


def test_schedule_step_sets_param_groups():
    sched = tlr.PolyLearningRate(base_lr=0.1, power=1.0, max_iters=10)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0)
    assert sched.step(5, opt) == pytest.approx(0.05)
    assert opt.param_groups[0]['lr'] == pytest.approx(0.05)


# -- optimizers and the clip ------------------------------------------------------

def _param_data(seed):
    rng = np.random.default_rng(seed)
    params = {'a': rng.normal(size=(5, 3)).astype(np.float32),
              'b': rng.normal(size=(7,)).astype(np.float32),
              'z': np.zeros((4,), np.float32)}           # a zero-norm tensor (LAMB)
    grads = [{k: rng.normal(scale=0.3, size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize('name,params', [
    ('sgd', dict(momentum=0.9, weight_decay=1e-3)),
    ('sgd', dict(momentum=0.9, nesterov=True)),
    ('sgd', dict()),
    ('adam', dict(weight_decay=1e-2)),
    ('fused_adam', dict(betas=(0.8, 0.99))),
    ('adamw', dict(weight_decay=0.05)),
    ('lamb', dict(weight_decay=0.01)),
])
@pytest.mark.parametrize('clip', [None, 0.5])
def test_optimizers_match_optax(name, params, clip):
    """Params after one and after three steps with a schedule and the
    recording clip, against the JAX package's optax chain on the same
    params and gradients; the recorded pre-clip norm each step.  Float32
    updates in another order: rtol 1e-5."""
    p0, grads = _param_data(4)
    sched = tlr.CosineAnnealingLearningRate(base_lr=0.05, max_iters=10,
                                            warmup=dict(type='linear', step=1, ratio=0.5))
    jsched = jlr.CosineAnnealingLearningRate(base_lr=0.05, max_iters=10,
                                             warmup=dict(type='linear', step=1, ratio=0.5))
    grad_clip = None if clip is None else dict(max_norm=clip)
    jfactory, _ = jbuilder.make_optimizer({'type': name, 'params': params})
    tx = jfactory.build(jsched, grad_clip=grad_clip)
    tfactory, _ = tbuilder.make_optimizer({'type': name, 'params': params})
    rule = tfactory.build(sched, grad_clip=grad_clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = rule.init(tp.values())
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        norm = rule.apply(opt, step)
        np.testing.assert_allclose(float(norm),
                                   float(jopt.find_recorded_grad_norm(state)), rtol=1e-6)
        if step in (0, 2):
            for k in p0:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=f'{name} {k} {step}')
    assert opt.param_groups[0]['lr'] == pytest.approx(sched(2))


@pytest.mark.parametrize('max_norm', [None, 100.0, 0.1])
def test_clip_records_the_norm_before_clipping(max_norm):
    """scale = min(1, max_norm / max(norm, 1e-12)); no clip without
    max_norm; the returned norm is the one before clipping."""
    rng = np.random.default_rng(5)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)))
    got = topt.clip_by_global_norm_recording(ps, max_norm)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    scale = 1.0 if max_norm is None else min(1.0, max_norm / norm)
    for p, g in zip(ps, gs):
        np.testing.assert_allclose(p.grad.numpy(), g * scale, rtol=1e-6)


def test_param_groups_and_frozen_prefixes_are_not_ported_yet():
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': {}})
    with pytest.raises(NotImplementedError):
        factory.build(0.1, param_groups=({}, {}))
    with pytest.raises(NotImplementedError):
        factory.build(0.1, frozen_prefixes=('vit/',))


def test_make_optimizer_returns_factory_and_config():
    cfg = {'type': 'adamw', 'params': dict(weight_decay=0.05),
           'grad_clip': dict(max_norm=3.0)}
    factory, opt_cfg = tbuilder.make_optimizer(cfg)
    assert isinstance(factory, topt.OptimizerFactory)
    assert opt_cfg.grad_clip.max_norm == 3.0
    rule = factory.build(1e-3, grad_clip=opt_cfg.grad_clip)
    assert rule.max_norm == 3.0 and rule.lr_at(7) == 1e-3
    opt = rule.init([torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(opt, torch.optim.AdamW) and opt.param_groups[0]['weight_decay'] == 0.05


# -- the train step and the slice as a whole -------------------------------------

SMALL = dict(name='vit_small', layerscale_init=1e-5, n_storage_tokens=4, norm_eps=1e-5)


def _small_dinoseg_cfg(**backbone):
    return dict(backbone={**SMALL, **backbone}, classes=5, dtype='float32')


def _seeded_params(model, x):
    """Seeded random weights in the JAX DinoSeg's tree: kernels ~N(0, 0.05²),
    norm scales and LayerScale gammas ~U(0.5, 1.5), the rest ~N(0, 0.02²)
    (O(1) gammas so that every block moves the loss)."""
    shapes = jax.eval_shape(lambda: model.init({'params': jax.random.key(0)},
                                               jnp.asarray(x)))
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'gamma' in name or 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes['params'])


def _batch(n, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(n, size, size)).astype(np.int32)
    y[:, 0, :3] = 255                                    # some ignored pixels
    return x, y


def _both(cfg, x, params):
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    tmodel.load_state_dict(convert_flax_dinoseg(params), strict=True)
    return jmodel, tmodel


def _opt(jsched_or_t, which):
    cfg = {'type': 'adamw', 'params': dict(weight_decay=0.05)}
    factory = (jbuilder if which == 'jax' else tbuilder).make_optimizer(cfg)[0]
    return factory.build(jsched_or_t, grad_clip=dict(max_norm=1.0))


def _jax_state(tx, params):
    """The JAX package's TrainState from given weights: what
    ``create_train_state(..., init_params=params)`` returns, without the
    eager ``model.init`` it runs first (seconds of op-by-op tracing)."""
    return jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats={}, opt_state=tx.init(params))


def _schedules():
    cfg = {'type': 'cosine', 'params': dict(
        base_lr=1e-3, max_iters=10, warmup=dict(type='linear', step=2, ratio=0.1))}
    return jbuilder.make_learningrate(cfg), tbuilder.make_learningrate(cfg)


def _close_params(tmodel, jparams, rtol, atol):
    want = convert_flax_dinoseg(jparams)
    got = tmodel.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_slice_dinoseg_fused_kernels_train_like_jax():
    """The slice as a whole.  A small DinoSeg (vit_small, 64² tiles: 21
    tokens, the fused kernels forced in both packages) from one set of
    weights.  First step: every parameter's gradient (the JAX gradients
    mapped by the same linear converter).  Then three AdamW + cosine steps
    with a linear warmup and a clip at 1.0 (active: the norms are ~3):
    cls_loss, total_loss, grad_norm and learning_rate per step, and every
    parameter after.  Tolerances: gradients rtol 1e-3 / atol 1e-5 after 12
    blocks of float32 sums in different orders (the qkv gradient of a block
    is a sum over all tokens and heads); the params 2e-5 absolute after
    three Adam steps of at most lr·(1 + wd) = 1e-3 each (Adam divides by
    √v, so a near-zero gradient's rounding moves its update the most)."""
    cfg = _small_dinoseg_cfg(attn_impl='fused')
    x, y = _batch(2, 64, seed=3)
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _seeded_params(jmodel, x)
    _, tmodel = _both(cfg, x, {'params': params})

    def jloss_fn(p):
        return jmodel.apply({'params': p}, jnp.asarray(x), jnp.asarray(y),
                            train=True)['cls_loss']

    jgrads = convert_flax_dinoseg(jax.jit(jax.grad(jloss_fn))(params))
    out = tmodel(torch.from_numpy(x), torch.from_numpy(y), train=True)
    out['cls_loss'].backward()
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    tmodel.zero_grad(set_to_none=True)

    jsched, tsched = _schedules()
    tx = _opt(jsched, 'jax')
    jstate = _jax_state(tx, params)
    jstep = jspmd.build_train_step(jmodel, tx, jsched, donate=False)
    rule = _opt(tsched, 'torch')
    tstate = tspmd.create_train_state(tmodel, rule)
    tstep = tspmd.build_train_step(tmodel, rule, tsched)
    for _ in range(3):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        assert set(tm) == set(jm) == {'cls_loss', 'total_loss', 'grad_norm',
                                      'learning_rate'}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    _close_params(tmodel, jstate.params, rtol=0, atol=2e-5)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


def test_fused_layer_norm_first_step_gradients_match_jax(monkeypatch):
    """DinoSeg's first-step gradients with ``EVER_FUSED_LN=1`` in both
    packages: the port's LayerNorm autograd Function (the plain versions of
    K4 and K5) against ``jax.grad`` through the JAX ``FusedLayerNorm``
    (flax's one-pass math on the CPU); plain attention in both, 12 blocks
    at 64².  Every parameter's gradient within 1e-6 absolute and 1e-4
    relative (2.6e-7 measured), where the slice test above allows 1e-5 and
    1e-3."""
    monkeypatch.setenv('EVER_FUSED_LN', '1')
    cfg = _small_dinoseg_cfg(attn_impl='xla')
    x, y = _batch(2, 64, seed=3)
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _seeded_params(jmodel, x)
    _, tmodel = _both(cfg, x, {'params': params})
    assert isinstance(tmodel.vit.blocks[0].norm1, FusedLayerNorm)

    def jloss_fn(p):
        return jmodel.apply({'params': p}, jnp.asarray(x), jnp.asarray(y),
                            train=True)['cls_loss']

    jgrads = convert_flax_dinoseg(jax.jit(jax.grad(jloss_fn))(params))
    tmodel(torch.from_numpy(x), torch.from_numpy(y), train=True)['cls_loss'].backward()
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_step_microbatches_match_jax(monkeypatch):
    """forward_times=2: the microbatches' gradients and metrics averaged,
    against the JAX step's scan, on a 2-block DinoSeg (vit_small's width,
    registered for this test in both packages' VIT_SPECS, so that the JAX
    step compiles quickly; plain attention, 32² tiles) with SGD + momentum
    at a constant LR.  Metrics and params after one step; float32 in both,
    rtol 2e-5 on metrics, 1e-6 absolute on params moved by
    lr·|g| ≈ 1e-2 · O(0.1)."""
    for specs in (jvit.VIT_SPECS, tvit.VIT_SPECS):
        monkeypatch.setitem(specs, 'vit_2block', (2, 384, 6, 4.0, 'mlp'))
    cfg = _small_dinoseg_cfg(attn_impl='xla', name='vit_2block')
    x, y = _batch(4, 32, seed=5)
    xs, ys = x.reshape(2, 2, *x.shape[1:]), y.reshape(2, 2, *y.shape[1:])
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _seeded_params(jmodel, x)
    _, tmodel = _both(cfg, x, {'params': params})
    opt_cfg = {'type': 'sgd', 'params': dict(momentum=0.9)}
    tx = jbuilder.make_optimizer(opt_cfg)[0].build(0.01)
    jstate = _jax_state(tx, params)
    jstep = jspmd.build_train_step(jmodel, tx, forward_times=2, donate=False)
    jstate, jm = jstep(jstate, (jnp.asarray(xs), jnp.asarray(ys)))
    rule = tbuilder.make_optimizer(opt_cfg)[0].build(0.01)
    tstate = tspmd.create_train_state(tmodel, rule)
    tstep = tspmd.build_train_step(tmodel, rule, forward_times=2)
    tstate, tm = tstep(tstate, (torch.from_numpy(xs), torch.from_numpy(ys)))
    assert set(tm) == set(jm) == {'cls_loss', 'total_loss', 'grad_norm'}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    _close_params(tmodel, jstate.params, rtol=0, atol=1e-6)


def test_train_loop_reports_mean_metrics_and_last_lr_and_norm():
    """build_train_loop: K steps per call, the metrics' mean over the K
    steps except learning_rate and grad_norm (the last step's), and the same
    trajectory as K separate steps."""
    cfg = _small_dinoseg_cfg(attn_impl='xla')
    x, y = _batch(2, 32, seed=6)
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _seeded_params(jmodel, x)
    _, jsched_t = _schedules()
    runs = []
    for loop in (False, True):
        _, tmodel = _both(cfg, x, {'params': params})
        rule = _opt(jsched_t, 'torch')
        state = tspmd.create_train_state(tmodel, rule)
        if loop:
            run = tspmd.build_train_loop(tmodel, rule, jsched_t, steps_per_loop=3)
            state, m = run(state, (torch.from_numpy(x)[None].expand(3, *x.shape),
                                   torch.from_numpy(y)[None].expand(3, *y.shape)))
            runs.append((m, tmodel))
        else:
            step = tspmd.build_train_step(tmodel, rule, jsched_t)
            ms = [step(state, (torch.from_numpy(x), torch.from_numpy(y)))[1]
                  for _ in range(3)]
            runs.append((ms, tmodel))
    (ms, m1), (m, m2) = runs
    assert float(m['learning_rate']) == pytest.approx(float(ms[-1]['learning_rate']))
    assert float(m['grad_norm']) == float(ms[-1]['grad_norm'])
    assert float(m['cls_loss']) == pytest.approx(
        np.mean([float(s['cls_loss']) for s in ms]), rel=1e-6)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_bf16_compute_keeps_f32_params_and_a_bf16_residual_stream():
    """dtype='bfloat16' means bf16 compute: under the train step the
    parameters, their gradients and the AdamW state stay float32, while the
    tokens between blocks are bf16."""
    cfg = dict(_small_dinoseg_cfg(attn_impl='fused'), dtype='bfloat16')
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    seen = []
    for blk in tmodel.vit.blocks:
        blk.register_forward_hook(lambda m, a, out: seen.append((a[0].dtype, out.dtype)))
    sched = tbuilder.make_learningrate({'type': 'cosine', 'params': dict(
        base_lr=1e-4, max_iters=1000)})
    rule = tbuilder.make_optimizer({'type': 'adamw', 'params': dict(
        weight_decay=0.05)})[0].build(sched)
    state = tspmd.create_train_state(tmodel, rule)
    step = tspmd.build_train_step(tmodel, rule, sched)
    x, y = _batch(2, 32, seed=7)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert seen and all(a == o == torch.bfloat16 for a, o in seen)
    assert np.isfinite(float(m['cls_loss'])) and m['cls_loss'].dtype == torch.float32
    for name, p in tmodel.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        st = state.optimizer.state[p]
        assert st['exp_avg'].dtype == st['exp_avg_sq'].dtype == torch.float32
    # an lr-1e-4 update is visible in f32 (it would vanish in bf16 weights)
    moved = [k for k, v in tmodel.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    probs = tspmd.build_eval_step(tmodel)(state, torch.from_numpy(x))
    assert probs.dtype == torch.float32 and probs.shape == (2, 32, 32, 5)


def test_mesh_is_the_parallel_slice():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError):
        tspmd.build_train_step(model, None, mesh=object())
    with pytest.raises(NotImplementedError):
        tspmd.build_eval_step(model, mesh=object())
