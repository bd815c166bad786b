"""The port's spatial train step (``build_spatial_train_step``) on FarSeg,
against the port's unsharded step and the JAX package's spatial step, on
the CPU.

One job of four gloo ranks (``torch_spatial_ranks.farseg_worker``, which
imports no JAX) trains the narrow FarSeg-R18 of ``tests/test_torch_farseg.py``
(float64; the stem's max pool on K8's route, its plain version here) one
SGD + momentum step on one 512×64 tile split into four strips of 128 rows
(4 rows at C5), and the unsharded step on the whole tile runs in the ranks
too, while this process runs the step through the JAX package's
``build_spatial_train_step`` on a 4-device mesh (float64, under
``jax.enable_x64``), all from the same weights.

Against the port's unsharded step the model runs twice.  With its float32
parts computed in float64 (``torch_spatial_ranks.float32_parts_in_float64``)
the spatial step equals the unsharded one within ``FLOAT64_TOL`` (1e-10;
its worst tensor read 1.6e-15 on a CPU).  As the model is, those parts
compute in float32: the bilinear resizes (as the JAX package's do), the
relation's channel sum, the logits and the loss, the global pool's sum and
K8's plain version.  A strip's bilinear resize is a product with the
strip's rows of the weights, and a halo row's gradient a sum of terms made
on two ranks, so those float32 results round otherwise than in one
process; the gap then reads up to 2.2e-9 relative on a CPU, in the running
variance of the decoder's BatchNorms behind the float32 resizes.
``STATE_TOL`` holds it.  ``pytest -s`` prints both readings.

The same job trains three models through the strip forms of the other
reductions over the tile (GroupNorm, the squeezes, the context block, the
pyramid pools), each on ResNet-18 cut to one block a stage
(``resnet_basic_tiny``, registered in both packages here and in the
ranks), one step over the strips and one on the whole tile:
FarSeg++ (``relation_type='v2'``, its scene encoder's GroupNorms on the
pooled scene, the decoder's ``norm='gn'``, dropout rates 0), also against
the JAX package's ``build_spatial_train_step`` at the JAX limits; FarSeg on
a trunk with SE and GC branches in every block (``se_ratio=16``,
``gc_ratio=1/16``); and PSPNet (``torch_spatial_ranks.PSPNet``: output
stride 8, bins 1, 2, 3, 6).  Each against the port's unsharded step with
its float32 parts in float64 within ``FLOAT64_TOL``, and as it is within
``STATE_TOL`` (FarSeg++) or ``POOLED_STATE_TOL`` (one float32 rounding:
the other two, whose float32 pooled maps feed BatchNorm running
statistics).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ever_tpu.core import builder as jbuilder
from ever_tpu.parallel import spatial as jspatial
from ever_tpu.parallel import spmd as jspmd
from ever_tpu.module import resnet as jres
from ever_tpu_torch.util.weight_io import convert_flax_farseg
from test_torch_dist import start_ranks
from test_torch_farseg import CLASSES, NARROW, _sgd
from test_torch_farseg_pp import HEAD_V2
from test_torch_resnet import close, one_torch_thread, seeded_variables  # noqa: F401
from torch_spatial_ranks import MORE_MODELS, TINY_TRUNK

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD, ROWS, COLS = 4, 512, 64
CFG = dict(NARROW, dtype='float64')
# the port's spatial step against its unsharded step: every state tensor
# within TOL · max(1, max|value|), the metrics within the float32 loss's
# rounding (module docstring: float32 parts as they are, and in float64)
STATE_TOL, FLOAT64_TOL, METRIC_TOL = 5e-9, 1e-10, 1e-6
# the models whose float32 pooled maps (an SE squeeze's, a pyramid bin's)
# feed BatchNorm running statistics directly: every state tensor within
# one float32 rounding (2^-24) of max(1, |value|).  A strip's pool is its
# float32 sum added over the strips, one process's one float32 sum; the
# difference, up to a few float32 roundings of the pooled value, reaches a
# running mean through the momentum's 0.1 (PSPNet's 1-bin pool read 9.9e-9,
# the SE + GC trunk 6.8e-9, on a CPU).  With those parts in float64 both
# read under 1e-14 (FLOAT64_TOL holds them)
POOLED_STATE_TOL = 2.0 ** -24
MORE_STATE_TOL = dict(farseg_pp=STATE_TOL, se_gc=POOLED_STATE_TOL, pspnet=POOLED_STATE_TOL)
# against the JAX spatial step: tests/test_torch_farseg.py's float64 limits
# (the first step's loss and running statistics, the state after SGD steps)
JAX_LOSS_TOL, JAX_STATS_TOL, JAX_PARAM_TOL = 1e-6, 1e-8, 1e-6
# 4 · 48 rows: strips of 48 reach layer4's stride-2 conv with 3 rows
MISALIGNED = 4 * 48
TINY = dict(encoder=dict(NARROW['encoder'], resnet_type=TINY_TRUNK))
# FarSeg++ (head width 64: the scene GroupNorms' 32 groups of 2 channels),
# the decoder's GroupNorm, no dropout (the packages draw other masks)
FARSEG_PP = dict(NARROW, **TINY, dtype='float64', head=dict(
    HEAD_V2, fs_relation=dict(HEAD_V2['fs_relation'], dropout_rate=0.0),
    fpn_decoder=dict(HEAD_V2['fpn_decoder'], norm='gn')))
SE_GC = dict(NARROW, dtype='float64',
             encoder=dict(TINY['encoder'], se_ratio=16, gc_ratio=1 / 16))


@pytest.fixture(scope='module', autouse=True)
def tiny_trunk():
    """``resnet_basic_tiny`` in the JAX package's ``RESNET_SPECS`` (the
    ranks register the port's) while the module runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jres.RESNET_SPECS, TINY_TRUNK, (jres.BasicBlock, (1, 1, 1, 1), 1, 64, False))
        yield


@functools.lru_cache(maxsize=None)
def _inputs_pp():
    """The JAX FarSeg++ and its seeded float64 variables."""
    x = _inputs()[2]
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG_PP})
        v = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(jm, x[:, :COLS]))
    return jm, v


@functools.lru_cache(maxsize=None)
def _inputs():
    """The tile (float64 x, labels with some ignored) and the JAX model's
    seeded float64 variables."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, ROWS, COLS, 3))
    y = rng.integers(0, CLASSES, size=(1, ROWS, COLS)).astype(np.int32)
    y[:, 0, :5] = 255
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': CFG})
        v = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(jm, x[:, :COLS]))
    return jm, v, x, y


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory, tiny_trunk):
    """The four ranks, started before the module's first test; killed at
    the end if still running."""
    _, v, x, y = _inputs()
    tmp = tmp_path_factory.mktemp('spatial_train')
    torch.save(dict(cfg=CFG, state_dict=convert_flax_farseg(v), x=x, y=y,
                    misaligned=MISALIGNED, classes=CLASSES, farseg_pp_cfg=FARSEG_PP,
                    farseg_pp_state_dict=convert_flax_farseg(_inputs_pp()[1]), se_gc_cfg=SE_GC),
               tmp / 'farseg-inputs.pt')
    started = start_ranks('torch_spatial_ranks', 'farseg_worker', WORLD, tmp, tmp)
    yield tmp, started
    started.kill()


@functools.lru_cache(maxsize=None)
def _jax_spatial():
    """The JAX package's spatial step on a 4-device mesh: metrics and the
    new params and batch statistics."""
    jm, v, x, y = _inputs()
    with jax.enable_x64(True):
        sched, tx = _sgd('jax')
        state = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                 batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
        step = jspatial.build_spatial_train_step(
            jm, tx, sched, mesh=Mesh(np.array(jax.devices()[:WORLD]), ('data',)), donate=False)
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        with pytest.raises(ValueError, match='divisible') as indivisible:
            step(state, (jnp.asarray(x[:, :-2]), jnp.asarray(y[:, :-2])))
        with pytest.raises(ValueError, match='rank>=2') as rank1:
            step(state, (jnp.asarray(x), jnp.asarray(y), jnp.asarray(x[0, 0, 0])))
        return ({k: float(m) for k, m in metrics.items()}, jax.device_get(state.params),
                jax.device_get(state.batch_stats), str(indivisible.value), str(rank1.value))


@functools.lru_cache(maxsize=None)
def _jax_spatial_pp():
    """The JAX package's spatial step of FarSeg++ on a 4-device mesh:
    metrics and the new params and batch statistics."""
    jm, v = _inputs_pp()
    _, _, x, y = _inputs()
    with jax.enable_x64(True):
        sched, tx = _sgd('jax')
        state = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                 batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
        step = jspatial.build_spatial_train_step(
            jm, tx, sched, mesh=Mesh(np.array(jax.devices()[:WORLD]), ('data',)), donate=False)
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        return ({k: float(m) for k, m in metrics.items()}, jax.device_get(state.params),
                jax.device_get(state.batch_stats))


@pytest.fixture(scope='module')
def ranks(job):
    _jax_spatial()                                  # while the ranks run
    _jax_spatial_pp()
    tmp, started = job
    started.finish(timeout=180)
    return [torch.load(tmp / f'farseg-rank{r}.pt', weights_only=False) for r in range(WORLD)]


def _against_unsharded(ranks, variant: str, tol: float) -> None:
    """Every rank's metrics and state (parameters and running statistics)
    after one spatial step of ``variant`` against the unsharded step on the
    whole tile from the same weights (run by the rank that holds it), each
    tensor within ``tol · max(1, max|value|)``; the ranks' states equal
    each other."""
    (metrics, want), = (u[1:] for r in ranks for u in r['unsharded'] if u[0] == variant)
    worst = (0.0, None)
    for res in (r[variant] for r in ranks):
        assert res['step'] == 1 and set(res['metrics']) == set(metrics)
        for k, m in metrics.items():
            np.testing.assert_allclose(res['metrics'][k], m, rtol=METRIC_TOL, err_msg=k)
        assert set(res['state']) == set(want)
        for k, w in want.items():
            if w.is_floating_point():
                err = float((res['state'][k] - w).abs().max()) / max(1.0, float(w.abs().max()))
                worst = max(worst, (err, k))
        for k, t in res['state'].items():
            assert torch.equal(t, ranks[0][variant]['state'][k]), k
    print(f'spatial step ({variant}) against the unsharded step: worst {worst[0]:.3e} '
          f'({worst[1]}), limit {tol}')
    assert worst[0] <= tol, worst


def test_spatial_step_equals_the_port_s_unsharded_step(ranks):
    """The model as it is: within ``STATE_TOL`` (the float32 parts'
    rounding, module docstring)."""
    _against_unsharded(ranks, 'as_is', STATE_TOL)


def test_spatial_step_with_float32_parts_in_float64_equals_the_unsharded_step(ranks):
    """The model with its float32 parts computed in float64: within
    ``FLOAT64_TOL`` (1e-10), so that the gap the other test allows is
    those parts' alone."""
    _against_unsharded(ranks, 'float64', FLOAT64_TOL)


@pytest.mark.parametrize('name', [name for name, _ in MORE_MODELS])
def test_spatial_step_through_the_strip_forms_equals_the_unsharded_step(ranks, name):
    """FarSeg++, the SE + GC FarSeg and PSPNet (module docstring): the
    spatial step against the port's unsharded step with the models' float32
    parts in float64 within ``FLOAT64_TOL``, and as they are within
    ``STATE_TOL`` (FarSeg++) or one float32 rounding
    (``POOLED_STATE_TOL``: the SE + GC FarSeg and PSPNet, whose float32
    pooled maps feed running statistics); the ranks' states equal."""
    _against_unsharded(ranks, f'{name}/float64', FLOAT64_TOL)
    _against_unsharded(ranks, name, MORE_STATE_TOL[name])


@pytest.mark.parametrize('model', ['farseg', 'farseg_pp'])
def test_spatial_step_matches_the_jax_spatial_step(ranks, model):
    """Rank 0 against the JAX package's spatial step on 4 devices, for
    FarSeg-R18 and the FarSeg++: ``cls_loss``, ``total_loss``,
    ``grad_norm`` and ``learning_rate``, every parameter and every running
    statistic, at ``tests/test_torch_farseg.py``'s float64 limits."""
    metrics, params, stats = (_jax_spatial() if model == 'farseg' else _jax_spatial_pp())[:3]
    res = ranks[0]['as_is' if model == 'farseg' else 'farseg_pp']
    assert set(res['metrics']) == set(metrics)
    for k, m in metrics.items():
        np.testing.assert_allclose(res['metrics'][k], m, rtol=JAX_LOSS_TOL if 'loss' in k
                                   else 1e-5, err_msg=k)
    for k, w in convert_flax_farseg(params, stats).items():
        got = res['state'][k].numpy()
        if k.endswith(('running_mean', 'running_var')):
            close(got, w.numpy(), JAX_STATS_TOL)
        else:
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=JAX_PARAM_TOL, err_msg=k)


def test_spatial_step_sends_its_halos_and_raises_jax_s_errors(ranks):
    """Each rank sent halos to its neighbours and gradients back (the
    border strips to one, the middle ones to two); a height the axis does
    not divide and a rank-1 leaf raise JAX's errors with its words; a strip
    that a stride does not divide raises, naming the conv."""
    _, _, _, indivisible, rank1 = _jax_spatial()
    for res in ranks:
        stats = res['as_is']['stats']
        assert stats['hops'] > 0 and stats['bytes'] > 0, stats
        assert res['float64']['stats']['hops'] == stats['hops']
        assert res['indivisible'] == indivisible
        assert res['rank1'] == rank1
        assert 'Conv2d (3, 3) (kernel 3, stride 2)' in res['misaligned']
        assert 'got 3 rows a rank' in res['misaligned']
    assert ranks[0]['as_is']['stats']['hops'] < ranks[1]['as_is']['stats']['hops']
    assert ranks[1]['as_is']['stats'] == ranks[2]['as_is']['stats']
