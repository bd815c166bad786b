"""The port's meshes of named axes (``ever_tpu_torch.parallel.mesh``) against
``ever_tpu.parallel.mesh``, and a step under tensor parallel with ZeRO-3
on a 2-D mesh against the JAX step, on the CPU.

In one process: ``make_hybrid_mesh`` degrades to a dcn axis of 1 as the
JAX one does on one slice; a 2-D abstract mesh's placements.  One job of
four gloo ranks (``torch_layout_ranks.mesh_worker``, which imports no JAX)
runs the rest: a ``('data', 'model')`` mesh of (2, 2) laid out row-major
as JAX lays out devices, each axis's groups; the hybrid mesh on one node
and on two (``LOCAL_WORLD_SIZE=2``); and one SGD step with a clip of a
DinoSeg on ``vit_small``'s width cut to 2 blocks, from
``create_train_state_sharded(level=3, tp_axis='model')``
(``tests/test_sharded_init.py``'s state, the 1 MiB
limit cut to 16 KiB), each data rank on its half of the batch, against the
JAX package's step on the whole batch (one device: GSPMD computes the
unsharded step).  The state after that step is written as directories
(``CheckPoint.save_sharded`` and the ``orbax``/``orbax_async`` backends:
each rank its shards, the tensor-parallel leaves over both axes), read
whole here against ``full_state_dict`` and against the JAX state
``save_sharded``/``restore_sharded`` round-trips (the step test's limits),
and restored into fresh states whose next step equals the unbroken run's
bit for bit (``tests/test_sharded_init.py:36-87``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import vit as jvit
from ever_tpu.parallel import mesh as jmesh
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# vit_small's width and heads, cut to 2 blocks
SPEC = ('vit_small_d2', (2, 384, 6, 4.0, 'mlp'))
CFG = {'type': 'DinoSeg', 'params': dict(backbone=dict(name=SPEC[0]), classes=7,
                                         dtype='float32')}
LR, MAX_NORM = 0.5, 0.25
# one float32 step: the metrics, and each tensor's update against its
# largest element plus one float32 ulp of the tensor's largest value (the
# split products and the all-reduces add in another order than one device,
# and a parameter near 1 rounds its update to 2^-23)
METRIC_RTOL, UPDATE_TOL = 1e-5, 1e-3


def test_hybrid_mesh_single_node_degrades_as_jax():
    """One node: the dcn axis leads with size 1, the ICI axes follow, as
    JAX's on one slice; the batch axes are the dcn and data axes."""
    want = jmesh.make_hybrid_mesh(('data',))
    got = tmesh.make_hybrid_mesh(('data',))
    assert got.axis_names == want.axis_names == ('replica', 'data')
    assert got.shape == {'replica': 1, 'data': 1} and want.shape['replica'] == 1
    assert got.batch_axes == ('replica', 'data') and got.size() == 1
    two = tmesh.make_hybrid_mesh(('data', 'model'), ici_shape=(1, 1))
    assert two.axis_names == jmesh.make_hybrid_mesh(('data', 'model'), (4, 2)).axis_names
    with pytest.raises(ValueError, match='does not cover'):
        tmesh.make_hybrid_mesh(('data', 'model'), ici_shape=(2, 1))


def test_placements_on_a_2d_abstract_mesh():
    """On (4, 2): a spec's placements one per axis, its batch dimension the
    one split over 'data', full replication only when no split axis has
    more than one rank; ``batch_sharding`` splits the data axis."""
    mesh = tmesh.abstract_mesh((4, 2), ('data', 'model'))
    assert mesh.shape == {'data': 4, 'model': 2} and mesh.size() == 4 and mesh.abstract
    sh = tmesh.NamedSharding(mesh, tmesh.P('model', 'data'))
    assert [str(p) for p in sh.placements] == ['S(1)', 'S(0)'] and sh.shard_dim == 1
    assert not sh.is_fully_replicated
    model_only = tmesh.NamedSharding(mesh, tmesh.P('model', None))
    assert model_only.shard_dim is None and not model_only.is_fully_replicated
    assert tmesh.NamedSharding(tmesh.abstract_mesh((4, 1), ('data', 'model')),
                               tmesh.P('model')).is_fully_replicated
    assert tmesh.batch_sharding(mesh, accum_leading=True).shard_dim == 1
    with pytest.raises(ValueError, match='does not match'):
        tmesh.abstract_mesh((4, 2))
    with pytest.raises(ValueError, match='unknown mesh axis'):
        mesh.axis_size('pipe')


@functools.lru_cache(maxsize=None)
def _jax_state():
    """The JAX step's model, initial state (key 0) and batch."""
    model = jbuilder.make_model(CFG)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 7, size=(8, 32, 32)).astype(np.int32)
    factory, _ = jbuilder.make_optimizer(dict(type='sgd', params=dict(momentum=0.9)))
    tx = factory.build(LR, grad_clip=dict(max_norm=MAX_NORM))
    state = jax.jit(lambda: jspmd.create_train_state(model, tx, (x, y), rng=jax.random.key(0)))()
    return model, tx, state, x, y


@functools.lru_cache(maxsize=None)
def _jax_step():
    model, tx, state, x, y = _jax_state()
    step = jspmd.build_train_step(model, tx, None, donate=False)
    new, metrics = step(state, (x, y))
    return {k: float(v) for k, v in metrics.items()}, jax.device_get(new.params), new


@pytest.fixture(scope='module', autouse=True)
def narrow_vit():
    """``SPEC`` in both packages' ``VIT_SPECS`` while the module's tests run."""
    from ever_tpu_torch.module import vit as tvit
    for specs in (jvit.VIT_SPECS, tvit.VIT_SPECS):
        specs[SPEC[0]] = SPEC[1]
    yield
    for specs in (jvit.VIT_SPECS, tvit.VIT_SPECS):
        del specs[SPEC[0]]


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory, narrow_vit):
    """The mesh job's four ranks, started before the module's first test;
    killed at the end if still running."""
    tmp = tmp_path_factory.mktemp('mesh')
    _, _, state, x, y = _jax_state()
    torch.save(dict(cfg=CFG, spec=SPEC, state_dict=convert_flax_dinoseg(
        jax.device_get(state.params)), x=x, y=y, lr=LR, max_norm=MAX_NORM,
        min_shard_bytes=1 << 14), tmp / 'mesh-inputs.pt')
    ranks = start_ranks('torch_layout_ranks', 'mesh_worker', 4, tmp, tmp)
    yield tmp, ranks
    ranks.kill()


def _jax_round_trip(tmp):
    """The JAX state after its step, written by the JAX package's
    ``CheckPoint.save_sharded`` and read back by ``restore_sharded``: its
    parameters as the port's ``state_dict``."""
    from ever_tpu.core.checkpoint import CheckPoint as JCheckPoint
    _, _, new = _jax_step()
    d = str(tmp / 'jax_sharded')
    JCheckPoint.save_sharded(d, new)
    restored = JCheckPoint.restore_sharded(
        d, jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), new),
        jax.tree.map(lambda a: a.sharding, new))
    return convert_flax_dinoseg(jax.device_get(restored.params))


@pytest.fixture(scope='module')
def ranks(job):
    tmp, started = job
    round_trip = _jax_round_trip(tmp)           # while the ranks run
    started.finish(timeout=150)
    out = [torch.load(tmp / f'mesh-rank{r}.pt', weights_only=False) for r in range(4)]
    out[0].update(tmp=tmp, jax_round_trip=round_trip)
    return out


def test_2d_mesh_lays_out_ranks_row_major_with_a_group_a_line(ranks):
    """Rank ``r`` of a (2, 2) ('data', 'model') mesh sits at (r // 2, r %
    2), as JAX's ``reshape`` of the device list: its data line is {r % 2,
    2 + r % 2} and its model line {2·(r // 2), 2·(r // 2) + 1}, each group
    summing exactly those ranks; the batch axes are ('data',); a shape that
    does not cover the world raises."""
    for r, res in enumerate(ranks):
        d, m = divmod(r, 2)
        data, model = (m, 2 + m), (2 * d, 2 * d + 1)
        assert res['groups']['data'] == (float(sum(data)), d, data)
        assert res['groups']['model'] == (float(sum(model)), m, model)
        assert res['batch'] == (('data',), d, 2)
        assert 'does not cover 4' in res['bad_shape']


def test_hybrid_mesh_puts_nodes_on_the_dcn_axis(ranks):
    """One node of four: ('replica', 'data', 'model') of (1, 2, 2), a
    batch of 2 ranks.  Two nodes of two (``LOCAL_WORLD_SIZE=2``): ranks 0-1
    on replica 0 and 2-3 on replica 1, the batch axes (replica, data) over
    all four ranks."""
    for r, res in enumerate(ranks):
        names, shape, batch, size = res['hybrid_one_node']
        assert names == ('replica', 'data', 'model') and batch == ('replica', 'data')
        assert shape == {'replica': 1, 'data': 2, 'model': 2} and size == 2
        shape, replica, batch_rank, size, groups = res['hybrid_two_nodes']
        assert shape == {'replica': 2, 'data': 2} and size == 4
        assert (replica, batch_rank) == (r // 2, r)
        assert groups['replica'][0] == float(r % 2 + 2 + r % 2)
        assert groups['data'][0] == float(4 * (r // 2) + 1)


def test_tp_zero3_step_matches_the_jax_step(ranks):
    """One SGD step (lr 0.5, momentum 0.9, whose first step is plain SGD;
    clip at 0.25, which binds) of the TP + ZeRO-3
    state over (2, 2): the loss, the pre-clip gradient norm (each shard and
    each replicated leaf counted once) and every parameter's update against
    the JAX step on the whole batch; every rank ends with the same whole
    state."""
    metrics, params, _ = _jax_step()
    _, _, state, _, _ = _jax_state()
    before = convert_flax_dinoseg(jax.device_get(state.params))
    after = convert_flax_dinoseg(params)
    assert metrics['grad_norm'] > MAX_NORM
    for res in ranks:
        for k in ('cls_loss', 'total_loss', 'grad_norm'):
            np.testing.assert_allclose(res['metrics'][k], metrics[k], rtol=METRIC_RTOL,
                                       err_msg=k)
        for k, w in after.items():
            want = (w - before[k]).numpy()
            got = (res['state'][k] - before[k]).numpy()
            ulp = 2.0 ** -23 * float(w.abs().max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=UPDATE_TOL * np.abs(want).max() + ulp, err_msg=k)
    for k, v in ranks[0]['state'].items():
        for res in ranks[1:]:
            assert torch.equal(res['state'][k], v), k


@pytest.mark.parametrize('how', ['sharded', 'orbax'])
def test_tp_zero3_directory_resumes_bit_equal(ranks, how):
    """A fresh TP + ZeRO-3 state restored from the directory of the state
    after step 1 (``restore_sharded``, or ``try_resume`` of the ``orbax``
    backend) resumes at step 1; its step 2 (the momentum buffers, split
    over both axes, restored too) equals the unbroken run's bit for bit on
    every rank."""
    for res in ranks:
        at, metrics, state = res[f'resumed/{how}']
        want_metrics, want = res['unbroken']
        assert at == 1 and metrics == want_metrics
        for k, v in want.items():
            assert torch.equal(state[k], v), k


def test_tp_zero3_directory_reads_whole(ranks):
    """``CheckPoint.load`` of the directories in one process: the model's
    tensors in its own shapes (qkv ``[3D, in]``) equal to
    ``full_state_dict``, the same tensors in the ``orbax`` and
    ``orbax_async`` directories, each momentum buffer in its parameter's
    shape; the tensors within the step test's limits of the JAX state
    after its step, written and read back by the JAX package's
    ``save_sharded``/``restore_sharded``."""
    from ever_tpu_torch.core.checkpoint import CheckPoint
    job_tmp = ranks[0]['tmp']
    whole = CheckPoint.load(str(job_tmp / 'mesh-sharded'), device='cpu')
    assert whole['global_step'] == 1
    want = ranks[0]['state']
    assert set(whole['model']) == set(want)
    for k, v in want.items():
        assert torch.equal(whole['model'][k], v), k
    assert whole['model']['vit.blocks.0.attn.qkv.weight'].shape == (3 * 384, 384)
    for backend in ('orbax', 'orbax_async'):
        other = CheckPoint.load(str(job_tmp / f'mesh-{backend}' / 'checkpoint-1'), device='cpu')
        for k, v in whole['model'].items():
            assert torch.equal(other['model'][k], v), (backend, k)
        for n, st in whole['opt']['state'].items():
            assert torch.equal(other['opt']['state'][n]['momentum_buffer'],
                               st['momentum_buffer']), (backend, n)
    for n, st in whole['opt']['state'].items():
        assert st['momentum_buffer'].shape == want[n].shape, n

    _, _, state, _, _ = _jax_state()
    before = convert_flax_dinoseg(jax.device_get(state.params))
    for k, w in ranks[0]['jax_round_trip'].items():
        want_update = (w - before[k]).numpy()
        got = (whole['model'][k] - before[k]).numpy()
        ulp = 2.0 ** -23 * float(w.abs().max())
        np.testing.assert_allclose(got, want_update, rtol=0,
                                   atol=UPDATE_TOL * np.abs(want_update).max() + ulp, err_msg=k)


def test_tp_zero3_state_splits_over_both_axes(ranks):
    """The TP leaves split over 'model' and, at level 3, over 'data' on
    their largest other dimension; a rank holds a quarter of their bytes."""
    specs = ranks[0]['specs']
    assert specs['vit.blocks.0.attn.qkv.weight'] == ('model', 'data')
    assert specs['vit.blocks.0.attn.proj.weight'] == ('data', 'model')
    assert specs['vit.blocks.0.mlp.fc1.weight'] == ('model', 'data')
    assert specs['vit.blocks.0.norm1.weight'] == ()
    assert len([s for s in specs.values() if 'model' in s]) == 2 * 4
    whole = sum(t.numel() * 4 for t in ranks[0]['state'].values())
    for res in ranks:
        assert res['bytes']['params'] < 0.3 * whole
