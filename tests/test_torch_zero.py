"""The port's ZeRO-1/3, sharded states and directory checkpoints against
``ever_tpu.parallel.{zero,sharded}`` and ``ever_tpu.core.checkpoint``, on
the CPU.

The placements, leaf by leaf against the JAX package's on its 8-device CPU
mesh (the port's on an 8-rank ``abstract_mesh``): ``shard_leaf_sharding``
on the JAX test's shapes, ``zero_shardings`` at both levels for the JAX
test's FarSeg-R18 and ``sharded_state_shardings`` for a narrow DinoSeg
under AdamW.  Layouts differ (flax ``[kh, kw, in, out]``, torch ``[out,
in, kh, kw]``), so a leaf's placement is compared as whether it is split
and the size of the split dimension: the rule picks the largest divisible
size, which no layout changes.  The leaves are paired through the weight
converters.  Then the ``vit7b16_sat493m`` state on ``meta``.

One job of two gloo ranks (``test_torch_dist.run_ranks`` of
``torch_zero_ranks.worker``, which imports no JAX) runs the rest,
each rank on its half of the global batch of a small conv-BatchNorm net in
float64 registered in both packages: replicated DDP, ZeRO-1 and ZeRO-3, two
SGD steps each against the JAX package's ``zero_init`` +
``build_train_step`` on the same global batch, and two AdamW steps each
bit-equal to the replicated run; the ``orbax`` and ``orbax_async``
directories of a ZeRO-3 state (the same contents; the async step recorded
only after ``wait()``), a sharded restore continuing bit-equal to the
unbroken step, ``remove_optimizer_in_ckpt`` of a directory; and the DCGAN
trained by two ranks against one process.  The same job trains a ViT cut
to 2 blocks replicated and at ZeRO-3, whose step gathers the parameters
block by block: bit-equal with one microbatch (bf16 compute), within 1e-6 (metrics) and
1e-7 (parameters) with two, at most two units' whole tensors held at once,
every rank gathering and reducing the units in one order; and a net whose
third block's output and one root parameter go unused, at ZeRO-3 against
ZeRO-1.  The same job evaluates the small net's state after two steps,
replicated, at ZeRO-1 and at ZeRO-3, through a ``Launcher`` on the mesh
and ``distributed_evaluate_pixel_prediction_task``: the sharded state
raises the JAX launcher's ``local_state()`` error on both ranks (its
message taken from the JAX package here), the others give one process's
predictions.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.core import registry as jregistry
from ever_tpu.interface import ERModule as JERModule
from ever_tpu.module import loss as jloss
from ever_tpu.module import vit as jvit
from ever_tpu.parallel import mesh as jmesh
from ever_tpu.parallel import sharded as jsharded
from ever_tpu.parallel import spmd as jspmd
from ever_tpu.parallel import zero as jzero
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core.checkpoint import CheckPoint, remove_optimizer_in_ckpt
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import sharded as tsharded
from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state
from ever_tpu_torch.parallel.zero import shard_leaf_sharding, zero_init, zero_shardings
from ever_tpu_torch.trainer.gan import build_gan_train_step, create_gan_state
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg, convert_flax_farseg
from test_torch_dist import run_ranks
from torch_zero_ranks import CLASSES, EVAL_BATCH, GAN_IMAGES, N, TorchTiny, _batch, _gan, _rule, \
    _Tiny
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_trainer import TINY

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FARSEG_R18 = dict(   # tests/test_zero.py's model
    encoder=dict(resnet_type='resnet18'), classes=5,
    head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=64),
              fs_relation=dict(scene_embedding_channels=512, in_channels_list=(64, 64, 64, 64),
                               out_channels=64, scale_aware_proj=True),
              fpn_decoder=dict(in_channels=64, out_channels=64,
                               in_feat_output_strides=(4, 8, 16, 32),
                               out_feat_output_stride=4)))


def _placement(spec, shape):
    """(split?, size of the split dimension) of a spec over ``'data'``."""
    dims = [d for d, a in enumerate(spec) if a == 'data']
    return (True, shape[dims[0]]) if dims else (False, None)


def _names(params, convert):
    """{port name: flax path} through ``convert``: each flax leaf filled
    with its index, read back from the converted tensor it lands in."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    filled = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float64) for i, (_, leaf) in enumerate(flat)])
    out = {}
    for name, t in convert(filled).items():
        values = torch.unique(t)
        if len(values) == 1:
            out[name] = jax.tree_util.keystr(flat[int(values[0])][0])
    return out


def _jax_specs(tree):
    return {jax.tree_util.keystr(p): s.spec
            for p, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]}


def test_shard_leaf_sharding_equals_jax():
    jm, tm = jmesh.make_mesh(('data',)), tmesh.abstract_mesh(8)
    for shape in [(), (3, 3, 5, 7), (16,), (3, 3, 16, 64), (64, 16, 3, 3), (4, 8)]:
        want = jzero.shard_leaf_sharding(np.zeros(shape), jm).spec
        got = shard_leaf_sharding(torch.zeros(shape), tm)
        assert tuple(got.spec) == tuple(want), shape
        assert got.is_fully_replicated == (tuple(want) == ())


@functools.lru_cache(maxsize=None)
def _jax_farseg_state():
    """The JAX test's FarSeg-R18 train state under SGD with momentum, as
    shapes (``eval_shape``)."""
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG_R18})
    factory, _ = jbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    jtx = factory.build(0.01)
    x, y = np.zeros((8, 32, 32, 3), np.float32), np.zeros((8, 32, 32), np.int32)
    return jax.eval_shape(lambda: jspmd.create_train_state(jm, jtx, (x, y),
                                                          rng=jax.random.key(0)))


@pytest.mark.parametrize('level', [1, 3])
def test_zero_shardings_equal_jax_leaf_by_leaf(level):
    """The JAX test's FarSeg-R18 under SGD with momentum: each parameter's
    placement and its momentum's, the buffers and the step replicated."""
    jstate = _jax_farseg_state()
    jsh = jzero.zero_shardings(jstate, jmesh.make_mesh(('data',)), level)
    pspec, ospec = _jax_specs(jsh.params), _jax_specs(jsh.opt_state)
    pshape = {jax.tree_util.keystr(p): leaf.shape
              for p, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}

    tm = tbuilder.make_model({'type': 'FarSeg', 'params': FARSEG_R18}, device='cpu')
    tfactory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    tsh = zero_shardings(create_train_state(tm, tfactory.build(0.01)), tmesh.abstract_mesh(8),
                         level)
    names = _names(jstate.params, convert_flax_farseg)
    params = dict(tm.named_parameters())
    assert set(names) == set(params)
    for name, path in names.items():
        shape = params[name].shape
        want = _placement(pspec[path], pshape[path])
        assert _placement(tsh.params[name].spec, shape) == want, name
        mom = [s for k, s in ospec.items() if k.endswith(path)]
        assert len(mom) == 1, (path, len(mom))
        assert _placement(tsh.opt_state[name].spec, shape) == _placement(mom[0], pshape[path])
    assert level == 3 or not any(s.shard_dim is not None for s in tsh.params.values())
    assert all(s.is_fully_replicated for s in tsh.batch_stats.values())
    assert tsh.step.is_fully_replicated and sum(
        s.shard_dim is not None for s in tsh.opt_state.values()) > 40
    with pytest.raises(ValueError, match='level must be 1 or 3'):
        zero_shardings(create_train_state(tm, tfactory.build(0.01)), tmesh.abstract_mesh(8), 2)


@pytest.fixture
def tiny_vit(monkeypatch):
    name, spec = TINY
    monkeypatch.setitem(jvit.VIT_SPECS, name, spec)
    monkeypatch.setitem(tvit.VIT_SPECS, name, spec)


@pytest.mark.parametrize('level', [1, 3])
def test_sharded_state_shardings_equal_jax_leaf_by_leaf(tiny_vit, level):
    """A narrow DinoSeg (2 blocks, width 64) under AdamW, the 1 MiB limit
    cut to 16 KiB as in the JAX test: each parameter and its two moments;
    the counters replicated."""
    cfg = {'type': 'DinoSeg', 'params': dict(backbone=dict(name=TINY[0]), classes=7,
                                             dtype='float32')}
    jm = jbuilder.make_model(cfg)
    import optax
    x = jax.ShapeDtypeStruct((8, 32, 32, 3), jnp.float32)
    y = jax.ShapeDtypeStruct((8, 32, 32), jnp.int32)
    jabs = jsharded.abstract_train_state(jm, optax.adamw(1e-4), (x, y))
    jsh = jsharded.sharded_state_shardings(jabs, jmesh.make_mesh(('data',)), level=level,
                                           min_shard_bytes=1 << 14)
    pspec, ospec = _jax_specs(jsh.params), _jax_specs(jsh.opt_state)
    pshape = {jax.tree_util.keystr(p): leaf.shape
              for p, leaf in jax.tree_util.tree_flatten_with_path(jabs.params)[0]}

    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    tabs = tsharded.abstract_train_state(cfg, factory.build(1e-4))
    assert all(t.device.type == 'meta' for t in tabs.leaves().values())
    tleaf = tsharded.leaf_shardings(tabs, tmesh.abstract_mesh(8), level=level,
                                    min_shard_bytes=1 << 14)
    names = _names(jabs.params, convert_flax_dinoseg)
    assert set(names) == set(tabs.params)
    for name, path in names.items():
        shape = tabs.params[name].shape
        want = _placement(pspec[path], pshape[path])
        assert _placement(tleaf[f'params/{name}'].spec, shape) == want, name
        moments = [s for k, s in ospec.items() if k.endswith(path)]
        assert len(moments) == 2, path
        for key in ('exp_avg', 'exp_avg_sq'):
            assert _placement(tleaf[f'opt_state/{name}/{key}'].spec, shape) == \
                _placement(moments[0], pshape[path]), (name, key)
        assert tleaf[f'opt_state/{name}/step'].is_fully_replicated
    got = tsharded.sharded_state_shardings(tabs, tmesh.abstract_mesh(8), level=level,
                                           min_shard_bytes=1 << 14)
    assert {n: s.spec for n, s in got.params.items()} == \
        {n: tleaf[f'params/{n}'].spec for n in tabs.params}
    # a tp_axis the mesh does not have changes nothing, as in the JAX package
    no_tp = tsharded.sharded_state_shardings(tabs, tmesh.abstract_mesh(8), level=level,
                                             tp_axis='model', min_shard_bytes=1 << 14)
    assert {n: s.spec for n, s in no_tp.params.items()} == \
        {n: s.spec for n, s in got.params.items()}


def test_vit7b_abstract_state_fits_eight_ranks_at_level_3():
    """``vit7b16_sat493m`` under AdamW on ``meta`` (no memory): 6.5-7.0 B
    parameters, every leaf over 64 MiB split, under 12e9 bytes a rank over
    8 ranks of the data axis."""
    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    tabs = tsharded.abstract_train_state(
        {'type': 'DinoSeg', 'params': dict(backbone=dict(name='vit7b16_sat493m'), classes=7,
                                           dtype='bfloat16')}, factory.build(1e-4))
    n_params = sum(t.numel() for t in tabs.params.values())
    assert 6.5e9 < n_params < 7.0e9
    leaves = tsharded.leaf_shardings(tabs, tmesh.abstract_mesh(8), level=3)
    per_rank = 0.0
    for path, t in tabs.leaves().items():
        nbytes = t.numel() * t.element_size()
        split = leaves[path].shard_dim is not None
        assert split or nbytes <= 64 << 20, path
        per_rank += nbytes / (8 if split else 1)
    assert per_rank < 12e9, per_rank


def test_the_layouts_still_to_port_raise_naming_their_item():
    import ever_tpu_torch.parallel as tparallel
    import ever_tpu_torch.parallel.spatial as tspatial
    for name in ('spatial', 'halo_exchange', 'spatial_partition_apply',
                 'build_spatial_train_step', 'build_halo_train_step'):
        assert hasattr(tparallel, name), name
    assert tparallel.spatial is tspatial
    assert 'A.9.5' not in tparallel.__doc__
    hybrid = tmesh.make_hybrid_mesh()           # ported (A.9.3): one process, one node
    assert hybrid.shape == {'replica': 1, 'data': 1}
    m = torch.nn.Linear(2, 2)
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': {}})
    tx = factory.build(0.1)
    with pytest.raises(ValueError, match='requires mesh='):
        build_train_step(m, tx, state_shardings=object())
    with pytest.raises(ValueError, match='abstract mesh'):
        zero_init(create_train_state(m, tx), tmesh.abstract_mesh(2), 1, device='cpu')
    sh = tmesh.batch_sharding(tmesh.make_mesh(), accum_leading=True)
    assert tuple(sh.spec) == (None, 'data') and sh.shard_dim == 1
    batch = tmesh.host_to_global((np.ones((2, 3, 4)), np.zeros((2, 3))), sh)
    assert [tuple(t.shape) for t in batch] == [(2, 3, 4), (2, 3)]


# -- two gloo ranks --------------------------------------------------------------

@jregistry.MODEL.register('torch_zero_tiny')
class JaxTiny(_Tiny, JERModule):
    """``torch_zero_ranks.TorchTiny`` in the JAX package."""

    def setup(self):
        self.conv = fnn.Conv(self.config.width, (3, 3), padding='SAME')
        self.bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
        self.cls = fnn.Conv(CLASSES, (1, 1))

    def __call__(self, x, y=None, train=False):
        logit = self.cls(fnn.relu(self.bn(self.conv(x), use_running_average=not train)))
        return dict(cls_loss=jloss.softmax_ce_loss_with_logits(logit, y)) if train else logit


def _tiny_state_dict(v):
    p, bs = v['params'], v['batch_stats']

    def conv(k):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))

    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    return {'conv.weight': conv(p['conv']['kernel']), 'conv.bias': t(p['conv']['bias']),
            'bn.weight': t(p['bn']['scale']), 'bn.bias': t(p['bn']['bias']),
            'bn.running_mean': t(bs['bn']['mean']), 'bn.running_var': t(bs['bn']['var']),
            'cls.weight': conv(p['cls']['kernel']), 'cls.bias': t(p['cls']['bias'])}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The JAX side (ZeRO-1/3 on the 8-device mesh, SGD, float64) and the
    one-process DCGAN here; the two ranks' results."""
    tmp = tmp_path_factory.mktemp('zero')
    x, y = _batch()
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'torch_zero_tiny', 'params': {}})
        v = jax.jit(lambda a: jm.init({'params': jax.random.key(0)}, a, train=False))(x[:1])
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        torch.save(_tiny_state_dict(v), tmp / 'init.pt')
        jmesh8 = jmesh.make_mesh(('data',))
        data = jmesh.host_to_global((jnp.asarray(x), jnp.asarray(y)),
                                    jmesh.batch_sharding(jmesh8))
        jax_steps = {}
        for level in (1, 3):
            jtx, jsched = _rule(jbuilder, 'sgd')
            st = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                  batch_stats=v['batch_stats'], opt_state=jtx.init(v['params']))
            st, sh = jzero.zero_init(st, jmesh8, level=level)
            step = jspmd.build_train_step(jm, jtx, jsched, mesh=jmesh8, donate=False,
                                          state_shardings=sh)
            jax_steps[level] = []
            for _ in range(2):
                st, m = step(st, data)
                jax_steps[level].append((
                    {k: float(val) for k, val in m.items()},
                    _tiny_state_dict({'params': jax.device_get(st.params),
                                      'batch_stats': jax.device_get(st.batch_stats)})))
    model, txs = _gan()
    gstep, gstate = build_gan_train_step(model, txs), create_gan_state(model, txs)
    for _ in range(2):
        gstate, gm = gstep(gstate, GAN_IMAGES)
    one = ({k: float(val) for k, val in gm.items()}, model.state_dict())
    run_ranks('torch_zero_ranks', 'worker', 2, tmp, tmp, timeout=240)
    return dict(tmp=tmp, jax=jax_steps, gan=one,
                ranks=[torch.load(tmp / f'rank{r}.pt', weights_only=False) for r in range(2)])


@pytest.mark.parametrize('level', [1, 3])
def test_zero_trajectory_matches_jax_zero_init(ranks, level):
    """Two SGD steps (momentum, weight decay, clip, poly) of ZeRO-1/3 over 2
    ranks against JAX's on 8 devices, float64 with the losses' float32
    sums: every tensor (running statistics included) and metric to 1e-6."""
    for (jm, jsd), (tm, tsd) in zip(ranks['jax'][level], ranks['ranks'][0]['sgd', level]['steps']):
        for k in ('cls_loss', 'total_loss', 'grad_norm', 'learning_rate'):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)
        for k, w in jsd.items():
            np.testing.assert_allclose(tsd[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize('opt', ['sgd', 'adamw'])
def test_zero_steps_equal_the_replicated_steps_bit_for_bit(ranks, opt):
    """ZeRO-1 and ZeRO-3 compute what replicated DDP computes, element by
    element: the averaged gradients and their norm are the same, and the
    update is elementwise.  Both ranks end equal; each holds half of every
    split leaf."""
    r0, r1 = ranks['ranks']
    for level in (1, 3):
        for (rm, rsd), (zm, zsd) in zip(r0[opt, 0]['steps'], r0[opt, level]['steps']):
            assert zm == rm
            for k, v in rsd.items():
                assert torch.equal(zsd[k], v), (level, k)
        for k, v in r0[opt, level]['steps'][-1][1].items():
            assert torch.equal(r1[opt, level]['steps'][-1][1][k], v)
    rep, z1, z3 = (r0[opt, level]['bytes'] for level in (0, 1, 3))
    assert z1['opt_state'] <= 0.5 * rep['opt_state'] + 256 and z1['params'] == rep['params']
    assert z3['opt_state'] == z1['opt_state'] and z3['params'] <= 0.5 * rep['params'] + 64


def test_create_train_state_sharded_places_the_host_model_leaf_by_leaf(ranks):
    """A host model placed by ``create_train_state_sharded`` at level 3
    (every divisible leaf split): its weights gathered are the model's,
    its two AdamW steps equal ZeRO-3's of ``zero_init``, no leaf over 200
    bytes is replicated but the buffers, and the replicated state fails
    ``assert_sharded_below``; a launcher's ``local_state`` of it raises,
    as the JAX launcher's does for a sharded state over processes."""
    r0 = ranks['ranks'][0]
    init = torch.load(ranks['tmp'] / 'init.pt')
    for k, v in init.items():
        assert torch.equal(r0['sharded_init'][k], v), k
    for k, v in r0['adamw', 3]['steps'][-1][1].items():
        assert torch.equal(r0['sharded_steps'][k], v), k
    assert 'fully replicated' in r0['replicated_below']
    assert 'sharded (ZeRO?)' in r0['local_state']


@functools.lru_cache(maxsize=None)
def jax_local_state_error() -> str:
    """The message of the JAX launcher's ``local_state()`` for a state whose
    parameters are split over the devices, raised by the JAX method itself
    on a launcher stand-in over the 8-device CPU mesh, as a multi-process
    run has it (``jax.process_count`` 2)."""
    from types import SimpleNamespace

    from jax.sharding import NamedSharding, PartitionSpec

    from ever_tpu.core.launcher import Launcher as JLauncher
    mesh8 = jmesh.make_mesh(('data',))
    split = jax.device_put(jnp.zeros(8), NamedSharding(mesh8, PartitionSpec('data')))
    host = SimpleNamespace(_mesh=mesh8, _local_mesh=mesh8, get_eval_step=lambda local: None,
                           state=SimpleNamespace(step=jnp.zeros(()), params={'w': split},
                                                 batch_stats={}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, 'process_count', lambda: 2)
        with pytest.raises(ValueError) as err:
            JLauncher.local_state(host)
    return str(err.value)


def test_distributed_evaluation_of_a_zero3_state_raises_jax_s_error(ranks):
    """C.5: the distributed evaluation closure on a ZeRO-3 state (its
    parameters split over the two ranks) raises, on both ranks, the
    ``ValueError`` the JAX launcher's ``local_state()`` raises for a state
    split over the processes, with its message."""
    want = jax_local_state_error()
    assert 'needs a replicated train state' in want
    for res in ranks['ranks']:
        assert res['evaluate'][3][1] == ('raised', want)


@pytest.mark.parametrize('level', [0, 1])
def test_distributed_evaluation_of_replicated_and_zero1_states_equals_one_process(ranks,
                                                                                   level):
    """C.5: a replicated (DDP) state and a ZeRO-1 state (its optimizer
    state alone split) evaluate through the distributed closure: the
    ranks' predictions, in rank order, equal one process's forward of the
    same weights on every sample (within float64 rounding), and both ranks
    print the same table of the summed confusion matrix."""
    x, _ = _batch()
    model = TorchTiny().double()
    results = [res['evaluate'][level] for res in ranks['ranks']]
    model.load_state_dict(results[0][0])
    with torch.no_grad():
        want = model(torch.from_numpy(x), train=False)
    got = [b for _, (kind, batches, _) in results for b in batches]
    assert all(kind == 'ok' for _, (kind, *_) in results)
    assert len(got) == N // EVAL_BATCH
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert results[0][1][2] == results[1][1][2]
    for k, v in results[0][0].items():
        assert torch.equal(results[1][0][k], v), k


def test_directory_checkpoints_save_shards_and_resume_bit_equal(ranks):
    """The ``orbax`` and ``orbax_async`` directories of one ZeRO-3 state
    hold the same tensors (read whole here); the async one is recorded
    only after ``wait()``; a sharded restore into a fresh ZeRO-3 state
    resumes at step 2 and its step 3 equals the unbroken run's bit for bit;
    ``remove_optimizer_in_ckpt`` rewrites a directory without ``opt``."""
    tmp, r0 = ranks['tmp'], ranks['ranks'][0]
    sync = CheckPoint.load(str(tmp / 'orbax' / 'checkpoint-2'), device='cpu')
    async_ = CheckPoint.load(str(tmp / 'orbax_async' / 'checkpoint-2'), device='cpu')
    assert sync['global_step'] == async_['global_step'] == 2
    for what in ('model', 'opt'):
        flat = {**{f'model/{k}': v for k, v in sync['model'].items()}} if what == 'model' else {
            f'{n}/{k}': v for n, st in sync['opt']['state'].items() for k, v in st.items()}
        other = {f'model/{k}': v for k, v in async_['model'].items()} if what == 'model' else {
            f'{n}/{k}': v for n, st in async_['opt']['state'].items() for k, v in st.items()}
        assert set(flat) == set(other) and flat
        for k, v in flat.items():
            assert torch.equal(torch.as_tensor(other[k]), torch.as_tensor(v)), k
    assert sync['opt']['state']['conv.weight']['exp_avg'].shape == (16, 3, 3, 3)
    info = r0['async_info_before_wait']
    assert info is None or info['last']['step'] == 0
    assert CheckPoint.load_checkpoint_info(str(tmp / 'orbax_async'))['last'] == \
        dict(step=2, name='checkpoint-2')
    assert r0['resumed_from'] == (True, 2, 2)
    for k, v in r0['unbroken'].items():
        assert torch.equal(r0['resumed'][k], v), k
    remove_optimizer_in_ckpt(str(tmp / 'orbax' / 'checkpoint-2'), str(tmp / 'stripped'),
                             device='cpu')
    stripped = CheckPoint.load(str(tmp / 'stripped'), device='cpu')
    assert set(stripped) == {'model', 'global_step'}
    for k, v in sync['model'].items():
        assert torch.equal(stripped['model'][k], v), k


def test_blockwise_zero3_step_equals_the_replicated_step_bit_for_bit(ranks):
    """Two AdamW steps of a ViT (2 blocks, width 64, bf16 compute) at
    ZeRO-3, gathered a unit at a time, the bf16 weight copies autograd
    saves kept as the parameters and cast again in the backward, against
    replicated DDP: every metric and every tensor equal; both ranks end
    equal."""
    r0, r1 = (r['blockwise'] for r in ranks['ranks'])
    rep, z3 = r0['vit', 1, 0], r0['vit', 1, 3]
    # each block's four matrix weights (saved transposed), two LayerNorm
    # weights and two LayerScales
    assert z3['recast'] == 2 * 8
    assert z3['metrics'] == rep['metrics']
    for k, v in rep['state'].items():
        assert torch.equal(z3['state'][k], v), k
        assert torch.equal(r1['vit', 1, 3]['state'][k], v), k


def test_blockwise_zero3_under_remat_equals_the_replicated_step(ranks):
    """The same with ``remat='full'``: each block's forward runs again in
    the backward inside ``torch.utils.checkpoint``, with the unit gathered
    (the recomputation frees nothing) and checkpoint's own saved-tensor
    hooks left in place (no cast kept as its parameter); bit-equal to
    replicated DDP under remat."""
    r0 = ranks['ranks'][0]['blockwise']
    rep, z3 = r0['vit', 'full', 0], r0['vit', 'full', 3]
    assert z3['recast'] == 0
    assert z3['metrics'] == rep['metrics'] == r0['vit', 1, 0]['metrics']
    for k, v in rep['state'].items():
        assert torch.equal(z3['state'][k], v), k


def test_blockwise_zero3_with_microbatches_matches_within_rounding(ranks):
    """Two microbatches a step (SGD): each unit reduced after each
    microbatch and its slices summed, each tensor's norm from its shards'
    squares summed over the ranks: the metrics within 1e-6 and the
    parameters within 1e-7 of the replicated step's, in float32."""
    r0 = ranks['ranks'][0]['blockwise']
    rep, z3 = r0['vit', 2, 0], r0['vit', 2, 3]
    for want, got in zip(rep['metrics'], z3['metrics']):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    for k, v in rep['state'].items():
        np.testing.assert_allclose(z3['state'][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize('micro', [1, 2])
def test_blockwise_zero3_holds_two_units_in_one_order(ranks, micro):
    """The units are the two blocks and the root; the root is gathered for
    the step, each block before its forward and again before its backward,
    and reduced once a microbatch as its backward ends (the last block
    first); the whole bytes held at once stay within two units' parameters
    and gradients, under half of the whole model's; both ranks log the same
    order."""
    r0, r1 = (r['blockwise']['vit', micro, 3] for r in ranks['ranks'])
    assert r0['units'] == ['vit.blocks.0', 'vit.blocks.1', '']
    one = [('gather', 'vit.blocks.0'), ('gather', 'vit.blocks.1'), ('gather', 'vit.blocks.1'),
           ('reduce', 'vit.blocks.1'), ('gather', 'vit.blocks.0'), ('reduce', 'vit.blocks.0'),
           ('reduce', '')]
    assert r0['log'] == [('gather', '')] + one * micro
    assert r1['log'] == r0['log']
    assert 0 < r0['peak'] <= r0['budget'] < 0.7 * r0['whole']


def test_units_with_unused_outputs_reduce_in_one_order(ranks):
    """A ModuleList's children are the units; the third block's output and
    the root's ``extra`` go unused, so their gradients count as zeros (as at
    ZeRO-1) and their reductions run after the backward, in unit order,
    the root last, on both ranks: two AdamW steps equal ZeRO-1's bit for
    bit."""
    r0, r1 = (r['blockwise'] for r in ranks['ranks'])
    assert r0['unit_names'] == ['blocks.0', 'blocks.1', 'blocks.2']
    assert r0['units', 3]['log'][-2:] == [('reduce', 'blocks.2'), ('reduce', '')]
    assert r0['units', 3]['log'] == r1['units', 3]['log']
    assert r0['units', 3]['metrics'] == r0['units', 1]['metrics']
    for k, v in r0['units', 1]['state'].items():
        assert torch.equal(r0['units', 3]['state'][k], v), k
    assert not torch.equal(r0['units', 3]['state']['extra'], torch.ones(4, 2, dtype=torch.float64))


def test_dcgan_on_two_ranks_matches_one_process(ranks):
    """Two Adam steps of both roles with a global batch of 8, 4 a rank:
    the global BatchNorm statistics, each rank's rows of the global
    latent draw and each role's averaged gradients; float64, to 1e-9."""
    want_m, want_sd = ranks['gan']
    for res in ranks['ranks']:
        got_m, got_sd = res['gan']
        assert set(got_m) == set(want_m)
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], v, rtol=1e-9, err_msg=k)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=k)
