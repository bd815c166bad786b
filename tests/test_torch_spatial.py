"""The port's spatial layouts (``ever_tpu_torch.parallel.spatial``) against
``ever_tpu.parallel.spatial``, on the CPU.

One job of four gloo ranks (``torch_spatial_ranks.primitives_worker``,
which imports no JAX) is started before the module's first test and runs
every case on an axis of 4 ranks (a middle strip has two neighbours) and on
the 2-rank ``'data'`` axis of a ``('pair', 'data')`` mesh of (2, 2), while
this process computes the JAX side on meshes of 4 and 2 CPU devices:

- ``halo_exchange`` and ``halo_exchange_exact`` under ``shard_map``: the
  padded strips, ``crop_start`` and the input's gradient of a probe loss
  (``jax.grad`` through JAX's ``ppermute``s), bit for bit: the inputs and
  probes are small integers, so every sum of halo gradients is exact;
- ``spatial_partition_apply`` of ``tests/test_spatial.py``'s conv stack
  (both boundaries, halo 0, a one-rank axis) at that file's limits, and
  JAX's four errors;
- ``build_halo_train_step`` (both boundaries, SGD with momentum) at
  ``tests/test_spatial_train.py``'s limits;
- two steps of ``build_spatial_train_step`` on a float64 net through the
  strip forms FarSeg does not reach (``torch_spatial_ranks.OpsNet``)
  against the port's unsharded step, within 1e-10; the global pool of the
  strips against the whole tile's;
- the strip forms of the other reductions over the tile
  (``torch_spatial_ranks.STRIP_FORMS``: GroupNorm, the SE and MBConv
  squeezes, the context block's two pools, the adaptive pools to 2, 3 and
  6 bins with the pyramid's upsample of the whole pooled map, a pyramid
  bin) against the same modules on the whole tile: values and input
  gradients;
- the ops whose strip output would not be the strip's share of the whole
  tile's (uneven strips): each raises under the strip context, naming
  itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from ever_tpu.parallel import spatial as jspatial
from ever_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import spatial as tspatial
from test_spatial import _ConvStack
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401
from torch_spatial_ranks import POOLS, STRIP_FORMS, OpsNet, ops_step, pools, strip_forms

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLDS = (2, 4)
HALO = 3                                    # 2·halo = the whole strip under 'exact'
STRIP, WIDTH, CHANNELS = 6, 5, 2           # the primitives' strips: [1, 6, 5, 2]
# tests/test_spatial.py's tile, halos and limits
TILE = (1, 128, 64, 3)
PARTITION = (('exact', 8), ('zeros', 8), ('exact', 0))
PARTITION_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_spatial_train.py's halo step and its 'exact' limits
TRAIN_HALO = 8
LOSS_TOL, PARAM_TOL = dict(rtol=1e-6, atol=1e-7), dict(rtol=1e-5, atol=1e-6)
# OpsNet computes in float64 throughout but for the cross-entropy's float32
# sums (its value; the per-pixel gradients are the same computation on the
# same float32 logits): the state within 1e-10 of max(1, |value|), the loss
# within float32 rounding
OPS_TILE, OPS_TOL, OPS_LOSS_TOL = (1, 64, 24, 3), 1e-10, 1e-6
# the pools accumulate in float32 (as the JAX package's do): the strips'
# sums added over the axis against one sum, within float32 rounding; their
# gradients (the probe over the bin's count, in float32) exactly
POOL_TILE, POOL_TOL = (2, 24, 10, 3), dict(rtol=1e-6, atol=1e-7)
# the strip forms' NCHW tile (strips of 12 and 6 rows), float64; GroupNorm
# and the context block's softmax pool compute in float64 (OPS_TOL of
# max(1, |value|)), the others pool in float32 as the JAX package's pools
# do (POOL_TOL: the strips' sums added over the axis against one sum)
FORM_TILE = (2, 8, 24, 10)
FORM_FLOAT64 = ('GroupNorm2d', 'ContextBlock2d att')


def _jax_mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ('data',))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    model = _ConvStack()
    tile = rng.normal(size=TILE).astype(np.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), jnp.asarray(tile))['params'])
    train = (rng.normal(size=TILE).astype(np.float32),
             rng.normal(size=TILE[:3]).astype(np.float32))
    ops_x = rng.normal(size=OPS_TILE)
    ops_y = rng.integers(0, 3, size=OPS_TILE[:3])
    ops_y[0, :3, :4] = 255
    torch.manual_seed(0)
    ops_state = {k: v.clone() for k, v in OpsNet().double().state_dict().items()}
    pool_x = rng.normal(size=POOL_TILE)
    pool_probes = {name: rng.normal(size=(POOL_TILE[0],) + (size or (1, 1)) + POOL_TILE[3:])
                   for name, size in POOLS}
    form_x = rng.normal(size=FORM_TILE)
    form_probes = {name: rng.normal(size=_form_shape(name)) for name, _ in STRIP_FORMS}
    return (model, tile, params, train, (ops_x, ops_y), ops_state, (pool_x, pool_probes),
            (form_x, form_probes))


def _form_shape(name: str) -> tuple:
    """The whole tile's output shape of a strip form's case."""
    n, c, h, w = FORM_TILE
    if name.startswith('adaptive_avg_pool'):
        b = int(name.split()[-1].rstrip(')'))
        return (n, c, b, b)
    return (n, 4 if name.startswith('PoolBlock') else c, h, w)


@functools.lru_cache(maxsize=None)
def _primitive_inputs(world):
    """Integer-valued strips and probes (every sum of them exact)."""
    rng = np.random.default_rng(world)
    x = rng.integers(-4, 5, size=(1, world * STRIP, WIDTH, CHANNELS)).astype(np.float32)
    probes = {name: rng.integers(-3, 4, size=(world, 1, STRIP + 2 * HALO, WIDTH, CHANNELS))
              .astype(np.float32) for name in ('zeros', 'exact')}
    return dict(x=x, probes=probes)


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory):
    """The job's four ranks, started before the module's first test (every
    case runs on an axis of 4 and on one of 2: module docstring); killed at
    the end if still running."""
    (_, tile, params, train, (ops_x, ops_y), ops_state, (pool_x, pool_probes),
     (form_x, form_probes)) = _inputs()
    tmp = tmp_path_factory.mktemp('spatial')
    torch.save(dict(cases={k: _primitive_inputs(k) for k in WORLDS}, halo=HALO, tile=tile,
                    params=params, width=8, depth=3, partition=PARTITION, train_x=train[0],
                    train_y=train[1], train_halo=TRAIN_HALO, ops_x=ops_x, ops_y=ops_y,
                    ops_state=ops_state, pool_x=pool_x, pool_probes=pool_probes,
                    form_x=form_x, form_probes=form_probes),
               tmp / 'prim-inputs.pt')
    started = start_ranks('torch_spatial_ranks', 'primitives_worker', 4, tmp, tmp)
    yield tmp, started
    started.kill()


@pytest.fixture(scope='module')
def ranks(job):
    """{axis size k: [each rank's results on an axis of k, by its
    coordinate]}; the two lines of the (2, 2) mesh computed the same."""
    for k in WORLDS:                                # while the ranks run
        _jax_primitives(k)
        _jax_partition(k)
        for boundary in ('exact', 'zeros'):
            _jax_halo_step(k, boundary)
    _jax_partition(1, (('exact', 4),))
    _ops_unsharded()
    _forms_whole()
    tmp, started = job
    started.finish(timeout=120)
    res = [torch.load(tmp / f'prim-rank{r}.pt', weights_only=False) for r in range(4)]
    for r in (2, 3):
        a, b = res[r][2]['exact'][0], res[r - 2][2]['exact'][0]
        assert torch.equal(a, b), r
    return {4: [res[r][4] for r in range(4)], 2: [res[r][2] for r in range(2)]}


@functools.lru_cache(maxsize=None)
def _jax_primitives(world):
    """{'zeros'|'exact': (padded strips, crop starts or None, input gradient)}
    of JAX's primitives under ``shard_map`` on ``world`` devices."""
    case = _primitive_inputs(world)
    x = jnp.asarray(case['x'])
    mesh = _jax_mesh(world)
    out = {}

    def zeros(a):
        return jspatial.halo_exchange(a, HALO, 'data'), jnp.zeros((1,), jnp.int32)

    def exact(a):
        padded, start = jspatial.halo_exchange_exact(a, HALO, 'data')
        return padded, jnp.reshape(start, (1,)).astype(jnp.int32)

    for name, fn in (('zeros', zeros), ('exact', exact)):
        f = shard_map(fn, mesh=mesh, in_specs=JP(None, 'data'),
                      out_specs=(JP(None, 'data'), JP('data')))
        probe = np.concatenate(list(case['probes'][name]), axis=1)

        def loss(a):
            padded, start = f(a)
            return jnp.sum(padded * probe), (padded, start)

        grad, (padded, start) = jax.jit(jax.grad(loss, has_aux=True))(x)
        out[name] = (np.asarray(padded), np.asarray(start) if name == 'exact' else None,
                     np.asarray(grad))
    return out


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['zeros', 'exact'])
def test_halo_primitives_equal_jax_bit_for_bit(ranks, world, name):
    """Each rank's padded strip, its ``crop_start`` and its rows of the
    input gradient equal JAX's exactly."""
    padded, start, grad = _jax_primitives(world)[name]
    rows = STRIP + 2 * HALO
    for r, res in enumerate(ranks[world]):
        got, got_start, got_grad = res[name]
        np.testing.assert_array_equal(got.numpy(), padded[:, r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(got_grad.numpy(), grad[:, r * STRIP:(r + 1) * STRIP])
        if name == 'exact':
            assert got_start == int(start[r]) == (0 if r == 0 else 2 * HALO
                                                  if r == world - 1 else HALO)
    assert 'outside a mesh' in ranks[world][0]['outside_mesh']


@functools.lru_cache(maxsize=None)
def _jax_partition(world, cases=PARTITION):
    """{(boundary, halo): the JAX function's output} on ``world`` devices,
    every case in one program."""
    model, tile, params = _inputs()[:3]
    mesh = _jax_mesh(world)
    outs = jax.jit(lambda t: [jspatial.spatial_partition_apply(
        lambda a: model.apply({'params': params}, a), t, mesh, axis='data', halo=halo,
        boundary=boundary) for boundary, halo in cases])(jnp.asarray(tile))
    return {case: np.asarray(y) for case, y in zip(cases, outs)}


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('boundary,halo', PARTITION)
def test_spatial_partition_apply_matches_jax(ranks, world, boundary, halo):
    """Each rank's strip of the output (a ``DTensor`` on dimension 1, as
    ``host_to_global`` gives) against the JAX function's rows, at
    ``tests/test_spatial.py``'s limits."""
    want = _jax_partition(world)[boundary, halo]
    h = TILE[1] // world
    for r, res in enumerate(ranks[world]):
        kind, got = res['partition', boundary, halo]
        assert kind == 'DTensor' and tuple(got.shape) == (1, h, TILE[2], 4)
        np.testing.assert_allclose(got.numpy(), want[:, r * h:(r + 1) * h], **PARTITION_TOL)


@pytest.mark.parametrize('world', WORLDS)
def test_spatial_partition_on_a_one_rank_axis_is_the_plain_forward(ranks, world):
    """A one-rank axis of a 2-D mesh: the whole tile through ``fn``, as
    JAX's one-device mesh gives it."""
    want = _jax_partition(1, (('exact', 4),))['exact', 4]
    for res in ranks[world]:
        kind, got = res['one_rank']
        assert kind == 'Tensor'
        np.testing.assert_allclose(got.numpy(), want, **PARTITION_TOL)


@pytest.mark.parametrize('kw', [dict(shape=(1, 100, 16, 3)), dict(boundary='bogus'),
                                dict(halo=-1), dict(halo=8, boundary='exact'),
                                dict(halo=9, boundary='zeros')],
                         ids=['indivisible', 'boundary', 'negative', 'exact', 'zeros'])
def test_spatial_partition_raises_jax_s_errors(kw):
    """JAX's four ``ValueError``s, with its words, on 8 ranks (an abstract
    mesh: the checks come before any exchange) and 8 devices."""
    kw = dict(kw)
    x = np.ones(kw.pop('shape', (1, 64, 16, 3)), np.float32)
    with pytest.raises(ValueError) as want:
        jspatial.spatial_partition_apply(lambda t: t, jnp.asarray(x), jax_make_mesh(('data',)),
                                         **kw)
    with pytest.raises(ValueError) as got:
        tspatial.spatial_partition_apply(lambda t: t, x, tmesh.abstract_mesh(8), device='cpu',
                                         **kw)
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _jax_halo_step(world, boundary):
    model, _, params, (x, y) = _inputs()[:4]
    tx = optax.sgd(0.05, momentum=0.9)
    step = jspatial.build_halo_train_step(lambda p, t: model.apply({'params': p}, t),
                                          lambda o, t: jnp.mean((o - t[..., None]) ** 2), tx,
                                          _jax_mesh(world), axis='data', halo=TRAIN_HALO,
                                          boundary=boundary)
    (it, new, _), metrics = step((jnp.zeros((), jnp.int32), params, tx.init(params)),
                                 (jnp.asarray(x), jnp.asarray(y)))
    return int(it), float(metrics['total_loss']), jax.device_get(new)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('boundary', ['exact', 'zeros'])
def test_halo_train_step_matches_jax(ranks, world, boundary):
    """One SGD + momentum step of the conv stack through both packages'
    halo steps: the loss and every updated parameter on every rank, at
    ``tests/test_spatial_train.py``'s limits; each rank sent one halo to
    each neighbour (``2·halo`` rows of [1, ·, 64, 3] under 'exact', ``halo``
    under 'zeros'), and no gradient back: the input needs none."""
    it, loss, params = _jax_halo_step(world, boundary)
    for r, res in enumerate(ranks[world]):
        got_it, got_loss, got, stats = res['halo_step', boundary]
        assert got_it == it == 1
        np.testing.assert_allclose(got_loss, loss, **LOSS_TOL)
        for i in range(4):
            name = f'c{i}' if i < 3 else 'out'
            key = f'convs.{i}' if i < 3 else 'out'
            np.testing.assert_allclose(got[f'{key}.weight'].numpy(),
                                       np.transpose(params[name]['kernel'], (3, 2, 0, 1)),
                                       **PARAM_TOL, err_msg=key)
            np.testing.assert_allclose(got[f'{key}.bias'].numpy(), params[name]['bias'],
                                       **PARAM_TOL, err_msg=key)
        neighbours = (r > 0) + (r < world - 1)
        rows = 2 * TRAIN_HALO if boundary == 'exact' else TRAIN_HALO
        assert stats == dict(hops=neighbours,
                             bytes=neighbours * rows * TILE[2] * TILE[3] * 4), stats


@functools.lru_cache(maxsize=None)
def _ops_unsharded():
    (x, y), state = _inputs()[4:6]
    model = OpsNet().double()
    model.load_state_dict(state)
    return ops_step(model, (torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.parametrize('world', WORLDS)
def test_spatial_step_of_the_ops_net_equals_the_unsharded_step(ranks, world):
    """Two spatial steps of ``OpsNet`` (float64: convs with symmetric,
    lax-``'SAME'`` and dilated padding, BatchNorm, max and average pools,
    element dropout, nearest resizes) on
    every rank against the port's unsharded steps: the state within 1e-10
    of max(1, |value|), the metrics within the loss's float32 rounding."""
    want_metrics, want = _ops_unsharded()
    for res in ranks[world]:
        metrics, state = res['ops']
        for got_m, want_m in zip(metrics, want_metrics):
            assert set(got_m) == set(want_m)
            for k in want_m:
                np.testing.assert_allclose(got_m[k], want_m[k], rtol=OPS_LOSS_TOL, err_msg=k)
        for k, w in want.items():
            scale = max(1.0, float(w.abs().max()))
            err = float((state[k].double() - w.double()).abs().max())
            assert err <= OPS_TOL * scale, (k, err)


@pytest.mark.parametrize('world', WORLDS)
def test_global_and_adaptive_pools_sum_over_the_strips(ranks, world):
    """``global_avg_pool`` and ``adaptive_avg_pool`` to (1, 1) bins of each
    rank's strip under the strip context: the whole tile's pooled values on
    every rank (``POOL_TOL``), and each strip's rows of the input gradient
    of ``Σ pooled·probe``, which every rank's loss reaches ``world`` times
    over (the sum's gradient is the ranks' sum; DDP's average divides it
    out in a step), exactly.  Other bins: the strip forms' test."""
    x, probes = _inputs()[6]
    want = pools(torch.from_numpy(x), probes)
    h = POOL_TILE[1] // world
    for r, res in enumerate(ranks[world]):
        for name, _ in POOLS:
            y, grad = res['pools'][name]
            wy, wgrad = want[name]
            np.testing.assert_allclose(y.numpy(), wy.numpy(), **POOL_TOL, err_msg=name)
            np.testing.assert_array_equal((grad / world).numpy(),
                                          wgrad[:, r * h:(r + 1) * h].numpy(), err_msg=name)


@functools.lru_cache(maxsize=None)
def _forms_whole():
    """The strip forms' cases on the whole tile, in one process."""
    x, probes = _inputs()[7]
    return strip_forms(torch.from_numpy(x), probes)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name,is_whole', STRIP_FORMS, ids=[n for n, _ in STRIP_FORMS])
def test_strip_forms_equal_the_op_on_the_whole_tile(ranks, world, name, is_whole):
    """Each reduction over the tile under the strip context against the
    same module on the whole tile: a strip's output is its rows of the
    whole output and its gradient of ``Σ output·probe`` (the probe's rows)
    its rows of the whole gradient; a whole output (the pooled map) is the
    whole tile's on every rank, and the gradient of ``Σ pooled·probe``,
    which every rank's loss reaches ``world`` times over, is ``world``
    times the strip's rows of it.  float64 cases within ``OPS_TOL`` of
    max(1, |value|), the float32 pools within ``POOL_TOL``."""
    want_y, want_g = _forms_whole()[name]
    h = FORM_TILE[2] // world
    for r, res in enumerate(ranks[world]):
        y, g = res['strip_forms'][name]
        rows = slice(r * h, (r + 1) * h)
        pairs = ((y, want_y if is_whole else want_y[:, :, rows]),
                 (g / world if is_whole else g, want_g[:, :, rows]))
        for got, want in pairs:
            assert got.shape == want.shape, (name, got.shape, want.shape)
            if name in FORM_FLOAT64:
                scale = max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= OPS_TOL * scale, name
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL, err_msg=name)


@pytest.mark.parametrize('world', WORLDS)
def test_ops_without_a_strip_form_raise_naming_themselves(ranks, world):
    """Under the strip context every op of ``torch_spatial_ranks.refusals``
    whose strip output would not be its share of the whole tile's (a resize
    whose ``h·scale`` is not whole, FreeNet's pool on an odd strip, a folded
    input whose strips would not unfold to the labels', a stride that does
    not divide the strip) raises on every rank, naming itself and the
    queue of uneven strips (ROADMAP.md A.11.2): none returns a strip-local
    answer.  (Every op that reads across rows has a strip form: the
    reductions over the tile, the test above; the resizes,
    ``tests/test_torch_spatial_resize.py``; the ViT's attention and
    checkpointed blocks, ``tests/test_torch_spatial_vit.py``; ViTEncoder,
    the folded stem, FreeNet and the causal attention,
    ``tests/test_torch_spatial_encoders.py``.)"""
    for res in ranks[world]:
        assert len(res['refusals']) == 4
        for name, err in res['refusals'].items():
            assert err.startswith(name) and 'A.11.2' in err, (name, err)
