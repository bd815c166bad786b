"""The port's tensor parallel (``ever_tpu_torch.parallel.tp``) and its
placements against ``ever_tpu.parallel.{tp,sharded}``, on the CPU.

Placements are compared by size, as ``tests/test_torch_zero.py`` compares
ZeRO's: flax kernels are ``[in, out]`` and torch weights ``[out, in]``, so
a leaf's spec differs between the packages while the size of the dimension
each axis splits does not.  Leaves are paired through the weight
converters.  The JAX side plans on its 8-device CPU mesh of (4, 2), the
port on ``abstract_mesh((4, 2))``.

One job of two gloo ranks (``torch_layout_ranks.tp_worker``, which imports
no JAX) runs ``vit_small`` at 32² (4 storage tokens, B=4) with the JAX
test's weights under tensor parallel on a ``('data', 'model')`` mesh of
(1, 2), against the JAX model's forward and the gradients of a probe
loss (``torch_layout_ranks.probe_loss``: the JAX test's ``mean(cls²)``
after a unit-scale LayerNorm is constant), on one device: GSPMD computes
the unsharded function (``tests/test_tp.py``).  The same ranks evaluate a
DinoSeg (2 blocks of width 64) under tensor parallel through the
distributed evaluation closure, which raises the JAX launcher's
``local_state()`` error (C.5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import vit as jvit
from ever_tpu.parallel import mesh as jmesh
from ever_tpu.parallel import sharded as jsharded
from ever_tpu.parallel import tp as jtp
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel import sharded as tsharded
from ever_tpu_torch.parallel import tp as ttp
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg, convert_flax_dinov3_vit
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_trainer import TINY
from test_torch_zero import _names, jax_local_state_error
from torch_zero_ranks import VIT_SPEC

pytestmark = pytest.mark.usefixtures('one_torch_thread')

VIT = dict(vit_type='vit_small', n_storage_tokens=4)
# float32 forward through 12 blocks: the split products add their halves in
# another order than the whole ones
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
# gradients, against each tensor's largest element: the same through the
# backward and the all-reduces (measured at most 2.1e-6)
GRAD_TOL = 1e-4


def _split_sizes(spec, shape) -> dict:
    """{mesh axis: size of the dimension it splits} of a spec."""
    out = {}
    for d, a in enumerate(spec):
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                out[name] = shape[d]
    return out


def _jax_specs(tree):
    return {jax.tree_util.keystr(p): s.spec
            for p, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]}


def _shapes(tree):
    return {jax.tree_util.keystr(p): leaf.shape
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX test's trunk, its weights (key 0) and input, and the probe
    loss's weights."""
    model = jbuilder.make_model({'type': 'vit_small', 'params': dict(n_storage_tokens=4)})
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    params = jax.jit(lambda a: model.init({'params': jax.random.key(0)}, a))(x)['params']
    probes = (rng.normal(size=(4, 384)).astype(np.float32),
              rng.normal(size=(4, 4, 384)).astype(np.float32))
    return model, x, params, probes


@functools.lru_cache(maxsize=None)
def _jax_vit():
    """On one device: the JAX test's loss, the trunk's output, and the
    gradients of the loss for the weights and the input."""
    model, x, params, (u, v) = _jax_init()

    def loss(p, xx):
        out = model.apply({'params': p}, xx)
        return (jnp.sum(out['x_norm_clstoken'] * u)
                + jnp.sum(out['x_norm_patchtokens'] * v)), out

    (value, out), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, x)
    return float(value), jax.device_get(out), jax.device_get(g), np.asarray(gx)


def test_vit_tp_shardings_equal_jax_by_size():
    """``vit_small``: qkv and fc1 split over 'model' on their output
    dimension, proj and fc2 on their input dimension, every other leaf
    replicated; each split of the same size as JAX's on (4, 2)."""
    _, _, shapes, _ = _jax_init()
    jsh = _jax_specs(jtp.vit_tp_shardings(shapes, jmesh.make_mesh(('data', 'model'), (4, 2))))
    jshape = _shapes(shapes)
    with torch.device('meta'):
        tm = tvit.DinoVisionTransformer(**VIT)
    params = dict(tm.named_parameters())
    tsh = ttp.vit_tp_shardings(params, tmesh.abstract_mesh((4, 2), ('data', 'model')))
    names = _names(shapes, convert_flax_dinov3_vit)
    assert set(names) == set(params) == set(tsh)
    split = 0
    for name, path in names.items():
        want = _split_sizes(jsh[path], jshape[path])
        assert _split_sizes(tsh[name].spec, params[name].shape) == want, name
        split += bool(want)
    assert split == 12 * 4
    assert tuple(tsh['blocks.0.attn.qkv.weight'].spec) == ('model', None)
    assert tuple(tsh['blocks.0.attn.proj.weight'].spec) == (None, 'model')
    assert tsh['cls_token'].is_fully_replicated and tsh['blocks.0.attn.qkv.bias'].spec == ()


@pytest.fixture
def tiny_vit(monkeypatch):
    name, spec = TINY
    monkeypatch.setitem(jvit.VIT_SPECS, name, spec)
    monkeypatch.setitem(tvit.VIT_SPECS, name, spec)


@pytest.mark.parametrize('level', [1, 3])
def test_sharded_state_shardings_with_tp_equal_jax_by_size(tiny_vit, level):
    """A narrow DinoSeg (2 blocks, width 64) under AdamW with the 1 MiB limit
    cut to 16 KiB, on (4, 2) with ``tp_axis='model'``: each parameter's and
    each of its moments' splits over both axes, of JAX's sizes (the TP leaf
    first, then ZeRO's largest free dimension)."""
    cfg = {'type': 'DinoSeg', 'params': dict(backbone=dict(name=TINY[0]), classes=7,
                                             dtype='float32')}
    jm = jbuilder.make_model(cfg)
    x = jax.ShapeDtypeStruct((8, 32, 32, 3), jnp.float32)
    y = jax.ShapeDtypeStruct((8, 32, 32), jnp.int32)
    jabs = jsharded.abstract_train_state(jm, optax.adamw(1e-4), (x, y))
    jsh = jsharded.sharded_state_shardings(
        jabs, jmesh.make_mesh(('data', 'model'), (4, 2)), level=level, tp_axis='model',
        min_shard_bytes=1 << 14)
    pspec, ospec = _jax_specs(jsh.params), _jax_specs(jsh.opt_state)
    pshape = _shapes(jabs.params)

    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    tabs = tsharded.abstract_train_state(cfg, factory.build(1e-4))
    tleaf = tsharded.leaf_shardings(tabs, tmesh.abstract_mesh((4, 2), ('data', 'model')),
                                    level=level, tp_axis='model', min_shard_bytes=1 << 14)
    names = _names(jabs.params, convert_flax_dinoseg)
    assert set(names) == set(tabs.params)
    both = 0
    for name, path in names.items():
        shape = tabs.params[name].shape
        want = _split_sizes(pspec[path], pshape[path])
        assert _split_sizes(tleaf[f'params/{name}'].spec, shape) == want, name
        moments = [s for k, s in ospec.items() if k.endswith(path)]
        assert len(moments) == 2, path
        for key in ('exp_avg', 'exp_avg_sq'):
            assert _split_sizes(tleaf[f'opt_state/{name}/{key}'].spec, shape) == \
                _split_sizes(moments[0], pshape[path]), (name, key)
        both += set(_split_sizes(moments[0], pshape[path])) == {'data', 'model'}
    assert both == 2 * 4
    got = tsharded.sharded_state_shardings(tabs, tmesh.abstract_mesh((4, 2), ('data', 'model')),
                                           level=level, tp_axis='model', min_shard_bytes=1 << 14)
    assert tuple(got.params['vit.blocks.0.attn.qkv.weight'].spec) == \
        ('model', 'data' if level == 3 else None)
    assert got.opt_state['vit.blocks.0.mlp.fc2.weight'].shard_dim == 0


def test_vit7b_abstract_state_with_tp_fits_eight_ranks():
    """``vit7b16_sat493m`` under AdamW on ``meta``, planned on
    ``abstract_mesh((4, 2))`` with ``tp_axis='model'`` at level 3
    (``tests/test_sharded_init.py``'s plan): every leaf over 64 MiB split,
    every qkv, proj, w1, w2 and w3 split over 'model', under 12e9 bytes a
    rank."""
    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    tabs = tsharded.abstract_train_state(
        {'type': 'DinoSeg', 'params': dict(backbone=dict(name='vit7b16_sat493m'), classes=7,
                                           dtype='bfloat16')}, factory.build(1e-4))
    mesh = tmesh.abstract_mesh((4, 2), ('data', 'model'))
    leaves = tsharded.leaf_shardings(tabs, mesh, level=3, tp_axis='model')
    per_rank, tp_leaves = 0.0, 0
    for path, t in tabs.leaves().items():
        nbytes = t.numel() * t.element_size()
        split = _split_sizes(leaves[path].spec, t.shape)
        assert split or nbytes <= 64 << 20, path
        if path.startswith('params/') and ttp.tp_split_dim(path, t.shape, 2) is not None:
            assert 'model' in split, path
            tp_leaves += 1
        per_rank += nbytes / np.prod([mesh.shape[a] for a in split] or [1])
    assert tp_leaves == 40 * 5
    assert per_rank < 12e9, per_rank


@pytest.mark.parametrize('name, dim', [('blocks.0.attn.qkv.weight', 0),
                                       ('blocks.0.attn.proj.weight', 1),
                                       ('blocks.0.mlp.fc1.weight', 0)])
def test_tp_view_makes_each_shard_one_block_of_the_whole(name, dim):
    """A directory writes a tensor-parallel leaf as ``tp.tp_view``'s reshape
    of the whole tensor: over k=2 ranks of 'model' and ZeRO's n=2 ranks of
    'data' on a dimension of the rank's shard (the other one, and for a
    contiguous split the same one), each rank's ZeRO shard of its TP shard
    is the block at its two coordinates; a packed qkv split by ZeRO on its
    rows raises."""
    d, k, n = 8, 2, 2
    shape = (3 * d, d) if 'qkv' in name else (d, 4 * d) if dim == 1 else (4 * d, d)
    whole = torch.arange(np.prod(shape), dtype=torch.float32).view(shape)

    def tp_rows(r):                     # rank r's rows (or columns) of the whole
        if 'qkv' in name:               # its heads' rows of q, k and v
            return torch.cat([j * d + torch.arange(r * d // k, (r + 1) * d // k)
                              for j in range(3)])
        return torch.arange(r * shape[dim] // k, (r + 1) * shape[dim] // k)

    for zdim in (1 - dim, dim):
        local_shape = list(shape)
        local_shape[dim] //= k
        if zdim == dim and 'qkv' in name:
            with pytest.raises(ValueError, match='packed qkv'):
                ttp.tp_view(name, local_shape, dim, k, zdim, n)
            continue
        view, mdim, ddim = ttp.tp_view(name, local_shape, dim, k, zdim, n)
        blocks = whole.reshape(view)
        for r in range(k):
            tp_shard = whole.index_select(dim, tp_rows(r))
            for z in range(n):
                size = tp_shard.shape[zdim] // n
                zero_shard = tp_shard.narrow(zdim, z * size, size)
                block = blocks.narrow(mdim, r, 1)
                if ddim is not None:
                    block = block.narrow(ddim, z * (view[ddim] // n), view[ddim] // n)
                assert torch.equal(block.reshape(zero_shard.shape), zero_shard), (r, z, zdim)


def test_vit7b_with_two_units_in_flight_fits_eight_ranks():
    """The same plan during a ZeRO-3 step that gathers a unit at a time
    (``parallel.zero.zero_units`` on the model built on ``meta``: 40
    blocks and the root): the state at rest plus the two largest units'
    whole float32 parameters and gradients (each split over 'model' where
    tensor parallel splits it, whole over 'data') stays under 12e9 bytes a
    rank, where gathering the whole model would add 3 × 13.4 GB."""
    from ever_tpu_torch.parallel.zero import zero_units
    cfg = {'type': 'DinoSeg', 'params': dict(backbone=dict(name='vit7b16_sat493m'), classes=7,
                                             dtype='bfloat16')}
    factory, _ = tbuilder.make_optimizer({'type': 'adamw', 'params': {}})
    tabs = tsharded.abstract_train_state(cfg, factory.build(1e-4))
    mesh = tmesh.abstract_mesh((4, 2), ('data', 'model'))
    leaves = tsharded.leaf_shardings(tabs, mesh, level=3, tp_axis='model')
    at_rest = sum(t.numel() * t.element_size()
                  / np.prod([mesh.shape[a] for a in _split_sizes(leaves[path].spec, t.shape)]
                            or [1]) for path, t in tabs.leaves().items())
    with torch.device('meta'):
        model = tbuilder.make_model(cfg, device='meta')
    units = zero_units(model)
    assert [n for n, _ in units] == [f'vit.blocks.{i}' for i in range(40)]
    in_unit = {f'{u}.{n}' for u, m in units for n, _ in m.named_parameters()}

    def flight(names):                          # float32 parameters and gradients
        return sum(2 * 4 * tabs.params[n].numel()
                   / (2 if 'model' in _split_sizes(leaves[f'params/{n}'].spec,
                                                   tabs.params[n].shape) else 1)
                   for n in names)

    sizes = sorted([flight([n for n in tabs.params if n.startswith(u + '.')]) for u, _ in units]
                   + [flight([n for n in tabs.params if n not in in_unit])], reverse=True)
    assert 0.5e9 < sizes[0] < 1e9
    assert at_rest + sizes[0] + sizes[1] < 12e9, (at_rest, sizes[:2])


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory):
    """The TP job's two ranks, started before the module's first test so
    that they run while this process computes; killed at the end if still
    running."""
    tmp = tmp_path_factory.mktemp('tp')
    _, x, params, probes = _jax_init()
    rng = np.random.default_rng(4)
    evaluation = (*VIT_SPEC, 5, rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                  rng.integers(0, 5, size=(4, 32, 32)))
    torch.save(dict(cfg=VIT, state_dict=convert_flax_dinov3_vit(params), x=x, probes=probes,
                    eval=evaluation), tmp / 'tp-inputs.pt')
    ranks = start_ranks('torch_layout_ranks', 'tp_worker', 2, tmp, tmp)
    yield tmp, ranks
    ranks.kill()


@pytest.fixture(scope='module')
def ranks(job):
    """The two ranks' results."""
    tmp, started = job
    _jax_vit()                                  # while the ranks run
    started.finish(timeout=120)
    return [torch.load(tmp / f'tp-rank{r}.pt', weights_only=False) for r in range(2)]


def test_tp_forward_matches_jax(ranks):
    """Both ranks' trunk output (cls, storage and patch tokens) and loss
    against the JAX model's, float32 (``OUT_TOL``)."""
    value, out, _, _ = _jax_vit()
    for res in ranks:
        for k in ('x_norm_clstoken', 'x_storage_tokens', 'x_norm_patchtokens'):
            np.testing.assert_allclose(res['out'][k].numpy(), np.asarray(out[k]), **OUT_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(res['loss'], value, rtol=1e-5)


def test_tp_gradients_match_jax(ranks):
    """Every parameter's gradient (the shards gathered; the replicated
    leaves, column-parallel biases included, whole on each rank) and the
    input's, against JAX's: each within ``GRAD_TOL`` of its largest
    element."""
    _, _, g, gx = _jax_vit()
    want = convert_flax_dinov3_vit(g)
    for res in ranks:
        assert set(res['grads']) == set(want)
        for k, w in want.items():
            scale = float(w.abs().max())
            np.testing.assert_allclose(res['grads'][k].numpy(), w.numpy(), rtol=0,
                                       atol=GRAD_TOL * scale + 1e-12, err_msg=k)
        np.testing.assert_allclose(res['x_grad'].numpy(), gx, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(gx).max()))
    for k in ranks[0]['grads']:
        assert torch.equal(ranks[0]['grads'][k], ranks[1]['grads'][k]), k


def test_tp_ranks_hold_their_halves_and_qkv_rows_by_head(ranks):
    """Each rank holds half of every split leaf (48 in 12 blocks) and the
    whole of the others; rank 0's qkv rows are heads 0-2 of q, k and v
    (width 384, 6 heads); a second ``apply_tp`` raises."""
    r0, r1 = ranks
    assert len(r0['sharded']) == 12 * 4 and r0['sharded'] == r1['sharded']
    for name, nbytes in r0['whole'].items():
        want = nbytes // 2 if name in r0['sharded'] else nbytes
        assert r0['local'][name] == r1['local'][name] == want, name
    assert r0['qkv_rows'] == [j * 384 + i for j in range(3) for i in range(192)]
    assert r1['qkv_rows'] == [j * 384 + 192 + i for j in range(3) for i in range(192)]
    assert 'tensor parallel already' in r0['again']


def test_distributed_evaluation_of_a_tp_state_raises_jax_s_error(ranks):
    """C.5: a DinoSeg under tensor parallel on the (1, 2) mesh, evaluated
    through ``distributed_evaluate_pixel_prediction_task``, raises on both
    ranks the JAX launcher's ``local_state()`` error for a state split over
    the processes, with its message: each rank would otherwise sum its
    shard's partial outputs with another rank's images."""
    want = jax_local_state_error()
    for res in ranks:
        assert res['evaluate'] == ('raised', want)
