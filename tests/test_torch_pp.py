"""The port's GPipe pipeline (``ever_tpu_torch.parallel.pp``) against
``ever_tpu.parallel.pp``, on the CPU.

In one process: ``stack_layer_params``.  One job of four gloo ranks
(``torch_layout_ranks.pp_worker``, which imports no JAX) runs the rest on
a ``('pipe',)`` mesh of 4 stages and on a ``('data', 'pipe')`` mesh of (2,
2), 2 stages on each data rank's half of the batch:

- the primitive ``pipeline`` on the JAX test's stack of 8 tanh layers
  (``tests/test_pp.py``), against the JAX ``pipeline`` under
  ``shard_map`` on 4 devices, and its input's gradient against JAX's
  gradient of the sequential stack;
- ``pipelined_vit_apply`` of the JAX test's trunk (``vit_small``, patch 8,
  4 storage tokens, LayerScale 1e-5, B=8 at 32², as many microbatches as
  stages)
  with the JAX weights: its outputs and the gradients of a probe loss
  (``torch_layout_ranks.probe_loss``) for the input and for every
  parameter a stage holds, against the JAX trunk on one device; each stage
  holding its own blocks alone; the hops each stage made;
- the depth, batch and microbatch divisibility errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module.vit import DinoVisionTransformer as JaxViT
from ever_tpu.parallel import mesh as jmesh
from ever_tpu.parallel import pp as jpp
from ever_tpu_torch.parallel.pp import stack_layer_params
from ever_tpu_torch.util.weight_io import convert_flax_dinov3_vit
from test_torch_dist import start_ranks
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

VIT = dict(vit_type='vit_small', patch_size=8, n_storage_tokens=4, layerscale_init=1e-5)
# float32 through 12 blocks, each microbatch a separate product: the JAX
# test's own limits for the trunk (rtol 1e-4, atol 1e-5)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
# gradients against each tensor's largest element (measured at most 1.4e-6)
GRAD_TOL = 1e-4


def test_stack_layer_params_roundtrip():
    """The JAX test's trees: each leaf stacked on a new leading axis."""
    trees = [{'a': torch.full((2,), float(i)), 'b': {'c': torch.ones(3) * i}} for i in range(4)]
    stacked = stack_layer_params(trees)
    assert stacked['a'].shape == (4, 2)
    assert torch.equal(stacked['b']['c'][2], torch.full((3,), 2.0))


@functools.lru_cache(maxsize=None)
def _jax_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(8, 16, 16)) * 0.2).astype(np.float32)
    xs = rng.normal(size=(4, 2, 16)).astype(np.float32)
    model = JaxViT(**VIT)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    params = jax.jit(lambda a: model.init({'params': jax.random.key(0)}, a))(x)['params']
    probes = (rng.normal(size=(8, 384)).astype(np.float32),
              rng.normal(size=(8, 16, 384)).astype(np.float32))
    return ws, xs, model, x, params, probes


@functools.lru_cache(maxsize=None)
def _jax_results():
    """The JAX pipeline primitive on 4 devices; the sequential stack's input
    gradient of ``sum``; the trunk's outputs and probe-loss gradients."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ws, xs, model, x, params, (u, v) = _jax_inputs()

    def layer_fn(w, h):
        return jnp.tanh(h @ w)

    mesh = jmesh.make_mesh(('pipe',), devices=jax.devices()[:4])
    run = shard_map(lambda sp, a: jpp.pipeline(layer_fn, sp, a, axis_name='pipe'), mesh=mesh,
                    in_specs=(P('pipe'), P()), out_specs=P(), check_vma=False)
    primitive = np.asarray(jax.jit(run)(ws, xs))

    def sequential(a):
        for i in range(len(ws)):
            a = layer_fn(ws[i], a)
        return a

    xs_grad = np.asarray(jax.grad(lambda a: jnp.sum(sequential(a)))(xs))

    def loss(p, xx):
        out = model.apply({'params': p}, xx)
        return (jnp.sum(out['x_norm_clstoken'] * u)
                + jnp.sum(out['x_norm_patchtokens'] * v)), out

    (_, out), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, x)
    return primitive, xs_grad, jax.device_get(out), convert_flax_dinov3_vit(
        jax.device_get(g)), np.asarray(gx)


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory):
    """The pipeline job's four ranks, started before the module's first
    test; killed at the end if still running."""
    tmp = tmp_path_factory.mktemp('pp')
    ws, xs, _, x, params, probes = _jax_inputs()
    torch.save(dict(ws=ws, xs=xs, cfg=VIT, x=x, probes=probes,
                    state_dict=convert_flax_dinov3_vit(params),
                    short=('vit_pp_short', (6, 384, 6, 4.0, 'mlp'))), tmp / 'pp-inputs.pt')
    ranks = start_ranks('torch_layout_ranks', 'pp_worker', 4, tmp, tmp)
    yield tmp, ranks
    ranks.kill()


@pytest.fixture(scope='module')
def ranks(job):
    tmp, started = job
    _jax_results()                              # while the ranks run
    started.finish(timeout=150)
    return [torch.load(tmp / f'pp-rank{r}.pt', weights_only=False) for r in range(4)]


# (stages, data ranks); the microbatches default to the stages
LAYOUTS = {'pipe4': (4, 1), 'data_pipe': (2, 2)}


def _place(rank: int, layout: str):
    """(stage, data rank) of ``rank`` on ``layout``."""
    stages, _ = LAYOUTS[layout]
    return rank % stages, rank // stages


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_pipeline_primitive_matches_jax(ranks, layout):
    """On every rank: the 8 tanh layers pipelined over the stages equal
    JAX's pipeline on 4 devices (the JAX test's 1e-5 / 1e-6), and the
    input's gradient of ``sum`` equals JAX's of the sequential stack."""
    primitive, xs_grad, *_ = _jax_results()
    for res in ranks:
        got, grad = res[f'{layout}/primitive']
        np.testing.assert_allclose(got.numpy(), primitive, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad.numpy(), xs_grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_pipelined_vit_outputs_and_input_gradients_match_jax(ranks, layout):
    """Each rank's rows of the trunk's outputs and of the input's gradient
    (one process's, on every stage) against the JAX trunk's."""
    _, _, out, _, gx = _jax_results()
    _, data = LAYOUTS[layout]
    for r, res in enumerate(ranks):
        _, d = _place(r, layout)
        rows = slice(d * 8 // data, (d + 1) * 8 // data)
        got = res[f'{layout}/vit']
        for k in ('x_norm_clstoken', 'x_storage_tokens', 'x_norm_patchtokens'):
            np.testing.assert_allclose(got['out'][k].numpy(), np.asarray(out[k])[rows],
                                       **OUT_TOL, err_msg=k)
        want = gx[rows]
        np.testing.assert_allclose(got['x_grad'].numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_pipelined_vit_parameter_gradients_match_jax(ranks):
    """On 4 stages (one process's batch): every parameter a stage holds
    (its 3 blocks, the replicated embedding, tokens and final norm) has
    JAX's gradient, within ``GRAD_TOL`` of the tensor's largest element."""
    _, _, _, g, _ = _jax_results()
    for res in ranks:
        grads = res['pipe4/vit']['grads']
        for k, got in grads.items():
            want = g[k].numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=GRAD_TOL * np.abs(want).max() + 1e-12, err_msg=k)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_each_stage_holds_its_blocks_and_hops_once_a_microbatch(ranks, layout):
    """Stage ``s`` of ``S`` holds blocks ``[s·12/S, (s+1)·12/S)`` and no
    other; it sends each of the ``S`` microbatches forward (but the last
    stage) and each gradient back (but the first); the last stage
    broadcasts the outputs, the first the input's gradient."""
    stages, data = LAYOUTS[layout]
    per, m_count = 12 // stages, stages
    for r, res in enumerate(ranks):
        s, _ = _place(r, layout)
        got = res[f'{layout}/vit']
        assert got['blocks'] == list(range(s * per, (s + 1) * per))
        hops = m_count * ((s < stages - 1) + (s > 0))
        mb = 8 // data // m_count
        stats = got['stats']
        assert stats['hops'] == hops
        assert stats['hop_bytes'] == hops * mb * 21 * 384 * 4
        assert stats['broadcasts'] == (s == stages - 1) + (s == 0)


def test_divisibility_errors_match_jax(ranks):
    """A depth of 6 over 4 stages, a batch of 3 over 4 (or a microbatch of
    3 over 2 data ranks) and a microbatch of 1 over 2 data ranks raise
    ``ValueError`` with the JAX package's messages."""
    for res in ranks:
        assert res['depth_error'] == 'depth 6 not divisible by 4 pipeline stages'
        assert res['pipe4/batch_error'] == 'batch 3 not divisible by 4 microbatches'
        assert res['data_pipe/batch_error'].startswith('microbatch size 3 not divisible by '
                                                       'the 2-way data sharding')
        assert res['data_error'].startswith('microbatch size 1 not divisible by the 2-way')
