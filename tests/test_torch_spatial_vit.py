"""Attention over row strips: the port's cross-length attention and its
DinoSeg trained by ``build_spatial_train_step``, on the CPU.

- The plain versions of K1 and K2 (the ``torch.library`` ops on CPU
  tensors) with a strip's queries against the whole sequence's keys, RoPE
  rows for each and ``n_valid``, against the JAX package's ``_fused`` in
  interpret mode run on the whole sequence: its output rows of the strip,
  and its gradients with ``do`` on the strip's rows and zeros elsewhere.
- One job of two gloo ranks (``torch_spatial_vit_ranks.vit_worker``, which
  imports no JAX) trains a 2-block DinoSeg at vit_small's width (6 heads of
  64, 4 storage tokens, LayerScale; attention through the kernels' op) one
  SGD step on one 128×64 tile, split into two strips of 64 rows (4 patch
  rows of 4, 21 tokens a rank against the tile's 37 keys), with ``remat``
  None and ``'full'``; this process runs the JAX package's
  ``build_spatial_train_step`` on two CPU devices from the same weights
  (plain attention, no remat: the numbers a recomputation gives are the
  same).  The ranks also run the unsharded step on the whole tile, a
  drop-path step (its masks recorded) and FarSeg-R18 with every stage
  checkpointed (``with_cp``), float64, on a 64×64 tile (1 row a strip at
  C5).

Limits: float32 metrics within rtol 2e-5 and parameters within 1e-6
absolute, moved by lr·|g| = 1e-2 · O(0.1) (``tests/test_torch_train.py``'s
microbatch test).  The FarSeg runs with its float32 parts computed in
float64 (``torch_spatial_ranks.float32_parts_in_float64``), held to the
unsharded step within ``FLOAT64_TOL`` (``tests/test_torch_spatial_train.py``'s).
As the model is, those parts' float32 rounding on two strips moved the
decoder's running statistics by 3.4e-8 on a CPU at a 128×64 tile, with
``with_cp`` and without alike, and the two steps were bit-equal.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import vit as jvit
from ever_tpu.parallel import spatial as jspatial
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.ops import attention as TA
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg
from test_torch_dist import start_ranks
from test_torch_farseg import CLASSES, NARROW
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_train import _seeded_params, _small_dinoseg_cfg
from torch_spatial_vit_ranks import DROP_PATH_RATE, LR, VIT_2BLOCK

pytestmark = pytest.mark.usefixtures('one_torch_thread')
JA = importlib.import_module('ever_tpu.ops.attention')

WORLD, ROWS, COLS = 2, 128, 64
PREFIX, PATCHES = 5, (ROWS // 16) * (COLS // 16)        # cls + 4 storage, 8 × 4
STRIP = PATCHES // WORLD
CFG = _small_dinoseg_cfg(name=VIT_2BLOCK[0], attn_impl='fused')
JAX_CFG = _small_dinoseg_cfg(name=VIT_2BLOCK[0], attn_impl='xla')
METRICS_RTOL, PARAM_ATOL = 2e-5, 1e-6
ATTN_ATOL = 1e-5
# tests/test_torch_spatial_train.py's limits of a float64 model's spatial
# step against its unsharded step: the state, and the float32 loss
FLOAT64_TOL, METRIC_TOL = 1e-10, 1e-6
FARSEG_TILE = 64
FARSEG_CFG = dict(NARROW, dtype='float64',
                  encoder=dict(NARROW['encoder'], with_cp=(True,) * 4))


@pytest.fixture(scope='module', autouse=True)
def vit_2block():
    """``vit_2block`` in both packages' ``VIT_SPECS`` while the module runs
    (the ranks register the port's)."""
    with pytest.MonkeyPatch.context() as mp:
        for specs in (jvit.VIT_SPECS, tvit.VIT_SPECS):
            mp.setitem(specs, *VIT_2BLOCK)
        yield


@functools.lru_cache(maxsize=None)
def _inputs():
    """The tile and labels (some ignored), the JAX model and its seeded
    float32 params."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, ROWS, COLS, 3)).astype(np.float32)
    y = rng.integers(0, CFG['classes'], size=(1, ROWS, COLS)).astype(np.int32)
    y[:, 0, :7] = 255
    jm = jbuilder.make_model({'type': 'DinoSeg', 'params': JAX_CFG})
    return x, y, jm, _seeded_params(jm, x)


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory, vit_2block):
    """The two ranks, started before the module's first test; killed at
    the end if still running."""
    x, y, _, params = _inputs()
    rng = np.random.default_rng(6)
    fx = rng.normal(size=(1, FARSEG_TILE, FARSEG_TILE, 3))
    fy = rng.integers(0, CLASSES, size=(1, FARSEG_TILE, FARSEG_TILE)).astype(np.int32)
    tmp = tmp_path_factory.mktemp('spatial_vit')
    torch.save(dict(cfg=CFG, state_dict=convert_flax_dinoseg({'params': params}), x=x, y=y,
                    farseg_cfg=FARSEG_CFG, farseg_x=fx, farseg_y=fy), tmp / 'vit-inputs.pt')
    started = start_ranks('torch_spatial_vit_ranks', 'vit_worker', WORLD, tmp, tmp)
    yield tmp, started
    started.kill()


@functools.lru_cache(maxsize=None)
def _jax_spatial():
    """The JAX package's spatial step on two devices: metrics and params."""
    x, y, jm, params = _inputs()
    tx = jbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})[0].build(LR)
    state = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                             opt_state=tx.init(params))
    step = jspatial.build_spatial_train_step(
        jm, tx, mesh=Mesh(np.array(jax.devices()[:WORLD]), ('data',)), donate=False)
    state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
    return {k: float(m) for k, m in metrics.items()}, jax.device_get(state.params)


@pytest.fixture(scope='module')
def ranks(job):
    _jax_spatial()                                  # while the ranks run
    tmp, started = job
    started.finish(timeout=120)
    return [torch.load(tmp / f'vit-rank{r}.pt', weights_only=False) for r in range(WORLD)]


# -- cross-length attention ---------------------------------------------------------

def _tables(n, d, seed):
    """Half-tiled [n, d] RoPE tables with identity rows for the prefix."""
    angles = np.random.default_rng(seed).uniform(-3, 3, size=(n, d // 2))
    angles[:PREFIX] = 0.0
    angles = np.concatenate([angles, angles], 1)
    return np.sin(angles).astype(np.float32), np.cos(angles).astype(np.float32)


def _strip_rows(strip: int) -> np.ndarray:
    """The token rows of a strip's queries: the prefix, then its patches."""
    return np.r_[0:PREFIX, PREFIX + strip * STRIP:PREFIX + (strip + 1) * STRIP]


@functools.lru_cache(maxsize=None)
def _jax_attention(pad: int):
    """q, k, v [1, n, 2, 64] float32 with ``pad`` masked keys, the tables,
    ``do`` zero outside each strip's rows, and the JAX package's ``_fused``
    (interpret mode, one jitted call) on the whole sequence: o and, for each
    strip's ``do``, the gradients of ``Σ o·do``."""
    b, h, d = 1, 2, 64
    n = PREFIX + PATCHES + pad
    rng = np.random.default_rng(10 + pad)
    q, k, v, dy = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(4))
    sin, cos = _tables(n, d, pad)
    dos = []
    for strip in range(WORLD):
        do = np.zeros_like(dy)
        do[:, _strip_rows(strip)] = dy[:, _strip_rows(strip)]
        dos.append(do)

    @jax.jit
    def fwd_bwd(q, k, v, dos):
        o, vjp = jax.vjp(lambda *t: JA._fused(*t, interpret=True, n_valid=PREFIX + PATCHES,
                                              rope=(jnp.asarray(sin), jnp.asarray(cos))),
                         q, k, v)
        return o, [vjp(do) for do in dos]

    o, grads = jax.device_get(fwd_bwd(q, k, v, dos))
    return (q, k, v, sin, cos, dos), o, grads


@pytest.mark.parametrize('strip', range(WORLD))
@pytest.mark.parametrize('pad', [0, 3])
def test_cross_length_attention_matches_jax_on_a_strip_s_rows(strip, pad):
    """A strip's queries (the prefix and its patch rows) against the whole
    sequence's keys, through the kernels' ops on CPU tensors (K1's and
    K2's plain versions), with q's and k's RoPE rows stacked and ``pad``
    masked keys: o against the JAX package's ``_fused`` (interpret mode)
    on the whole sequence at the strip's rows, and dq, dk, dv against its
    gradients with ``do`` on those rows and zeros elsewhere; float32, atol
    1e-5."""
    (q, k, v, sin, cos, dos), o_jax, grads = _jax_attention(pad)
    dq_jax, dk_jax, dv_jax = grads[strip]
    rows = _strip_rows(strip)
    b, _, h, d = q.shape
    n_valid = PREFIX + PATCHES
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q[:, rows], k, v))
    tables = tuple(torch.from_numpy(np.concatenate([t[rows], t])) for t in (sin, cos))
    o, lse = TA.fused_attention(tq, tk, tv, n_valid=n_valid, rope=tables)
    assert o.shape == (b, len(rows), h, d) and lse.shape == (b, h, len(rows))
    o.backward(torch.from_numpy(dos[strip][:, rows]))
    np.testing.assert_allclose(o.detach().numpy(), o_jax[:, rows], rtol=0, atol=ATTN_ATOL)
    for got, want in ((tq, dq_jax[:, rows]), (tk, dk_jax), (tv, dv_jax)):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=ATTN_ATOL)
    plain = TA.attention_reference(*(t.detach() for t in (tq, tk, tv)), n_valid=n_valid,
                                   rope=tables)
    assert torch.equal(plain, o.detach())


def test_cross_length_tables_must_cover_both_lengths():
    """Tables of q's rows alone, or shared ones at unequal lengths, raise."""
    q, k = torch.zeros(1, 5, 2, 64), torch.zeros(1, 9, 2, 64)
    for rows in (5, 9, 13):
        with pytest.raises(ValueError, match='14 rows'):
            TA.attention_reference(q, k, k, rope=(torch.zeros(rows, 64), torch.ones(rows, 64)))


# -- the DinoSeg strip step -------------------------------------------------------

def _close_params(state, jparams, atol):
    for k, w in convert_flax_dinoseg({'params': jparams}).items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)


def _same_on_every_rank(ranks, key):
    for k, t in ranks[0][key]['state'].items():
        for res in ranks[1:]:
            assert torch.equal(res[key]['state'][k], t), (key, k)


@pytest.mark.parametrize('remat', [None, 'full'])
def test_dinoseg_strip_step_matches_the_jax_spatial_step(ranks, remat):
    """Every rank's metrics (rtol 2e-5) and parameters (1e-6 absolute)
    after one strip step against the JAX package's spatial step on two
    devices; the ranks' states equal."""
    metrics, params = _jax_spatial()
    for res in (r[f'strips/{remat}'] for r in ranks):
        assert res['step'] == 1 and set(res['metrics']) == set(metrics)
        for k, m in metrics.items():
            np.testing.assert_allclose(res['metrics'][k], m, rtol=METRICS_RTOL, err_msg=k)
        _close_params(res['state'], params, PARAM_ATOL)
    _same_on_every_rank(ranks, f'strips/{remat}')


def test_prefix_tokens_come_out_bit_equal_on_every_rank(ranks):
    """The trunk's eval forward over the strips: the cls and storage tokens
    (whole on every rank, attending to the whole tile's keys) are the same
    bits on every rank and within 1e-5 of the unsharded forward's; each
    rank's patch tokens are the unsharded forward's rows of its strip."""
    cls, storage, patches = ranks[0]['trunk/unsharded']
    for r, res in enumerate(ranks):
        got_cls, got_storage, got_patches = res['trunk']
        assert torch.equal(got_cls, ranks[0]['trunk'][0])
        assert torch.equal(got_storage, ranks[0]['trunk'][1])
        for got, want in ((got_cls, cls), (got_storage, storage),
                          (got_patches, patches[:, r * STRIP:(r + 1) * STRIP])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize('remat', [None, 'full'])
def test_dinoseg_strip_step_matches_the_unsharded_step(ranks, remat):
    """The strip step against the port's unsharded step on the whole tile
    from the same weights: metrics within rtol 2e-5, every tensor within
    1e-6 absolute."""
    want = ranks[0]['unsharded']
    res = ranks[0][f'strips/{remat}']
    for k, m in want['metrics'].items():
        np.testing.assert_allclose(res['metrics'][k], m, rtol=METRICS_RTOL, err_msg=k)
    for k, w in want['state'].items():
        np.testing.assert_allclose(res['state'][k].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_strip_step_gathers_keys_once_a_block_and_again_in_the_recomputation(ranks):
    """Each rank broadcast its strip's keys and values once a block (2
    blocks, [1, 16, 2, 6, 64] float32 each), and with ``remat='full'``
    once more in the backward's recomputation, counted apart; the head's
    16× upsample sent one halo row of logits ([1, 1, 4, 5] float32) and its
    gradient."""
    nbytes, row = STRIP * 2 * 384 * 4, (COLS // 16) * CFG['classes'] * 4
    for res in ranks:
        plain, remat = res['strips/None']['stats'], res['strips/full']['stats']
        assert plain == dict(hops=2, bytes=2 * row, gathers=2, gather_bytes=2 * nbytes), plain
        assert remat == dict(plain, remat_gathers=2, remat_gather_bytes=2 * nbytes), remat


def test_drop_path_draws_the_whole_batch_s_masks_on_every_rank(ranks):
    """Under the strip step every rank draws the same keep masks (two a
    block, one entry a sample), and the step equals the unsharded step with
    the same generator."""
    masks = [r['drop/masks'] for r in ranks]
    assert len(masks[0]) == 4 and all(m.shape == (1,) for m in masks[0])
    for other in masks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(masks[0], other))
    want = ranks[0]['drop/unsharded']
    assert DROP_PATH_RATE > 0
    for res in (r['drop/strips'] for r in ranks):
        for k, m in want['metrics'].items():
            np.testing.assert_allclose(res['metrics'][k], m, rtol=METRICS_RTOL, err_msg=k)
        for k, w in want['state'].items():
            np.testing.assert_allclose(res['state'][k].numpy(), w.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    _same_on_every_rank(ranks, 'drop/strips')


def test_with_cp_farseg_strip_step_matches_the_unsharded_step(ranks):
    """FarSeg-R18 with every stage checkpointed, float64 with its float32
    parts in float64: each rank's metrics within ``METRIC_TOL`` and state
    within ``FLOAT64_TOL · max(1, max|value|)`` of the unsharded step; the
    recomputation sent its stages' halos again (``remat_hops``: fewer than
    the whole step's, forward and backward), the ranks' states equal."""
    want = ranks[-1]['with_cp/unsharded']
    for res in (r['with_cp/strips'] for r in ranks):
        stats = res['stats']
        assert 0 < stats['remat_hops'] < stats['hops'] and stats['remat_bytes'] > 0, stats
        for k, m in want['metrics'].items():
            np.testing.assert_allclose(res['metrics'][k], m, rtol=METRIC_TOL, err_msg=k)
        for k, w in want['state'].items():
            if w.is_floating_point():
                err = float((res['state'][k] - w).abs().max())
                assert err <= FLOAT64_TOL * max(1.0, float(w.abs().max())), (k, err)
    _same_on_every_rank(ranks, 'with_cp/strips')
