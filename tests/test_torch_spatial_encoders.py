"""The last ops the spatial step took strip forms for, in the models that
reach them, against the JAX package's ``build_spatial_train_step`` on two
CPU devices.

One job of two gloo ranks (``torch_spatial_encoder_ranks.encoders_worker``,
which imports no JAX) trains each model one SGD + momentum step (lr 0.01)
over two strips, while this process runs the JAX package's spatial step on
the same tile from the same weights (each jitted once):

- ``ViTEncoder`` at ``vit_small_d4``'s width and depth (4 blocks of 384, 6
  heads, 4 storage tokens) → ``FPN`` (32) → ``AssymetricDecoder`` (16, its
  classifier and ×4 bilinear), composed in both packages as a user
  composes them, float32, on a 128×64 tile: an 8×4 patch grid, 4 patch
  rows a strip, the os32 tap's antialiased halving 2 rows a strip; with
  ``remat`` None and ``'full'`` (the JAX side's attention ``'xla'``, no
  remat: a recomputation gives the same numbers).  Then a drop-path step
  (rate 0.3) against the port's unsharded step, its keep masks the same on
  both ranks;
- the narrow FarSeg-R18 of ``tests/test_torch_farseg.py`` with
  ``stem='s2d_input'`` (K8's route at the stem, its plain version here),
  float64, on a 64×64 tile folded to [1, 32, 32, 12]: equal to the same
  model's ``stem='conv'`` step over the strips of the unfolded tile, bit
  for bit, and against the JAX step;
- FreeNet at narrow widths (stages 8 and 16; 6 bands, 4 classes, sparse
  labels), float64, on a 32×16 scene: the spectral gate's squeeze over the
  tile, the 2×2 pool, the decoder's ×2 resize;
- ``CausalSelfAttention`` (width 32, 4 heads) on two strips of 6 of 12
  tokens, causal and not, against ``jax.nn.dot_product_attention`` on the
  whole sequence: each rank's output rows and input gradient, and the
  parameters' gradients summed over the ranks (each its share).

Limits: float32 metrics within rtol 2e-5 (``METRICS_RTOL``) and parameters
within 1e-6 absolute (``PARAM_ATOL``), as ``tests/test_torch_spatial_vit.py``
holds DinoSeg, the running statistics within 1e-6 of max(1, |value|); the
float64 models at ``tests/test_torch_spatial_train.py``'s JAX limits (loss
rtol 1e-6, other metrics 1e-5, running statistics 1e-8 of max(1, |value|),
parameters 1e-6: their resizes, pools and losses compute in float32 in
both packages); the attention within 1e-5 absolute (``ATTN_ATOL``).
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.interface.module import ERModule as JERModule
from ever_tpu.module import fpn as jfpn
from ever_tpu.module import loss as jloss
from ever_tpu.module import vit as jvit
from ever_tpu.parallel import spatial as jspatial
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.util import weight_io as twio
from test_torch_dist import start_ranks
from test_torch_farseg import NARROW
from test_torch_resnet import _fold, close, one_torch_thread, seeded_variables  # noqa: F401
from torch_spatial_encoder_ranks import (CAUSAL, CLASSES, DECODER_WIDTH, DROP_PATH_RATE,
                                         FPN_WIDTH, VIT_D4)
from torch_spatial_vit_ranks import LR

pytestmark = pytest.mark.usefixtures('one_torch_thread')

WORLD = 2
VIT_TILE, FARSEG_TILE, FREENET_TILE = (128, 64), 64, (32, 16)
METRICS_RTOL, PARAM_ATOL, STATS_TOL = 2e-5, 1e-6, 1e-6
JAX_LOSS_TOL, JAX_METRIC_TOL, JAX_STATS_TOL, JAX_PARAM_TOL = 1e-6, 1e-5, 1e-8, 1e-6
ATTN_ATOL = 1e-5
FARSEG_CFG = dict(NARROW, dtype='float64',
                  encoder=dict(NARROW['encoder'], stem='s2d_input'), classes=CLASSES)
FREENET_CFG = dict(in_channels=6, stage_channels=(8, 16), classes=4, dtype='float64')
CAUSAL_TOKENS = 12


@pytest.fixture(scope='module', autouse=True)
def vit_d4():
    """``vit_small_d4`` in the JAX package's ``VIT_SPECS`` while the module
    runs (the ranks register the port's)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_SPECS, *VIT_D4)
        yield


class JaxViTFPN(JERModule):
    """The JAX package's composition of ``torch_spatial_encoder_ranks.ViTFPN``."""

    def set_default_config(self):
        self.config.update(dict(dtype='float32'))

    def setup(self):
        self.encoder = jvit.ViTEncoder(dict(vit_type=VIT_D4[0], attn_impl='xla'))
        self.fpn = jfpn.FPN(in_channels_list=(VIT_D4[1][1],) * 4, out_channels=FPN_WIDTH)
        self.decoder = jfpn.AssymetricDecoder(
            in_channels=FPN_WIDTH, out_channels=DECODER_WIDTH,
            classifier_config=dict(num_classes=CLASSES, scale_factor=4))

    def __call__(self, x, y=None, train: bool = False):
        logits = self.decoder(self.fpn(self.encoder(x, train), train), train)
        logits = logits.astype(jnp.float32)
        if train and y is not None:
            return dict(cls_loss=jloss.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return jax.nn.softmax(logits, axis=-1)


def _vit_variables(jm, x) -> dict:
    """Seeded variables of the JAX composition: kernels ~N(0, 0.05²), norm
    scales and LayerScale gammas ~U(0.5, 1.5) (so that every block moves
    the loss), the rest ~N(0, 0.02²); BatchNorm statistics at their
    initial values."""
    shapes = jax.eval_shape(lambda: jm.init({'params': jax.random.key(0)}, jnp.asarray(x)))
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'gamma' in name or 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, 1.0 if 'var' in jax.tree_util.keystr(p) else 0.0,
                             np.float32), shapes['batch_stats'])
    return dict(params=jax.tree_util.tree_map_with_path(draw, shapes['params']),
                batch_stats=stats)


def _convert_vit(params, batch_stats) -> dict:
    """The JAX composition's variables under the port's names."""
    flat = twio._variables(params, batch_stats)
    vit = {k[len('encoder/'):]: flat.pop(k) for k in [k for k in flat if k.startswith('encoder/')]}
    sd = {f'encoder.{k}': v for k, v in twio.convert_flax_vit_encoder(vit).items()}
    sd.update(twio._convert_conv_net(flat, [('', '', twio._fpn_decoder_rules(
        ('fpn',), ('decoder',)))], 'ViT-FPN'))
    return sd


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    """Every model's batch and weights, the JAX models and variables."""
    rng = np.random.default_rng(31)
    vx = rng.normal(size=(1, *VIT_TILE, 3)).astype(np.float32)
    vy = rng.integers(0, CLASSES, size=(1, *VIT_TILE)).astype(np.int32)
    vy[:, 0, :7] = 255
    vm = JaxViTFPN()
    vv = _vit_variables(vm, vx)
    fx = rng.normal(size=(1, FARSEG_TILE, FARSEG_TILE, 3))
    fy = rng.integers(0, CLASSES, size=(1, FARSEG_TILE, FARSEG_TILE)).astype(np.int32)
    fy[:, 0, :5] = 255
    nx = rng.normal(size=(1, *FREENET_TILE, FREENET_CFG['in_channels']))
    ny = np.where(rng.random(FREENET_TILE) < 0.3, rng.integers(0, 4, FREENET_TILE), 255)
    ny = ny[None].astype(np.int32)
    with jax.enable_x64(True):
        fm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG_CFG})
        fv = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(fm, _fold(fx)))
        nm = jbuilder.make_model({'type': 'FreeNet', 'params': FREENET_CFG})
        nv = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(nm, nx))
    cm = jvit.CausalSelfAttention(**CAUSAL)
    cx = rng.normal(size=(2, CAUSAL_TOKENS, CAUSAL['dim'])).astype(np.float32)
    cv = jax.tree.map(lambda a: (0.2 * rng.normal(size=a.shape)).astype(np.float32),
                      jax.eval_shape(lambda: cm.init(jax.random.key(0), jnp.asarray(cx))))
    return dict(vit=(vm, vv, vx, vy), farseg=(fm, fv, _fold(fx), fx, fy), freenet=(nm, nv, nx, ny),
                causal=(cm, cv['params'], cx, rng.normal(size=cx.shape).astype(np.float32)))


def _causal_state_dict(params) -> dict:
    return {'qkv.weight': torch.from_numpy(np.asarray(params['qkv']['kernel']).T.copy()),
            'proj.weight': torch.from_numpy(np.asarray(params['proj']['kernel']).T.copy()),
            'proj.bias': torch.from_numpy(np.array(params['proj']['bias']))}


@pytest.fixture(scope='module', autouse=True)
def job(tmp_path_factory, vit_d4):
    """The two ranks, started before the module's first test; killed at
    the end if still running."""
    data = _inputs()
    _, vv, vx, vy = data['vit']
    _, fv, sx, fx, fy = data['farseg']
    _, nv, nx, ny = data['freenet']
    _, cp, cx, probe = data['causal']
    tmp = tmp_path_factory.mktemp('spatial_encoders')
    torch.save(dict(vit_state_dict=_convert_vit(vv['params'], vv['batch_stats']), vit_x=vx,
                    vit_y=vy, farseg_cfg=FARSEG_CFG,
                    farseg_state_dict=twio.convert_flax_farseg(fv), s2d_x=sx, farseg_x=fx,
                    farseg_y=fy, freenet_cfg=FREENET_CFG,
                    freenet_state_dict=twio.convert_flax_freenet(nv['params']), freenet_x=nx,
                    freenet_y=ny, causal_state_dict=_causal_state_dict(cp), causal_x=cx,
                    causal_probe=probe), tmp / 'enc-inputs.pt')
    started = start_ranks('torch_spatial_encoder_ranks', 'encoders_worker', WORLD, tmp, tmp)
    yield tmp, started
    started.kill()


def _jax_step(jm, variables, batch, x64: bool) -> tuple:
    """The JAX package's spatial step on two devices (SGD + momentum at
    ``LR``): its metrics, params and batch statistics."""
    with jax.enable_x64(x64):
        tx = jbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})[0].build(LR)
        params = variables['params']
        state = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=variables.get('batch_stats', {}),
                                 opt_state=tx.init(params))
        step = jspatial.build_spatial_train_step(
            jm, tx, mesh=Mesh(np.array(jax.devices()[:WORLD]), ('data',)), donate=False)
        state, metrics = step(state, tuple(jnp.asarray(t) for t in batch))
        return ({k: float(m) for k, m in metrics.items()}, jax.device_get(state.params),
                jax.device_get(state.batch_stats))


@functools.lru_cache(maxsize=None)
def _jax() -> dict:
    """Every JAX side: the three spatial steps and the causal attention's
    outputs and gradients on the whole sequence."""
    data = _inputs()
    vm, vv, vx, vy = data['vit']
    fm, fv, sx, _, fy = data['farseg']
    nm, nv, nx, ny = data['freenet']
    cm, cp, cx, probe = data['causal']
    # the three compile in threads of their own (XLA compiles without the
    # GIL; jax.enable_x64 is a thread's own setting): a third of the time
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        steps = dict(vit=pool.submit(_jax_step, vm, vv, (vx, vy), False),
                     farseg=pool.submit(_jax_step, fm, fv, (sx, fy), True),
                     freenet=pool.submit(_jax_step, nm, nv, (nx, ny), True))
        out = {k: f.result() for k, f in steps.items()}

    @jax.jit
    def attend(params, x, probe):
        res = {}
        for is_causal in (True, False):
            y, vjp = jax.vjp(lambda p, t: cm.apply({'params': p}, t, is_causal), params, x)
            res[is_causal] = (y,) + vjp(probe)
        return res

    out['causal'] = jax.device_get(attend(cp, cx, probe))
    return out


@pytest.fixture(scope='module')
def ranks(job):
    _jax()                                          # while the ranks run
    tmp, started = job
    started.finish(timeout=180)
    return [torch.load(tmp / f'enc-rank{r}.pt', weights_only=False) for r in range(WORLD)]


def _same_on_every_rank(ranks, key):
    for k, t in ranks[0][key]['state'].items():
        for res in ranks[1:]:
            assert torch.equal(res[key]['state'][k], t), (key, k)


def _against(res, metrics, want, metric_tol, param_tol, stats_tol, loss_tol=None):
    """A rank's step against ``metrics`` and the state ``want`` (name →
    tensor): the metrics within ``metric_tol`` relative (a loss within
    ``loss_tol``), each parameter within ``param_tol`` absolute, each
    running statistic within ``stats_tol`` of max(1, |value|)."""
    assert res['step'] == 1 and set(res['metrics']) == set(metrics)
    for k, m in metrics.items():
        tol = loss_tol if loss_tol and 'loss' in k else metric_tol
        np.testing.assert_allclose(res['metrics'][k], m, rtol=tol, err_msg=k)
    for k, w in want.items():
        got = res['state'][k].numpy()
        if k.endswith(('running_mean', 'running_var')):
            close(got, w.numpy(), stats_tol)
        else:
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=param_tol, err_msg=k)


@pytest.mark.parametrize('remat', [None, 'full'])
def test_vit_encoder_fpn_strip_step_matches_the_jax_spatial_step(ranks, remat):
    """ViTEncoder + FPN + AssymetricDecoder over two strips: every rank's
    metrics, parameters and running statistics against the JAX package's
    spatial step, float32; the ranks' states equal."""
    metrics, params, stats = _jax()['vit']
    want = _convert_vit(params, stats)
    for res in ranks:
        _against(res[f'vit/{remat}'], metrics, want, METRICS_RTOL, PARAM_ATOL, STATS_TOL)
    _same_on_every_rank(ranks, f'vit/{remat}')


def test_vit_encoder_drop_path_draws_the_same_masks_on_every_rank(ranks):
    """Stochastic depth over the strips: both ranks draw the same keep
    masks (two a block, one entry a sample), and the step equals the
    port's unsharded step with the same generator (float32 limits)."""
    masks = [r['vit/drop_masks'] for r in ranks]
    assert len(masks[0]) == 2 * VIT_D4[1][0] and all(m.shape == (1,) for m in masks[0])
    assert all(torch.equal(a, b) for a, b in zip(*masks))
    assert DROP_PATH_RATE > 0 and not all(bool(m.all()) for m in masks[0])
    want = ranks[0]['vit/drop_unsharded']
    for res in ranks:
        _against(res['vit/drop'], want['metrics'], want['state'], METRICS_RTOL, PARAM_ATOL,
                 STATS_TOL)
    _same_on_every_rank(ranks, 'vit/drop')


def test_folded_stem_strip_step_is_the_conv_stem_s_on_the_unfolded_tile(ranks):
    """FarSeg-R18 with ``stem='s2d_input'`` over the strips of the folded
    tile: its metrics and state are the bits of ``stem='conv'``'s over the
    strips of the unfolded tile (each strip's folded rows unfold to exactly
    its pixel rows), and both ranks' states equal."""
    for res in ranks:
        folded, plain = res['s2d'], res['conv']
        assert folded['metrics'] == plain['metrics']
        for k, t in plain['state'].items():
            assert torch.equal(folded['state'][k], t), k
        assert folded['stats'] == plain['stats']
    _same_on_every_rank(ranks, 's2d')


@pytest.mark.parametrize('model', ['farseg', 'freenet'])
def test_float64_strip_step_matches_the_jax_spatial_step(ranks, model):
    """The folded-stem FarSeg-R18 and FreeNet over two strips against the
    JAX package's spatial step, float64, at the JAX limits; the ranks'
    states equal."""
    metrics, params, stats = _jax()[model]
    want = (twio.convert_flax_farseg(params, stats) if model == 'farseg'
            else twio.convert_flax_freenet(params))
    key = 's2d' if model == 'farseg' else model
    for res in ranks:
        _against(res[key], metrics, want, JAX_METRIC_TOL, JAX_PARAM_TOL, JAX_STATS_TOL,
                 JAX_LOSS_TOL)
    _same_on_every_rank(ranks, key)


@pytest.mark.parametrize('is_causal', [True, False], ids=['causal', 'full'])
def test_causal_attention_on_a_strip_matches_jax_on_the_whole_sequence(ranks, is_causal):
    """Each rank's output and input gradient are the JAX module's on the
    whole sequence at the strip's rows (``jax.nn.dot_product_attention``),
    and the ranks' parameter gradients sum to the JAX module's; 1e-5."""
    y, gp, gx = _jax()['causal'][is_causal]
    n = CAUSAL_TOKENS // WORLD
    for r, res in enumerate(ranks):
        got_y, got_gx, _ = res['causal'][is_causal]
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got_y.numpy(), y[:, rows], rtol=0, atol=ATTN_ATOL)
        np.testing.assert_allclose(got_gx.numpy(), gx[:, rows], rtol=0, atol=ATTN_ATOL)
    for k, w in _causal_state_dict(gp).items():
        got = sum(res['causal'][is_causal][2][k] for res in ranks)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=ATTN_ATOL, err_msg=k)
