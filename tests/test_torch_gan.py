"""The port's DCGAN and its two-optimizer trainer against
``ever_tpu.module.gan`` and ``ever_tpu.trainer.gan``, on the CPU.

A narrow DCGAN (16², 3 channels, base width 8, latent 16) in float64 in
both packages (flax BatchNorm's one-pass variance, as FarSeg's parity
runs), the weights carried over by ``convert_flax_dcgan``: the generator,
the discriminator, ``d_loss``/``g_loss`` and the running statistics after
each loss; three ``build_gan_train_step`` steps with SGD and with Adam,
every metric and every tensor of the model.  Both losses cast the logits to
float32, as the JAX model does, so the limits are float32's.  The latent
is a numpy array patched into ``_latent`` on both sides (the JAX model
draws it from its ``'dropout'`` stream, the port from the step's
generator).  Then the JAX test's tiny GAN (``tests/test_gan.py``) through
``get_trainer('gan_spmd')`` in both packages, the trainer's raises, and a
resume of the narrow DCGAN bit-equal to an unbroken run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import gan as jgan
from ever_tpu.trainer import get_trainer as jget_trainer
from ever_tpu.trainer.gan import GANState as JaxGANState
from ever_tpu.trainer.gan import build_gan_train_step as jax_gan_step
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core.checkpoint import CheckPoint
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.interface import ERDataset as TERDataset
from ever_tpu_torch.interface import ERModule as TERModule
from ever_tpu_torch.module import gan as tgan
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.trainer import get_trainer as tget_trainer
from ever_tpu_torch.trainer.gan import GANLauncher, build_gan_train_step, create_gan_state
from ever_tpu_torch.util.weight_io import convert_flax_dcgan, convert_flax_linear
from test_gan import GanData, TinyGAN  # noqa: F401  (the JAX contract, registered)
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_trainer import _Record

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CFG = dict(image_size=16, channels=3, latent_dim=16, base_width=8, dtype='float64')
N = 4
X = np.random.default_rng(0).uniform(-1, 1, size=(N, 16, 16, 3))
Z = np.random.default_rng(1).normal(size=(N, 16))
# float32 logits and losses in both packages: relative limits of float32
TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture
def same_latent(monkeypatch):
    monkeypatch.setattr(jgan.DCGAN, '_latent', lambda self, n: jnp.asarray(Z[:n]))
    monkeypatch.setattr(tgan.DCGAN, '_latent',
                        lambda self, n, generator=None: torch.from_numpy(Z[:n]))


@functools.lru_cache(maxsize=None)
def _init_variables():
    """The JAX model's initial variables (drawn in float32, jitted)."""
    jm = jbuilder.make_model({'type': 'DCGAN', 'params': CFG})
    v = jax.jit(lambda x: jm.init({'params': jax.random.key(0), 'dropout': jax.random.key(1)},
                                  x, train=True, method=jm.d_loss))(jnp.asarray(X, jnp.float32))
    return jax.tree.map(np.asarray, v)


def _models():
    """The JAX model, its float64 variables, and the port's model with
    them."""
    jm = jbuilder.make_model({'type': 'DCGAN', 'params': CFG})
    v = jax.tree.map(lambda a: a.astype(np.float64), _init_variables())
    tm = tbuilder.make_model({'type': 'DCGAN', 'params': CFG}, device='cpu').double()
    tm.load_state_dict(convert_flax_dcgan(v), strict=True)
    return jm, v, tm


def _assert_state(tm, variables, **tol):
    want = convert_flax_dcgan(variables)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


def test_converter_flips_the_transposed_kernels():
    """Each ``up{i}`` kernel ``[kh, kw, in, out]`` lands as ``[in, out, kh,
    kw]`` flipped in both spatial axes; convolutions as ``[out, in, kh,
    kw]``; the discriminator's ``bn{i}`` as ``bns.{i-1}``."""
    v = _init_variables()
    sd = convert_flax_dcgan(v)
    k = np.asarray(v['params']['G']['up0']['kernel'])
    np.testing.assert_array_equal(sd['G.ups.0.weight'].numpy(),
                                  np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
    k = np.asarray(v['params']['D']['down1']['kernel'])
    np.testing.assert_array_equal(sd['D.downs.1.weight'].numpy(), np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd['D.bns.0.running_var'].numpy(),
                                  np.asarray(v['batch_stats']['D']['bn1']['var']))
    with pytest.raises(KeyError, match='unmapped DCGAN'):
        convert_flax_dcgan({'params': {'G': {'extra': {'kernel': np.zeros((2, 2))}}}})


def test_forward_losses_and_running_statistics_match_jax(same_latent):
    """generate, D, then ``d_loss`` and ``g_loss`` in train mode in turn:
    each loss dict and every tensor (running statistics included) after
    it."""
    with jax.enable_x64(True):
        jm, v, tm = _models()

        def chain(v, x, z):
            out = [jm.apply(v, z, method=jm.generate),
                   jm.apply(v, x, method=lambda m, x: m.D(x))]
            for method in ('d_loss', 'g_loss'):
                loss, mut = jm.apply(v, x, train=True, method=getattr(jm, method),
                                     mutable=['batch_stats'])
                v = dict(v, batch_stats=mut['batch_stats'])
                out.append((loss, v['batch_stats']))
            return out

        img, logit, *losses = jax.device_get(jax.jit(chain)(v, X, jnp.asarray(Z)))
        got = tm.generate(torch.from_numpy(Z))
        assert got.shape == (N, 16, 16, 3)
        np.testing.assert_allclose(got.detach().numpy(), img, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tm.D(torch.from_numpy(X)).detach().numpy(), logit,
                                   rtol=0, atol=1e-12)
        for method, (want, batch_stats) in zip(('d_loss', 'g_loss'), losses):
            out = getattr(tm, method)(torch.from_numpy(X), train=True)
            assert set(out) == set(want)
            for k in want:
                np.testing.assert_allclose(float(out[k]), float(want[k]), err_msg=k, **TOL)
            _assert_state(tm, dict(v, batch_stats=batch_stats), rtol=0, atol=1e-12)
    assert float(tm(torch.from_numpy(X))['d_loss']) > 0     # the default call is d_loss


def _txs(pkg, opt):
    """Both roles' update rules and constant schedules from one config."""
    b = jbuilder if pkg == 'jax' else tbuilder
    cfg = {'sgd': dict(type='sgd', params=dict(momentum=0.9)),
           'adam': dict(type='adam', params=dict(betas=(0.5, 0.999)))}[opt]
    scheds, txs = {}, {}
    for role, lr in (('G', 2e-3), ('D', 1e-3)):
        scheds[role] = b.make_learningrate(dict(type='poly', params=dict(
            base_lr=lr, power=0.9, max_iters=10)))
        factory, _ = b.make_optimizer(cfg)
        txs[role] = factory.build(scheds[role], grad_clip=dict(max_norm=5.0))
    return txs, scheds


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_three_gan_steps_match_jax(same_latent, opt):
    """The D update then the G update, three times: every metric (the loss
    entries, both pre-clip norms, both learning rates) and every tensor of
    the model after each step.  Adam divides each element's gradient by its
    own scale, so an element whose gradient is near 0 carries the float32
    losses' rounding into its update at the learning rate's scale: under
    Adam the tensors are held to 1e-3 of the largest learning rate (2e-6)
    absolute, the metrics to float32's limits."""
    with jax.enable_x64(True):
        jm, v, tm = _models()
        jtxs, jscheds = _txs('jax', opt)
        js = JaxGANState(step=jnp.zeros((), jnp.int32),
                         params=jax.tree.map(jnp.asarray, v['params']),
                         batch_stats=jax.tree.map(jnp.asarray, v['batch_stats']),
                         opt_state={r: jtxs[r].init(v['params'][r]) for r in jtxs})
        jstep = jax_gan_step(jm, jtxs, jscheds, donate=False)
        ttxs, tscheds = _txs('torch', opt)
        ts = create_gan_state(tm, ttxs)
        tstep = build_gan_train_step(tm, ttxs, tscheds)
        for i in range(3):
            js, want = jstep(js, jnp.asarray(X))
            ts, got = tstep(ts, X)
            assert set(got) == set(want) == {'D_d_loss', 'D_d_real_acc', 'G_g_loss',
                                             'd_grad_norm', 'g_grad_norm', 'd_lr', 'g_lr'}
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           err_msg=f'step {i} {k}', **TOL)
            _assert_state(tm, {'params': jax.device_get(js.params),
                               'batch_stats': jax.device_get(js.batch_stats)},
                          **(TOL if opt == 'sgd' else dict(rtol=0, atol=2e-6)))
    assert ts.step == 3


# -- the JAX test's tiny GAN through both packages' get_trainer -----------------

class _Dense2(nn.Module):
    """Dense(32), ReLU, Dense(out): flax ``Dense_0``/``Dense_1``."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.Dense_0, self.Dense_1 = nn.Linear(n_in, 32), nn.Linear(32, n_out)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


@tregistry.MODEL.register('unit_test_gan')
class TorchTinyGAN(TERModule):
    """``tests/test_gan.py``'s ``TinyGAN`` in the port."""

    def set_default_config(self):
        self.config.update(dict(latent=4))

    def __init__(self, config=None):
        super().__init__(config)
        self.G, self.D = _Dense2(4, 8), _Dense2(8, 1)

    def d_loss(self, batch, train=False, generator=None):
        z, real = batch
        with torch.no_grad():
            fake = self.G(z)
        real_logit, fake_logit = self.D(real), self.D(fake)
        return dict(d_loss=tloss.sigmoid_focal_loss(real_logit, torch.ones_like(real_logit),
                                                    alpha=-1, gamma=0.0)
                    + tloss.sigmoid_focal_loss(fake_logit, torch.zeros_like(fake_logit),
                                               alpha=-1, gamma=0.0))

    def g_loss(self, batch, train=False, generator=None):
        z, _ = batch
        fake_logit = self.D(self.G(z))
        return dict(g_loss=tloss.sigmoid_focal_loss(fake_logit, torch.ones_like(fake_logit),
                                                    alpha=-1, gamma=0.0))


@tregistry.DATASET.register('unit_test_gan_data')
class TorchGanData(TERDataset):
    set_default_config = GanData.set_default_config
    __len__ = GanData.__len__
    __getitem__ = GanData.__getitem__


TINY_CONFIG = """
config = dict(
    model=dict(type='unit_test_gan', params=dict()),
    data=dict(train=dict(type='unit_test_gan_data', params=dict(batch_size=8))),
    learning_rate=dict(
        G=dict(type='constant', params=dict(base_lr=1e-3)),
        D=dict(type='constant', params=dict(base_lr=2e-3))),
    optimizer=dict(
        G=dict(type='adam', params=dict()),
        D=dict(type='adam', params=dict())),
    train=dict(num_iters=4, log_interval_step=1, save_ckpt_interval_epoch=1),
)
"""


def test_gan_spmd_logged_losses_match_jax(tmp_path):
    """The same config file and initial weights through
    ``get_trainer('gan_spmd')`` in both packages: 4 steps over the JAX
    test's data, every logged metric of every step; float32, rtol 1e-5."""
    cfg = tmp_path / 'gan_cfg.py'
    cfg.write_text(TINY_CONFIG)
    jm = TinyGAN({})
    sample = tuple(jnp.asarray(np.stack(a)) for a in zip(*[GanData({})[i] for i in range(8)]))
    params = jax.jit(lambda b: jm.init({'params': jax.random.key(42),
                                        'dropout': jax.random.key(1)},
                                       b, train=True, method=jm.d_loss)['params'])(sample)
    params = jax.tree.map(np.asarray, params)
    state_dict = convert_flax_linear(params)      # the JAX step donates its state
    jrec, trec = _Record(), _Record()

    def jwire(tl):
        jrec.wire(tl)
        tl.set_pretrained_state(params=params)

    def twire(tl):
        trec.wire(tl)
        tl.set_pretrained_state(state_dict)

    jget_trainer('gan_spmd', argv=['--config_path', str(cfg), '--model_dir',
                                   str(tmp_path / 'jax')])().run(
        after_construct_launcher_callbacks=[jwire])
    out = tget_trainer('gan_spmd', argv=['--config_path', str(cfg), '--model_dir',
                                         str(tmp_path / 'port'), '--device', 'cpu'])().run(
        after_construct_launcher_callbacks=[twire])
    assert sorted(trec.steps) == sorted(jrec.steps) == [1, 2, 3, 4]
    for step, want in jrec.steps.items():
        got = trec.steps[step]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f'{step} {k}')
    tl = out['launcher']
    assert tl.global_step == 4 and tl.state.step == 4 and set(tl.state.optimizer) == {'G', 'D'}
    assert (tmp_path / 'port' / 'checkpoint-4.ckpt').exists()


def test_gan_launcher_raises_as_the_jax_one(tmp_path):
    tl = GANLauncher(str(tmp_path), TorchTinyGAN({}), optimizers={}, lr_schedules={},
                     device='cpu')
    with pytest.raises(NotImplementedError, match='steps_per_loop'):
        tl._train_loop_k(None, 2, 2)
    with pytest.raises(NotImplementedError, match='steps_per_loop'):
        tl._train_loop(None, 2, 1, False, 1, 2)
    with pytest.raises(NotImplementedError, match='gradient accumulation'):
        tl._ensure_train_step(2)
    with pytest.raises(RuntimeError, match='init_state'):
        tl.restore_state({}, {}, 3)


# -- resume --------------------------------------------------------------------

@tregistry.DATASET.register('torch_gan_images')
class GanImages(TERDataset):
    """16² images in [-1, 1]; sample ``i`` from seed ``i``."""

    def set_default_config(self):
        self.config.update(dict(n=16))

    def __len__(self):
        return self.config.n

    def __getitem__(self, i):
        return np.random.default_rng(int(i)).uniform(-1, 1, (16, 16, 3)).astype(np.float32)


DCGAN_CONFIG = """
config = dict(
    model=dict(type='DCGAN', params=dict(image_size=16, latent_dim=16, base_width=8)),
    data=dict(train=dict(type='torch_gan_images', params=dict(batch_size=4))),
    learning_rate=dict(type='constant', params=dict(base_lr=2e-4)),
    optimizer=dict(type='adam', params=dict(betas=(0.5, 0.999))),
    train=dict(num_iters={n}, log_interval_step=1, save_ckpt_interval_epoch={every}),
    checkpoint_backend={backend!r},
)
"""


def _dcgan_run(tmp_path, name, n, every=1000, model_dir=None, backend='msgpack'):
    cfg = tmp_path / f'{name}.py'
    cfg.write_text(DCGAN_CONFIG.format(n=n, every=every, backend=backend))
    rec = _Record()
    out = tget_trainer('gan_th_ddp', argv=['--config_path', str(cfg), '--model_dir',
                                           str(model_dir or tmp_path / name), '--device',
                                           'cpu'])().run(after_construct_launcher_callbacks=[rec.wire])
    return out['launcher'], rec


@pytest.mark.parametrize('backend', ['msgpack', 'orbax'])
def test_dcgan_resume_equals_an_unbroken_run(tmp_path, backend):
    """4 steps (one epoch of 4 batches of 4, checkpointed as a file or a
    directory), rerun to 6 on the same model dir, against 6 at once: both
    optimizers' states, the model (running statistics included) and the
    logged metrics of steps 5-6 bit for bit."""
    whole, wrec = _dcgan_run(tmp_path, 'whole', 6)
    _dcgan_run(tmp_path, 'part', 4, every=1, backend=backend)
    part, prec = _dcgan_run(tmp_path, 'resumed', 6, model_dir=tmp_path / 'part',
                            backend=backend)
    assert part.global_step == whole.global_step == 6
    for k, w in whole.model.state_dict().items():
        assert torch.equal(part.model.state_dict()[k], w), k
    for role in ('G', 'D'):
        a, b = part.state.optimizer[role].state_dict(), whole.state.optimizer[role].state_dict()
        for i, st in b['state'].items():
            for key, t in st.items():
                assert torch.equal(torch.as_tensor(a['state'][i][key]), torch.as_tensor(t)), key
    for step in (5, 6):
        assert prec.steps[step] == wrec.steps[step]
    assert set(wrec.steps[6]) == {'D_d_loss', 'D_d_real_acc', 'G_g_loss', 'd_grad_norm',
                                  'g_grad_norm', 'd_lr', 'g_lr', 'learning_rate'}
    name = CheckPoint.get_checkpoint_name(4, backend)
    ckpt = CheckPoint.load(str(tmp_path / 'part' / name), device='cpu')
    assert set(ckpt['opt']) == {'G', 'D'} and ckpt['global_step'] == 4
    assert name == ('checkpoint-4' if backend == 'orbax' else 'checkpoint-4.ckpt')
