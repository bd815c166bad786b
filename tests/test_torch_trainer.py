"""The port's config-driven run against the JAX package, on the CPU.

The samplers' index orders against the JAX ones; then the same config
file through ``get_trainer('th_ddp')`` in both packages (the port with
``--device cpu``): a narrow DinoSeg (2 blocks, width 64, float32) on 64²
crops of an in-memory dataset registered in both registries, AdamW with a
warmed-up cosine schedule and a clip, from the same initial weights (the
flax parameters carried over by ``convert_flax_dinoseg``), evaluated after
training.  The logged losses, the checkpoint index and the evaluation table
are compared.  Then the port's own runtime: a resume mid-epoch against an
unbroken run, staged ``train_iters``, ``evaluate()`` without a checkpoint
and the crash-save.  Inputs come from numpy with a seed.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import registry as jregistry
from ever_tpu.data import distributed as jsamplers
from ever_tpu.interface import ERDataset as JERDataset
from ever_tpu.module import vit as jvit
from ever_tpu.trainer import get_trainer as jget_trainer
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.core.logger import TrainLogHook
from ever_tpu_torch.data import distributed as tsamplers
from ever_tpu_torch.interface import ERDataset as TERDataset
from ever_tpu_torch.interface.callback import BestCheckpointCallback, SaveCheckpointCallback
from ever_tpu_torch.interface.dataloader import default_collate
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.trainer import get_trainer as tget_trainer
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CLASSES = 5
# a ViT spec small enough for the CPU: 2 blocks, width 64, 2 heads
TINY = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))


class _SegData:
    """64² crops with labels in [0, 5) and 5 % ignored (255) pixels; sample
    ``i`` is drawn from ``seed + i``."""

    def set_default_config(self):
        self.config.update(dict(num_samples=16, image_size=64, seed=0))

    def __len__(self):
        return self.config.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.config.seed + int(idx))
        size = self.config.image_size
        x = rng.normal(size=(size, size, 3)).astype(np.float32)
        y = rng.integers(0, CLASSES, size=(size, size)).astype(np.uint8)
        y[rng.random((size, size)) < 0.05] = 255
        return x, y


@jregistry.DATASET.register('torch_parity_seg')
class JaxSegData(_SegData, JERDataset):
    pass


@tregistry.DATASET.register('torch_parity_seg')
class TorchSegData(_SegData, TERDataset):
    pass


@tregistry.DATASET.register('torch_failing_seg')
class FailingSegData(TorchSegData):
    """Raises once ``fail_after`` batches of 4 have been drawn."""

    def set_default_config(self):
        super().set_default_config()
        self.config.update(dict(fail_after=0))
        self.draws = 0

    def __getitem__(self, idx):
        self.draws += 1
        if self.draws > 4 * self.config.fail_after:
            raise RuntimeError('dataset failure')
        return super().__getitem__(idx)


# -- samplers --------------------------------------------------------------------

class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def _orders(mod, name, n, seed, steps, **kw):
    """Each step's index order (two passes) and length of one sampler."""
    cls = getattr(mod, name)
    if name in ('StepDistributedRandomSubsetSampler', 'SubsetRandomSampler'):
        s = cls(list(range(3, 3 + n)), seed=seed, **kw)
    elif name in ('SubsetSampler', 'DistributedNonOverlapSubsetSeqSampler'):
        s = cls(list(range(n, 0, -1)), **kw)
    elif name in ('StepDistributedSampler', 'RandomSampler', 'DistributedInfiniteSampler'):
        s = cls(_Sized(n), seed=seed, **kw)
    else:
        s = cls(_Sized(n), **kw)
    out = []
    for step in steps:
        s.set_step(step)
        s.set_epoch(step)
        for _ in range(2):          # a second pass: epochs that advance by themselves
            it = iter(s)
            out.append(([next(it) for _ in range(3 * n)]
                        if name == 'DistributedInfiniteSampler' else list(it), len(s)))
    return out


@pytest.mark.parametrize('name', tsamplers.__all__[1:-2])
@pytest.mark.parametrize('kw', [dict(), dict(num_replicas=3, rank=1)])
def test_sampler_orders_equal_jax(name, kw):
    """Every sampler, for seeds 0 and 5 and steps 0, 1, 7 and 100 (two passes
    each), yields the JAX sampler's indices and length; with 3 replicas,
    rank 1's share."""
    if name in ('RandomSampler', 'SequentialSampler', 'SubsetSampler',
                'SubsetRandomSampler'):
        kw = {}                     # single-process samplers
    for seed in (0, 5):
        want = _orders(jsamplers, name, 13, seed, (0, 1, 7, 100), **kw)
        got = _orders(tsamplers, name, 13, seed, (0, 1, 7, 100), **kw)
        assert got == want, (name, seed)


def test_to_dataloader_batches_tensors_and_drops_the_training_tail():
    ds = TorchSegData(dict(num_samples=10, image_size=8, batch_size=4))
    dl = ds.to_dataloader()
    batches = list(dl)
    assert len(dl) == len(batches) == 2                       # 10 // 4, tail dropped
    x, y = batches[0]
    assert isinstance(x, torch.Tensor) and x.shape == (4, 8, 8, 3) and x.dtype == torch.float32
    assert y.dtype == torch.uint8 and y.shape == (4, 8, 8)
    ev = TorchSegData(dict(num_samples=5, image_size=8, batch_size=2,
                           sampler_type='SequentialSampler')).to_dataloader()
    assert [len(b[0]) for b in ev] == [2, 2, 1]
    np.testing.assert_array_equal(default_collate([ds[3], ds[4]])[1].numpy(),
                                  np.stack([ds[3][1], ds[4][1]]))


# -- the run against the JAX package ------------------------------------------------

CONFIG = """
config = dict(
    model=dict(type='DinoSeg', params=dict(
        backbone=dict(name='vit_tiny_test'), classes={classes}, dtype='float32')),
    data=dict(
        train=dict(type='{data}', params=dict(
            num_samples=16, image_size=64, batch_size=8,
            sampler_type='StepDistributedSampler')),
        test=dict(type='{data}', params=dict(
            num_samples=5, image_size=64, seed=1000, batch_size=2,
            sampler_type='SequentialSampler')),
    ),
    learning_rate=dict(type='cosine', params=dict(
        base_lr=1e-3, max_iters=6, warmup=dict(type='linear', step=2, ratio=0.1))),
    optimizer=dict(type='adamw', params=dict(weight_decay=0.05),
                   grad_clip=dict(max_norm=1.0)),
    train=dict(num_iters={num_iters}, eval_after_train={eval_after_train},
               log_interval_step=1, save_ckpt_interval_epoch=1, distributed=True),
)
"""


def _config(path, num_iters=6, eval_after_train=True, data='torch_parity_seg',
            batch_size=8):
    text = CONFIG.format(classes=CLASSES, num_iters=num_iters, data=data,
                         eval_after_train=eval_after_train)
    path.write_text(text.replace('batch_size=8', f'batch_size={batch_size}'))
    return str(path)


@pytest.fixture(scope='module')
def tiny_vit():
    name, spec = TINY
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_SPECS, name, spec)
        mp.setitem(tvit.VIT_SPECS, name, spec)
        yield


def _seeded_params(seed=7):
    """Seeded random flax parameters of the narrow DinoSeg: kernels
    ~N(0, 0.05²), norm scales ~U(0.5, 1.5), the rest ~N(0, 0.02²)."""
    from ever_tpu.core import builder as jbuilder
    model = jbuilder.make_model({'type': 'DinoSeg', 'params': dict(
        backbone=dict(name=TINY[0]), classes=CLASSES, dtype='float32')})
    shapes = jax.eval_shape(lambda: model.init({'params': jax.random.key(0)},
                                               jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes['params'])


class _Record(TrainLogHook):
    """Every logged step's losses and learning rate, and every table the
    launcher's evaluation returned."""

    def __init__(self):
        self.steps = {}
        self.tables = []

    def after_iter(self, global_step, loss_dict, learning_rate):
        self.steps[global_step] = dict(loss_dict, learning_rate=learning_rate)

    def wire(self, launcher):
        launcher.logger.register_train_log_hook(self)
        evaluate = launcher.evaluate

        def recorded(data_loader, config=None):
            self.tables.append(evaluate(data_loader, config))
            return self.tables[-1]

        launcher.evaluate = recorded


def _port_run(cfg, model_dir, state_dict=None, opts=()):
    rec = _Record()

    def wire(tl):
        rec.wire(tl)
        if state_dict is not None:
            tl.set_pretrained_state(state_dict)

    argv = ['--config_path', cfg, '--model_dir', str(model_dir), '--device', 'cpu', *opts]
    out = tget_trainer('th_ddp', argv=argv)().run(after_construct_launcher_callbacks=[wire])
    return out['launcher'], rec


@pytest.fixture(scope='module')
def both_runs(tiny_vit, tmp_path_factory):
    """One JAX run and one port run of the same config and weights."""
    tmp = tmp_path_factory.mktemp('trainer_parity')
    cfg = _config(tmp / 'cfg.py')
    params = _seeded_params()
    jrec = _Record()

    def jwire(tl):
        jrec.wire(tl)
        tl.set_pretrained_state(params=params)

    jout = jget_trainer('th_ddp', argv=['--config_path', cfg, '--model_dir',
                                        str(tmp / 'jax')])().run(
        after_construct_launcher_callbacks=[jwire])
    tl, trec = _port_run(cfg, tmp / 'port', convert_flax_dinoseg({'params': params}))
    return dict(tmp=tmp, jax=(jout['launcher'], jrec), port=(tl, trec))


def test_logged_losses_match_jax(both_runs):
    """cls_loss, total_loss, grad_norm and the learning rate of every step;
    rtol 2e-5, as the train-step tests (float32 sums in other orders)."""
    (_, jrec), (tl, trec) = both_runs['jax'], both_runs['port']
    assert sorted(trec.steps) == sorted(jrec.steps) == list(range(1, 7))
    for step, want in jrec.steps.items():
        got = trec.steps[step]
        assert set(got) == set(want) == {'cls_loss', 'total_loss', 'grad_norm',
                                         'learning_rate'}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=f'{step} {k}')
    assert tl.global_step == 6 and tl.state.step == 6


def test_checkpoints_fall_at_the_same_steps(both_runs):
    tmp = both_runs['tmp']
    infos = [json.loads((tmp / d / 'checkpoint_info.json').read_text())
             for d in ('jax', 'port')]
    assert infos[0] == infos[1]
    assert infos[1]['last'] == dict(step=6, name='checkpoint-6.ckpt')
    for name in infos[1].values():
        name = name['name'] if isinstance(name, dict) else name
        assert (tmp / 'port' / name).exists()
    ckpt = torch.load(tmp / 'port' / 'checkpoint-6.ckpt', weights_only=True)
    assert set(ckpt) == {'model', 'opt', 'global_step'} and ckpt['global_step'] == 6
    assert (tmp / 'port' / 'config.pkl').exists()


def test_evaluation_table_matches_jax(both_runs):
    """The automatic evaluation after training (5 test crops in batches of
    2): the confusion matrices both runs dumped are equal, and every cell of
    summary_all's table agrees to 1e-5 (the values are rounded to 5
    decimals)."""
    tmp = both_runs['tmp']
    cms = [np.load(sorted((tmp / d / 'cm').glob('*.npy'))[-1]) for d in ('jax', 'port')]
    np.testing.assert_array_equal(cms[1], cms[0])
    labels = np.stack([TorchSegData(dict(seed=1000))[i][1] for i in range(5)])
    assert cms[1].sum() == (labels != 255).sum()
    (_, jrec), (_, trec) = both_runs['jax'], both_runs['port']
    assert len(jrec.tables) == len(trec.tables) == 1
    want, got = jrec.tables[0], trec.tables[0]
    assert got.field_names == want.field_names
    for grow, wrow in zip(got.rows, want.rows, strict=True):
        for g, w in zip(grow, wrow, strict=True):
            if isinstance(w, str):
                assert g == w
            else:
                np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-5)


def test_resume_mid_epoch_equals_an_unbroken_run(tiny_vit, tmp_path):
    """16 samples in batches of 6 (2 batches an epoch, the tail dropped):
    4 steps then a resume to 7 against 7 steps at once; the resume starts
    in the middle of the third epoch.  Parameters equal exactly."""
    cfg = _config(tmp_path / 'cfg.py', num_iters=7, eval_after_train=False, batch_size=6)
    cfg_short = _config(tmp_path / 'short.py', num_iters=4, eval_after_train=False,
                        batch_size=6)
    torch.manual_seed(0)
    init = tbuilder.make_model({'type': 'DinoSeg', 'params': dict(
        backbone=dict(name=TINY[0]), classes=CLASSES)}, device='cpu').state_dict()
    whole, rec_whole = _port_run(cfg, tmp_path / 'whole', init)
    _port_run(cfg_short, tmp_path / 'resumed', init)
    resumed, rec_resumed = _port_run(cfg, tmp_path / 'resumed', init)
    assert sorted(rec_resumed.steps) == [5, 6, 7]
    for step in (5, 6, 7):
        assert rec_resumed.steps[step] == rec_whole.steps[step]
    got, want = resumed.model.state_dict(), whole.model.state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _launcher(model_dir, data='torch_parity_seg', **data_kw):
    model = tbuilder.make_model({'type': 'DinoSeg', 'params': dict(
        backbone=dict(name=TINY[0]), classes=CLASSES)}, device='cpu')
    schedule = tbuilder.make_learningrate({'type': 'constant', 'params': dict(base_lr=1e-3)})
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': {}})
    tl = Launcher(str(model_dir), model, factory.build(schedule), schedule, device='cpu')
    ds = tregistry.DATASET[data](dict(dict(num_samples=8, batch_size=4), **data_kw))
    return tl, ds.to_dataloader()


def test_train_iters_twice_registers_callbacks_once(tiny_vit, tmp_path):
    tl, dl = _launcher(tmp_path / 'run')
    tl.train_iters(dl, num_iters=2, distributed=False)
    tl.train_iters(dl, num_iters=4, distributed=False)
    saves = [cb for cb in tl._callbacks if isinstance(cb, SaveCheckpointCallback)]
    assert len(saves) == 1 and tl.global_step == 4 and tl.state.step == 4


def test_best_checkpoint_callback_keeps_the_best_score(tiny_vit, tmp_path):
    """2-step epochs: scores 0.5, 0.3 and 0.7 at the epoch boundaries after
    steps 1, 3 and 5, and 0.6 after training: model-best.ckpt is written
    after steps 1 and 5 only."""
    tl, dl = _launcher(tmp_path / 'run')
    tl.override_evaluate(lambda self, loader, config=None: None)
    scores = iter([0.5, 0.3, 0.7, 0.6])
    saved = []
    cb = BestCheckpointCallback(dl, epoch_interval=1, metric_fn=lambda launcher: next(scores))
    tl.register_callback(cb)
    save = tl.checkpoint.save
    tl.checkpoint.save = lambda filename=None: (saved.append((tl.global_step, filename)),
                                                save(filename))
    tl.train_iters(dl, num_iters=6, distributed=False)
    best = [s for s in saved if s[1] == 'model-best.ckpt']
    assert best == [(1, 'model-best.ckpt'), (5, 'model-best.ckpt')] and cb._best == 0.7
    ckpt = torch.load(tmp_path / 'run' / 'model-best.ckpt', weights_only=True)
    assert ckpt['global_step'] == 5


def test_evaluate_without_a_checkpoint_raises(tiny_vit, tmp_path):
    cfg = _config(tmp_path / 'cfg.py')
    trainer = tget_trainer('th_ddp', argv=['--config_path', cfg, '--model_dir',
                                           str(tmp_path / 'empty'), '--device', 'cpu'])()
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        trainer.evaluate()


def test_a_dataset_failure_crash_saves_the_step(tiny_vit, tmp_path):
    """The dataset raises while the batch of step 4 is drawn (3 steps
    done): the run re-raises after saving checkpoint-3, the last one."""
    tl, dl = _launcher(tmp_path / 'run', data='torch_failing_seg', num_samples=64,
                       fail_after=3)
    with pytest.raises(RuntimeError, match='dataset failure'):
        tl.train_iters(dl, num_iters=8)
    info = json.loads((tmp_path / 'run' / 'checkpoint_info.json').read_text())
    assert info['last'] == dict(step=3, name='checkpoint-3.ckpt')
    assert os.path.exists(tmp_path / 'run' / 'checkpoint-3.ckpt')
    ckpt = torch.load(tmp_path / 'run' / 'checkpoint-3.ckpt', weights_only=True)
    assert ckpt['global_step'] == 3


class _EpochData(torch.utils.data.Dataset):
    """Samples that depend on the epoch the iterator tells the dataset, as
    LoveDA's crops and flips do: ``100·epoch + index``."""

    def __init__(self):
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return torch.tensor(100 * self.epoch + i)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_resume_mid_epoch_tells_the_workers_their_epoch(num_workers):
    """A resume in the middle of an epoch draws an unbroken run's batches
    also when the loader forks worker processes: the dataset learns its
    epoch before the resumed iterator starts the workers (they copy the
    dataset as it is then).  8 samples in batches of 4, resumed after step 3
    (the first batch of epoch 1) and drawn to step 6."""
    from ever_tpu_torch.core.iterator import Iterator

    def loader():
        return torch.utils.data.DataLoader(_EpochData(), batch_size=4,
                                           num_workers=num_workers)

    whole = Iterator(loader())
    want = [whole.next()[0].tolist() for _ in range(6)]
    resumed = Iterator(loader())
    resumed.set_start_step(3)
    got = [resumed.next()[0].tolist() for _ in range(3)]
    assert want[:4] == [[0, 1, 2, 3], [4, 5, 6, 7], [100, 101, 102, 103], [104, 105, 106, 107]]
    assert got == want[3:]
