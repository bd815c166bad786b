"""The port's logging sinks, the loop's trace and the runtime helpers, on
the CPU.

- **The sinks**: with stub ``torch.utils.tensorboard`` and ``wandb``
  modules in ``sys.modules`` (as ``tests/test_logger_sinks.py`` drives the
  JAX package's), the port's ``Logger`` makes the JAX ``Logger``'s calls
  with the same names, values and steps for the same inputs; without the
  packages it warns and keeps logging.
- **A user's own model through ``get_trainer``**: a model registered from
  the test (a 3×3 convolution whose train forward returns the OHEM,
  Tversky and label-smoothing losses), a LoveDA tree read with a
  ``transforms`` list of the ``preprocess`` family, ``--use_tensorboard``
  with the real ``SummaryWriter``, ``train.profile_dir`` and
  ``summary_weights``: 4 steps write an event file with ``train/ohem_loss``
  at every step, weight histograms every 2 steps, and a Chrome trace of
  steps 1-2 with their ``load_data`` and ``train_step`` spans.
- **The helpers**: ``eval_start``, ``eval_progress``, ``speed``,
  ``save_log`` and ``restore_log`` print the JAX package's lines;
  ``load_model_state_dict_from_ckpt``, ``remove_module_prefix``,
  ``set_lr`` and ``ScoreTracker``'s wandb log.
"""

import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

from ever_tpu.core import checkpoint as jckpt, logger as jlogger
from ever_tpu_torch.core import checkpoint as tckpt, logger as tlogger
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.interface import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.opt.learning_rate import set_lr
from test_torch_data import make_loveda
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


class _StubWriter:
    instances = []

    def __init__(self, log_dir=None):
        self.log_dir = log_dir
        self.calls = []
        self.closed = False
        _StubWriter.instances.append(self)

    def add_scalar(self, tag, value, step):
        self.calls.append(('scalar', tag, float(value), int(step)))

    def add_histogram(self, tag, values, step):
        self.calls.append(('histogram', tag, np.asarray(values).tolist(), int(step)))

    def close(self):
        self.closed = True


class _StubWandb(types.ModuleType):
    def __init__(self):
        super().__init__('wandb')
        self.inits, self.logs, self.finished, self.run = [], [], False, None

    def init(self, **kwargs):
        self.inits.append(kwargs)

    def log(self, payload, step=None):
        self.logs.append((dict(payload), step))

    def finish(self):
        self.finished = True


@pytest.fixture
def stub_sinks(monkeypatch):
    tb = types.ModuleType('torch.utils.tensorboard')
    tb.SummaryWriter = _StubWriter
    _StubWriter.instances = []
    wandb = _StubWandb()
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', tb)
    monkeypatch.setitem(sys.modules, 'wandb', wandb)
    return wandb


def _drive(logger_cls, tmp, wandb):
    """The same calls on a logger of either package; what reached the
    sinks."""
    n = len(wandb.logs)
    logger = logger_cls('sinks', use_tensorboard=True, tensorboard_logdir=str(tmp),
                        use_wandb=True, wandb_config={'project': 'p', 'entity': 'e'})
    writer = _StubWriter.instances[-1]
    for step, (a, b) in enumerate(((1.5, 0.25), (1.25, 0.5), (1.0, 0.75)), start=3):
        logger.train_log(step=step, num_iters=10, loss_dict={'cls_loss': a, 'aux_loss': b},
                         data_time=0.01, time_cost=0.05 * step, learning_rate=0.01 / step)
    logger.eval_log({'miou': 0.61, 'oa': 0.9, 'note': 'x'}, step=7)
    logger.log_histograms({'head': np.arange(4.0), 'bias': np.ones(2)}, step=7)
    logger.close()
    assert writer.closed and wandb.finished and writer.log_dir == str(tmp)
    # the JAX logger flattens the tree in key order, the port keeps the
    # state_dict's order: the histograms are compared as a set
    scalars = [c for c in writer.calls if c[0] == 'scalar']
    histograms = sorted(c for c in writer.calls if c[0] == 'histogram')
    return scalars, histograms, wandb.logs[n:], wandb.inits[-1]


def test_sinks_receive_the_jax_loggers_calls(tmp_path, stub_sinks):
    """Scalars ``train/{k}``, ``train/lr``, ``train/time_per_step`` and
    ``eval/{k}`` at the same steps with the same values, the wandb payloads
    and ``init`` arguments, and histograms ``weights/{name}``: equal to
    the JAX Logger's (its histograms take a tree, the port's a state_dict,
    so a flat dict feeds both)."""
    want = _drive(jlogger.Logger, tmp_path / 'jax', stub_sinks)
    got = _drive(tlogger.Logger, tmp_path / 'port',
                 stub_sinks)
    assert got == want
    assert ('scalar', 'train/cls_loss', 1.5, 3) in got[0]
    assert [c[1] for c in got[1]] == ['weights/bias', 'weights/head']


def test_histograms_read_a_state_dict(tmp_path, stub_sinks):
    model = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 1), torch.nn.BatchNorm2d(3))
    logger = tlogger.Logger('hist', use_tensorboard=True, tensorboard_logdir=str(tmp_path))
    logger.log_histograms(model.state_dict(), step=5)
    names = [c[1] for c in _StubWriter.instances[-1].calls]
    assert names == [f'weights/{k}' for k in model.state_dict()]


def test_sinks_degrade_gracefully_when_missing(tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def deny(name, *a, **kw):
        if name == 'wandb' or name.startswith('torch.utils.tensorboard'):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', deny)
    monkeypatch.delitem(sys.modules, 'torch.utils.tensorboard', raising=False)
    monkeypatch.delitem(sys.modules, 'wandb', raising=False)
    logger = tlogger.Logger('missing', use_tensorboard=True,
                            tensorboard_logdir=str(tmp_path), use_wandb=True)
    assert logger._tb is None and logger._wandb is None
    logger.train_log(1, 2, {'loss': 1.0}, 0.0, 0.0, 0.1)
    logger.eval_log({'miou': 0.5}, step=1)
    logger.log_histograms({'w': torch.ones(2)}, step=1)
    logger.close()


def test_module_level_helpers_print_the_jax_lines():
    records = {}
    for name, mod in (('jax', jlogger), ('port', tlogger)):
        lg = logging.getLogger(f'helpers-{name}')
        lg.handlers, lg.propagate = [], False
        seen = []
        handler = logging.Handler()
        handler.emit = lambda r, seen=seen: seen.append(r.getMessage())
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        mod.eval_progress(lg, 3, 9)
        mod.speed(lg, 0.25, 'tile')
        mod.save_log(lg, 'checkpoint-4.ckpt')
        mod.restore_log(lg, 'checkpoint-4.ckpt')
        mod.eval_start(lg)
        records[name] = seen
    assert records['port'][:4] == records['jax'][:4]
    assert records['port'][4].startswith('Start evaluation at ')


def test_checkpoint_helpers_and_set_lr(tmp_path):
    state = {'module.w': torch.arange(3.0), 'module.b': torch.ones(1), 'step': torch.zeros(())}
    got = tckpt.remove_module_prefix(state)
    want = jckpt.remove_module_prefix(state)
    assert list(got) == list(want) == ['w', 'b', 'step']
    assert list(tckpt.remove_module_prefix(state, 'module.w')) == ['', 'module.b', 'step']
    path = str(tmp_path / 'c.ckpt')
    torch.save({'model': got, 'opt': {}, 'global_step': 3}, path)
    loaded = tckpt.load_model_state_dict_from_ckpt(path, device='cpu')
    assert list(loaded) == ['w', 'b', 'step'] and torch.equal(loaded['w'], got['w'])
    params = [torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))]
    opt = torch.optim.SGD([{'params': params[:1]}, {'params': params[1:], 'lr': 0.5}], lr=0.1)
    set_lr(opt, 0.03)
    assert [g['lr'] for g in opt.param_groups] == [0.03, 0.03]


def test_score_tracker_logs_to_an_active_wandb_run(stub_sinks):
    from ever_tpu_torch.metric.utils import ScoreTracker

    tracker = ScoreTracker()
    tracker.append({'miou': 0.5}, step=2)
    assert stub_sinks.logs == []
    stub_sinks.run = object()
    tracker.append({'miou': 0.6}, step=4)
    assert stub_sinks.logs == [({'miou': 0.6}, 4)] and len(tracker) == 2


CLASSES = 7


@tregistry.MODEL.register('TestUserSeg')
class UserSeg(ERModule):
    """A user's own model: a 3×3 convolution to the class logits; the
    train forward returns OHEM of the per-pixel CE, a focal Tversky loss
    and the label-smoothed CE."""

    def set_default_config(self):
        self.config.update(dict(classes=CLASSES))

    def __init__(self, config=None):
        super().__init__(config)
        self.conv = torch.nn.Conv2d(3, self.config.classes, 3, padding=1)

    def forward(self, x, y=None, train=False, generator=None):
        logits = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if not (train and y is not None):
            return logits.softmax(-1)
        return dict(
            ohem_loss=L.online_hard_example_mining(
                L.softmax_ce_loss_with_logits(logits, y, reduction='none'), keep_ratio=0.25),
            tversky_loss=L.tversky_loss_with_logits(logits, y, alpha=0.7, beta=0.3, gamma=0.75),
            ls_ce_loss=L.label_smoothing_cross_entropy(logits, y, eps=0.1, ignore_index=255))


CONFIG = '''
from ever_tpu_torch.preprocess import segm
config = dict(
    model=dict(type='TestUserSeg', params=dict(classes=7)),
    data=dict(
        train=dict(type='loveda', params=dict(
            root={root!r}, split='train', total_batch_size=2, num_workers=0, crop_size=48,
            sampler_type='StepDistributedSampler',
            transforms=[segm.RandomDiscreteScale([0.75, 1.25, 1.5], p=0.5, size_divisor=16),
                        segm.RandomCrop(32), segm.RandomRotate90K(), segm.RandomTranspose(),
                        segm.RandomHorizontalFlip(), segm.MeanStdNormalize()])),
        test=dict(type='loveda', params=dict(root={root!r}, split='val', batch_size=1,
                                            sampler_type='SequentialSampler')),
    ),
    learning_rate=dict(type='poly', params=dict(base_lr=0.01, power=0.9, max_iters=4)),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4)),
    train=dict(num_iters=4, log_interval_step=1, save_ckpt_interval_epoch=100,
               eval_after_train=False, distributed=True),
)
'''


def test_a_users_model_trains_with_transforms_tensorboard_and_a_trace(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from ever_tpu_torch.trainer import get_trainer

    root = make_loveda(tmp_path / 'loveda', sizes=(64, 80), test_split=False)
    cfg = tmp_path / 'user_cfg.py'
    cfg.write_text(CONFIG.format(root=root))
    model_dir, trace_dir = tmp_path / 'run', tmp_path / 'run' / 'trace'
    argv = ['--config_path', str(cfg), '--model_dir', str(model_dir), '--device', 'cpu',
            '--use_tensorboard', 'train.profile_dir', str(trace_dir),
            'train.profile_steps', '(1, 3)', 'train.summary_weights', 'true',
            'train.tensorboard_interval_step', '2']
    launcher = get_trainer('th_ddp', argv=argv)().run()['launcher']
    launcher.logger.close()
    assert launcher.global_step == 4

    (trace,) = os.listdir(trace_dir)
    assert trace == 'trace-steps-1-3.json'
    with open(trace_dir / trace) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name') for e in events
             if e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    assert names.count('load_data') == 2 and names.count('train_step') == 2

    (event_file,) = [n for n in os.listdir(model_dir) if n.startswith('events.out.tfevents')]
    acc = EventAccumulator(str(model_dir / event_file), size_guidance={'histograms': 0})
    acc.Reload()
    for tag in ('train/ohem_loss', 'train/tversky_loss', 'train/ls_ce_loss', 'train/lr',
                'train/time_per_step'):
        values = acc.Scalars(tag)
        assert [v.step for v in values] == [1, 2, 3, 4], tag
        assert all(np.isfinite(v.value) for v in values)
    assert [h.step for h in acc.Histograms('weights/conv.weight')] == [2, 4]
