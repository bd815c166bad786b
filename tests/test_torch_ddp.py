"""The slice as a whole on the CPU: a project from ``create`` whose
``train.py`` runs under ``torchrun --nproc_per_node 2 ... --device cpu``
(gloo), against one process on the same global batches and against the
JAX package's ``get_trainer('th_ddp')``.

The project holds the test's narrow configs, a seeded dataset whose
samples ignore 60 % or 5 % of their pixels by index (so the ranks' valid
pixel counts differ), and a module that records every logged step to the
model dir, wires the distributed evaluation in a multi-process run, names
the narrow ViT and registers ``DoubleFarSeg`` (FarSeg with float64
parameters: the comparisons of FarSeg hold in float64).

The global batches: ``data.distributed.global_batches`` gives each step's
indices of the two ranks' batches in rank order; the one-process runs and
the JAX run read the dataset through an ``index_map`` of their
concatenation in sequence, in batches of 8.

FarSeg (narrow ResNet-18 trunk, 64², float64, SGD with momentum, poly,
clip 35): 6 steps over 2 ranks (epochs of 2 steps, a checkpoint as each
epoch's first batch is drawn and at the end, and the distributed evaluation
of 9 samples, 5 and 4 a rank) against 6 steps in one process (one epoch of
6 batches: checkpoints after step 5 and at the end), a resume of the 2-rank
run's step-5 checkpoint in one process and of the one-process run's in 2
ranks, and the JAX run (its max pool through ``reduce_window``, which
differs from the Pallas kernel only at exact ties: none in float64).  DinoSeg (2 blocks of
width 64, float32, AdamW): 4 steps over 2 ranks against one process and
JAX.

Tolerances.  Both packages compute the loss in float32 (the models cast
their logits), so the logged losses agree to float32 rounding of sums in
another order (rtol 1e-6).  FarSeg at ``dtype='float64'`` is float64 but
for the steps both packages keep in float32: the loss, the relation map,
the decoder's bilinear resizes and the scene pooling's accumulation.  The
first step's gradients of 2 ranks and of one process differ only by
float64 sums in another order; from the second step on those differences
flip float32 roundings in the steps above, and the state after 6 steps
differs by float32 rounding carried through the steps (beyond 1e-8 in the
running means), so it is held to 1e-7 of max(1, max |value|) of each
tensor.  DinoSeg in float32: 1e-6 absolute.
"""

import inspect
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.core import registry as jregistry
from ever_tpu.interface import ERDataset as JERDataset
from ever_tpu.module import vit as jvit
from ever_tpu.trainer import get_trainer as jget_trainer
from ever_tpu_torch.core.logger import TrainLogHook
from ever_tpu_torch.data.distributed import global_batches
from ever_tpu_torch.util._main import create_project
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg, convert_flax_farseg
from test_torch_farseg import NARROW
from test_torch_resnet import seeded_variables

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CLASSES = 5
SIZE = 64
TRAIN, TEST = 16, 9
TINY = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))
LAUNCH_TIMEOUT = 240


def sample(j, seed, size):
    """Sample ``j``: a normal image and labels in [0, 5), 60 % of the
    pixels ignored (255) when ``j % 3 == 0`` and 5 % otherwise."""
    rng = np.random.default_rng(seed + int(j))
    x = rng.normal(size=(size, size, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(size, size)).astype(np.uint8)
    y[rng.random((size, size)) < (0.6 if j % 3 == 0 else 0.05)] = 255
    return x, y


class _SegData:
    def set_default_config(self):
        self.config.update(dict(num_samples=TRAIN, image_size=SIZE, seed=0, index_map=None))

    def __len__(self):
        m = self.config.index_map
        return len(m) if m else self.config.num_samples

    def __getitem__(self, i):
        m = self.config.index_map
        return sample(m[i] if m else i, self.config.seed, self.config.image_size)


@jregistry.DATASET.register('ddp_seg')
class JaxSegData(_SegData, JERDataset):
    pass


DATA_MODULE = ('import numpy as np\n\n'
               'from ever_tpu_torch.core import registry\n'
               'from ever_tpu_torch.interface import ERDataset\n'
               f'TRAIN, SIZE = {TRAIN}, {SIZE}\n\n\n'
               + inspect.getsource(sample) + '\n\n'
               + "@registry.DATASET.register('ddp_seg')\n"
               + inspect.getsource(_SegData).replace('class _SegData:',
                                                     'class SegData(ERDataset):'))

HARNESS_MODULE = f'''\
"""The test project's harness: the narrow ViT, FarSeg with float64
parameters, every logged step recorded to the model dir, and the
distributed evaluation in a multi-process run."""
import json
import os

import ever_tpu_torch as er
from ever_tpu_torch.core import registry
from ever_tpu_torch.core.logger import TrainLogHook
from ever_tpu_torch.metric.evaluate_fn import distributed_evaluate_pixel_prediction_task
from ever_tpu_torch.module import vit
from ever_tpu_torch.module.fs_relation import FarSeg
from ever_tpu_torch.trainer.trainer import Trainer

vit.VIT_SPECS[{TINY[0]!r}] = {TINY[1]!r}


@registry.MODEL.register('DoubleFarSeg')
class DoubleFarSeg(FarSeg):
    def __init__(self, config=None):
        super().__init__(config)
        self.double()


class Record(TrainLogHook):
    def __init__(self, path):
        self.path, self.steps = path, {{}}
        if os.path.exists(path):                  # a resumed run adds its steps
            with open(path) as f:
                self.steps = json.load(f)

    def after_iter(self, global_step, loss_dict, learning_rate):
        self.steps[str(global_step)] = dict(loss_dict, learning_rate=learning_rate)
        with open(self.path, 'w') as f:
            json.dump(self.steps, f)


_run = Trainer.run


def run(self, after_construct_launcher_callbacks=None):
    def wire(tl):
        path = os.path.join(tl.model_dir, f'logged-{{er.dist.get_world_size()}}-'
                                          f'{{er.dist.get_rank()}}.json')
        tl.logger.register_train_log_hook(Record(path))
        if er.dist.get_world_size() > 1:
            tl.override_evaluate(distributed_evaluate_pixel_prediction_task(
                int(self.config.model.params.classes)))
    return _run(self, [wire, *(after_construct_launcher_callbacks or [])])


Trainer.run = run
'''

FARSEG_CONFIG = f'''
config = dict(
    model=dict(type='FarSeg', params=dict(
        encoder=dict(resnet_type='resnet18', maxpool_impl='pallas'),
        head={NARROW['head']!r},
        classes={CLASSES}, loss=dict(ignore_index=255, ce=dict(), dice=None),
        dtype='float64')),
    data=dict(
        train=dict(type='ddp_seg', params=dict(total_batch_size=8,
                                               sampler_type='StepDistributedSampler')),
        test=dict(type='ddp_seg', params=dict(num_samples={TEST}, seed=1000, batch_size=2,
                                              sampler_type='SequentialSampler')),
    ),
    learning_rate=dict(type='poly', params=dict(base_lr=0.05, power=0.9, max_iters=20)),
    optimizer=dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4),
                   grad_clip=dict(max_norm=35.0)),
    train=dict(num_iters=6, eval_after_train=True, log_interval_step=1,
               save_ckpt_interval_epoch=1, distributed=True, distributed_evaluate=True),
)
'''

DINOSEG_CONFIG = f'''
config = dict(
    model=dict(type='DinoSeg', params=dict(
        backbone=dict(name={TINY[0]!r}), classes={CLASSES}, dtype='float32')),
    data=dict(
        train=dict(type='ddp_seg', params=dict(total_batch_size=8,
                                               sampler_type='StepDistributedSampler')),
    ),
    learning_rate=dict(type='cosine', params=dict(
        base_lr=1e-3, max_iters=6, warmup=dict(type='linear', step=2, ratio=0.1))),
    optimizer=dict(type='adamw', params=dict(weight_decay=0.05),
                   grad_clip=dict(max_norm=1.0)),
    train=dict(num_iters=4, eval_after_train=False, log_interval_step=1,
               save_ckpt_interval_epoch=1, distributed=True),
)
'''


def _start(proj, world, cfg, model_dir, opts=()):
    """The project's train.py, started: under ``torchrun --standalone`` with
    ``world`` ranks, or as a plain process for ``world == 1``."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(world)] if world > 1 else [sys.executable]
    cmd += [os.path.join(proj, 'train.py'), '--config_path', cfg, '--model_dir',
            str(model_dir), '--device', 'cpu', *map(str, opts)]
    # one intra-op thread a rank: torch sizes its pool from OMP_NUM_THREADS
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    log = open(f'{model_dir}.log', 'w+')
    return cmd, log, subprocess.Popen(cmd, cwd=proj, env=env, stdout=log,
                                      stderr=subprocess.STDOUT)


def _finish(*launches):
    """Wait for every launch; kill what outlives ``LAUNCH_TIMEOUT`` seconds
    and fail with the output of any that did not exit 0."""
    failed = []
    for cmd, log, proc in launches:
        try:
            proc.wait(timeout=LAUNCH_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        if proc.returncode != 0:
            failed.append(f'{cmd} exited {proc.returncode}:\n{log.read()[-6000:]}')
        log.close()
    assert not failed, '\n'.join(failed)


def _logged(model_dir, world):
    with open(os.path.join(model_dir, f'logged-{world}-0.json')) as f:
        return {int(k): v for k, v in json.load(f).items()}


def _final(model_dir, step):
    return torch.load(os.path.join(model_dir, f'checkpoint-{step}.ckpt'), weights_only=True)


def _cm(model_dir):
    return np.load(sorted(glob_cm(model_dir))[-1])


def glob_cm(model_dir):
    d = os.path.join(model_dir, 'cm')
    return [os.path.join(d, n) for n in os.listdir(d)] if os.path.isdir(d) else []


def _resume_from(src, dst, step):
    """A copy of run ``src`` whose last checkpoint is ``step``."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns('cm', 'logged-*'))
    with open(os.path.join(dst, 'checkpoint_info.json')) as f:
        info = json.load(f)
    info['last'] = dict(step=step, name=f'checkpoint-{step}.ckpt')
    with open(os.path.join(dst, 'checkpoint_info.json'), 'w') as f:
        json.dump(info, f)


def _order(steps):
    return sum(global_batches(range(TRAIN), 2, 4, steps), [])


class _JaxRecord(TrainLogHook):
    def __init__(self):
        self.steps = {}

    def after_iter(self, global_step, loss_dict, learning_rate):
        self.steps[global_step] = dict(loss_dict, learning_rate=learning_rate)


def _jax_run(cfg, model_dir, opts, variables):
    rec = _JaxRecord()

    def wire(tl):
        tl.logger.register_train_log_hook(rec)
        tl.set_pretrained_state(params=variables['params'],
                                batch_stats=variables.get('batch_stats'))

    argv = ['--config_path', cfg, '--model_dir', str(model_dir), *map(str, opts)]
    jget_trainer('th_ddp', argv=argv)().run(after_construct_launcher_callbacks=[wire])
    return rec.steps


@pytest.fixture(scope='module')
def project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ddp')
    proj = str(tmp / 'proj')
    create_project(proj)
    with open(os.path.join(proj, 'data', 'ddp_seg.py'), 'w') as f:
        f.write(DATA_MODULE)
    with open(os.path.join(proj, 'module', 'ddp_harness.py'), 'w') as f:
        f.write(HARNESS_MODULE)
    for name, text in (('farseg_ddp.py', FARSEG_CONFIG), ('dinoseg_ddp.py', DINOSEG_CONFIG)):
        with open(os.path.join(proj, 'configs', name), 'w') as f:
            f.write(text)
    return tmp, proj


@pytest.fixture(scope='module')
def farseg_runs(project):
    """The FarSeg runs: 2 ranks and one process to 6; each run's step-5
    checkpoint resumed to 6 by the other world size; JAX."""
    tmp, proj = project
    cfg = os.path.join(proj, 'configs', 'farseg_ddp.py')
    x = np.stack([sample(i, 0, SIZE)[0] for i in range(2)])
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': dict(NARROW, dtype='float64')})
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), seeded_variables(jm, x))
    weights = tmp / 'farseg.pth'
    torch.save(convert_flax_farseg(variables), weights)
    port = ['model.type', 'DoubleFarSeg',
            'model.params.GLOBAL', repr(dict(weight=dict(path=str(weights))))]
    one = ['data.train.params.index_map', repr(_order(6)),
           'data.train.params.sampler_type', 'SequentialSampler']
    runs = _start(proj, 2, cfg, tmp / 'two', port), _start(proj, 1, cfg, tmp / 'one', port + one)
    with jax.enable_x64(True):
        jsteps = _jax_run(cfg, tmp / 'jax', one + ['model.params.encoder.maxpool_impl',
                                                   'reduce_window'], variables)
    _finish(*runs)
    _resume_from(tmp / 'one', tmp / 'one_to_two', 5)
    _resume_from(tmp / 'two', tmp / 'two_to_one', 5)
    _finish(_start(proj, 1, cfg, tmp / 'two_to_one', port + one),
            _start(proj, 2, cfg, tmp / 'one_to_two', port))
    return tmp, jsteps


@pytest.fixture(scope='module')
def dinoseg_runs(project):
    tmp, proj = project
    cfg = os.path.join(proj, 'configs', 'dinoseg_ddp.py')
    name, spec = TINY
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_SPECS, name, spec)
        from test_torch_trainer import _seeded_params
        params = _seeded_params()
        weights = tmp / 'dinoseg.pth'
        torch.save(convert_flax_dinoseg({'params': params}), weights)
        port = ['model.params.GLOBAL', repr(dict(weight=dict(path=str(weights))))]
        one = ['data.train.params.index_map', repr(_order(4)),
               'data.train.params.sampler_type', 'SequentialSampler']
        runs = (_start(proj, 2, cfg, tmp / 'dino_two', port),
                _start(proj, 1, cfg, tmp / 'dino_one', port + one))
        jsteps = _jax_run(cfg, tmp / 'dino_jax', one, {'params': params})
        _finish(*runs)
    return tmp, jsteps


def _close_logged(got, want, rtol):
    assert sorted(got) == sorted(want)
    for step, values in want.items():
        assert set(got[step]) == set(values)
        for k in values:
            np.testing.assert_allclose(got[step][k], values[k], rtol=rtol,
                                       err_msg=f'step {step} {k}')


def _close_params(got, want, tol):
    """Every floating tensor: max |got - want| <= tol · max(1, max |want|)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if w.is_floating_point():
            w = w.double().numpy()
            np.testing.assert_allclose(got[k].double().numpy(), w, rtol=0,
                                       atol=tol * max(1.0, np.abs(w).max()), err_msg=k)


def test_farseg_two_ranks_equal_one_process(farseg_runs):
    """Every step's logged losses, grad_norm and learning rate on rank 0 of
    the 2-rank run against the one-process run on the same global batches
    (rtol 1e-6), and the float64 parameters and running statistics after 6
    steps (1e-7 of their scale; the module docstring says why)."""
    tmp, _ = farseg_runs
    two, one = _logged(tmp / 'two', 2), _logged(tmp / 'one', 1)
    assert sorted(two) == list(range(1, 7))
    _close_logged(two, one, rtol=1e-6)
    _close_params(_final(tmp / 'two', 6)['model'], _final(tmp / 'one', 6)['model'], 1e-7)


def test_farseg_two_ranks_log_the_same_on_both_ranks(farseg_runs):
    """The logged metrics are the global values: rank 1's are rank 0's."""
    tmp, _ = farseg_runs
    with open(tmp / 'two' / 'logged-2-1.json') as f:
        assert json.load(f) == json.load(open(tmp / 'two' / 'logged-2-0.json'))


def test_farseg_matches_jax_th_ddp(farseg_runs):
    """The JAX package's th_ddp trainer on the same global batches (float64
    under ``jax.enable_x64``, from the same weights): every logged metric
    within rtol 2e-5, as ``test_torch_trainer.py``."""
    tmp, jsteps = farseg_runs
    _close_logged(_logged(tmp / 'two', 2), jsteps, rtol=2e-5)


def test_rank_zero_writes_one_checkpoint_set_with_one_process_keys(farseg_runs):
    """Checkpoints as the second and third epochs' first batches are drawn
    (after steps 1, 3 and 5) and at the end, written once into the model
    dir; the model's keys are a one-process run's (no DDP ``module.``
    prefix)."""
    tmp, _ = farseg_runs
    two, one = _final(tmp / 'two', 6), _final(tmp / 'one', 6)
    names = sorted(n for n in os.listdir(tmp / 'two') if n.endswith('.ckpt'))
    assert names == ['checkpoint-1.ckpt', 'checkpoint-3.ckpt', 'checkpoint-5.ckpt',
                     'checkpoint-6.ckpt']
    assert set(two) == {'model', 'opt', 'global_step'} and two['global_step'] == 6
    assert set(two['model']) == set(one['model'])
    assert not any(k.startswith('module.') for k in two['model'])
    info = json.loads((tmp / 'two' / 'checkpoint_info.json').read_text())
    assert info['last'] == dict(step=6, name='checkpoint-6.ckpt')
    assert {k: v for k, v in info.items() if k != 'last'} == {
        str(s): f'checkpoint-{s}.ckpt' for s in (1, 3, 5, 6)}


@pytest.mark.parametrize('run', ['two_to_one', 'one_to_two'])
def test_resume_across_world_sizes(farseg_runs, run):
    """The 2-rank run's step-5 checkpoint resumed to 6 in one process, and
    the one-process run's in 2 ranks: step 6 logged as the unbroken
    2-rank run logs them (rtol 1e-6) and the final parameters and running
    statistics within 1e-7 of their scale (the module docstring says why)."""
    tmp, _ = farseg_runs
    world = 1 if run == 'two_to_one' else 2
    got, want = _logged(tmp / run, world), _logged(tmp / 'two', 2)
    assert sorted(got) == [6]
    _close_logged(got, {6: want[6]}, rtol=1e-6)
    _close_params(_final(tmp / run, 6)['model'], _final(tmp / 'two', 6)['model'], 1e-7)


def test_distributed_evaluation_equals_one_process_and_jax(farseg_runs):
    """The 9 test samples split 5 and 4 over the ranks, predicted by each
    rank's own eval step, the matrices summed: equal to the one-process
    evaluation's and to the JAX run's, every valid pixel counted once."""
    tmp, _ = farseg_runs
    two, one, jx = _cm(tmp / 'two'), _cm(tmp / 'one'), _cm(tmp / 'jax')
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(two, jx)
    labels = np.stack([sample(i, 1000, SIZE)[1] for i in range(TEST)])
    assert two.sum() == (labels != 255).sum()


def test_dinoseg_two_ranks_equal_one_process_and_jax(dinoseg_runs):
    """DinoSeg in float32: 4 steps over 2 ranks against one process on the
    same global batches (losses, grad_norm and the final parameters within
    1e-6 of their scale) and the JAX th_ddp run (rtol 2e-5)."""
    tmp, jsteps = dinoseg_runs
    two, one = _logged(tmp / 'dino_two', 2), _logged(tmp / 'dino_one', 1)
    assert sorted(two) == list(range(1, 5))
    _close_logged(two, one, rtol=1e-6)
    _close_logged(two, jsteps, rtol=2e-5)
    _close_params(_final(tmp / 'dino_two', 4)['model'], _final(tmp / 'dino_one', 4)['model'],
                  1e-6)
