"""The rank side of ``tests/test_torch_zero.py``: the small net it trains
(registered in the port's registry), its batch and update rules, the
DCGAN's, and the worker each gloo rank runs.  No JAX here: the ranks start
without it."""

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import dist
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.core.checkpoint import CheckPoint
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.interface import ERModule as TERModule
from ever_tpu_torch.metric.evaluate_fn import distributed_evaluate_pixel_prediction_task
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.module.ops import BatchNorm2d
from ever_tpu_torch.parallel import mesh as tmesh
from ever_tpu_torch.parallel.sharded import assert_sharded_below, create_train_state_sharded
from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state
from ever_tpu_torch.parallel.zero import full_state_dict, local_bytes, zero_init, zero_units
from ever_tpu_torch.trainer.gan import build_gan_train_step, create_gan_state

CLASSES, N, SIZE = 5, 8, 8


class _Tiny:
    def set_default_config(self):
        self.config.update(dict(width=16))


@tregistry.MODEL.register('torch_zero_tiny')
class TorchTiny(_Tiny, TERModule):
    """3×3 conv, BatchNorm (momentum 0.9), ReLU, 1×1 classifier, CE."""

    def __init__(self, config=None):
        super().__init__(config)
        w = self.config.width
        self.conv, self.bn, self.cls = nn.Conv2d(3, w, 3, padding=1), BatchNorm2d(w), \
            nn.Conv2d(w, CLASSES, 1)

    def forward(self, x, y=None, train=False, generator=None):
        h = F.relu(self.bn(self.conv(torch.as_tensor(x).permute(0, 3, 1, 2)), train))
        logit = self.cls(h).permute(0, 2, 3, 1)
        return dict(cls_loss=tloss.softmax_ce_loss_with_logits(logit, y)) if train else logit


def _batch():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, SIZE, SIZE, 3))
    y = rng.integers(0, CLASSES, size=(N, SIZE, SIZE)).astype(np.int32)
    y[:, 0, :3] = 255
    return x, y


OPTS = {'sgd': dict(type='sgd', params=dict(momentum=0.9, weight_decay=1e-4)),
        'adamw': dict(type='adamw', params=dict(weight_decay=0.05))}


def _rule(b, opt):
    sched = b.make_learningrate(dict(type='poly', params=dict(base_lr=0.05, power=0.9,
                                                              max_iters=20)))
    factory, _ = b.make_optimizer(OPTS[opt])
    return factory.build(sched, grad_clip=dict(max_norm=1.0)), sched


def _tiny_state(init, opt, level, mesh):
    model = tbuilder.make_model({'type': 'torch_zero_tiny', 'params': {}}, device='cpu').double()
    model.load_state_dict(init)
    tx, sched = _rule(tbuilder, opt)
    state, sh = create_train_state(model, tx), None
    if level:
        state, sh = zero_init(state, mesh, level, device='cpu')
    return state, build_train_step(model, tx, sched, mesh=mesh, state_shardings=sh)


class _Host:
    """The launcher side a ``CheckPoint`` reads: its model dir, state and
    the step it restores."""
    logger = None
    device = torch.device('cpu')

    def __init__(self, model_dir, state):
        self.model_dir, self.state = model_dir, state

    def restore_state(self, model_state, opt_state, global_step):
        self.state.step = int(global_step)


# a ViT cut to 2 blocks of width 64 (tests/test_torch_trainer.py's TINY)
VIT_SPEC = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))
def _vit_cfg(dtype, remat=None):
    return {'type': 'DinoSeg', 'params': dict(backbone=dict(name=VIT_SPEC[0], remat=remat),
                                              classes=CLASSES, dtype=dtype)}


def _vit_batch():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, 32, 32, 3)).astype(np.float32)
    return x, rng.integers(0, CLASSES, size=(N, 32, 32)).astype(np.int32)


class UnitsNet(nn.Module):
    """Three blocks in an ``nn.ModuleList``, the third one's output unused,
    and a root parameter no forward reads: units whose backward never
    runs."""

    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(nn.Sequential(nn.Linear(8, 8), nn.LayerNorm(8))
                                    for _ in range(3))
        self.head = nn.Linear(8, 4)
        self.extra = nn.Parameter(torch.ones(4, 2))

    def forward(self, x, y=None, train=False, generator=None):
        h = torch.as_tensor(x)
        for blk in self.blocks[:2]:
            h = torch.tanh(blk(h))
        self.blocks[2](h)
        return dict(mse_loss=((self.head(h) - torch.as_tensor(y)) ** 2).mean())


def _blockwise(mesh, rank, world):
    """Tiny DinoSeg: two steps replicated and at ZeRO-3, AdamW with one
    microbatch in bf16 compute (float32 parameters), again with
    ``remat='full'``, SGD with two microbatches in float32; UnitsNet at
    ZeRO-1 and ZeRO-3."""
    tvit.VIT_SPECS[VIT_SPEC[0]] = VIT_SPEC[1]
    x, y = _vit_batch()
    rows = slice(rank * N // world, (rank + 1) * N // world)
    out = {}
    for micro, remat in ((1, None), (1, 'full'), (2, None)):
        for level in (0, 3):
            torch.manual_seed(0)
            model = tbuilder.make_model(_vit_cfg('bfloat16' if micro == 1 else 'float32', remat),
                                        device='cpu')
            tx, sched = _rule(tbuilder, 'adamw' if micro == 1 else 'sgd')
            state, sh = create_train_state(model, tx), None
            if level:
                state, sh = zero_init(state, mesh, level, device='cpu')
            step = build_train_step(model, tx, sched, forward_times=micro, mesh=mesh,
                                    state_shardings=sh)
            batch = (x[rows], y[rows])
            if micro > 1:
                batch = tuple(b.reshape(micro, -1, *b.shape[1:]) for b in batch)
            metrics = []
            for _ in range(2):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            got = dict(metrics=metrics, state=full_state_dict(state))
            if level:
                zo = state.optimizer
                got.update(peak=zo.stats['peak_bytes'], recast=zo.stats['casts_recast'],
                           budget=zo.unit_budget(),
                           log=list(zo.unit_log), units=[u.name for u in zo.units],
                           whole=2 * sum(s.shape.numel() * 4 for s in zo.slots.values()))
            out['vit', remat or micro, level] = got
    rng = np.random.default_rng(11)
    ux, uy = rng.normal(size=(N, 8)), rng.normal(size=(N, 4))
    for level in (1, 3):
        torch.manual_seed(1)
        model = UnitsNet().double()
        tx, sched = _rule(tbuilder, 'adamw')
        state, sh = zero_init(create_train_state(model, tx), mesh, level, device='cpu')
        step = build_train_step(model, tx, sched, mesh=mesh, state_shardings=sh)
        metrics = []
        for _ in range(2):
            state, m = step(state, (ux[rows], uy[rows]))
            metrics.append({k: float(v) for k, v in m.items()})
        out['units', level] = dict(metrics=metrics, state=full_state_dict(state),
                                   log=list(state.optimizer.unit_log))
    out['unit_names'] = [n for n, _ in zero_units(UnitsNet())]
    return out


EVAL_BATCH = 2


def distributed_evaluation(launcher, x, y, classes: int = CLASSES) -> tuple:
    """``distributed_evaluate_pixel_prediction_task`` of the launcher over
    the samples ``(x, y)`` of ``classes`` (``EVAL_BATCH`` a batch; each rank predicts its
    disjoint share): ('ok', [each batch's predictions in order], the
    table of the confusion matrix summed over the ranks) or ('raised', the
    error's message).  A collective call: every rank of the run evaluates."""
    seen = []

    def record(y_true, y_pred, info, model_dir, checkpoint):
        seen.append(torch.as_tensor(y_pred).detach().clone())
        return y_true, y_pred

    ds = torch.utils.data.TensorDataset(torch.as_tensor(x), torch.as_tensor(y))
    loader = torch.utils.data.DataLoader(ds, batch_size=EVAL_BATCH)
    launcher.override_evaluate(distributed_evaluate_pixel_prediction_task(
        classes, prediction_fn=record, cuda_empty_cache=False))
    try:
        table = launcher.evaluate(loader)
    except ValueError as e:
        return 'raised', str(e)
    return 'ok', seen, str(table)


def evaluations(out, rank, start, mesh) -> dict:
    """The distributed evaluation of the tiny net after two AdamW steps,
    replicated (DDP), at ZeRO-1 and at ZeRO-3, each through a
    ``Launcher`` on the mesh: the state each evaluated (gathered) and what
    the closure gave."""
    x, y = _batch()
    rows = slice(rank * N // 2, (rank + 1) * N // 2)
    res = {}
    for level in (0, 1, 3):
        state, step = _tiny_state(start, 'adamw', level, mesh)
        for _ in range(2):
            state, _ = step(state, (x[rows], y[rows]))
        launcher = Launcher(os.path.join(out, f'eval{level}-{rank}'), state.model, None,
                            device='cpu', mesh=mesh)
        launcher._state = state
        res[level] = (full_state_dict(state), distributed_evaluation(launcher, x, y))
    return res


GAN_CFG = dict(image_size=16, channels=3, latent_dim=16, base_width=8, dtype='float64')


def _gan(seed=3):
    torch.manual_seed(seed)
    model = tbuilder.make_model({'type': 'DCGAN', 'params': GAN_CFG}, device='cpu').double()
    txs = {}
    for role in ('G', 'D'):
        factory, _ = tbuilder.make_optimizer(dict(type='adam', params=dict(betas=(0.5, 0.999))))
        txs[role] = factory.build(2e-4)
    return model, txs


GAN_IMAGES = np.random.default_rng(9).uniform(-1, 1, size=(N, 16, 16, 3))


def worker(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_dist_env(init, world, rank, backend='gloo')
    mesh = tmesh.make_mesh()
    start = torch.load(os.path.join(out, 'init.pt'))
    x, y = _batch()
    rows = slice(rank * N // world, (rank + 1) * N // world)
    res = {}
    for opt in ('sgd', 'adamw'):
        for level in (0, 1, 3):
            state, step = _tiny_state(start, opt, level, mesh)
            steps = []
            for _ in range(2):
                state, m = step(state, (x[rows], y[rows]))
                steps.append(({k: float(v) for k, v in m.items()}, full_state_dict(state)))
            res[opt, level] = dict(steps=steps, bytes=local_bytes(state))
    res['blockwise'] = _blockwise(mesh, rank, world)
    # checkpoints of a ZeRO-3 AdamW state at step 2, then step 3
    state, step = _tiny_state(start, 'adamw', 3, mesh)
    for _ in range(2):
        state, _ = step(state, (x[rows], y[rows]))
    pending = None
    for backend in ('orbax', 'orbax_async'):
        ckpt = CheckPoint(_Host(os.path.join(out, backend), state), backend)
        os.makedirs(ckpt._launcher.model_dir, exist_ok=True)
        ckpt.set_global_step(2)
        ckpt.save()
        if backend == 'orbax_async':
            pending = CheckPoint.load_checkpoint_info(ckpt._launcher.model_dir)
            ckpt.wait()
    res['async_info_before_wait'] = pending
    state, _ = step(state, (x[rows], y[rows]))
    res['unbroken'] = full_state_dict(state)
    fresh, step = _tiny_state(start, 'adamw', 3, mesh)
    ckpt = CheckPoint(_Host(os.path.join(out, 'orbax'), fresh), 'orbax')
    res['resumed_from'] = (ckpt.try_resume(), ckpt.global_step, fresh.step)
    fresh, _ = step(fresh, (x[rows], y[rows]))
    res['resumed'] = full_state_dict(fresh)
    # the state placed from a host model, leaf by leaf
    model = tbuilder.make_model({'type': 'torch_zero_tiny', 'params': {}}, device='cpu').double()
    model.load_state_dict(start)
    tx, sched = _rule(tbuilder, 'adamw')
    state, sh = create_train_state_sharded(model, tx, mesh=mesh, level=3, min_shard_bytes=0,
                                           device='cpu')
    res['sharded_init'] = full_state_dict(state)
    step = build_train_step(model, tx, sched, mesh=mesh, state_shardings=sh)
    for _ in range(2):
        state, _ = step(state, (x[rows], y[rows]))
    res['sharded_steps'] = full_state_dict(state)
    assert_sharded_below(state, 200)
    launcher = Launcher(os.path.join(out, f'launcher{rank}'), model, tx, device='cpu', mesh=mesh)
    launcher._state = state
    try:
        launcher.local_state()
        res['local_state'] = 'returned'
    except ValueError as e:
        res['local_state'] = str(e)
    replicated, _ = _tiny_state(start, 'adamw', 0, mesh)
    try:
        assert_sharded_below(replicated, 200)
        res['replicated_below'] = 'passed'
    except AssertionError as e:
        res['replicated_below'] = str(e)
    res['evaluate'] = evaluations(out, rank, start, mesh)
    # the DCGAN over two ranks
    model, txs = _gan()
    gstep = build_gan_train_step(model, txs, mesh=mesh)
    gstate = create_gan_state(model, txs)
    for _ in range(2):
        gstate, gm = gstep(gstate, GAN_IMAGES[rows])
    res['gan'] = ({k: float(v) for k, v in gm.items()}, model.state_dict())
    torch.save(res, os.path.join(out, f'rank{rank}.pt'))
