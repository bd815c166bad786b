"""GAN training: one step updates the discriminator, then the generator,
each with its own optimizer (counterpart of ``ever_tpu/trainer/gan.py``).

Contract: a GAN ``ERModule`` has two children ``G`` and ``D`` and two
methods, ``d_loss(batch, train, generator)`` and ``g_loss(batch, train,
generator)``, each taking the batch whole and returning a loss dict (keys
ending in ``loss`` are summed).  The D update trains ``D`` on ``d_loss``;
then the G update trains ``G`` on ``g_loss``, whose gradient reaches D's
parameters too but only G's optimizer steps.  ``learning_rate`` and
``optimizer`` configs are ``{'G': ..., 'D': ...}`` dicts or one shared
config.

The metrics are the JAX step's: each role's loss entries as
``{role}_{key}`` (``D_d_loss``, ``D_d_real_acc``, ``G_g_loss``), the
pre-clip gradient norms ``d_grad_norm`` and ``g_grad_norm``, and with
schedules ``d_lr`` and ``g_lr`` at the step's count.  Each role's draws
(the latent) come from a generator seeded from ``(rng_seed, step,
ord(role))``, as the JAX step folds ``ord(role)`` into the step's key.

Under a data mesh each role's loss is a module of its own wrapped in
``DistributedDataParallel`` (:class:`_RoleLoss`): its parameters are that
role's alone, so each update averages exactly its role's gradients over
the ranks, and no parameter of the wrapped module goes without a gradient
(G runs without a graph in ``d_loss``).  Calling the model's methods
directly would skip DDP's forward and leave each rank on its own
gradients.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.utils._pytree import tree_map

from ever_tpu_torch.core import builder
from ever_tpu_torch.core.config import AttrDict
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.core.logger import Logger
from ever_tpu_torch.interface.module import split_metrics, sum_losses
from ever_tpu_torch.parallel.spmd import _device, _mean_over, step_generator
from ever_tpu_torch.trainer.trainer import SPMDTrainer

__all__ = ['GANState', 'create_gan_state', 'build_gan_train_step',
           'GANLauncher', 'GANSPMDTrainer']

ROLES = (('D', 'd_loss'), ('G', 'g_loss'))


@dataclass
class GANState:
    """The step count, the model and one optimizer a role
    (``{'G': ..., 'D': ...}``)."""
    step: int
    model: nn.Module
    optimizer: Dict[str, torch.optim.Optimizer]


def create_gan_state(model: nn.Module, txs: Dict[str, Any], sample_batch=None, rng=None,
                     init_params: Optional[Dict[str, torch.Tensor]] = None) -> GANState:
    """Step 0 and each role's optimizer (``txs[role].init`` over the role's
    named parameters).  ``init_params``, a ``state_dict``, is loaded first;
    ``sample_batch`` and ``rng`` are the JAX initialiser's inputs, unused
    (a PyTorch module holds its parameters already)."""
    del sample_batch, rng
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    return GANState(step=0, model=model, optimizer={
        role: tx.init((n, p) for n, p in getattr(model, role).named_parameters()
                      if p.requires_grad)
        for role, tx in txs.items()})


class _RoleLoss(nn.Module):
    """One role's loss as a module whose parameters are the role's: the
    unit ``DistributedDataParallel`` wraps (module docstring)."""

    def __init__(self, gan: nn.Module, role: str, method: str):
        super().__init__()
        self.net = getattr(gan, role)
        object.__setattr__(self, 'gan', gan)      # not a child: its other role stays out
        self.method = method

    def forward(self, batch, generator=None):
        return getattr(self.gan, self.method)(batch, train=True, generator=generator)


def build_gan_train_step(model: nn.Module, txs: Dict[str, Any],
                         lr_schedules: Optional[Dict[str, Callable[[int], float]]] = None,
                         mesh=None, rng_seed: int = 0) -> Callable:
    """``step(state, batch) -> (state, metrics)``: the D update, then the G
    update, on the same batch (this process's share under ``mesh``).
    Metrics are 0-d float32 tensors (module docstring), averaged over the
    mesh's ranks."""
    grouped = mesh is not None and mesh.group is not None
    losses = {role: _RoleLoss(model, role, method) for role, method in ROLES}
    nets = {role: mesh.data_parallel(m) if grouped else m for role, m in losses.items()}
    scope = mesh if mesh is not None else contextlib.nullcontext()

    def step(state: GANState, batch):
        dev = _device(model)
        batch = tree_map(lambda t: torch.as_tensor(t, device=dev), batch)
        metrics = {}
        for role, _ in ROLES:
            model.zero_grad(set_to_none=True)
            gen = step_generator(rng_seed, state.step, ord(role), device=dev)
            with scope:
                out = nets[role](batch, gen)
            sum_losses(out).backward()
            metrics.update({f'{role}_{k}': v for k, v in split_metrics(out).items()})
            metrics[f'{role.lower()}_grad_norm'] = txs[role].apply(state.optimizer[role],
                                                                  state.step)
        model.zero_grad(set_to_none=True)
        if grouped and mesh.size() > 1:
            metrics = _mean_over(mesh, metrics)
        for role, sched in (lr_schedules or {}).items():
            metrics[f'{role.lower()}_lr'] = torch.tensor(float(sched(state.step)))
        state.step += 1
        return state, metrics

    return step


class GANLauncher(Launcher):
    """The launcher of a GAN: the state holds one optimizer a role
    (``optimizers`` and ``lr_schedules`` are ``{'G': ..., 'D': ...}``); the
    checkpoints hold both optimizers' states."""

    def __init__(self, *args, optimizers: Optional[Dict[str, Any]] = None,
                 lr_schedules: Optional[Dict[str, Any]] = None, **kwargs):
        kwargs.pop('optimizer', None)
        kwargs.pop('lr_schedule', None)
        super().__init__(*args, optimizer=None, lr_schedule=None, **kwargs)
        self._txs = optimizers or {}
        self._schedules = lr_schedules or {}

    @property
    def optimizer(self):
        return self._txs

    @property
    def lr(self) -> float:
        if 'G' in self._schedules:
            return float(self._schedules['G'](self.global_step))
        return 0.0

    def init_state(self, sample_batch=None) -> None:
        if self._state is not None:
            return
        self._state = create_gan_state(self._model, self._txs,
                                       init_params=self._init_state_dict)

    def _ensure_train_step(self, forward_times: int) -> None:
        if forward_times != 1:
            raise NotImplementedError('GAN training does not support '
                                      'gradient accumulation yet')
        if self._train_step is None:
            self._train_step = build_gan_train_step(
                self._model, self._txs, self._schedules, mesh=self._mesh,
                rng_seed=self._seed)

    def _train_loop_k(self, *args, **kwargs):
        raise NotImplementedError(
            'GAN training does not support train.steps_per_loop > 1 yet — '
            'the K-step loop would build a non-GAN step over the dict-of-'
            'optimizers state; set steps_per_loop=1')

    def _train_loop(self, iterator, num_iters, forward_times, distributed,
                    log_interval_step, steps_per_loop, *args, **kwargs):
        if steps_per_loop > 1:
            self._train_loop_k(iterator, num_iters, steps_per_loop)
        return super()._train_loop(iterator, num_iters, forward_times, distributed,
                                   log_interval_step, steps_per_loop, *args, **kwargs)


class GANSPMDTrainer(SPMDTrainer):
    """Builds the two-optimizer launcher from ``{'G':…, 'D':…}`` (or shared)
    ``learning_rate`` and ``optimizer`` configs; data parallel over the
    processes ``torchrun`` starts, as :class:`SPMDTrainer`."""

    def _per_role_cfg(self, cfg) -> Dict[str, AttrDict]:
        if 'G' in cfg and 'D' in cfg:
            return {r: cfg[r] for r in ('G', 'D')}
        return {'G': cfg, 'D': cfg}

    def build_launcher(self):
        model = self.make_model()
        lr_cfgs = self._per_role_cfg(self._config.learning_rate)
        opt_cfgs = self._per_role_cfg(self._config.optimizer)
        schedules, txs = {}, {}
        for role in ('G', 'D'):
            schedules[role] = builder.make_learningrate(lr_cfgs[role])
            factory, opt_cfg = builder.make_optimizer(opt_cfgs[role])
            txs[role] = factory.build(schedules[role], grad_clip=opt_cfg.get('grad_clip'))
        use_wandb = getattr(self.args, 'use_wandb', False)
        logger = Logger('ever_tpu_torch', tensorboard_logdir=self._model_dir,
                        use_tensorboard=getattr(self.args, 'use_tensorboard', False),
                        use_wandb=use_wandb,
                        wandb_config=dict(project=getattr(self.args, 'project', None),
                                          entity=getattr(self.args, 'entity', None),
                                          config=self._config.to_dict()) if use_wandb else None)
        self._launcher = GANLauncher(
            model_dir=self._model_dir, model=model, optimizers=txs, lr_schedules=schedules,
            mixed_precision=getattr(self.args, 'mixed_precision', 'fp32'),
            logger=logger, seed=int(self._config.get('seed', 42)),
            checkpoint_backend=self._config.get('checkpoint_backend', 'msgpack'),
            device=self._device, mesh=self.make_mesh())
        return self._launcher
