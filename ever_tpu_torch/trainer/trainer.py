"""Trainer: config-driven launch (counterpart of ``ever_tpu/trainer/trainer.py``).

Import the config file and apply the command line's ``opts``, pickle the
config into the model dir, build the dataloaders, the model (on the card
unless ``--device cpu``), the LR schedule and the optimizer through the
registries, then ``Launcher.train_by_config``.

:class:`SPMDTrainer` (``th_ddp`` and ``spmd``) is the data-parallel trainer
of ``torchrun --nproc_per_node=N train.py``: it starts the process group
from torchrun's environment and trains over the data mesh, one card a
process (``parallel/spmd.py``); in one plain process it computes what
:class:`Trainer` does.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import torch

from ever_tpu_torch.core import builder, dist
from ever_tpu_torch.core.config import AttrDict, import_config, save_pkl
from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.core.logger import Logger
from ever_tpu_torch.module.resnet import resnet_frozen_prefixes
from ever_tpu_torch.parallel.mesh import make_mesh

__all__ = ['Trainer', 'SPMDTrainer', 'merge_dict', 'half_bn']


def merge_dict(a: dict, b: dict) -> dict:
    """Merge two dicts; a key in both raises."""
    out = dict(a)
    for k, v in b.items():
        if k in out:
            raise ValueError(f'duplicate key in merge_dict: {k!r}')
        out[k] = v
    return out


def half_bn(model):
    """Kept so that reference call sites port unchanged.  Precision is the
    model's ``dtype`` config here, and the norms compute their statistics
    in float32 under bf16 compute, so there is nothing to convert."""
    return model


class Trainer:
    def __init__(self, args):
        self.args = args
        self._device = get_device(getattr(args, 'device', None))
        self._config = import_config(args.config_path)
        opts = getattr(args, 'opts', None)
        if opts:
            self._config.update_from_list(opts)
        self._model_dir = args.model_dir
        self.initialize_workspace()
        self._launcher: Optional[Launcher] = None
        self._model_fn: Optional[Callable] = None

    def initialize_workspace(self) -> None:
        """Make the model dir and keep the config there (``config.pkl``) for
        inference-time rebuilds."""
        if dist.is_main_process():
            os.makedirs(self._model_dir, exist_ok=True)
            save_pkl(self._config, os.path.join(self._model_dir, 'config.pkl'))

    @property
    def config(self) -> AttrDict:
        return self._config

    @property
    def model_dir(self) -> str:
        return self._model_dir

    @property
    def launcher(self) -> Optional[Launcher]:
        return self._launcher

    @property
    def device(self):
        return self._device

    # -- factories -----------------------------------------------------------
    def make_model(self):
        """Build the model on the trainer's device; ``--mixed_precision
        bf16`` sets its compute dtype unless the config names one.  Its
        initial weights are drawn from the config's ``seed`` (42 by
        default), as the JAX launcher's are, without touching the caller's
        generator."""
        model_cfg = self._config.model
        if getattr(self.args, 'mixed_precision', 'fp32') == 'bf16':
            model_cfg.setdefault('params', AttrDict()).setdefault('dtype', 'bfloat16')
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(self._config.get('seed', 42)))
            model = builder.make_model(model_cfg, device=self._device)
        if self._model_fn is not None:
            model = self._model_fn(model)
        return model

    def model_fn(self, fn: Callable) -> None:
        """Hook that wraps or replaces the built model."""
        self._model_fn = fn

    def make_dataloader(self, data_cfg):
        return builder.make_dataloader(data_cfg)

    def make_lr_optimizer(self, model):
        """(schedule, update rule), clipped only when the optimizer config
        has a ``grad_clip`` key, with the model's hooks as the JAX trainer
        reads them: ``custom_param_groups`` gives learning-rate groups and
        ``frozen_param_prefixes`` the frozen parameters; a model without
        that hook whose ``encoder`` config is a ResNet's with ``freeze_at``
        freezes that encoder's first stages."""
        schedule = builder.make_learningrate(self._config.learning_rate)
        factory, opt_config = builder.make_optimizer(self._config.optimizer)
        param_groups = None
        hook = getattr(model, 'custom_param_groups', None)
        if callable(hook):
            param_groups = hook(None)
        frozen = None
        hook = getattr(model, 'frozen_param_prefixes', None)
        if callable(hook):
            frozen = tuple(hook()) or None
        if frozen is None and hasattr(model, 'config'):
            enc_cfg = model.config.get('encoder', None)
            if enc_cfg and int(enc_cfg.get('freeze_at', 0) or 0) >= 1:
                if enc_cfg.get('resnet_type'):
                    frozen = tuple('encoder.resnet.' + p for p in resnet_frozen_prefixes(
                        int(enc_cfg.freeze_at)))
                else:
                    logging.getLogger('ever_tpu_torch').warning(
                        'encoder.freeze_at=%s set but the model exposes no '
                        'frozen_param_prefixes hook and the encoder is not a '
                        'ResNet config: nothing will be frozen', enc_cfg.get('freeze_at'))
        return schedule, factory.build(schedule, grad_clip=opt_config.get('grad_clip', None),
                                       param_groups=param_groups, frozen_prefixes=frozen)

    def make_mesh(self):
        """None: one process, no data mesh."""
        return None

    def build_launcher(self) -> Launcher:
        model = self.make_model()
        schedule, tx = self.make_lr_optimizer(model)
        use_wandb = getattr(self.args, 'use_wandb', False)
        logger = Logger('ever_tpu_torch', tensorboard_logdir=self._model_dir,
                        use_tensorboard=getattr(self.args, 'use_tensorboard', False),
                        use_wandb=use_wandb,
                        wandb_config=dict(project=getattr(self.args, 'project', None),
                                          entity=getattr(self.args, 'entity', None),
                                          config=self._config.to_dict()) if use_wandb else None)
        self._launcher = Launcher(
            model_dir=self._model_dir, model=model, optimizer=tx, lr_schedule=schedule,
            mixed_precision=getattr(self.args, 'mixed_precision', 'fp32'),
            logger=logger, seed=int(self._config.get('seed', 42)),
            checkpoint_backend=self._config.get('checkpoint_backend', 'msgpack'),
            device=self._device, mesh=self.make_mesh(),
            find_unused_parameters=getattr(self.args, 'find_unused_parameters', False))
        return self._launcher

    # -- entries -------------------------------------------------------------
    def run(self, after_construct_launcher_callbacks=None):
        """Train (and evaluate, as the config's ``train`` says); returns
        ``{'config', 'launcher'}``."""
        train_dl = self.make_dataloader(self._config.data.train)
        test_dl = None
        if 'test' in self._config.get('data', {}):
            test_dl = self.make_dataloader(self._config.data.test)
        return self.train_with_dataloader(train_dl, test_dl,
                                          after_construct_launcher_callbacks)

    def train_with_dataloader(self, train_dl, test_dl=None,
                              after_construct_launcher_callbacks=None):
        tl = self.build_launcher()
        tl.info(f'config: {self.args.config_path}; model_dir: {self._model_dir}')
        tl.info(f'device: {self._device} ({dist.get_world_size()} processes)')
        for f in after_construct_launcher_callbacks or ():
            f(tl)
        tl.train_by_config(train_dl, self._config.train, test_dl)
        return dict(config=self._config, launcher=tl)

    def evaluate(self, after_construct_launcher_callbacks=None):
        """Score the model dir's last checkpoint on ``data.test``."""
        test_dl = self.make_dataloader(self._config.data.test)
        tl = self.build_launcher()
        for f in after_construct_launcher_callbacks or ():
            f(tl)
        tl.init_state()
        if not tl.init():
            # an empty model_dir would otherwise score an untrained model
            raise FileNotFoundError(
                f'no checkpoint found in {tl.model_dir!r}; evaluate() scores '
                'the last checkpoint: train first or point --model_dir at '
                'a trained run')
        return tl.evaluate(test_dl, self._config.get('train', None))


class SPMDTrainer(Trainer):
    """The data-parallel trainer (``ever_tpu/trainer/trainer.py``
    ``SPMDTrainer``; the reference's ``THDDPTrainer``): the process group
    from ``torchrun``'s environment (``nccl`` on the card, ``gloo`` with
    ``--device cpu``; a no-op in one plain process or when the caller
    started one), one card a process, and the data mesh over every process.
    The BatchNorm statistics, losses and logged metrics are those of the
    global batch, as under the JAX package's sharded batch."""

    def __init__(self, args):
        dist.init_dist_env(device=getattr(args, 'device', None))
        super().__init__(args)

    def make_mesh(self):
        return make_mesh(('data',))
