"""Trainer: config-driven launch (counterpart of ``ever_tpu/trainer/trainer.py``).

Import the config file and apply the command line's ``opts``, pickle the
config into the model dir, build the dataloaders, the model (on the card
unless ``--device cpu``), the LR schedule and the optimizer through the
registries, then ``Launcher.train_by_config``.  ``th_ddp`` and ``spmd`` run
on one card here: several cards are the parallel slice (``ROADMAP.md``
A.9).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ever_tpu_torch.core import builder, dist
from ever_tpu_torch.core.config import AttrDict, import_config, save_pkl
from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.launcher import Launcher
from ever_tpu_torch.core.logger import Logger

__all__ = ['Trainer', 'merge_dict', 'half_bn']


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
        bf16`` sets its compute dtype unless the config names one."""
        model_cfg = self._config.model
        if getattr(self.args, 'mixed_precision', 'fp32') == 'bf16':
            model_cfg.setdefault('params', AttrDict()).setdefault('dtype', 'bfloat16')
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
        has a ``grad_clip`` key.  No ported model defines custom parameter
        groups or frozen prefixes yet (``util/param_util``, ``ROADMAP.md``
        A.4)."""
        del model
        schedule = builder.make_learningrate(self._config.learning_rate)
        factory, opt_config = builder.make_optimizer(self._config.optimizer)
        return schedule, factory.build(schedule, grad_clip=opt_config.get('grad_clip', None))

    def build_launcher(self) -> Launcher:
        model = self.make_model()
        schedule, tx = self.make_lr_optimizer(model)
        logger = Logger('ever_tpu_torch', tensorboard_logdir=self._model_dir,
                        use_tensorboard=getattr(self.args, 'use_tensorboard', False),
                        use_wandb=getattr(self.args, 'use_wandb', False))
        self._launcher = Launcher(
            model_dir=self._model_dir, model=model, optimizer=tx, lr_schedule=schedule,
            mixed_precision=getattr(self.args, 'mixed_precision', 'fp32'),
            logger=logger, seed=int(self._config.get('seed', 42)),
            checkpoint_backend=self._config.get('checkpoint_backend', 'msgpack'),
            device=self._device)
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
