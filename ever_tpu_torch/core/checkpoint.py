"""Checkpoint save and resume with a JSON index (counterpart of
``ever_tpu/core/checkpoint.py``).

A checkpoint is one ``torch.save`` file, ``checkpoint-{step}.ckpt`` under
the model dir, holding the JAX package's three keys: ``model`` (the model's
``state_dict``, BatchNorm buffers included), ``opt`` (the optimizer's
``state_dict``) and ``global_step``.  ``checkpoint_info.json`` maps each
saved step to its file and records the ``last`` one, so a crashed run finds
where to resume.  The JAX default backend name ``'msgpack'`` selects this
format; the ``orbax`` backends are the parallel slice's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import torch

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.dist import is_main_process

__all__ = ['CheckPoint', 'is_checkpoint', 'load_model_state_from_ckpt',
           'load_model_state_dict_from_ckpt', 'remove_module_prefix', 'remove_optimizer_in_ckpt']

MODEL = 'model'
OPTIMIZER = 'opt'
GLOBALSTEP = 'global_step'
LASTCHECKPOINT = 'last'
CHECKPOINT_NAME = 'checkpoint_info.json'


def is_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and all(k in obj for k in (MODEL, OPTIMIZER, GLOBALSTEP))


class CheckPoint:
    def __init__(self, launcher=None, backend: str = 'msgpack'):
        if backend.startswith('orbax'):
            raise NotImplementedError(f'checkpoint backend {backend!r} is the '
                                      'parallel slice (ROADMAP.md A.9)')
        if backend != 'msgpack':
            raise ValueError(f'unknown checkpoint backend: {backend!r}')
        self.backend = backend
        self._launcher = launcher
        self._global_step = 0
        self._json_log: Dict[str, Any] = {LASTCHECKPOINT: dict(step=0, name='')}
        self.init_checkpoint_info_from_launcher()

    # -- global step ---------------------------------------------------------
    def set_global_step(self, value: int) -> None:
        if value < 0:
            raise ValueError('The global step must be larger than zero.')
        self._global_step = int(value)

    @property
    def global_step(self) -> int:
        return self._global_step

    def step(self) -> None:
        self._global_step += 1

    # -- wiring --------------------------------------------------------------
    def set_launcher(self, launcher) -> None:
        self._launcher = launcher
        self.init_checkpoint_info_from_launcher()

    def init_checkpoint_info_from_launcher(self) -> None:
        if self._launcher is None:
            return
        info = self.load_checkpoint_info(self._launcher.model_dir)
        if info is not None:
            self._json_log = info

    # -- save ----------------------------------------------------------------
    def save(self, filename: Optional[str] = None) -> None:
        """Write the launcher's model, optimizer and step (rank 0) and
        record the file in ``checkpoint_info.json``.  The model is the
        unwrapped one (``TrainState.model``, never its
        ``DistributedDataParallel`` wrapper), so a data-parallel run's
        checkpoint has a one-process run's keys.  No collective: a crashed
        rank saves alone."""
        if filename is None:
            filename = self.get_checkpoint_name(self.global_step)
        if is_main_process():
            state = self._launcher.state
            torch.save({MODEL: state.model.state_dict(),
                        OPTIMIZER: state.optimizer.state_dict(),
                        GLOBALSTEP: self.global_step},
                       os.path.join(self._launcher.model_dir, filename))
        self._json_log[str(self.global_step)] = filename
        if self.global_step >= self._json_log[LASTCHECKPOINT]['step']:
            self._json_log[LASTCHECKPOINT] = dict(step=self.global_step, name=filename)
        self.save_checkpoint_info(self._launcher.model_dir)
        if self._launcher.logger is not None:
            self._launcher.logger.save_log(filename)

    def save_checkpoint_info(self, model_dir: str) -> None:
        if not is_main_process():
            return
        with open(os.path.join(model_dir, CHECKPOINT_NAME), 'w') as f:
            json.dump(self._json_log, f)

    # -- load ----------------------------------------------------------------
    @staticmethod
    def load(filepath: str, device: Optional[Union[str, torch.device]] = None) -> dict:
        """Read a checkpoint file onto ``device`` (the GPU unless
        ``device='cpu'``).  The file is one this program wrote."""
        return torch.load(filepath, map_location=get_device(device),
                          weights_only=True)

    def try_resume(self) -> bool:
        """Restore the launcher's model, optimizer and step from the last
        checkpoint of its model dir; False when there is none."""
        if self._launcher is None:
            return False
        info = self.load_checkpoint_info(self._launcher.model_dir)
        if info is None or not info[LASTCHECKPOINT]['name']:
            return False
        last_path = os.path.join(self._launcher.model_dir, info[LASTCHECKPOINT]['name'])
        if not os.path.exists(last_path):
            return False
        ckpt = self.load(last_path, self._launcher.device)
        self._launcher.restore_state(model_state=ckpt[MODEL], opt_state=ckpt[OPTIMIZER],
                                     global_step=int(ckpt[GLOBALSTEP]))
        self.set_global_step(int(ckpt[GLOBALSTEP]))
        if self._launcher.logger is not None:
            self._launcher.logger.restore_log(last_path)
        return True

    @staticmethod
    def load_checkpoint_info(model_dir: str) -> Optional[dict]:
        json_path = os.path.join(model_dir, CHECKPOINT_NAME)
        if not os.path.exists(json_path):
            return None
        with open(json_path) as f:
            return json.load(f)

    @staticmethod
    def get_checkpoint_name(global_step: int) -> str:
        return f'checkpoint-{global_step}.ckpt'


def load_model_state_from_ckpt(filepath: str,
                               device: Optional[Union[str, torch.device]] = None) -> dict:
    """The model's ``state_dict`` of a checkpoint file (or the file itself
    when it holds a bare ``state_dict``)."""
    ckpt = CheckPoint.load(filepath, device)
    return ckpt[MODEL] if is_checkpoint(ckpt) else ckpt


def load_model_state_dict_from_ckpt(filepath: str,
                                    device: Optional[Union[str, torch.device]] = None) -> dict:
    """The reference's spelling of :func:`load_model_state_from_ckpt`."""
    return load_model_state_from_ckpt(filepath, device)


def remove_module_prefix(state_dict: dict, prefix: str = 'module.') -> dict:
    """``state_dict`` with ``prefix`` (DDP's ``module.``) stripped from the
    keys that start with it."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def remove_optimizer_in_ckpt(fp: str, new_fp: Optional[str] = None,
                             device: Optional[Union[str, torch.device]] = None) -> None:
    """Rewrite a checkpoint without its optimizer state (to ``new_fp``, or
    in place)."""
    ckpt = CheckPoint.load(fp, device)
    ckpt.pop(OPTIMIZER, None)
    torch.save(ckpt, new_fp or fp)
