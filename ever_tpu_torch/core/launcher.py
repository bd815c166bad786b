"""Launcher: the training engine's host side (counterpart of
``ever_tpu/core/launcher.py``).

One step on the device is ``parallel/spmd.py``'s train step (forward,
backward, clip, learning rate, optimizer); the launcher does what surrounds
it: iteration counting, per-step sampler reseeding, epoch-boundary
callbacks (checkpoints, evaluation), the batches' copy to the device,
logging, evaluation routing, resume, and a checkpoint of the step a crash
interrupted.

The host never waits for the card except where it must.  Batches are
pinned and copied asynchronously; a step's metrics are copied to the host
only when the step is logged (every ``log_interval_step``), asynchronously
behind a CUDA event, and read after the next step has been queued, so one
step stays in flight, as the JAX loop's ``pending`` step does.
"""

from __future__ import annotations

import os
import time
import types
from typing import Callable, Dict, List, Optional, Union

import torch
from torch.utils._pytree import tree_map

from ever_tpu_torch.core import dist
from ever_tpu_torch.core.checkpoint import CheckPoint
from ever_tpu_torch.core.config import AttrDict
from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.iterator import get_iterator
from ever_tpu_torch.core.logger import Logger
from ever_tpu_torch.interface.callback import (
    Callback,
    EvaluationCallback,
    SaveCheckpointCallback,
)
from ever_tpu_torch.parallel.spmd import (
    build_eval_step,
    build_train_loop,
    build_train_step,
    create_train_state,
)

__all__ = ['Launcher']


def _stack(trees):
    """Stack a list of batches (tuples/dicts of tensors) on a new leading
    axis."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(g)) for g in zip(*trees))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


class _PendingMetrics:
    """A logged step's metrics on their way to the host: device values are
    stacked and copied into pinned memory behind a CUDA event, host values
    kept as they are."""

    def __init__(self, step: int, metrics: Dict[str, torch.Tensor]):
        self.step = step
        self._keys = list(metrics)
        on_card = [k for k in self._keys if metrics[k].device.type == 'cuda']
        self._host = {k: float(v) for k, v in metrics.items() if k not in on_card}
        self._on_card = on_card
        self._event = None
        if on_card:
            self._values = torch.stack([metrics[k].float() for k in on_card]).to(
                'cpu', non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def read(self) -> Dict[str, float]:
        """Wait for this step's metrics (not for the steps queued after it)."""
        values = dict(self._host)
        if self._event is not None:
            self._event.synchronize()
            values.update(zip(self._on_card, self._values.tolist()))
        return {k: values[k] for k in self._keys}


class Launcher:
    def __init__(self,
                 model_dir: str,
                 model: torch.nn.Module,
                 optimizer,                       # an opt.optimizer.UpdateRule
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 mixed_precision: str = 'fp32',
                 mesh=None,
                 logger: Optional[Logger] = None,
                 seed: int = 42,
                 checkpoint_backend: str = 'msgpack',
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise NotImplementedError('mesh= (several cards) is the parallel '
                                      'slice (ROADMAP.md A.9)')
        self._device = get_device(device)
        self._model_dir = model_dir
        self._model = model.to(self._device)
        self._tx = optimizer
        self._lr_schedule = lr_schedule
        self._mixed_precision = mixed_precision
        self._seed = seed
        self._state = None
        self._train_step = None
        self._eval_step = None
        self._forward_times = 1
        self._callbacks: List[Callback] = []
        self._master = dist.is_main_process()
        if self._master and model_dir:
            os.makedirs(model_dir, exist_ok=True)
        self._logger = logger or Logger('ever_tpu_torch', tensorboard_logdir=model_dir or None)
        self._ckpt = CheckPoint(self, backend=checkpoint_backend)
        self._evaluate_fn: Optional[Callable] = None
        self._init_state_dict = None

    # -- properties ----------------------------------------------------------
    @property
    def model(self) -> torch.nn.Module:
        return self._model

    unwrapped_model = model
    model_without_ddp = model

    @property
    def state(self):
        return self._state

    @property
    def optimizer(self):
        return self._tx

    @property
    def lr_schedule(self):
        return self._lr_schedule

    @property
    def model_dir(self) -> str:
        return self._model_dir

    @property
    def checkpoint(self) -> CheckPoint:
        return self._ckpt

    @property
    def global_step(self) -> int:
        return self._ckpt.global_step

    @property
    def lr(self) -> float:
        if self._lr_schedule is None:
            return 0.0
        return float(self._lr_schedule(self.global_step))

    @property
    def logger(self) -> Logger:
        return self._logger

    @property
    def mesh(self):
        return None

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    @property
    def device(self) -> torch.device:
        return self._device

    def info(self, msg: str) -> None:
        self._logger.info(msg)

    # -- state ---------------------------------------------------------------
    def set_pretrained_state(self, state_dict: Optional[Dict[str, torch.Tensor]]) -> None:
        """A ``state_dict`` (e.g. from ``util.weight_io``) loaded into the
        model when the train state is made."""
        self._init_state_dict = state_dict

    def init_state(self) -> None:
        """Make the train state (optimizer and step 0) once.  A PyTorch model
        holds its parameters already, so unlike the JAX launcher this needs
        no sample batch."""
        if self._state is not None:
            return
        weight = (self._model_config().get('GLOBAL') or {}).get('weight') or {}
        if weight.get('path'):
            raise NotImplementedError('GLOBAL.weight.path needs weight_io.load_weights, '
                                      'not ported yet (ROADMAP.md A.4)')
        self._state = create_train_state(self._model, self._tx,
                                         init_params=self._init_state_dict)

    def restore_state(self, model_state, opt_state, global_step: int) -> None:
        if self._state is None:
            raise RuntimeError('init_state must run before restore_state')
        self._model.load_state_dict(model_state)
        # step counters stay host scalars, as torch.optim keeps them (a
        # counter on the card makes every update read it back)
        for st in opt_state['state'].values():
            if torch.is_tensor(st.get('step')):
                st['step'] = st['step'].cpu()
        self._state.optimizer.load_state_dict(opt_state)
        self._state.step = int(global_step)

    def _model_config(self) -> dict:
        return getattr(self._model, 'config', None) or {}

    # -- callbacks -----------------------------------------------------------
    def register_callback(self, *callbacks: Callback) -> None:
        for cb in callbacks:
            cb.set_launcher(self)
            self._callbacks.append(cb)

    register_callbacks = register_callback

    def run_callbacks(self, stage_name: str) -> None:
        for f in self._callbacks:
            if getattr(f, stage_name) and (not f.only_master or self._master):
                f.func()

    # -- evaluation ----------------------------------------------------------
    def override_evaluate(self, fn: Callable) -> None:
        """Inject an evaluation method: ``fn(self, dataloader, config)``."""
        self._evaluate_fn = types.MethodType(fn, self)

    def evaluate(self, data_loader, config=None):
        if self._evaluate_fn is None:
            fn = self._default_evaluate_fn(data_loader)
            if fn is None:
                self.info('no evaluate fn injected (override_evaluate); skipping eval')
                return None
            self.override_evaluate(fn)
        return self._evaluate_fn(data_loader, config)

    def _default_evaluate_fn(self, data_loader):
        """The evaluation for a model that declares its class count, chosen
        from the labels of one dataset sample: a plain mask → pixel task,
        ``{'change', ...}`` → binary change detection, ``{'damage', ...}``
        → damage assessment."""
        cfg = self._model_config()
        classes = cfg.get('classes', None) or cfg.get('num_classes', None)
        damage_classes = cfg.get('damage_classes', None)
        if not classes and not damage_classes:
            return None
        if dist.get_world_size() > 1:
            self.info('multi-process run: auto eval is disabled; wire a '
                      'distributed evaluate fn via override_evaluate')
            return None
        ds = getattr(data_loader, 'dataset', None)
        sample = None
        try:
            if ds is not None and len(ds) > 0:
                sample = ds[0]
        except TypeError:
            pass
        if sample is None:
            self.info('cannot inspect eval labels (loader exposes no sized '
                      'dataset); wire a fn via override_evaluate')
            return None
        y = (sample[1] if isinstance(sample, (tuple, list)) and len(sample) > 1 else None)
        from ever_tpu_torch.metric import evaluate_fn as E
        if isinstance(y, dict) and 'damage' in y and damage_classes:
            self.info(f'auto-injecting damage-assessment eval (damage_classes='
                      f'{damage_classes}); use override_evaluate for custom evaluation')
            return E.evaluate_damage_assessment_task(int(damage_classes))
        if isinstance(y, dict) and 'change' in y:
            self.info('auto-injecting binary change-detection eval; use '
                      'override_evaluate for custom evaluation')
            return E.evaluate_change_detection_task()
        if hasattr(y, 'shape') and classes:
            self.info(f'auto-injecting pixel-prediction eval (classes={classes}); '
                      'use override_evaluate for custom evaluation')
            return E.evaluate_pixel_prediction_task(int(classes))
        self.info(f'eval labels are {type(y).__name__}; no auto eval applies: '
                  'wire a custom fn via override_evaluate. Skipping eval.')
        return None

    def evaluate_last_ckpt(self, data_loader, config=None):
        self.init_state()
        self.init()
        return self.evaluate(data_loader, config)

    # -- steps ---------------------------------------------------------------
    def _ensure_train_step(self, forward_times: int) -> None:
        if self._train_step is None or self._forward_times != forward_times:
            self._forward_times = forward_times
            self._train_step = build_train_step(
                self._model, self._tx, self._lr_schedule,
                forward_times=forward_times, rng_seed=self._seed)

    def get_eval_step(self):
        if self._eval_step is None:
            self._eval_step = build_eval_step(self._model)
        return self._eval_step

    def _to_device(self, batch):
        """The batch on the launcher's device.  Host memory is pinned first:
        a copy from pageable memory would wait for the card to finish every
        queued step."""
        def move(t):
            t = torch.as_tensor(t)
            if self._device.type == 'cuda' and t.device.type == 'cpu' and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self._device, non_blocking=True)
        return tree_map(move, batch)

    # -- training loop -------------------------------------------------------
    def train_iters(self, train_data_loader, test_data_loader=None, **kwargs):
        num_iters = kwargs.get('num_iters', -1)
        if num_iters <= 0:
            raise ValueError('num_iters must be positive')
        if kwargs.get('profile_dir', None):
            raise NotImplementedError('profile_dir (a trace of the loop) is not '
                                      'ported yet')
        forward_times = kwargs.get('forward_times', 1)
        steps_per_loop = int(kwargs.get('steps_per_loop', 1))
        eval_per_epoch = kwargs.get('eval_per_epoch', False)
        eval_interval_epoch = kwargs.get('eval_interval_epoch', -1)
        eval_after_train = kwargs.get('eval_after_train', False)
        log_interval_step = kwargs.get('log_interval_step', 1)
        iterator_type = kwargs.get('iterator_type', 'normal')
        save_ckpt_interval_epoch = kwargs.get('save_ckpt_interval_epoch', 1)
        dist_eval = kwargs.get('distributed_evaluate', False)
        distributed = kwargs.get('distributed', True)

        iterator = get_iterator(iterator_type)(train_data_loader)
        iterator.set_start_step(self._ckpt.global_step)

        # a previous train_iters call's auto-registered callbacks go; the
        # user's stay
        self._callbacks = [cb for cb in self._callbacks
                           if not getattr(cb, '_auto_registered', False)]
        save_cb = SaveCheckpointCallback(save_ckpt_interval_epoch)
        save_cb._auto_registered = True
        self.register_callback(save_cb)
        if eval_per_epoch or eval_after_train:
            if eval_per_epoch and eval_interval_epoch <= 0:
                raise ValueError('eval_interval_epoch must be positive when '
                                 'eval_per_epoch = True')
            if not eval_per_epoch and eval_interval_epoch > 0:
                raise ValueError('eval_per_epoch should be True when '
                                 'eval_interval_epoch > 0')
            eval_cb = EvaluationCallback(
                test_data_loader, eval_interval_epoch, not dist_eval,
                config=AttrDict(kwargs), after_train=eval_after_train)
            eval_cb._auto_registered = True
            self.register_callback(eval_cb)
        self._callbacks.sort(key=lambda cb: cb.prior)

        self.run_callbacks('before_train')
        self._logger.forward_times_log(forward_times)
        try:
            self._train_loop(iterator, num_iters, forward_times, distributed,
                             log_interval_step, steps_per_loop)
        except (KeyboardInterrupt, Exception):
            # make the interrupted step resumable
            if self._state is not None and self._ckpt.global_step > 0:
                try:
                    self._ckpt.save()
                    self.info(f'crash-saved checkpoint at step {self._ckpt.global_step}')
                except Exception as e:          # the original error is raised below
                    self.info(f'crash-save failed: {e!r}')
            raise
        self.run_callbacks('after_train')
        self._logger.after_train()

    def _train_loop(self, iterator, num_iters, forward_times, distributed,
                    log_interval_step, steps_per_loop):
        """One step per dispatch, or ``steps_per_loop`` of them (``spmd``'s
        train loop, the metrics their mean).  A step is logged when its
        count is a multiple of ``log_interval_step`` (every dispatch when
        ``steps_per_loop`` is larger) and at the end; its time is the wall
        time per step since the previous logged step, its data time the
        share of it spent loading, in callbacks and copying batches."""
        loops: Dict[int, Callable] = {}
        pending = None
        since = (self._ckpt.global_step, time.perf_counter(), 0.0)
        while self._ckpt.global_step < num_iters:
            k = min(steps_per_loop, num_iters - self._ckpt.global_step)
            t0 = time.perf_counter()
            stage = []
            for i in range(k):
                if distributed:
                    iterator.set_seed_for_dist_sampler(self._ckpt.global_step + i)
                data_list = iterator.next(forward_times, call_backs=self._callbacks,
                                          is_master=self._master)
                stage.append(data_list[0] if forward_times == 1 else _stack(data_list))
            batch = self._to_device(stage[0] if steps_per_loop == 1 else _stack(stage))
            data_time = time.perf_counter() - t0

            self.init_state()
            if steps_per_loop == 1:
                self._ensure_train_step(forward_times)
                self._state, metrics = self._train_step(self._state, batch)
            else:
                if k not in loops:
                    loops[k] = build_train_loop(
                        self._model, self._tx, self._lr_schedule, steps_per_loop=k,
                        forward_times=forward_times, rng_seed=self._seed)
                self._state, metrics = loops[k](self._state, batch)
            for _ in range(k):
                self._ckpt.step()
            step = self._ckpt.global_step
            since = since[:2] + (since[2] + data_time,)
            if pending is not None:
                since = self._log_step(pending, num_iters, since)
                pending = None
            if (step % log_interval_step == 0 or steps_per_loop > log_interval_step
                    or step == num_iters):
                pending = _PendingMetrics(step, metrics)
        if pending is not None:
            self._log_step(pending, num_iters, since)

    def _log_step(self, pending: _PendingMetrics, num_iters: int, since):
        host = pending.read()
        now = time.perf_counter()
        last_step, last_time, data_time = since
        n = max(pending.step - last_step, 1)
        lr = host.pop('learning_rate', self.lr)
        self._logger.train_log(pending.step, num_iters, host, data_time / n,
                               (now - last_time) / n, lr)
        return pending.step, now, 0.0

    # -- config-driven entry -------------------------------------------------
    def train_by_config(self, train_data_loader, config, test_data_loader=None):
        cfg = dict(config)
        if cfg.get('resume_from_last', True):
            self.init_state()
            self.init()
        self.train_iters(train_data_loader, test_data_loader, **cfg)

    def init(self) -> bool:
        """Resume from the last checkpoint if one exists."""
        return self._ckpt.try_resume()

    def save_model(self, filename: Optional[str] = None) -> None:
        self._ckpt.save(filename or 'model-saved.ckpt')
