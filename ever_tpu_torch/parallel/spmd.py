"""Train and eval step builders (PyTorch port).

Counterpart of ``ever_tpu/parallel/spmd.py``, with the same names and
metrics.  One step: the model's train forward (a loss dict) and backward for
each of ``forward_times`` microbatches, the gradients and metrics averaged
over them, then the :class:`~ever_tpu_torch.opt.optimizer.UpdateRule`
(record or clip the global norm, set ``schedule(step)``, step the
optimizer).  PyTorch runs eagerly, so there is no ``jit``: the state is
updated in place and returned.  The parameters and the optimizer state stay
float32 whatever the model's compute dtype.

BatchNorm's running statistics (the JAX ``TrainState.batch_stats``) are the
model's buffers: each train forward moves them in place, so with
``forward_times > 1`` they move once per microbatch, in order, as the JAX
step's scan carries them; ``init_params`` loads them with the parameters,
and the eval step normalises by them.

Each step's generator for the model's train-time draws (RoPE augmentation,
drop-path) is seeded from ``(rng_seed, step)``, and a microbatch's from
``(rng_seed, step, i)``: the counterpart of ``fold_in``.  ``mesh=`` (data
parallel over several cards) is the parallel slice and raises here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ever_tpu_torch.interface.module import split_metrics, sum_losses

__all__ = ['TrainState', 'create_train_state', 'build_train_step',
           'build_train_loop', 'build_eval_step', 'step_generator']

Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError('mesh= is the parallel slice, not ported yet')


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _model_args(batch, device) -> tuple:
    items = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    return tuple(torch.as_tensor(t, device=device) for t in items)


def _index(batch, i: int):
    if isinstance(batch, (tuple, list)):
        return tuple(t[i] for t in batch)
    return batch[i]


def step_generator(rng_seed: int, step: int, micro: Optional[int] = None,
                   device='cpu') -> torch.Generator:
    """The generator of one step (and microbatch), seeded from the tuple."""
    key = (rng_seed, step) if micro is None else (rng_seed, step, micro)
    return torch.Generator(device=device).manual_seed(hash(key) & (2 ** 63 - 1))


def create_train_state(model: torch.nn.Module, tx, sample_batch=None, rng=None,
                       init_params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """The model, its optimizer (``tx.init`` over its trainable parameters,
    by name) and step 0.  ``init_params``, a ``state_dict`` (pretrained weights, e.g.
    from ``util.weight_io``), is loaded first.  ``sample_batch`` and ``rng``
    are the JAX initialiser's inputs, taken so that call sites read alike: a
    PyTorch module is built with its parameters, so neither is used."""
    del sample_batch, rng
    if init_params is not None:
        model.load_state_dict(init_params, strict=True)
    optimizer = tx.init((n, p) for n, p in model.named_parameters() if p.requires_grad)
    return TrainState(step=0, model=model, optimizer=optimizer)


def _forward_backward(model, batch, generator) -> Metrics:
    out = model(*_model_args(batch, _device(model)), train=True,
                generator=generator)
    if not isinstance(out, dict):
        raise TypeError('training forward must return a dict of losses/metrics '
                        '(keys ending in "loss" are summed)')
    total = sum_losses(out)
    total.backward()
    metrics = split_metrics(out)
    metrics['total_loss'] = total.detach()
    return metrics


def build_train_step(model: torch.nn.Module, tx,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     forward_times: int = 1, mesh=None, rng_seed: int = 0
                     ) -> Callable:
    """``step(state, batch) -> (state, metrics)``.

    ``batch`` is a tuple of the model's positional inputs (``(x, y)``),
    each with a leading ``forward_times`` microbatch axis when
    ``forward_times > 1``.  Metrics are 0-d float32 tensors on the device:
    the model's loss entries, ``total_loss``, ``grad_norm`` (before the
    clip) and, with ``lr_schedule``, ``learning_rate`` at the step's count.
    """
    _no_mesh(mesh)

    def step(state: TrainState, batch):
        opt = state.optimizer
        # the model's: frozen parameters' gradients are no optimizer's
        model.zero_grad(set_to_none=True)
        dev = _device(model)
        if forward_times == 1:
            metrics = _forward_backward(
                model, batch, step_generator(rng_seed, state.step, device=dev))
        else:
            parts = [_forward_backward(model, _index(batch, i),
                                       step_generator(rng_seed, state.step, i, dev))
                     for i in range(forward_times)]
            metrics = {k: sum(m[k] for m in parts) / forward_times for k in parts[0]}
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(forward_times)
        metrics['grad_norm'] = tx.apply(opt, state.step)
        if lr_schedule is not None:
            metrics['learning_rate'] = torch.tensor(float(lr_schedule(state.step)))
        state.step += 1
        return state, metrics

    return step


def build_train_loop(model: torch.nn.Module, tx,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     steps_per_loop: int = 1, forward_times: int = 1, mesh=None,
                     rng_seed: int = 0) -> Callable:
    """K optimizer steps per call: ``loop(state, batches) -> (state,
    metrics)``, where every input of ``batches`` carries a leading
    ``steps_per_loop`` axis.  Metrics are the mean over the K steps, except
    ``learning_rate`` and ``grad_norm``, which report the last step."""
    step = build_train_step(model, tx, lr_schedule, forward_times, mesh, rng_seed)

    def loop(state: TrainState, batches):
        per_step = []
        for k in range(steps_per_loop):
            state, m = step(state, _index(batches, k))
            per_step.append(m)
        last = per_step[-1]
        return state, {k: (last[k] if k in ('learning_rate', 'grad_norm')
                           else torch.stack([m[k] for m in per_step]).mean())
                       for k in last}

    return loop


def build_eval_step(model: torch.nn.Module, mesh=None) -> Callable:
    """``eval_step(state, batch) -> model output`` (eval mode, no grad)."""
    _no_mesh(mesh)

    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            return model(*_model_args(batch, _device(model)), train=False)

    return eval_step
