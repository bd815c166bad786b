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
``(rng_seed, step, i)``: the counterpart of ``fold_in``.

``mesh=`` (``parallel/mesh.py``) makes the step data parallel over the
mesh's processes, one card each, as the JAX step is over a batch sharded on
``'data'``: each process passes its share of the global batch.  The model
is wrapped once in ``DistributedDataParallel``, which averages the
gradients over the ranks (microbatches before the last run under
``no_sync()``), and the forward runs inside ``with mesh:``, where the
BatchNorm statistics, the losses' sums and the drop-path draws are those of
the global batch.  The metrics are averaged over the ranks with one
``all_reduce``, so they are the global values the JAX step reports.  The
eval step stays rank-local: each process predicts its own batches.

``state_shardings=`` (from ``parallel/zero.py`` ``zero_init`` or
``parallel/sharded.py``) makes the step a ZeRO step over the mesh: the
forward and backward run on the rank's batch without
``DistributedDataParallel``, and the state's
:class:`~ever_tpu_torch.parallel.zero.ZeroOptimizer` averages the
gradients and updates its shards; at level 3 it gathers the parameters it
holds sharded one unit at a time, as the forward and the backward reach
each unit.  The :class:`TrainState` carries the placements
(``shardings``); as in JAX, ``state_shardings`` without ``mesh`` raises.
A batch may come as ``DTensor`` leaves (``mesh.host_to_global``); the step
takes their local rows.

A layer that returns a bare tensor (``parallel/ep.py``'s ``MoEMlp``)
cannot put its auxiliary loss into the model's loss dict, so it records
it with :func:`sow_loss` into the collection the step opens around each
forward (:func:`sown_losses`); the step adds their sum as the metric
``sown_aux_loss``, which joins ``total_loss``, as the JAX step adds flax's
``'losses'`` collection.  Under tensor parallel (``parallel/tp.py``) the
mesh's batch axes are its data axes: the model's own layers reduce over
the model axis.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_map

from ever_tpu_torch.interface.module import split_metrics, sum_losses

__all__ = ['TrainState', 'create_train_state', 'build_train_step',
           'build_train_loop', 'build_eval_step', 'step_generator', 'sow_loss',
           'sown_losses']

Metrics = Dict[str, torch.Tensor]

_SOWN: contextvars.ContextVar = contextvars.ContextVar('ever_tpu_torch_sown', default=None)


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    shardings: Optional[object] = None      # parallel.zero.StateShardings under ZeRO


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _model_args(batch, device) -> tuple:
    """The model's positional inputs on ``device``: each item of the batch
    tuple, with dict, list and tuple labels (``{'masks', 'change'}``,
    ``(m1, m2, change)``) recursed into and their leaves made tensors, as
    ``core/to.py`` recurses."""
    items = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    return tuple(tree_map(lambda t: torch.as_tensor(_local(t), device=device), t)
                 for t in items)


def _local(t):
    """A ``DTensor`` leaf's local rows (``mesh.host_to_global``); any other
    leaf as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _index(batch, i: int):
    """Microbatch (or step) ``i`` of every leaf of the batch."""
    return tree_map(lambda t: t[i], batch)


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


@contextlib.contextmanager
def sown_losses():
    """Open a ``'losses'`` collection for the forward inside the block: every
    :func:`sow_loss` there records into the dict it yields (``{name:
    [values]}``), as flax's ``apply(..., mutable=['losses'])`` collects a
    layer's ``sow('losses', ...)``."""
    sown: Dict[str, list] = {}
    token = _SOWN.set(sown)
    try:
        yield sown
    finally:
        _SOWN.reset(token)


def sow_loss(name: str, value: torch.Tensor) -> None:
    """Record a layer's auxiliary loss ``value`` under ``name`` in the open
    :func:`sown_losses` collection (the train step opens one around each
    forward); with none open it is dropped, as flax drops a ``sow`` into a
    collection that is not mutable."""
    sown = _SOWN.get()
    if sown is not None:
        sown.setdefault(name, []).append(value)


def _forward_backward(model, net, batch, generator) -> Metrics:
    with sown_losses() as sown:
        out = net(*_model_args(batch, _device(model)), train=True, generator=generator)
    if not isinstance(out, dict):
        raise TypeError('training forward must return a dict of losses/metrics '
                        '(keys ending in "loss" are summed)')
    if sown:
        out = dict(out)
        out['sown_aux_loss'] = sum(v.float().sum() for vs in sown.values() for v in vs)
    total = sum_losses(out)
    total.backward()
    metrics = split_metrics(out)
    metrics['total_loss'] = total.detach()
    return metrics


def _mean_over(mesh, metrics: Metrics) -> Metrics:
    """Every metric's mean over the mesh's ranks: one ``all_reduce`` of the
    stacked values."""
    keys = list(metrics)
    values = torch.stack([metrics[k].double() for k in keys])
    tdist.all_reduce(values, group=mesh.group)
    values /= mesh.size()
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, values)}


def build_train_step(model: torch.nn.Module, tx,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     forward_times: int = 1, mesh=None, rng_seed: int = 0,
                     find_unused_parameters: bool = False,
                     state_shardings=None) -> Callable:
    """``step(state, batch) -> (state, metrics)``.

    ``batch`` is a tuple of the model's positional inputs (``(x, y)``;
    ``y`` may be a dict, list or tuple of arrays), every array with a
    leading ``forward_times`` microbatch axis when ``forward_times > 1``.
    Metrics are 0-d float32 tensors on the device:
    the model's loss entries, ``total_loss``, ``grad_norm`` (before the
    clip) and, with ``lr_schedule``, ``learning_rate`` at the step's count.
    With ``mesh`` over a process group, ``batch`` is this process's share
    and the step is data parallel (module docstring);
    ``find_unused_parameters`` is passed to ``DistributedDataParallel``.
    ``state_shardings`` makes it a ZeRO step (module docstring).
    """
    if state_shardings is not None:
        if mesh is None:
            # dropping the placements would replicate the state: the memory
            # ZeRO was configured to save
            raise ValueError('state_shardings requires mesh= (they are NamedShardings '
                             'over a mesh)')
        return _zero_step(model, tx, lr_schedule, forward_times, mesh, rng_seed)
    grouped = mesh is not None and mesh.group is not None
    net = mesh.data_parallel(model, find_unused_parameters) if grouped else model
    scope = mesh if mesh is not None else contextlib.nullcontext()

    def step(state: TrainState, batch):
        opt = state.optimizer
        # the model's: frozen parameters' gradients are no optimizer's
        model.zero_grad(set_to_none=True)
        dev = _device(model)
        with scope:
            if forward_times == 1:
                metrics = _forward_backward(
                    model, net, batch, step_generator(rng_seed, state.step, device=dev))
            else:
                parts = []
                for i in range(forward_times):
                    # DDP reduces the gradients once, after the last microbatch
                    with (net.no_sync() if grouped and i < forward_times - 1
                          else contextlib.nullcontext()):
                        parts.append(_forward_backward(
                            model, net, _index(batch, i),
                            step_generator(rng_seed, state.step, i, dev)))
                metrics = {k: sum(m[k] for m in parts) / forward_times for k in parts[0]}
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(forward_times)
        metrics['grad_norm'] = tx.apply(opt, state.step)
        if grouped and mesh.size() > 1:
            metrics = _mean_over(mesh, metrics)
        if lr_schedule is not None:
            metrics['learning_rate'] = torch.tensor(float(lr_schedule(state.step)))
        state.step += 1
        return state, metrics

    return step


def _zero_step(model, tx, lr_schedule, forward_times: int, mesh, rng_seed: int) -> Callable:
    """The ZeRO step over ``mesh`` (module docstring)."""
    from ever_tpu_torch.parallel.zero import ZeroOptimizer

    def step(state: TrainState, batch):
        zo = state.optimizer
        if not isinstance(zo, ZeroOptimizer):
            raise TypeError('a step with state_shardings takes a ZeRO state '
                            '(parallel.zero.zero_init or parallel.sharded)')
        dev = _device(model)
        zo.begin_step(forward_times)
        try:
            parts = []
            with mesh:
                for i in range(forward_times):
                    parts.append(_forward_backward(
                        model, model, batch if forward_times == 1 else _index(batch, i),
                        step_generator(rng_seed, state.step,
                                       None if forward_times == 1 else i, dev)))
                    zo.end_backward()
            metrics = {k: sum(m[k] for m in parts) / forward_times for k in parts[0]}
            metrics['grad_norm'] = zo.step(tx, state.step)
        finally:
            zo.end_step()
        if mesh.size() > 1:
            metrics = _mean_over(mesh, metrics)
        if lr_schedule is not None:
            metrics['learning_rate'] = torch.tensor(float(lr_schedule(state.step)))
        state.step += 1
        return state, metrics

    return step


def build_train_loop(model: torch.nn.Module, tx,
                     lr_schedule: Optional[Callable[[int], float]] = None,
                     steps_per_loop: int = 1, forward_times: int = 1, mesh=None,
                     rng_seed: int = 0, find_unused_parameters: bool = False,
                     state_shardings=None) -> Callable:
    """K optimizer steps per call: ``loop(state, batches) -> (state,
    metrics)``, where every input of ``batches`` carries a leading
    ``steps_per_loop`` axis.  Metrics are the mean over the K steps, except
    ``learning_rate`` and ``grad_norm``, which report the last step."""
    step = build_train_step(model, tx, lr_schedule, forward_times, mesh, rng_seed,
                            find_unused_parameters, state_shardings)

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
    """``eval_step(state, batch) -> model output`` (eval mode, no grad).
    Rank-local with or without ``mesh``: each process predicts its own
    batches, which may differ in number between the ranks."""
    del mesh

    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            return model(*_model_args(batch, _device(model)), train=False)

    return eval_step
