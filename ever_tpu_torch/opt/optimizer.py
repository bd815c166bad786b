"""Optimizers (registered in ``OPT``) as factories of ``torch.optim`` updates.

Counterpart of ``ever_tpu/opt/optimizer.py``.  Each registry entry returns an
:class:`OptimizerFactory`; ``factory.build(schedule, grad_clip=...)`` gives
the :class:`UpdateRule` that the train step applies: record the gradients'
global norm (and clip by it when configured), write ``schedule(step)`` into
the param groups, then step the optimizer.

``torch.optim``'s SGD, Adam and AdamW compute what the optax chains of the
JAX package compute (SGD and Adam with L2 weight decay added to the
gradient, AdamW with decoupled decay); LAMB is written out below after
``optax.lamb``.  On the TPU XLA fused these updates, so they are no TPU
kernels.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from ever_tpu_torch.core import registry

__all__ = ['OptimizerFactory', 'UpdateRule', 'Lamb', 'DEFAULT_GRAD_CLIP',
           'clip_by_global_norm_recording']

# the max_norm of a grad_clip config that names none (the reference's)
DEFAULT_GRAD_CLIP = dict(max_norm=35.0)

Schedule = Union[float, Callable[[int], float]]


@torch.no_grad()
def clip_by_global_norm_recording(params: Iterable[torch.Tensor],
                                  max_norm: Optional[float]) -> torch.Tensor:
    """The gradients' global L2 norm before clipping, as a 0-d f32 tensor.

    With ``max_norm`` the gradients are scaled in place by
    ``min(1, max_norm / max(norm, 1e-12))``, the JAX package's clip;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead.
    ``max_norm=None`` records the norm and scales nothing.  Parameters
    without a gradient are skipped.  Nothing here waits for the device.
    """
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2))).float()
    if max_norm is not None:
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        torch._foreach_mul_(grads, scale)
    return norm


class UpdateRule:
    """What :meth:`OptimizerFactory.build` returns: the update of one train
    step.  ``init(params)`` makes the ``torch.optim`` optimizer that holds
    the state; ``apply(optimizer, step)`` records (and clips) the global
    gradient norm, sets the learning rate to ``lr_at(step)`` and steps."""

    def __init__(self, make: Callable[..., torch.optim.Optimizer],
                 learning_rate: Schedule, max_norm: Optional[float]):
        self._make = make
        self.learning_rate = learning_rate
        self.max_norm = max_norm

    def lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self._make(list(params), self.lr_at(0))

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> torch.Tensor:
        """One update at the step count ``step`` (before its increment);
        returns the recorded pre-clip gradient norm."""
        params = [p for g in optimizer.param_groups for p in g['params']]
        norm = clip_by_global_norm_recording(params, self.max_norm)
        lr = self.lr_at(step)
        for group in optimizer.param_groups:
            group['lr'] = lr
        optimizer.step()
        return norm


class OptimizerFactory:
    """Deferred optimizer: torch-style kwargs now, schedule at build time."""

    def __init__(self, fn: Callable[..., torch.optim.Optimizer], **params):
        self._fn = fn
        self.params = dict(params)

    def build(self, learning_rate: Schedule, grad_clip: Optional[dict] = None,
              param_groups=None, frozen_prefixes=None) -> UpdateRule:
        """The full update: ``learning_rate`` is a float or a ``step -> lr``
        schedule; ``grad_clip={'max_norm': float}`` clips by the global norm,
        and without it the norm is only recorded (a reference config without
        the key trains unclipped)."""
        if param_groups is not None or frozen_prefixes:
            raise NotImplementedError('param_groups and frozen_prefixes need '
                                      'util/param_util, not ported yet')
        max_norm = (float(grad_clip.get('max_norm', DEFAULT_GRAD_CLIP['max_norm']))
                    if grad_clip else None)

        def make(params, lr):
            return self._fn(params, lr, **self.params)

        return UpdateRule(make, learning_rate, max_norm)


class Lamb(torch.optim.Optimizer):
    """LAMB as ``optax.lamb`` computes it: the Adam direction
    ``m̂/(√v̂ + eps)`` plus ``weight_decay·p``, scaled per tensor by the trust
    ratio ``‖p‖/‖u‖`` (1 where either norm is 0), times ``-lr``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st['step'] = 0
                    st['m'] = torch.zeros_like(p)
                    st['v'] = torch.zeros_like(p)
                st['step'] += 1
                t, m, v, g = st['step'], st['m'], st['v'], p.grad
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt_() + group['eps'])
                if group['weight_decay']:
                    u.add_(p, alpha=group['weight_decay'])
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                p.add_(u * ratio, alpha=-group['lr'])


def _sgd(params, lr, momentum: float = 0.0, weight_decay: float = 0.0,
         nesterov: bool = False, dampening: float = 0.0):
    if dampening:
        raise NotImplementedError('sgd dampening is not supported')
    # torch adds the L2 term to the gradient before momentum, as the JAX chain
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum))


def _adam(params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.0):
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def _adamw(params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
           weight_decay: float = 0.01):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _lamb(params, lr, betas=(0.9, 0.999), eps: float = 1e-6,
          weight_decay: float = 0.0):
    return Lamb(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


def _factory(fn):
    def make(**params) -> OptimizerFactory:
        return OptimizerFactory(fn, **params)
    return make


registry.OPT.register('sgd', _factory(_sgd))
registry.OPT.register('adam', _factory(_adam))
registry.OPT.register('adamw', _factory(_adamw))
registry.OPT.register('lamb', _factory(_lamb))
# the reference's apex alias: plain Adam
registry.OPT.register('fused_adam', _factory(_adam))
