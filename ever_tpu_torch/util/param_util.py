"""Parameter counting, freezing and FLOP accounting (counterpart of
``ever_tpu/util/param_util.py``).

Parameters are named by their dotted ``state_dict`` names
(``encoder.resnet.layer1.0.conv1.weight``); the JAX package's ``/``-paths
map to them one to one (``util/weight_io.py``).  As in the JAX package,
freezing is a mask that the optimizer reads: :func:`freeze_mask` and its
variants give ``{name: trainable}``, and the update rule gives a parameter
whose mask is False exactly zero updates (``opt/optimizer.py``).  FLOPs come
from ``torch.utils.flop_counter``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ever_tpu_torch.core.logger import get_logger

logger = get_logger('ever_tpu_torch.param_util')

__all__ = ['count_model_parameters', 'trainable_parameters', 'freeze_mask',
           'freeze_params', 'freeze_modules', 'freeze_bn', 'apply_freeze',
           'count_model_flops', 'count_model_params_flops', 'param_paths',
           'copy_conv_parameters', 'copy_bn_parameters', 'copy_weight_bias']

Params = Union[nn.Module, Dict[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, a dict, or (name,
    tensor) pairs."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, dict):
        return dict(params)
    return dict(params)


def count_model_parameters(params: Params, _default_logger: logging.Logger = logger) -> int:
    cnt = sum(int(p.numel()) for p in _named(params).values())
    _default_logger.info('#params: %d, %s M', cnt, round(cnt / 1e6, 3))
    return cnt


def trainable_parameters(params: Params, mask: Optional[Dict[str, bool]] = None,
                         _default_logger: logging.Logger = logger) -> int:
    """The number of parameters whose ``mask`` entry is True (all of them
    without a mask)."""
    if mask is None:
        return count_model_parameters(params, _default_logger)
    cnt = sum(int(p.numel()) for k, p in _named(params).items() if mask[k])
    _default_logger.info('#trainable params: %d, %s M', cnt, round(cnt / 1e6, 3))
    return cnt


def param_paths(params: Params) -> Sequence[str]:
    """The dotted name of every parameter."""
    return list(_named(params))


def freeze_mask(params: Params, frozen_prefixes: Sequence[str] = (),
                predicate: Optional[Callable[[str], bool]] = None) -> Dict[str, bool]:
    """``{name: trainable}``: False where the name starts with one of
    ``frozen_prefixes`` or ``predicate(name)`` holds."""
    def trainable(name: str) -> bool:
        if predicate is not None and predicate(name):
            return False
        return not any(name.startswith(p) for p in frozen_prefixes)
    return {name: trainable(name) for name in _named(params)}


def freeze_params(params: Params, prefix: str = '') -> Dict[str, bool]:
    """A mask freezing every parameter under ``prefix``."""
    return freeze_mask(params, frozen_prefixes=(prefix,))


def freeze_modules(params: Params, name_fragment: str) -> Dict[str, bool]:
    """A mask freezing every parameter whose name contains
    ``name_fragment`` (e.g. ``'layer1'``)."""
    return freeze_mask(params, predicate=lambda n: name_fragment in n)


_BN_PAT = ('bn', 'batchnorm', 'batch_norm', 'norm')


def freeze_bn(params: Params) -> Dict[str, bool]:
    """A mask freezing the normalisation layers' weights and biases: those
    of a module whose class is a norm (``BatchNorm2d``, ``LayerNorm`` ...),
    or whose name starts or ends with ``bn`` or ``norm`` (the JAX package
    matches its ``BatchNorm_0`` path component so).  Their running
    statistics are buffers, pinned by ``batchnorm_trainable=False``."""
    norm_modules = set()
    if isinstance(params, nn.Module):
        norm_modules = {name for name, m in params.named_modules()
                        if 'norm' in type(m).__name__.lower()}

    def is_bn(name: str) -> bool:
        parts = name.lower().split('.')
        if name.rpartition('.')[0] in norm_modules:
            return True
        return any(any(p.startswith(b) or p.endswith(b) for b in _BN_PAT)
                   for p in parts[:-1])
    return freeze_mask(params, predicate=is_bn)


def apply_freeze(rule, mask: Dict[str, bool]):
    """The update rule ``rule`` (``OptimizerFactory.build``'s result) with
    every parameter whose ``mask`` entry is False frozen: it gets exactly
    zero updates (no weight decay, no momentum)."""
    return rule.with_frozen(lambda name: not mask.get(name, True))


@torch.no_grad()
def copy_conv_parameters(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Copy a convolution's weight (and bias) into another of the same
    shape."""
    for k in ('weight', 'bias'):
        s, d = getattr(src, k, None), getattr(dst, k, None)
        if s is not None and d is not None:
            if s.shape != d.shape:
                raise ValueError(f'{k} shape mismatch: {tuple(s.shape)} vs {tuple(d.shape)}')
            d.copy_(s)
    return dst


@torch.no_grad()
def copy_bn_parameters(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Copy a BatchNorm's weight, bias and running statistics."""
    for k in ('weight', 'bias', 'running_mean', 'running_var'):
        s, d = getattr(src, k, None), getattr(dst, k, None)
        if s is not None and d is not None:
            d.copy_(s)
    return dst


@torch.no_grad()
def copy_weight_bias(src: nn.Module, dst: nn.Module) -> nn.Module:
    """Copy ``weight`` and ``bias`` between modules that have them."""
    for k in ('weight', 'bias'):
        s, d = getattr(src, k, None), getattr(dst, k, None)
        if s is not None and d is not None:
            d.copy_(s)
    return dst


def count_model_flops(fn: Callable, *sample_args,
                      _default_logger: logging.Logger = logger) -> int:
    """The FLOPs of ``fn(*sample_args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*sample_args)
    flops = int(counter.get_total_flops())
    _default_logger.info('# FLOPs: %d, %s G', flops, round(flops / 1e9, 2))
    return flops


def count_model_params_flops(params: Params, fn: Callable, *sample_args,
                             _default_logger: logging.Logger = logger) -> None:
    """Log the parameter count and the FLOPs of ``fn(*sample_args)`` in one
    call, as ``ever_tpu/util/param_util.py``'s ``count_model_params_flops``
    does."""
    count_model_parameters(params, _default_logger)
    count_model_flops(fn, *sample_args, _default_logger=_default_logger)

