"""2:4 structured-sparse linear (counterpart of
``ever_tpu/module/dinov3/layers/sparse_linear.py``).

The reference sparsifies weights to 2:4 through xformers and cuSPARSELt.
The JAX package reproduces the numbers (two largest magnitudes of every
four kept, straight-through gradients) with a masked dense product; so
does the port, in plain PyTorch: the JAX package has no kernel here.
Running the product on the tensor cores' 2:4 sparsity is later work.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ['sparsify24', 'LinearW24', 'replace_linears_with_sparse_linear',
           'update_24sparsity']


def _keep24(w: torch.Tensor) -> torch.Tensor:
    """``w`` with the two smallest |w| of every 4 consecutive weights along
    the last axis zeroed.  Element i stays when fewer than 2 others outrank
    it, j outranking i when |w_j| > |w_i| or |w_j| = |w_i| and j < i: the
    earlier index wins a tie, so exactly 2 of every 4 stay."""
    *lead, n = w.shape
    if n % 4:
        raise ValueError(f'last dim {n} not divisible by 4')
    g = w.reshape(*lead, n // 4, 4)
    a = g.abs()
    idx = torch.arange(4, device=w.device)
    larger = a[..., None, :] > a[..., :, None]
    tie_earlier = (a[..., None, :] == a[..., :, None]) & (idx[None, :] < idx[:, None])
    rank = (larger | tie_earlier).sum(-1)
    return (g * (rank < 2).to(w.dtype)).reshape(w.shape)


class Sparsify24Fn(torch.autograd.Function):
    """The 2:4 mask forward, the gradient passed straight through."""

    @staticmethod
    def forward(ctx, w):
        return _keep24(w)

    @staticmethod
    def backward(ctx, g):
        return g


def sparsify24(w: torch.Tensor) -> torch.Tensor:
    """The two largest |w| of every 4 along the last axis (the reference's
    ``largest_abs_values_greedy`` with a straight-through gradient)."""
    return Sparsify24Fn.apply(w)


class LinearW24(nn.Linear):
    """``nn.Linear`` whose weight is 2:4-sparsified along the input axis at
    every call (``sparsity_enabled``; off, a plain linear), computed in the
    input's dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 sparsity_enabled: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device, dtype)
        self.sparsity_enabled = sparsity_enabled

    def forward(self, x):
        w = sparsify24(self.weight) if self.sparsity_enabled else self.weight
        return F.linear(x, w.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))


def update_24sparsity(state_dict: Dict[str, torch.Tensor],
                      path_filter: Callable[[str], bool] = lambda p: True
                      ) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with every 2-D ``weight`` whose input width
    divides by 4 and whose name ``path_filter`` accepts hard-sparsified 2:4
    (the serving and export form of a ``LinearW24`` model)."""
    out, count = {}, 0
    for name, v in state_dict.items():
        if (name.endswith('weight') and v.dim() == 2 and v.shape[1] % 4 == 0
                and path_filter(name)):
            out[name] = _keep24(v.detach())
            count += 1
        else:
            out[name] = v
    logging.getLogger('ever_tpu_torch').info('update_24sparsity: %d weights', count)
    return out


def replace_linears_with_sparse_linear(root_module, *, filter_fn=None):
    """The reference's in-place swap of ``nn.Linear`` children.  Not here, as
    in the JAX package: build the model with :class:`LinearW24`, or sparsify
    trained weights with :func:`update_24sparsity`."""
    raise NotImplementedError(
        'replace_linears_with_sparse_linear swaps no modules: build the model with LinearW24 in '
        'place of nn.Linear, or apply update_24sparsity to trained weights')
