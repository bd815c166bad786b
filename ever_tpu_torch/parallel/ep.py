"""Expert parallel: a mixture-of-experts FFN whose experts are split over an
``'expert'`` mesh axis (counterpart of ``ever_tpu/parallel/ep.py``).

:class:`MoEMlp` has the JAX module's parameters, names and shapes
(``router [D, E]``, ``experts_fc1 [E, D, H]``, ``experts_bias1 [E, H]``,
``experts_fc2 [E, H, D]``, ``experts_bias2 [E, D]``) and its semantics:
the router in float32, top-``k`` experts with their softmax gates
renormalised over the chosen ones, expert capacity ``C = ceil(k · tokens ·
capacity_factor / E)``, the buffer slots given choice 0 of every token
first, then choice 1 and so on (a running count), tokens past capacity
dropped (they contribute zero; the residual carries them), flax's
``nn.gelu`` (the tanh approximation), and the Switch load-balancing loss
``aux_loss_weight · E · Σ_e f_e·P_e`` sown into the ``'losses'``
collection (``parallel.spmd.sow_loss``).  The JAX module dispatches and
combines by one-hot einsums; here each kept (token, choice) is gathered
into its expert's slot and its output read back from it, which computes
the same values (a slot holds one token; a token's output is its kept
choices' gated sum).

:func:`moe_expert_shardings` places each ``experts_*`` leaf's expert
dimension on the axis and everything else replicated (a leaf the axis does
not divide stays replicated), as the JAX rule does.  In JAX the placement
is all; here :meth:`MoEMlp.shard_experts` keeps this rank's ``E/n``
experts and makes the forward expert parallel over the axis's group: the
routing is computed whole on every rank, each rank runs its own experts
on their slots, and the ranks' partial outputs are all-reduced.  Backward,
the input's and the router's gradients are partial sums through each
rank's experts and are all-reduced; the auxiliary loss, which every rank
computes whole, sends a 1/n share of its gradient from each rank, so it
counts once.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from ever_tpu_torch.parallel.spmd import sow_loss
from ever_tpu_torch.parallel.tp import _CopyToTP, _ReduceFromTP

__all__ = ['MoEMlp', 'moe_expert_shardings']


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    to variance ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class MoEMlp(nn.Module):
    """Mixture-of-experts MLP over the tokens of ``[B, N, D]`` inputs
    (module docstring); ``dim`` is ``D``, which flax infers from the input.
    The experts compute in ``dtype`` (None: the input's).  Built on
    ``device``: the GPU unless given."""

    def __init__(self, num_experts: int, hidden: int, k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                 dtype: Optional[torch.dtype] = torch.float32, *, dim: int, device=None):
        from ever_tpu_torch.core.device import get_device

        super().__init__()
        self.num_experts, self.hidden, self.k = num_experts, hidden, k
        self.capacity_factor, self.aux_loss_weight, self.dtype = (
            capacity_factor, aux_loss_weight, dtype)
        e = num_experts
        self.router = nn.Parameter(0.02 * torch.randn(dim, e))
        self.experts_fc1 = nn.Parameter(_lecun_normal_(torch.empty(e, dim, hidden), dim))
        self.experts_bias1 = nn.Parameter(torch.zeros(e, hidden))
        self.experts_fc2 = nn.Parameter(_lecun_normal_(torch.empty(e, hidden, dim), hidden))
        self.experts_bias2 = nn.Parameter(torch.zeros(e, dim))
        self.group, self.ep_size, self.first_expert = None, 1, 0
        self.to(get_device(device))

    def shard_experts(self, mesh: Mesh, axis: str = 'expert') -> 'MoEMlp':
        """Keep this rank's experts of :func:`moe_expert_shardings` over
        ``mesh``'s ``axis`` and make the forward expert parallel (module
        docstring), in place; a collective call.  Experts the axis does not
        divide stay whole on every rank, and the forward with them."""
        if mesh.abstract:
            raise ValueError('an abstract mesh runs no forward: expert parallel needs the '
                             'mesh of a process group (parallel.mesh.make_mesh)')
        n = mesh.axis_size(axis)
        shardings = moe_expert_shardings(dict(self.named_parameters()), mesh, axis)
        if n == 1 or shardings['experts_fc1'].spec != P(axis):
            return self
        r, local = mesh.rank(axis), self.num_experts // n
        for name, sh in shardings.items():
            if sh.spec == P(axis):
                p = getattr(self, name)
                setattr(self, name, nn.Parameter(
                    p.detach()[r * local:(r + 1) * local].clone(), requires_grad=p.requires_grad))
        self.group, self.ep_size, self.first_expert = mesh.axis_group(axis), n, r * local
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        e, k = self.num_experts, self.k
        tokens = b * n
        cap = int(-(-(k * tokens * self.capacity_factor) // e))
        router = self.router
        if self.group is not None:
            x, router = _CopyToTP.apply(x, self.group), _CopyToTP.apply(router, self.group)
        xt = x.reshape(tokens, d)
        probs = torch.softmax(xt.float() @ router.float(), dim=-1)            # [T, E]
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)                    # [T, k]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        f_e = F.one_hot(gate_idx[:, 0], e).float().mean(0)
        aux = self.aux_loss_weight * e * (f_e * probs.mean(0)).sum()
        if self.group is not None:
            aux = _ScaleGrad.apply(aux, 1.0 / self.ep_size)
        sow_loss('moe_aux_loss', aux)

        # each (token, choice)'s slot in its expert's buffer: choice 0 of
        # every token first, then choice 1, ...; slots past capacity drop
        onehot = F.one_hot(gate_idx, e).float()                              # [T, k, E]
        flat = onehot.transpose(0, 1).reshape(k * tokens, e)
        pos = (torch.cumsum(flat, 0) - flat).reshape(k, tokens, e).transpose(0, 1)
        slot = (pos * onehot).sum(-1).long()                                 # [T, k]
        local = self.experts_fc1.shape[0]
        expert = gate_idx - self.first_expert
        kept = (slot < cap) & (expert >= 0) & (expert < local)
        # row of the flat [local·C (+ 1 for the dropped)] expert buffer
        row = torch.where(kept, expert * cap + slot, torch.full_like(slot, local * cap))

        xin = xt.float().new_zeros(local * cap + 1, d).index_put(
            (row.reshape(-1),), xt.float().repeat_interleave(k, 0))
        dtype = self.dtype or x.dtype
        xin = xin[:-1].reshape(local, cap, d).to(dtype)
        h = torch.bmm(xin, self.experts_fc1.to(dtype)) + self.experts_bias1[:, None].to(dtype)
        h = F.gelu(h, approximate='tanh')
        out = torch.bmm(h, self.experts_fc2.to(dtype)) + self.experts_bias2[:, None].to(dtype)

        out = torch.cat([out.reshape(local * cap, d).float(), out.new_zeros(1, d).float()])
        weight = gate_vals * kept
        y = (weight[..., None] * out[row]).sum(1)                              # [T, D]
        if self.group is not None:
            y = _ReduceFromTP.apply(y, self.group)
        return y.reshape(b, n, d).to(x.dtype)


def moe_expert_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh,
                         axis: str = 'expert') -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for ``params`` (``{name: tensor}``, a
    ``state_dict``): every ``experts_*`` leaf's leading expert dimension on
    ``axis``, the router and everything else replicated; a leaf the axis
    does not divide stays replicated (the JAX fallback)."""
    n = mesh.axis_size(axis)
    return {name: NamedSharding(mesh, P(axis) if 'experts_' in name and len(leaf.shape)
                                and leaf.shape[0] % n == 0 else P())
            for name, leaf in params.items()}
