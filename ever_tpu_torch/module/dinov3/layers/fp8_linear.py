"""The reference's fp8 linear on the int8 matrix product K7
(counterpart of ``ever_tpu/module/dinov3/layers/fp8_linear.py``).

The reference scales activations and weights per tensor by their largest
magnitude into float8 and calls ``torch._scaled_mm``.  The JAX package
keeps that per-tensor amax scaling but stores int8 and multiplies with
int32 accumulation; so does the port, and its product is K7
(``ops.quant.int8_matmul_t``: the kernel on a CUDA tensor, its plain
version on a CPU one), whose contract is exactly this layer's with scalar
scales:

- :func:`scale`: ``s = max(amax, 1e-12) / 127`` in float32 and ``q =
  clip(round(t / s), -127, 127)`` as int8, rounding half to even as
  ``jnp.round`` does (torch's elementwise ops, not K6, whose nearest mode is
  ``floor(x/s + ½)``);
- :func:`matmul`: one K7 launch, ``float(x_q · w_qᵀ) · (s_x · s_w)``, then
  the bias.

So the forward equals the JAX package's bit for bit.  Training is
straight-through (:class:`Fp8LinearFn`): the backward is the float
products ``g · W`` and ``gᵀ · x`` (plain matrix products; the JAX package
computes them outside any kernel too).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ever_tpu_torch.ops.quant import int8_matmul_t

EPS = 1e-12
INT8_MAX = 127.0

__all__ = ['scale', 'matmul', 'fp8_linear', 'Fp8LinearFn', 'Fp8Linear',
           'Fp8LinearKMaskedBias', 'convert_linears_to_fp8']


def scale(t: torch.Tensor, amax_t: torch.Tensor):
    """Per-tensor amax quantization: ``(int8 values, float32 scale)``."""
    scale_t = torch.clamp(amax_t.float(), min=EPS) / INT8_MAX
    t_q = torch.clamp(torch.round(t / scale_t), -INT8_MAX, INT8_MAX).to(torch.int8)
    return t_q, scale_t


def matmul(first: torch.Tensor, amax_first: torch.Tensor, second_t: torch.Tensor,
           amax_second_t: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized ``first @ second_t.T`` rescaled to float32, plus ``bias``:
    ``first`` ``[M, K]``, ``second_t`` ``[N, K]`` (a Linear's weight), one
    K7 launch on CUDA tensors."""
    f_q, s_f = scale(first, amax_first)
    w_q, s_w = scale(second_t, amax_second_t)
    out = int8_matmul_t(f_q.contiguous(), s_f.reshape(1, 1), w_q.contiguous(),
                        s_w.reshape(1, 1))
    if bias is not None:
        out = out + bias
    return out


class Fp8LinearFn(torch.autograd.Function):
    """The quantized forward with a straight-through float backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return matmul(x, x.abs().amax(), w, w.abs().amax(), b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w                            # [M, O] @ [O, I] -> [M, I]
        gw = g.t() @ x                        # [O, M] @ [M, I] -> [O, I]
        gb = g.sum(0) if ctx.has_bias else None
        return gx, gw, gb


def fp8_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """``x`` ``[M, I]`` float32 through the quantized product with ``w``
    ``[O, I]`` and ``b`` ``[O]``: float32 ``[M, O]``."""
    return Fp8LinearFn.apply(x, w, b)


class Fp8Linear(nn.Linear):
    """``nn.Linear`` on the quantized product: the input flattened to rows
    and taken in float32, the output in the input's dtype."""

    def _bias(self) -> Optional[torch.Tensor]:
        return None if self.bias is None else self.bias.float()

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1]).float()
        y = fp8_linear(flat, self.weight.float(), self._bias())
        return y.reshape(*x.shape[:-1], self.out_features).to(x.dtype)


class Fp8LinearKMaskedBias(Fp8Linear):
    """The fused-QKV projection on the quantized product, its bias times the
    buffer ``bias_mask`` (ones, zeros over the K third), as
    ``vit.LinearKMaskedBias``."""

    def __init__(self, in_features: int, out_features: int, device=None, dtype=None):
        if out_features % 3:
            raise ValueError(f'out_features must be a multiple of 3, got {out_features}')
        super().__init__(in_features, out_features, True, device, dtype)
        nn.init.zeros_(self.bias)
        mask = torch.ones(out_features, device=device)
        mask[out_features // 3:2 * out_features // 3] = 0.0
        self.register_buffer('bias_mask', mask)

    def _bias(self) -> torch.Tensor:
        return (self.bias * self.bias_mask).float()


def convert_linears_to_fp8(root_module, *, filter: str = '.*'):
    """The reference's in-place swap of ``nn.Linear`` children.  Not here, as
    in the JAX package: build the model with :class:`Fp8Linear` where it
    has ``nn.Linear``, or quantize a trained model for serving with
    ``ever_tpu_torch.ops.ptq_quantize`` (every product on K7)."""
    raise NotImplementedError(
        'convert_linears_to_fp8 swaps no modules: build the model with Fp8Linear in place of '
        'nn.Linear, or quantize a trained model for serving with '
        'ever_tpu_torch.ops.ptq_quantize / make_ptq_predict_fn')
