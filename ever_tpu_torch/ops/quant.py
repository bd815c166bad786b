"""Int8 quantization and the int8 matrix product: the plain PyTorch versions
or the hand-written kernels, and the int8 serving layer ``QuantDense``.

Counterpart of ``ever_tpu/ops/quant.py``:

- :func:`quantize_int8` — per-tensor int8: the scale ``max(amax|x| / 127,
  1e-8)`` as float32 ``[1, 1]`` by a torch reduction (the JAX package also
  computes it outside its kernel), then the values by
  :func:`quantize_int8_values`, K6 (``csrc/quant_int8.cu``, replacing
  ``_quant_kernel``): ``clip(floor(x/s + u), -128, 127)`` with stochastic
  rounding, or ``clip(round(x/s))`` to nearest even.  ``stochastic=None``
  does what the JAX package does: stochastic on the accelerator, nearest
  off it (CUDA tensors stochastic, CPU tensors nearest); either mode can be
  asked for on either device.
- :func:`int8_matmul` — ``float(x_q · w_q) · (x_scale · w_scale)`` with
  int32 accumulation, by :func:`int8_matmul_t`, K7 (``csrc/int8_matmul.cu``,
  replacing ``_matmul_kernel``), which takes W transposed, ``[N, K]``.  K7
  has two paths, picked from the operands before the launch
  (:func:`int8_matmul_path`): ``'wgmma'`` (TMA and ``wgmma``) when K is a
  positive multiple of 16 and both operands start on 16 bytes, else
  ``'mma_sync'`` (byte loads and ``mma.sync``).
- :func:`quantize_params` and :class:`QuantDense`, the serving layer built
  from a trained flax ``Dense``'s params.

K6 and K7 are the ``torch.library`` ops ``ever_tpu_torch::quantize_int8_values``
and ``::int8_matmul_t``: the plain version on CPU tensors, the kernel on
CUDA tensors, and a fake implementation for ``torch.export``.

Random bits.  The TPU kernel draws ``u`` from the TPU's hardware generator,
whose stream cannot be reproduced elsewhere.  Here ``u = (bits >> 8) ·
2⁻²⁴`` with ``bits`` a counter-based hash of the seed and the element's flat
index (two rounds of murmur3's 32-bit finaliser): the same distribution, a
different stream.  The plain version computes the same bits with int64
tensor operations, so on the card K6 and its plain version agree exactly in
both modes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.ops._build import check_device, define_op

__all__ = ['quantize_int8', 'quantize_int8_values', 'quantize_int8_reference',
           'quantize_int8_values_reference', 'int8_matmul', 'int8_matmul_t',
           'int8_matmul_reference', 'int8_matmul_path', 'quantize_params',
           'QuantDense']

_MASK32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x85EBCA6B, 0xC2B2AE35


def _mix32_int(h: int) -> int:
    """murmur3's 32-bit finaliser on a Python int."""
    h ^= h >> 16
    h = (h * _MIX1) & _MASK32
    h ^= h >> 13
    h = (h * _MIX2) & _MASK32
    return h ^ (h >> 16)


def _key(seed: int) -> int:
    """The 32-bit key of a seed, shared by K6 and its plain version."""
    return _mix32_int((int(seed) ^ 0x9E3779B9) & _MASK32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h · c) mod 2³²`` for int64 ``h`` in [0, 2³²), in 16-bit halves so
    that no product leaves the int64 range."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def _uniform(key: int, n: int, device) -> torch.Tensor:
    """u ~ U[0, 1) of elements 0..n-1 as float32: ``(bits >> 8) · 2⁻²⁴``
    with ``bits = mix(mix(lo32(i) ^ key) ^ hi32(i))``, as K6 draws it."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    bits = _mix32(_mix32((i & _MASK32) ^ key) ^ (i >> 32))
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _scale(x32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x32.abs().amax() / 127.0, min=1e-8).reshape(1, 1)


def _check_2d(x):
    if x.dim() != 2:
        raise ValueError('quantize_int8 expects 2-D input')


def quantize_int8_values_reference(x: torch.Tensor, scale: torch.Tensor, seed: int = 0,
                                   stochastic: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K6: int8 values of float32 ``x`` at the
    given scale."""
    v = x / scale.reshape(())
    if stochastic:
        q = torch.floor(v + _uniform(_key(seed), x.numel(), x.device).view(x.shape))
    else:
        q = torch.round(v)
    return q.clamp(-128, 127).to(torch.int8)


def _launch_quant(x, scale, seed, stochastic):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f'the quantize kernel takes contiguous float32, got {x.dtype}')
    scale = scale.float().contiguous()
    if scale.device != x.device or scale.numel() != 1:
        raise ValueError('scale must be one float32 value on x\'s device')
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    fn = _load('quant_int8', 'ever_quant_int8', [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_int])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), q.data_ptr(), x.numel(), _key(seed),
                 int(bool(stochastic)), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'quantize kernel launch failed: CUDA error {err}')
    quantize_int8_values.launches += 1
    return q


def _quantize_cpu(x, scale, seed, stochastic):
    return quantize_int8_values_reference(x, scale, seed, stochastic).contiguous()


def _quantize_fake(x, scale, seed, stochastic):
    return torch.empty(x.shape, dtype=torch.int8, device=x.device)


_quantize_op = define_op(
    'quantize_int8_values(Tensor x, Tensor scale, SymInt seed, bool stochastic) -> Tensor',
    _quantize_cpu, _launch_quant, _quantize_fake)


def quantize_int8_values(x: torch.Tensor, scale: torch.Tensor, seed: int = 0,
                         stochastic: bool = True) -> torch.Tensor:
    """int8 values of float32 ``x`` at the per-tensor ``scale``.

    The op ``ever_tpu_torch::quantize_int8_values``: on a CUDA tensor it
    launches K6 (``csrc/quant_int8.cu``) or raises; on a CPU tensor it runs
    :func:`quantize_int8_values_reference`.  ``quantize_int8_values.launches``
    counts kernel launches.
    """
    check_device(x, 'quantize')
    return _quantize_op(x, scale, int(seed), bool(stochastic))


quantize_int8_values.launches = 0


def quantize_int8(x: torch.Tensor, seed: int = 0, stochastic: Optional[bool] = None):
    """Per-tensor int8 quantization of 2-D ``x``: ``(values int8, scale
    float32 [1, 1])`` with ``values · scale ≈ x``.  ``stochastic=None``
    rounds stochastically on CUDA tensors and to nearest on CPU tensors."""
    _check_2d(x)
    x32 = x.float().contiguous()
    scale = _scale(x32)
    if stochastic is None:
        stochastic = x.device.type == 'cuda'
    return quantize_int8_values(x32, scale, seed, stochastic), scale


def quantize_int8_reference(x: torch.Tensor, seed: int = 0, stochastic: bool = False):
    """Plain PyTorch version of :func:`quantize_int8` (round to nearest
    unless asked)."""
    _check_2d(x)
    x32 = x.float()
    scale = _scale(x32)
    return quantize_int8_values_reference(x32, scale, seed, stochastic), scale


def _check_mm(x_q, w, w_rows_are_k: bool):
    if x_q.dim() != 2 or w.dim() != 2:
        raise ValueError('int8_matmul takes 2-D operands')
    k_w = w.shape[0] if w_rows_are_k else w.shape[1]
    if x_q.shape[1] != k_w:
        raise ValueError(f'contraction sizes differ: x_q {tuple(x_q.shape)}, '
                         f'w {tuple(w.shape)}')
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f'int8_matmul takes int8 operands, got {x_q.dtype}, {w.dtype}')


def int8_matmul_reference(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 with the JAX API (``w_q`` ``[K, N]``):
    the product accumulated exactly (int64 on the CPU; float64 on CUDA,
    where |sum| ≤ K·128² stays far below 2⁵³), cast to int32 and float32,
    times ``x_scale · w_scale`` formed in float32 first."""
    _check_mm(x_q, w_q, True)
    wide = torch.float64 if x_q.device.type == 'cuda' else torch.int64
    acc = (x_q.to(wide) @ w_q.to(wide)).to(torch.int32)
    return acc.float() * (x_scale.float().reshape(()) * w_scale.float().reshape(()))


# K7's paths, as ``ever_int8_matmul_path`` numbers them
MM_PATHS = ('wgmma', 'mma_sync')


def int8_matmul_path(x_q: torch.Tensor, w_t: torch.Tensor) -> str:
    """The path K7 takes for ``x_q`` ``[M, K]`` and ``w_t`` ``[N, K]``:
    ``'wgmma'`` when TMA can address both operands (K a positive multiple of
    16, both starting on 16 bytes), else ``'mma_sync'``.  The kernel makes
    the same choice from the same facts (``ever_int8_matmul_path``)."""
    k = x_q.shape[1]
    aligned = (x_q.data_ptr() | w_t.data_ptr()) % 16 == 0
    return MM_PATHS[0] if k > 0 and k % 16 == 0 and aligned else MM_PATHS[1]


def _launch_mm(x_q, x_scale, w_t, w_scale):
    if not (x_q.is_contiguous() and w_t.is_contiguous()):
        raise ValueError('the int8 matmul kernel takes contiguous operands')
    x_scale, w_scale = (s.float().contiguous() for s in (x_scale, w_scale))
    if any(t.device != x_q.device for t in (w_t, x_scale, w_scale)):
        raise ValueError('all int8_matmul operands must be on one device')
    m, k = x_q.shape
    n = w_t.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    fn = _load('int8_matmul', 'ever_int8_matmul',
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)
    with torch.cuda.device(x_q.device):
        err = fn(x_q.data_ptr(), w_t.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                 out.data_ptr(), m, n, k, torch.cuda.current_stream(x_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'int8 matmul kernel launch failed: CUDA error {err}')
    int8_matmul_t.launches += 1
    return out


def _int8_matmul_cpu(x_q, x_scale, w_t, w_scale):
    return int8_matmul_reference(x_q, x_scale, w_t.t(), w_scale)


def _int8_matmul_fake(x_q, x_scale, w_t, w_scale):
    return x_q.new_empty((x_q.shape[0], w_t.shape[0]), dtype=torch.float32)


_int8_matmul_op = define_op(
    'int8_matmul_t(Tensor x_q, Tensor x_scale, Tensor w_t, Tensor w_scale) -> Tensor',
    _int8_matmul_cpu, _launch_mm, _int8_matmul_fake)


def int8_matmul_t(x_q: torch.Tensor, x_scale: torch.Tensor, w_t: torch.Tensor,
                  w_scale: torch.Tensor) -> torch.Tensor:
    """:func:`int8_matmul` with W given transposed, ``w_t`` ``[N, K]``: the
    layout K7 reads.

    The op ``ever_tpu_torch::int8_matmul_t``: on a CUDA tensor it launches
    K7 (``csrc/int8_matmul.cu``) or raises; on a CPU tensor it runs
    :func:`int8_matmul_reference`.  ``int8_matmul_t.launches`` counts kernel
    launches.
    """
    _check_mm(x_q, w_t, False)
    check_device(x_q, 'int8 matmul')
    return _int8_matmul_op(x_q, x_scale, w_t, w_scale)


int8_matmul_t.launches = 0


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``float(x_q · w_q) · (x_scale · w_scale)``, float32 ``[M, N]``, with
    the JAX API: ``x_q`` ``[M, K]``, ``w_q`` ``[K, N]`` int8, scales float32
    ``[1, 1]``.  K7 reads W transposed, so this copies ``w_q`` to ``[N, K]``
    per call; :class:`QuantDense` keeps that copy instead."""
    _check_mm(x_q, w_q, True)
    return int8_matmul_t(x_q, x_scale, w_q.t().contiguous(), w_scale)


def _load(lib: str, name: str, argtypes):
    from ever_tpu_torch.ops._build import function
    return function(lib, name, argtypes)


def quantize_params(kernel: torch.Tensor, seed: int = 0) -> dict:
    """Quantize an ``[in, out]`` dense kernel for serving:
    ``dict(kernel_q=int8 [in, out], scale=float32 [1, 1])``, rounded as
    :func:`quantize_int8` rounds on the kernel's device."""
    w_q, w_scale = quantize_int8(kernel, seed)
    return dict(kernel_q=w_q, scale=w_scale)


def _as_f32(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))
    return t.to(device=device, dtype=torch.float32)


class QuantDense(nn.Module):
    """Serving-time int8 dense layer: ``y = int8_matmul(q(x), W_q) + b`` in
    float32.  The int8 weights (kept transposed, ``weight_t`` ``[out,
    in]``, the layout K7 reads), their scale ``w_scale`` ``[1, 1]`` and the
    optional float32 ``bias`` are buffers.  The weights and every
    activation are rounded as :func:`quantize_int8` rounds by default:
    stochastically on CUDA tensors and to nearest on CPU tensors, as the
    JAX package does on and off the TPU.  Stochastic rounding is unbiased
    but has twice the error variance of rounding to nearest (s²·f(1-f), 1/6
    on average, against s²/12).  Built from a trained flax ``Dense``'s
    params::

        qd = QuantDense.from_params(params['head']['fc'], device='cpu')
        y = qd(x)                    # x: [..., in] float32 or bf16
    """

    def __init__(self, weight_t: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer('weight_t', weight_t)
        self.register_buffer('w_scale', w_scale)
        self.register_buffer('bias', bias)

    @classmethod
    def from_params(cls, dense_params: dict, seed: int = 0, device=None) -> 'QuantDense':
        """From flax ``Dense`` params (``kernel`` ``[in, out]``, optional
        ``bias``; numpy arrays or tensors), quantized with ``seed`` on
        ``device`` (``cuda`` unless given)."""
        dev = get_device(device)
        q = quantize_params(_as_f32(dense_params['kernel'], dev), seed)
        bias = dense_params.get('bias')
        return cls(q['kernel_q'].t().contiguous(), q['scale'],
                   None if bias is None else _as_f32(bias, dev))

    def forward(self, x: torch.Tensor, seed: int = 1) -> torch.Tensor:
        shape = x.shape
        x_q, x_scale = quantize_int8(x.reshape(-1, shape[-1]), seed)
        y = int8_matmul_t(x_q, x_scale, self.weight_t, self.w_scale)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*shape[:-1], y.shape[-1])
