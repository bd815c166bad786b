"""Attention dispatch: the plain PyTorch reference or the hand-written kernel.

Counterpart of ``ever_tpu/ops/attention.py``.  Two regimes, picked by token
count (or forced through ``impl``):

- ``'xla'`` — few hundred tokens: :func:`attention_reference`, plain matmul +
  softmax in PyTorch (the counterpart of the JAX ``'xla'`` branch).
- ``'fused'`` / ``'flash'`` — 512 tokens and up: the streaming CUDA
  kernels, :func:`fused_attention` (``csrc/attention_fwd.cu``) forward and
  :func:`fused_attention_bwd` (``csrc/attention_bwd.cu``) backward, joined
  by a ``torch.autograd.Function`` (the counterpart of the JAX package's
  ``custom_vjp``).  On the TPU the two names are two kernels (VMEM-resident
  and library flash); the Hopper kernels stream K/V through shared memory,
  so one pair covers both regimes.

Shapes follow the flax convention: q/k/v are ``[B, N, H, D]`` (``'bnhd'``),
or ``[B, H, N, D]`` with ``layout='bhnd'``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

__all__ = ['attention', 'attention_reference', 'attention_bwd_reference',
           'fused_attention', 'fused_attention_bwd', 'pad_target',
           'FUSED_TOKEN_THRESHOLD']

# auto-dispatch boundary (tokens), kept from the JAX package: below it the
# plain path, from it up the kernel.  Past 16384 tokens the JAX package
# switches to its library flash kernel; the streaming CUDA kernel covers
# that regime as well.
FUSED_TOKEN_THRESHOLD = 512

# element types the kernel takes, with its code for each
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# key columns at or past n_valid get this score: finite, so rows whose keys
# are all masked stay NaN-free
_MASK = -1e30

# the JAX kernel's q-block search, kept so that stack-level padding pads to
# the same length in both packages
_SCORE_BUDGET = 30 * 1024 * 1024
_BQ_CAP = 384


def _row_block(s: int, n_bufs: float) -> int:
    start = min(s, _BQ_CAP)
    for unit in (128, 8):
        for m in range(start - start % unit, 0, -unit):
            if s % m == 0 and m * s * 4 * n_bufs <= _SCORE_BUDGET:
                return m
    return 128


def pad_target(n: int, unit: str = 'auto') -> int:
    """Padded sequence length at ``n`` real tokens for stack-level padding
    (``DinoVisionTransformer(pad_tokens=True)``).

    Same rule as the JAX package's ``pad_target``: an int ``unit`` pads to
    its multiple; ``'auto'`` keeps the 128-multiple when it adds at most 5%,
    else takes the smallest 8-aligned length whose TPU q-block is at least
    192 rows (e.g. 1029 → 1032).  The CUDA kernel masks any ragged length
    itself, so the port needs the padding only to match the JAX model.
    """
    if unit != 'auto':
        u = int(unit)
        return -(-n // u) * u
    t128 = -(-n // 128) * 128
    if (t128 - n) / max(n, 1) <= 0.05:
        return t128
    for t in range(-(-n // 8) * 8, t128, 8):
        if _row_block(t, n_bufs=4.0) >= 192:
            return t
    return t128


def _to_bhnd(t: torch.Tensor, layout: str) -> torch.Tensor:
    return t if layout == 'bhnd' else t.transpose(1, 2)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rope_outside(q, k, rope, layout):
    """Rotate q and k by ``rope=(sin, cos)`` ([N, D] tables) in q's dtype."""
    sin, cos = rope
    n, d = sin.shape
    shape = (1, 1, n, d) if layout == 'bhnd' else (1, n, 1, d)
    sin = sin.to(q.dtype).reshape(shape)
    cos = cos.to(q.dtype).reshape(shape)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def attention_reference(q, k, v, layout: str = 'bnhd',
                        n_valid: Optional[int] = None, rope=None,
                        return_lse: bool = False):
    """Plain PyTorch attention: matmul + softmax, scores in float32.

    The plain version of :func:`fused_attention` (and the ``'xla'`` path):
    q/k rotated by ``rope`` first, scores scaled by 1/sqrt(D), key columns
    at or past ``n_valid`` masked.  Returns o in q's dtype and layout, and
    with ``return_lse`` also the f32 log-sum-exp ``[B, H, N]``.
    """
    if rope is not None:
        q, k = _rope_outside(q, k, rope, layout)
    qt, kt, vt = (_to_bhnd(t, layout) for t in (q, k, v))
    n, d = qt.shape[-2], qt.shape[-1]
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if n_valid is not None and n_valid < n:
        s[..., n_valid:] = _MASK
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), vt.float()).to(q.dtype)
    o = _to_bhnd(o, layout)
    return (o, lse) if return_lse else o


def attention_bwd_reference(q, k, v, o, lse, do, layout: str = 'bnhd',
                            n_valid: Optional[int] = None, rope=None):
    """Plain PyTorch attention backward: ``(dq, dk, dv)``.

    The plain version of :func:`fused_attention_bwd`, the formulas of the
    JAX kernel ``_fa_bwd_kernel`` written out in float32: with ``Rq, Rk``
    the rotated q and k and ``scale = 1/sqrt(D)``,
    ``p = exp(scale·Rq·Rkᵀ − lse)`` (0 on key columns at or past
    ``n_valid``), ``ds = p∘(do·vᵀ − rowsum(do∘o))``, ``dq = Rᵀ(scale·ds·Rk)``,
    ``dk = Rᵀ(scale·dsᵀ·Rq)``, ``dv = pᵀ·do``, where
    ``Rᵀ(y) = y·cos − rotate_half(y)·sin`` (the transpose of the rotation for
    half-tiled tables, the only kind the ViT builds).  ``o`` and ``lse`` are
    the forward's.  Returns the gradients in q's dtype and layout.
    """
    dtype = q.dtype
    qt, kt, vt, ot, dot = (_to_bhnd(t, layout).float() for t in (q, k, v, o, do))
    n, d = qt.shape[-2], qt.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if rope is not None:
        sin, cos = (t.float().reshape(1, 1, n, d) for t in rope)
        qt = qt * cos + _rotate_half(qt) * sin
        kt = kt * cos + _rotate_half(kt) * sin
    p = torch.matmul(qt, kt.transpose(-1, -2)).mul_(scale)
    if n_valid is not None and n_valid < n:
        p[..., n_valid:] = _MASK
    p = p.sub_(lse.float()[..., None]).exp_()
    ds = torch.matmul(dot, vt.transpose(-1, -2))
    ds = ds.sub_((dot * ot).sum(-1, keepdim=True)).mul_(p)
    dv = torch.matmul(p.transpose(-1, -2), dot)
    del p
    dq = torch.matmul(ds, kt).mul_(scale)
    dk = torch.matmul(ds.transpose(-1, -2), qt).mul_(scale)
    if rope is not None:
        dq = dq * cos - _rotate_half(dq) * sin
        dk = dk * cos - _rotate_half(dk) * sin
    return tuple(_to_bhnd(t, layout).to(dtype) for t in (dq, dk, dv))


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides (unit
    last stride, a 16-byte aligned start and strides that are multiples of
    16 bytes, as TMA needs), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    # a fresh copy: .contiguous() would hand back a contiguous view as it is,
    # start and all
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_inputs(ts, layout, n_valid, rope):
    """Check what both attention kernels take and prepare it: the [B,N,H,D]
    (or [B,H,N,D]) tensors ``ts`` as kernel views, the dims ``(b, h, s, d,
    n)``, the (b, h, s) axis order of ``layout`` and the tables in the
    tensors' type.  Raises before any kernel library is loaded."""
    q = ts[0]
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f'the attention kernels take bfloat16 or float32 '
                        f'tensors of one type, got {[t.dtype for t in ts]}')
    if any(t.shape != q.shape for t in ts) or q.dim() != 4:
        raise ValueError(f'attention tensors must share one 4-d shape, got '
                         f'{[tuple(t.shape) for t in ts]}')
    if any(t.device != q.device for t in ts):
        raise ValueError('attention tensors must be on one device')
    if layout not in ('bnhd', 'bhnd'):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    # dims as (b, h, s, d) whatever the layout
    perm = (0, 2, 1, 3) if layout == 'bnhd' else (0, 1, 2, 3)
    b, h, s, d = (q.shape[i] for i in perm)
    if d not in (64, 128):
        raise ValueError(f'the attention kernels take head dim 64 or 128, got {d}')
    n = s if n_valid is None else int(n_valid)
    if not 1 <= n <= s:
        raise ValueError(f'n_valid must lie in [1, {s}], got {n_valid}')
    sin = cos = None
    if rope is not None:
        sin, cos = (t.to(q.dtype).contiguous() for t in rope)
        if tuple(sin.shape) != (s, d) or tuple(cos.shape) != (s, d):
            raise ValueError(f'rope tables must be [{s}, {d}], got '
                             f'{tuple(sin.shape)}/{tuple(cos.shape)}')
    return [_kernel_view(t) for t in ts], (b, h, s, d, n), perm, sin, cos


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_scratch(b, h, s, d, rope: bool, f32: bool, device):
    """K1's scratch, none of it zeroed: the bf16 ``[B, H, S, D]`` buffers
    its staging launch writes and its main kernel streams by TMA, K
    (rotated, or rounded from float32) with RoPE or float32 inputs and V
    (rounded) with float32 inputs, else None (the main kernel then reads
    the bf16 input in place)."""
    def seq(needed):
        return (torch.empty((b, h, s, d), dtype=torch.bfloat16, device=device)
                if needed else None)

    return seq(rope or f32), seq(f32)


def _launch_fwd(q, k, v, layout, n_valid, rope):
    (q, k, v), (b, h, s, d, n), perm, sin, cos = _kernel_inputs(
        (q, k, v), layout, n_valid, rope)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kbuf, vbuf = _fwd_scratch(b, h, s, d, rope is not None,
                              q.dtype == torch.float32, q.device)
    st = [[t.stride(i) for i in perm[:3]] for t in (q, k, v, o)]
    fn = _load('attention_fwd')
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(sin), _ptr(cos),
            _ptr(kbuf), _ptr(vbuf), o.data_ptr(), lse.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, s, d, n,
            *st[0], *st[1], *st[2], *st[3], 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f'attention kernel launch failed: CUDA error {err}')
    fused_attention.launches += 1
    return o, lse


# K2's table of lse·log2(e) and delta per q row is padded to this many rows,
# so that TMA fetches any q tile's entries from 16-byte-aligned rows
_STATS_PAD = 64


def _bwd_scratch(b, h, s, d, rope: bool, f32: bool, device):
    """K2's scratch, none of it zeroed (its prologue writes all of it):
    bf16 ``[B, H, S, D]`` copies of scale·rope(q) always, of rope(k) with
    RoPE or float32 inputs, of v and do with float32 inputs (else None); and
    the float32 ``[B, H, 2, S_pad]`` table of lse·log2(e) and delta =
    rowsum(do∘o), ``S_pad`` = S rounded up to a multiple of 64."""
    def seq(needed):
        return (torch.empty((b, h, s, d), dtype=torch.bfloat16, device=device)
                if needed else None)

    s_pad = -(-s // _STATS_PAD) * _STATS_PAD
    stats = torch.empty((b, h, 2, s_pad), dtype=torch.float32, device=device)
    return seq(True), seq(rope or f32), seq(f32), seq(f32), stats


def _launch_bwd(q, k, v, o, lse, do, layout, n_valid, rope):
    (q, k, v, o, do), (b, h, s, d, n), perm, sin, cos = _kernel_inputs(
        (q, k, v, o, do), layout, n_valid, rope)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s):
        raise ValueError(f'lse must be float32 [{b}, {h}, {s}], got '
                         f'{lse.dtype} {tuple(lse.shape)}')
    if lse.device != q.device:
        raise ValueError('lse must be on the device of q')
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format)
                  for _ in range(3))
    qbuf, kbuf, vbuf, dobuf, stats = _bwd_scratch(
        b, h, s, d, rope is not None, q.dtype == torch.float32, q.device)
    st = [t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in perm[:3]]
    fn = _load('attention_bwd')
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(_ptr(t) for t in (q, k, v, o, do, lse, sin, cos, qbuf, kbuf,
                                vbuf, dobuf, stats, dq, dk, dv)),
            _KERNEL_DTYPES[q.dtype], b, h, s, d, n, *st,
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f'attention backward kernel launch failed: CUDA '
                           f'error {err}')
    fused_attention_bwd.launches += 1
    return dq, dk, dv


# ctypes signatures: (pointers, ints, strides) of each C entry
_SIGNATURES = {
    'attention_fwd': ('ever_attn_fwd', 9, 6, 12),
    'attention_bwd': ('ever_attn_bwd', 16, 6, 24),
}


def _load(name: str):
    from ever_tpu_torch.ops._build import function
    fn_name, n_ptr, n_int, n_stride = _SIGNATURES[name]
    return function(name, fn_name, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                    + [ctypes.c_longlong] * n_stride + [ctypes.c_float])


def fused_attention(q, k, v, layout: str = 'bnhd',
                    n_valid: Optional[int] = None,
                    rope=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward through the hand-written kernel: ``(o, lse)``.

    Port of the JAX fused kernel (``_fused`` / ``_fa_fwd_kernel``): o in q's
    layout, lse ``[B, H, N]`` f32.  ``rope=(sin, cos)`` are the unfolded
    [N, D] tables.  K is rotated once per (b, h) by a staging launch into a
    bf16 scratch buffer; q is rotated and scaled inside the main kernel,
    once per q tile, on its way from device memory into registers.
    ``n_valid``: only the first ``n_valid`` keys are real; query rows past
    it are garbage by contract.

    On a CUDA tensor this launches the kernel (bf16 or f32, head dim 64 or
    128) or raises; on a CPU tensor it runs :func:`attention_reference`, the
    plain version of the same function.  With f32 inputs the staging launch
    rounds K and V to bf16 and the main kernel rounds q, for the tensor
    cores; scores, softmax and o stay f32.  ``fused_attention.launches``
    counts calls that launched the kernel (its staging launch and main
    kernel count as one).
    """
    if q.device.type == 'cuda':
        return _launch_fwd(q, k, v, layout, n_valid, rope)
    if q.device.type == 'cpu':
        return attention_reference(q, k, v, layout=layout, n_valid=n_valid,
                                   rope=rope, return_lse=True)
    raise RuntimeError(f'no attention kernel for device {q.device}')


fused_attention.launches = 0


def fused_attention_bwd(q, k, v, o, lse, do, layout: str = 'bnhd',
                        n_valid: Optional[int] = None, rope=None):
    """Attention backward through the hand-written kernel: ``(dq, dk, dv)``.

    Port of the JAX fused backward (``_fused_bwd_impl`` / ``_fa_bwd_kernel``)
    from the unrotated q/k/v, the forward's o and lse, and the upstream
    gradient ``do``; dq and dk leave inverse-rotated (half-tiled tables).
    Key rows at or past ``n_valid`` get zero dk/dv; query rows past it are
    garbage by contract.

    On a CUDA tensor this launches the kernel (bf16 or f32, head dim 64 or
    128) or raises; on a CPU tensor it runs :func:`attention_bwd_reference`,
    the plain version of the same function.  ``fused_attention_bwd.launches``
    counts kernel launches.
    """
    if q.device.type == 'cuda':
        return _launch_bwd(q, k, v, o, lse, do, layout, n_valid, rope)
    if q.device.type == 'cpu':
        return attention_bwd_reference(q, k, v, o, lse, do, layout=layout,
                                       n_valid=n_valid, rope=rope)
    raise RuntimeError(f'no attention kernel for device {q.device}')


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    """o = attention(q, k, v) with :func:`fused_attention` as the forward
    and :func:`fused_attention_bwd` as the backward: the kernels on CUDA
    tensors, their plain versions on CPU tensors.  The RoPE tables get no
    gradient, as in the JAX package's ``_fused_core_rope``."""

    @staticmethod
    def forward(ctx, q, k, v, sin, cos, layout, n_valid):
        rope = None if sin is None else (sin, cos)
        o, lse = fused_attention(q, k, v, layout=layout, n_valid=n_valid,
                                 rope=rope)
        ctx.save_for_backward(q, k, v, sin, cos, o, lse)
        ctx.layout, ctx.n_valid = layout, n_valid
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, sin, cos, o, lse = ctx.saved_tensors
        rope = None if sin is None else (sin, cos)
        dq, dk, dv = fused_attention_bwd(q, k, v, o, lse, do, layout=ctx.layout,
                                         n_valid=ctx.n_valid, rope=rope)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: Optional[str] = None, layout: str = 'bnhd',
              n_valid: Optional[int] = None, rope=None) -> torch.Tensor:
    """Multi-head attention with automatic kernel choice.

    ``impl``: None (auto) | ``'xla'`` | ``'fused'`` | ``'flash'``.  Auto picks
    the kernels for CUDA tensors with at least ``FUSED_TOKEN_THRESHOLD``
    tokens, whatever their type (the kernels raise on one they do not take),
    and the plain path otherwise.  On the kernel path a gradient flows
    through the backward kernel when q, k or v requires one.
    ``n_valid``: only the first ``n_valid`` tokens are real (stack-level
    padding); pad keys are masked out, pad query rows are garbage.
    ``rope``: optional ``(sin, cos)`` [N, D] tables (identity rows where
    tokens must not rotate; half-tiled, as the backward assumes).
    """
    n = q.shape[2 if layout == 'bhnd' else 1]
    if impl is None:
        impl = ('fused' if q.device.type == 'cuda'
                and n >= FUSED_TOKEN_THRESHOLD else 'xla')
    if impl in ('fused', 'flash'):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            sin, cos = (None, None) if rope is None else rope
            return _FusedAttention.apply(q, k, v, sin, cos, layout, n_valid)
        return fused_attention(q, k, v, layout=layout, n_valid=n_valid,
                               rope=rope)[0]
    if impl != 'xla':
        raise ValueError(f"impl must be None, 'xla', 'fused' or 'flash', "
                         f'got {impl!r}')
    return attention_reference(q, k, v, layout=layout, n_valid=n_valid,
                               rope=rope)
