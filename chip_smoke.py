#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--profile] [--seed N]

Phases (any failure exits non-zero before the last line is printed):

1. build   — compile every CUDA kernel of the paths from ``ever_tpu_torch/csrc``
             with ``nvcc``, one process per source, all at once; print each
             library's most registers and spills from ptxas's report, and
             fail on a ``wgmma`` that ptxas serialized.
2. kernels — each attention kernel against its plain PyTorch version on the card:
             the attention forward (K1) and backward (K2) at the main
             paths' shape (B=8, H=16, N=1029, D=64, bf16, RoPE), with stack
             padding (N=1032, ``n_valid=1029``), at head dim 128 without RoPE,
             and from float32 inputs; then each timed beside its bound and
             one PyTorch library call computing the same function (K1 also
             at head dim 128 and from float32 inputs), and both split by
             kernel from ``torch.profiler`` (K1: its K staging launch and
             main kernel; K2: its prologue, dK/dV pass and dQ pass) with each
             main kernel's TFLOP/s.
3. serve   — DinoSeg ViT-L/16 (``vitl16_sat493m``, 24 blocks, width 1024,
             16 heads) with bf16 parameters and seeded random weights,
             served through ``tiled_inference`` over one 4096² scene (512²
             tiles, stride 512, ``tile_batch=8``: 64 tiles, 8 batches).  Every
             attention call (N = 1029 tokens) goes through K1: 24 × 8 = 192
             launches per scene.  The output must be finite probabilities,
             one tile batch through the kernel must match the same batch with
             plain attention, and a float32 model must launch K1 too.
4. train   — the same model as the JAX package's ``vit512`` bench section:
             bf16 compute with float32 parameters, AdamW (weight decay 0.05)
             with a cosine schedule (base_lr 1e-4, 1000 iterations), built
             through ``builder`` and ``parallel.spmd``; 8 seeded random 512²
             tiles with labels in [0, 7), RoPE rescale augmentation on.  Two
             warm-up and ten timed steps: 24 K1 and 24 K2 launches per step, a
             finite loss and grad_norm every step, parameters still float32.
             Then the gradients of 2 tiles through the kernels against the
             same step with plain attention, one 1024² step at B=2 with
             ``remat='full'`` (48 K1 and 24 K2 launches) against the same
             step without remat, and one forward and backward through
             ``impl='flash'`` at N=16389 (a 2048² tile) against the plain
             versions; one step runs under ``torch.cuda.set_sync_debug_mode
             ('error')``: the step never makes the host wait for the card.
5. farseg  — FarSeg-R50 (the JAX package's ``farseg`` bench section, without
             its TPU-only layouts) with ``maxpool_impl='pallas'``: first the
             stem's max pool backward (K8) against its plain version at the
             main shape ([8, 256, 256, 64] bf16), in float32, at [2, 30, 22, 5]
             (the unaligned path) and on inputs with ties, then timed.  Then
             the train step: 512² tiles, batch 8, bf16 compute with float32
             parameters, SGD with momentum 0.9 and a poly schedule (base_lr
             0.01, power 0.9, 1000 iterations), built through ``builder`` and
             ``parallel.spmd``; two warm-up and ten timed steps, one K8
             launch per step, a finite loss and grad_norm every step,
             parameters still float32, running statistics finite and moved;
             the step's FLOPs counted once by ``FlopCounterMode`` for MFU.
             Then the gradients of 2 tiles at float32 compute through K8
             against ``maxpool_impl='reduce_window'``.  Then one 4096² scene
             through ``tiled_inference`` (512² tiles, stride 512,
             ``tile_batch=8``, bf16): no K8 launch, as K8 is a backward.
6. layernorm — the fused LayerNorm's forward (K4) and backward (K5) against
             their plain versions at DinoSeg's shape ([8232, 1024] bf16,
             float32 γ and β), in float32, at [37, 203] (a width off the
             16-byte vector: the element-by-element path), at [517, 768]
             (partial last CTAs) and at [300, 4096] (K5's two-sweep path),
             each on the K5 path the wrapper predicts and the kernel takes;
             two K5 calls on the same inputs must give the same bits; then
             each timed beside its bound, its plain version and the
             library's LayerNorm forward and backward, K5 split by kernel
             (rows, partial sums).
7. fused-LN DinoSeg — the DinoSeg ViT-L/16 of phases 3 and 4 built with
             ``EVER_FUSED_LN=1``, full depth: 2 + 10 train steps at 512² B=8
             (49 K4 and 49 K5, 24 K1 and 24 K2 launches a step), 2 tiles'
             gradients against the default-LN model with the same weights,
             one 4096² scene in bf16 (392 K4 and 192 K1 launches) and one
             tile batch against the default-LN model.
8. quant   — the int8 serving layer: the quantize pass (K6) against its plain
             version, exactly, in both rounding modes at the three shapes of
             ``tools/quant_check.py``, the stochastic mode's error statistics
             at [32808, 4096]; the int8 matmul (K7) against its plain version,
             exactly, at [32808, 4096] x [4096, 1024] (ViT-L/16's fc2 over 8
             tiles of 1024²), (300, 128, 130), a K of 80 with N = 257 (TMA's
             zero fill past K) on its ``wgmma`` path, and on its ``mma.sync``
             path a K of 45 and an x_q off 16-byte alignment, each case
             checking that the wrapper and the kernel pick the path it wants;
             ``QuantDense.from_params`` of a seeded [4096, 1024] kernel with
             bias, applied to [32808, 4096], against float32 within 1.1× the
             error its stochastic rounding noise predicts (the card's
             default), and the same product composed from K6 to nearest and
             K7 within 0.02 (``tools/quant_check.py``'s limit); then K6,
             K7 and the layer timed beside bounds, plain versions and library
             calls.
9. trainer — the config-driven run: the project template's
             ``configs/dinoseg_vitl_loveda.py`` as it is (DinoSeg ViT-L/16 in
             bf16, AdamW, cosine with warmup, ``grad_clip``) with its data
             replaced by seeded in-memory crops (16 of 512², batch 8; 4
             test scenes of 1024², batch 2) and its run cut to 8 steps,
             through ``get_trainer('th_ddp', argv=...)().run()``: finite
             losses, the last checkpoint in ``checkpoint_info.json``, and
             exactly 24 K1 launches a train step and an eval batch and 24 K2
             a train step; the automatic evaluation's confusion matrix,
             counted on the card, equal to ``np.bincount`` of the same
             predictions on the host; a resume to 10 steps against 10 steps
             at once, bit for bit; the trained model under
             ``tiled_inference(tta='d4')`` (one 1024² scene, ``tile_batch=2``:
             16 tiles and 24 K1 launches a call) against per-tile ``tta()``
             calls; and the times: ms/step through the ``Launcher`` (a
             12-step run without periodic checkpoints, its loop under
             ``torch.cuda.set_sync_debug_mode('error')``, and the 10-step run
             with one every 2 steps) beside the bare train step, the
             checkpoint saves, s per evaluated scene, tiles/s with and
             without TTA, each with the card's name and power limit.
10. report — a ``{"kernels": [...]}`` line, the card's name and power limit,
             and the result line ``{"ok": true, "device": {...}}``.

``--profile`` adds ``torch.profiler`` traces of one tile batch and one train
step of each model, and of one fused-LN DinoSeg train step: device busy time
against wall time, device time by kind of kernel, and the kernels that take
the most of it.

It imports nothing of JAX and needs one CUDA card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

# H100 SXM dense peaks (NVIDIA data sheet), for the bound
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

B, H, S, D = 8, 16, 1029, 64          # the main path's attention shape
EMBED = H * D                         # ViT-L width
SCENE, TILE, STRIDE, TILE_BATCH, CLASSES = 4096, 512, 512, 8, 7
# kernel vs plain version (f32 from the same inputs).  The kernel rounds the
# rotated, scaled q and K (and, from f32 inputs, V) to bf16 for the tensor
# cores, P to bf16 for P·V, and writes o in the input type.  With N(0, 1)
# inputs the softmax spreads over hundreds of keys, so o is small (max |o|
# a few tenths, mean |o| a few hundredths): the o limits sit on that scale,
# as the largest error and as the relative RMS error ||do|| / ||o||, which a
# fault in P·V (a wrong V row in a tile) moves far more than rounding does.
# lse is about log(S) ~ 7, so its limit is a fraction of a percent.
ATTN_O_MAX_TOL, ATTN_O_RMS_TOL, ATTN_LSE_TOL = 8e-3, 1e-2, 2e-2
# K2 vs its plain version (f32 from the same inputs, real rows), on each
# gradient's own scale: the largest error against the gradient's largest
# value, and ||dg|| / ||g||.  The kernel rounds scale*rope(q), rope(k), v
# and do to bf16 (2^-9 relative each) and p and ds again before the
# products that make dq, dk and dv, so ds carries two roundings into two
# chained products: about 4e-3 relative, measured at every shape.  A wrong
# row or lane in one product (one key row of dV read from its neighbour)
# moves the relative error of that gradient to O(0.1).
ATTN_BWD_MAX_TOL, ATTN_BWD_RMS_TOL = 3e-2, 1.5e-2
# one tile batch, kernel path vs plain path, both bf16 through 24 blocks:
# the two attentions round differently in every block
SLICE_MAX_TOL, SLICE_MEAN_TOL = 5e-2, 5e-3
# the train step: DinoSeg ViT-L/16 at 512², as the JAX package's vit512
# bench section
TRAIN_BATCH, WARMUP_STEPS, TIMED_STEPS = 8, 2, 10
# useful work of one train step, as the JAX bench counts it (no remat, no
# padding): the matmuls are 24·C² FLOP per token per block forward (qkv 6C²,
# proj 2C², fc1 8C², fc2 8C²), three times that with the backward; attention
# 4·B·H·N²·D forward and 8·B·H·N²·D backward, over 24 blocks
TRAIN_FLOPS = 24 * (3 * 24 * EMBED ** 2 * TRAIN_BATCH * S
                    + 12 * TRAIN_BATCH * H * S * S * D)
# kernels vs plain attention on 2 tiles in the same train step (bf16
# compute): global ||dg|| / ||g|| and the worst per-tensor cosine.  The
# first run measured 8.8e-4 and 0.99994: the two attentions round p, ds and
# their outputs differently in every block.  The limits sit ten times
# further out; a kernel path that sends no gradient into q, k or v leaves
# the qkv weights a cosine near 0.
GRAD_REL_TOL, GRAD_COS_MIN = 1e-2, 0.999
# remat='full' vs no remat: the same kernels on the same inputs, recomputed.
# Two runs without remat (printed beside it) differed by about 1e-4 while
# the logits' upsample was F.interpolate, whose CUDA backward adds with
# atomics; as two matrix products (module/ops.py upsample_bilinear) both
# comparisons read 0
REMAT_REL_TOL = 1e-3
# impl='flash' at a 2048² tile: N = 128² + 5 tokens, B=1, H=2
FLASH_N = 128 * 128 + 5
# CUDA-core float32 peak (NVIDIA data sheet): K8's compares and adds
PEAK_F32_FLOPS = 67e12
# K8 (the stem max pool's backward) at FarSeg-R50's 512², batch-8 stem
POOL_SHAPE = (8, 256, 256, 64)
# (shape, type, ties): the main shape, in float32, an H and W that are even
# but leave a ragged block with C off the 8-wide vector (the kernel's
# element-by-element path), and small integers (many exact ties)
POOL_CASES = ((POOL_SHAPE, torch.bfloat16, False), (POOL_SHAPE, torch.float32, False),
              ((2, 30, 22, 5), torch.bfloat16, False), ((8, 64, 64, 64), torch.bfloat16, True))
# K8 vs its plain version: both compare the same values exactly and sum the
# same <= 4 float32 terms before one rounding, so they should agree to the
# bit; the limit is one bf16 ulp of the largest |dx| (2^-8 relative), which
# a dropped or misplaced window term exceeds (it moves dx by a whole g)
POOL_TOL = 2.0 ** -8
# the FarSeg-R50 train step: the JAX package's farseg bench section
FARSEG = dict(encoder=dict(resnet_type='resnet50', maxpool_impl='pallas'),
              classes=CLASSES, dtype='bfloat16')
# K8 vs maxpool_impl='reduce_window' on 2 tiles at float32 compute: the two
# backwards differ at the exact ties of the stem's BatchNorm output (float32
# values of 8 M pixels: a few windows hold two equal maxima), where K8 sends
# the gradient to each and the library to one; that moves the stem's
# gradients, above all the cancelling sums of its BatchNorm's.  Two runs of
# the same step differ far less (cuDNN's backward convolutions, printed
# beside).  The first run measured 4.8e-4 and a worst cosine of 0.99987;
# the limits sit ten times further out.  A K8 that drops a window's term
# moves the stem conv's cosine far below them.
FARSEG_GRAD_REL_TOL, FARSEG_GRAD_COS_MIN = 5e-3, 0.9987
# K4/K5 (the fused LayerNorm) at DinoSeg ViT-L/16's 512² batch of 8: one
# row per token, 8 · 1029 rows of width 1024; the sat preset's eps
LN_ROWS, LN_EPS = TRAIN_BATCH * S, 1e-5
# (rows, width, type, K5's path): the main shape, in float32, a width off
# the 16-byte vector (the kernels' element-by-element path; 37 rows leave
# K5's second CTA 5 rows), 517 rows (K4's last CTA 5 rows of 8, K5's 5 of
# 32), and a width past K5's one-pass registers (ViT-g's 4096: two sweeps)
LN_CASES = ((LN_ROWS, EMBED, torch.bfloat16, 'one_pass'),
            (LN_ROWS, EMBED, torch.float32, 'one_pass'),
            (37, 203, torch.bfloat16, 'elementwise'), (517, 768, torch.bfloat16, 'one_pass'),
            (300, 4096, torch.bfloat16, 'two_sweep'))
# K4/K5 vs their plain versions on the same inputs (K5 given K4's mean and
# rstd).  y and dx: the same float32 arithmetic with the row sums in another
# order, rounded once to the output type, so at most a bf16 ulp of the
# largest value apart (2^-8 relative); a wrong row statistic or a misplaced
# vector moves them by O(1).  mean and rstd: float32 row sums in another
# order, 1e-5 relative.  dγ and dβ: float32 sums over all rows, per CTA and
# then across CTAs, against torch's reduction: ||d|| / ||ref|| <= 1e-5; the
# partial sums of one lost CTA (8 to 32 of 8232 rows) move them by 3e-2 to
# 6e-2.
LN_TOL, LN_STAT_TOL, LN_DW_TOL = 2.0 ** -8, 1e-5, 1e-5
# DinoSeg with EVER_FUSED_LN=1 against the default LayerNorm, same weights:
# the fused norm takes its statistics in one pass (E[x²] - mu²) and applies
# float32 γ and β, the default two-pass statistics with γ and β rounded to
# bf16.  One tile batch in bf16, probabilities: the limits of the attention
# comparison above.  2 tiles' gradients: ||dg|| / ||g|| and the worst
# per-tensor cosine: the first run measured 3.2e-3 and 0.99991 (vit.cls_token);
# the limits sit ten times further out.
FUSED_LN_GRAD_REL_TOL, FUSED_LN_GRAD_COS_MIN = 3e-2, 0.999
# DinoSeg's LayerNorms per forward: two per block and the trunk's final norm
LN_PER_FORWARD = 2 * 24 + 1
# the int8 serving layer, at the shapes of tools/quant_check.py: quantize at
# 8 tiles of 1024² (4101 tokens each) x 4096, [4096, 16384] and [512, 768]
QUANT_SHAPES = ((8 * 4101, 4096), (4096, 16384), (512, 768))
# K7: (M, K, N, byte offset of x_q, path).  ViT-L/16's fc2 over those tokens
# (M = 256·128 + 40 rows: a ragged last tile of 128); (300, 128, 130) from
# the JAX tests (M and N ragged, N below one 256-wide tile); a K that is a
# multiple of 16 but not of TMA's 128-byte slice (zero-filled past K) with an
# odd N; then the mma.sync path: a K off 16 bytes, and an x_q starting 1 byte
# past 16-byte alignment
MM_CASES = ((8 * 4101, 4096, 1024, 0, 'wgmma'), (300, 128, 130, 0, 'wgmma'),
            (1000, 80, 257, 0, 'wgmma'), (77, 45, 100, 0, 'mma_sync'),
            (64, 128, 64, 1, 'mma_sync'))
# QuantDense's product rounded to nearest against float32 x @ w + b
# (tools/quant_check.py's limit); stochastic rounding, the layer's own mode
# on the card, doubles the error's variance and is held to its own
# prediction instead (phase_quant)
QUANT_REL_TOL = 0.02
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12


# kernel-name words that sort a profile's device time by kind
PROFILE_KINDS = (('the port\'s kernels', ('attn_fwd_kernel', 'stage_kernel', 'attn_bwd_',
                                         'prologue_kernel', 'maxpool32', 'int8_gemm',
                                         'ever_ln_', 'ever_quant')),
                 ('convolutions and matmuls', ('xmma', 'gemm', 'nvjet', 'cutlass', 'conv')),
                 ('normalization', ('batch_norm', 'layer_norm', 'GammaBeta')),
                 ('resizes', ('upsample',)),
                 ('optimizer', ('multi_tensor_apply',)),
                 ('reductions', ('reduce_kernel',)))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of ``fn()`` in ms, from CUDA events over ``iters`` calls
    queued behind a spin of the card long enough (about 1 ms a call) for the
    host to queue every call before the first one starts: a host slower than
    the kernel then cannot starve the card between calls, as it can in
    ``cuda_ms``.  For calls that a CUDA graph cannot capture (autograd)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn()`` in ms, from CUDA events around the replay of
    one CUDA graph holding ``iters`` calls: the host's cost of each call
    (Python, allocation, the launch itself) stays out, which matters for
    kernels that take tens of microseconds."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):                 # warm up where it is captured
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def rope_tables(n_tokens: int, device, dtype=torch.bfloat16,
                grid: int = TILE // 16, head_dim: int = D) -> tuple:
    """The main paths' RoPE tables at 512² tiles: the ViT's 32×32 patch
    tables (``grid``² patches) with identity rows for the 5 prefix tokens
    (cls + 4 storage) and for any tail pad rows, in ``dtype``, as
    ``SelfAttention`` builds them; ``head_dim`` wide (the width split
    into fewer heads for 128)."""
    from ever_tpu_torch.module.vit import RopePositionEmbedding, token_rope
    sin, cos = RopePositionEmbedding(EMBED, EMBED // head_dim, rescale_coords=2.0)(
        grid, grid, device=device)
    sin, cos = token_rope(sin, cos, prefix=5, tail=n_tokens - 5 - sin.shape[0])
    return sin.to(dtype), cos.to(dtype)


# (batch, heads, tokens, n_valid, head dim, RoPE, type): the main paths'
# shape, the same with stack padding, ViT-7B's head dim 128 without RoPE,
# and the main paths' shape from float32 inputs
KERNEL_CASES = ((B, H, S, None, D, True, torch.bfloat16),
                (B, H, S + 3, S, D, True, torch.bfloat16),
                (1, 32, S, S - 100, 128, False, torch.bfloat16),
                (B, H, S, None, D, True, torch.float32))


def case_inputs(gen, b, h, s, d, with_rope, dtype):
    """q/k/v as strided views of one packed [B, N, 3, H, D] tensor, as the
    model makes them, and the RoPE tables (or None)."""
    dev = torch.device('cuda')
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    return q, k, v, rope_tables(s, dev, dtype, head_dim=d) if with_rope else None


def f32_rope(rope):
    return None if rope is None else (rope[0].float(), rope[1].float())


def check_fwd(gen) -> float:
    """K1 against its plain version at every case; the largest error."""
    from ever_tpu_torch.ops import attention as A

    errs = []
    for b, h, s, n_valid, d, with_rope, dtype in KERNEL_CASES:
        q, k, v, rope = case_inputs(gen, b, h, s, d, with_rope, dtype)
        o, lse = A.fused_attention(q, k, v, n_valid=n_valid, rope=rope)
        torch.cuda.synchronize()
        ro, rlse = A.attention_reference(q.float(), k.float(), v.float(),
                                         n_valid=n_valid, rope=f32_rope(rope),
                                         return_lse=True)
        n = n_valid or s                             # rows past n_valid are garbage
        do = o[:, :n].float() - ro[:, :n]
        err_o = do.abs().max().item()
        rms_o = (do.norm() / ro[:, :n].norm()).item()
        err_l = (lse[..., :n] - rlse[..., :n]).abs().max().item()
        finite = bool(torch.isfinite(o[:, :n]).all() and torch.isfinite(lse[..., :n]).all())
        name = (f'attention_fwd B={b} H={h} S={s} D={d} n_valid={n_valid} '
                f'rope={with_rope} {str(dtype)[6:]}')
        print(f'kernels: {name}: max|o-plain| {err_o:.3e} (max|o| '
              f'{ro[:, :n].abs().max().item():.3e}), ||do||/||o|| {rms_o:.3e}, '
              f'max|lse-plain| {err_l:.3e} (tolerances {ATTN_O_MAX_TOL}, '
              f'{ATTN_O_RMS_TOL}, {ATTN_LSE_TOL})', flush=True)
        check(finite, f'{name}: non-finite output')
        check(o.dtype == dtype, f'{name}: o is {o.dtype}')
        check(err_o <= ATTN_O_MAX_TOL and rms_o <= ATTN_O_RMS_TOL
              and err_l <= ATTN_LSE_TOL, f'{name} disagrees with its plain version')
        errs.append(max(err_o, err_l))
    return max(errs)


def check_bwd(gen) -> float:
    """K2 against its plain version at every case, from K1's o and lse and
    a random upstream gradient; the largest error."""
    from ever_tpu_torch.ops import attention as A

    errs = []
    for b, h, s, n_valid, d, with_rope, dtype in KERNEL_CASES:
        q, k, v, rope = case_inputs(gen, b, h, s, d, with_rope, dtype)
        o, lse = A.fused_attention(q, k, v, n_valid=n_valid, rope=rope)
        do = torch.randn(o.shape, generator=gen, device=o.device).to(dtype)
        grads = A.fused_attention_bwd(q, k, v, o, lse, do, n_valid=n_valid, rope=rope)
        torch.cuda.synchronize()
        refs = A.attention_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                         lse, do.float(), n_valid=n_valid,
                                         rope=f32_rope(rope))
        n = n_valid or s
        name = (f'attention_bwd B={b} H={h} S={s} D={d} n_valid={n_valid} '
                f'rope={with_rope} {str(dtype)[6:]}')
        parts, fails = [], []
        for gname, g, r in zip(('dq', 'dk', 'dv'), grads, refs):
            delta = g[:, :n].float() - r[:, :n]
            err, scale = delta.abs().max().item(), r[:, :n].abs().max().item()
            rms = (delta.norm() / r[:, :n].norm()).item()
            parts.append(f'{gname} max|d| {err:.3e} (max|{gname}| {scale:.3e}) '
                         f'rel {rms:.3e}')
            if g.dtype != dtype or not bool(torch.isfinite(g[:, :n]).all()):
                fails.append(f'{gname} is {g.dtype} or not finite')
            if err > ATTN_BWD_MAX_TOL * scale or rms > ATTN_BWD_RMS_TOL:
                fails.append(f'{gname} disagrees with its plain version')
            errs.append(err)
        zero_tail = all(not t[:, n:].any() for t in grads[1:])
        print(f'kernels: {name}: {"; ".join(parts)}; dk, dv zero past n_valid: '
              f'{zero_tail} (tolerances {ATTN_BWD_MAX_TOL}·max, {ATTN_BWD_RMS_TOL})',
              flush=True)
        check(not fails, f'{name}: {", ".join(fails)}')
        check(zero_tail, f'{name}: dk or dv not zero on rows past n_valid')
    return max(errs)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(bound ms, 'operations' or 'bytes') on the H100's memory peak and
    ``peak_flops`` (the bf16 tensor-core peak unless given)."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


# each kernel's launches by part, as (part, words of its kernel names), for
# its split: K1's staging launch and main kernel; K2's prologue and passes;
# K5's rows (one pass, or the two-sweep kernel) and its partial sums
FWD_KERNELS = (('K staging', ('stage_kernel',)), ('main kernel', ('attn_fwd_kernel',)))
BWD_KERNELS = (('prologue', ('prologue_kernel',)), ('dK/dV pass', ('attn_bwd_dkdv',)),
               ('dQ pass', ('attn_bwd_dq',)))
LN_BWD_KERNELS = (('rows', ('ever_ln_bwd_rows', 'ever_ln_bwd<')),
                  ('partial sums', ('ever_ln_bwd_reduce',)))


def kernel_split(fn, parts, calls: int = 10) -> dict:
    """Device ms per call of each part of a kernel (``parts`` as in
    ``BWD_KERNELS``) over ``calls`` calls of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {part: 0.0 for part, _ in parts}
    for event in prof.key_averages():
        for part, words in parts:
            if any(w in event.key for w in words):
                split[part] += event.device_time_total / calls / 1e3
    check(all(ms > 0 for ms in split.values()), f'the profiler missed a kernel: {split}')
    return split


def phase_kernels(gen):
    """Both attention kernels checked and timed at the main shape: their
    records for the report."""
    from ever_tpu_torch.ops import attention as A

    fwd_err, bwd_err = check_fwd(gen), check_bwd(gen)

    # timing at the main paths' shape: S=1029, no pad, RoPE on
    q, k, v, rope = case_inputs(gen, B, H, S, D, True, torch.bfloat16)
    ms = device_ms(lambda: A.fused_attention(q, k, v, rope=rope), iters=50)
    # the float32 instance (a default DinoSeg's type) and head dim 128 at the
    # same width and work (8 heads), for the record only
    q32, k32, v32 = (t.float() for t in (q, k, v))
    rope32 = f32_rope(rope)
    f32_ms = device_ms(lambda: A.fused_attention(q32, k32, v32, rope=rope32), iters=50)
    q128, k128, v128, rope128 = case_inputs(gen, B, H // 2, S, 2 * D, True, torch.bfloat16)
    d128_ms = device_ms(lambda: A.fused_attention(q128, k128, v128, rope=rope128), iters=50)
    del q128, k128, v128
    plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, rope=rope), iters=10)
    # yardstick only: one PyTorch call on the same, already rotated, tensors
    qr, kr = A._rope_outside(q, k, rope, 'bnhd')
    qr, kr, vr = (t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    library_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr), iters=50)
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4 + 2 * S * D * 2
    bound_ms, bound_by = bound(flops, nbytes)
    print(f'kernels: attention_fwd {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, '
          f'SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), '
          f'{flops / ms / 1e9:.1f} TFLOP/s; float32 inputs {f32_ms:.4f} ms/launch; '
          f'head dim 128 (H={H // 2}, RoPE) {d128_ms:.4f} ms/launch', flush=True)
    split = kernel_split(lambda: A.fused_attention(q, k, v, rope=rope), FWD_KERNELS)
    print('kernels: attention_fwd split by kernel (profiler, device ms per call): '
          f'K staging {split["K staging"]:.4f}; main kernel {split["main kernel"]:.4f} '
          f'({flops / split["main kernel"] / 1e9:.1f} TFLOP/s)', flush=True)
    fwd = dict(name='attention_fwd', route='cuda',
               source='ever_tpu_torch/csrc/attention_fwd.cu',
               replaces='ever_tpu/ops/attention.py:175', launches=None,
               max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)

    o, lse = A.fused_attention(q, k, v, rope=rope)
    do = torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
    bwd_ms = device_ms(lambda: A.fused_attention_bwd(q, k, v, o, lse, do, rope=rope),
                       iters=30)
    bwd32_ms = device_ms(lambda: A.fused_attention_bwd(
        q32, k32, v32, o.float(), lse, do.float(), rope=rope32), iters=10)
    bwd_plain_ms = cuda_ms(lambda: A.attention_bwd_reference(
        q, k, v, o, lse, do, rope=rope), iters=5)
    # yardstick only: SDPA's backward on the rotated tensors, graph kept
    qg, kg, vg = (t.detach().requires_grad_() for t in (qr, kr, vr))
    og = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
    dog = do.transpose(1, 2).contiguous()
    bwd_library_ms = device_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), dog, retain_graph=True), iters=30)
    # five products of 2·B·H·N²·D; q, k, v, o, do read, dq, dk, dv written
    bflops = 10.0 * B * H * S * S * D
    bbytes = 8 * B * S * H * D * 2 + B * H * S * 4 + 2 * S * D * 2
    bwd_bound_ms, bwd_bound_by = bound(bflops, bbytes)
    print(f'kernels: attention_bwd {bwd_ms:.4f} ms/launch, plain {bwd_plain_ms:.4f} ms, '
          f'SDPA backward {bwd_library_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms '
          f'({bflops / 1e9:.1f} GFLOP, {bbytes / 1e6:.1f} MB), '
          f'{bflops / bwd_ms / 1e9:.1f} TFLOP/s; float32 inputs {bwd32_ms:.4f} ms/launch',
          flush=True)
    split = kernel_split(lambda: A.fused_attention_bwd(q, k, v, o, lse, do, rope=rope),
                         BWD_KERNELS)
    # the dK/dV pass runs four products, the dQ pass three (it repeats s and dp)
    work = {'prologue': None, 'dK/dV pass': 4, 'dQ pass': 3}
    print('kernels: attention_bwd split by kernel (profiler, device ms per call): '
          + '; '.join(f'{part} {ms:.4f}' + (
              f' ({work[part] * bflops / 5 / ms / 1e9:.1f} TFLOP/s)' if work.get(part) else '')
              for part, ms in split.items()), flush=True)
    bwd = dict(name='attention_bwd', route='cuda',
               source='ever_tpu_torch/csrc/attention_bwd.cu',
               replaces='ever_tpu/ops/attention.py:207', launches=None,
               max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
               library_ms=bwd_library_ms)
    return fwd, bwd


def seeded_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: matrices ~N(0, 0.04²) (peaked softmaxes),
    biases and tokens ~N(0, 0.02²), norm weights and LayerScale gammas
    ~U(0.5, 1.5) so every block moves the output."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('gamma') or ('norm' in name and name.endswith('weight')):
                p.copy_(torch.rand(p.shape, generator=gen, device=p.device) + 0.5)
            elif p.dim() >= 2 and not name.endswith(('cls_token', 'storage_tokens')):
                p.copy_(0.04 * torch.randn(p.shape, generator=gen, device=p.device))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))


def kernel_name(key: str) -> str:
    """A profiler row's kernel without its return type, namespace and
    arguments: 'attn_fwd_kernel<64, __nv_bfloat16>'."""
    key = key.replace('(anonymous namespace)::', '')
    return key.removeprefix('void ').split('(')[0]


def profile_run(label: str, fn) -> None:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # rows named like 'Optimizer.step#SGD.step' are annotations spanning
    # kernels, not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and '#' not in e.key]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f'profile: {label} under the profiler: {wall_ms:.2f} ms wall, '
          f'{busy_ms:.2f} ms of kernels, {len(kernels)} kernel names', flush=True)
    kinds = {}
    for e in kernels:
        kind = next((k for k, words in PROFILE_KINDS if any(w in e.key for w in words)),
                    'elementwise, copies and the rest')
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3
    print('profile: by kind: ' + '; '.join(
        f'{k} {v:.3f} ms' for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
        flush=True)
    port = [e for e in kernels if any(w in e.key for w in PROFILE_KINDS[0][1])]
    print('profile: the port\'s kernels: ' + ('; '.join(
        f'{kernel_name(e.key)} {e.device_time_total / 1e3:.3f} ms ({e.count}x)'
        for e in sorted(port, key=lambda e: -e.device_time_total)) or 'none'), flush=True)
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:20]:
        print(f'profile: {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x '
              f'{e.key[:100]}', flush=True)


def build_dinoseg(gen, **backbone):
    """DinoSeg vitl16_sat493m with bf16 compute, float32 parameters and
    seeded random weights, on the card."""
    from ever_tpu_torch.core.builder import make_model

    cfg = {'type': 'DinoSeg', 'params': dict(
        backbone=dict(name='vitl16_sat493m', **backbone), classes=CLASSES,
        dtype='bfloat16')}
    with torch.device('cuda'):                      # initialise on the card
        model = make_model(cfg)
    seeded_init_(model, gen)
    return model


def phase_serve(gen, profile: bool) -> None:
    """The serving path: one scene, one tile batch against plain attention,
    one float32 tile batch."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.module.vit import SelfAttention
    from ever_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    model = build_dinoseg(gen).to(torch.bfloat16)   # serving keeps bf16 parameters
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    torch.cuda.synchronize()
    print(f'serve: DinoSeg vitl16_sat493m bf16, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, '
          f'built in {time.perf_counter() - t0:.1f} s', flush=True)

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES,
                              tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches, bwd_launches = A.fused_attention.launches, A.fused_attention_bwd.launches
    n_tiles = (SCENE // STRIDE) ** 2
    print(f'serve: {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; attention_fwd launches {launches} '
          f'(expected {24 * n_tiles // TILE_BATCH}), attention_bwd {bwd_launches}; '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    check(launches == 24 * n_tiles // TILE_BATCH and bwd_launches == 0,
          f'attention kernels launched {launches}/{bwd_launches} times, expected 192/0')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    sums = out.sum(-1)
    check(float((sums - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')

    # one tile batch: kernel path vs the same model with the plain attention
    tiles = torch.stack([scene[y:y + TILE, x:x + TILE]
                         for y, x in ((0, 0), (0, 512), (512, 0), (512, 512),
                                      (1024, 0), (0, 1024), (2048, 2048), (3584, 3584))])
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        p_kernel = model(tiles)
        for m in attns:
            m.attn_impl = 'xla'
        plain_batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        p_plain = model(tiles)
        for m in attns:
            m.attn_impl = None
    diff = (p_kernel - p_plain).abs()
    agree = (p_kernel.argmax(-1) == p_plain.argmax(-1)).float().mean().item()
    print(f'serve: tile batch of {TILE_BATCH}: {batch_ms:.2f} ms with the kernel, '
          f'{plain_batch_ms:.2f} ms with plain attention; kernel vs plain '
          f'max|dp| {diff.max().item():.3e}, mean|dp| {diff.mean().item():.3e} '
          f'(tolerances {SLICE_MAX_TOL}, {SLICE_MEAN_TOL}), argmax agreement '
          f'{agree:.4f}', flush=True)
    check(diff.max().item() <= SLICE_MAX_TOL and diff.mean().item() <= SLICE_MEAN_TOL,
          'kernel path and plain path disagree on a tile batch')

    # a default DinoSeg computes in float32: its attention goes through the
    # kernel too
    model.config.dtype = 'float32'
    model.float()
    with torch.no_grad():
        f32_batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        A.fused_attention.launches = 0
        p32 = model(tiles)
        torch.cuda.synchronize()
    launches32 = A.fused_attention.launches
    agree32 = (p32.argmax(-1) == p_kernel.argmax(-1)).float().mean().item()
    print(f'serve: the same tile batch in float32: {f32_batch_ms:.2f} ms, '
          f'attention_fwd launches {launches32} (expected 24), argmax agreement '
          f'with bf16 {agree32:.4f}', flush=True)
    check(launches32 == 24, f'float32 model launched the kernel {launches32} times')
    check(bool(torch.isfinite(p32).all()), 'non-finite float32 probabilities')
    if profile:
        model.config.dtype = 'bfloat16'
        model.to(torch.bfloat16)
        with torch.no_grad():
            profile_run('one serving tile batch', lambda: model(tiles))


def loss_and_grads(model, x, y, seed: int):
    """One train forward and backward: the loss and every parameter's
    gradient (float32 copies)."""
    model.zero_grad(set_to_none=True)
    out = model(x, y, train=True,
                generator=torch.Generator(device='cuda').manual_seed(seed))
    out['cls_loss'].backward()
    grads = [p.grad.detach().float().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return out['cls_loss'].item(), grads


def compare_grads(got, want):
    """(global ||got - want|| / ||want||, worst per-tensor cosine, every
    tensor's cosine) over matching gradient lists; a tensor whose wanted
    gradient is zero counts as cosine 1."""
    num = sum(((g - w) ** 2).sum() for g, w in zip(got, want)).sqrt()
    den = sum((w ** 2).sum() for w in want).sqrt()
    cos = [float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
           if w.norm() > 0 else 1.0 for g, w in zip(got, want)]
    return float(num / den), min(cos), cos


def phase_train(gen, profile: bool):
    """The train path, then the gradient, remat and flash-route checks;
    returns the K1 and K2 launches of the timed steps and their median
    ms/step."""
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.module.vit import SelfAttention
    from ever_tpu_torch.ops import attention as A
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    model = build_dinoseg(gen)
    schedule = make_learningrate({'type': 'cosine', 'params': dict(
        base_lr=1e-4, max_iters=1000)})
    factory, _ = make_optimizer({'type': 'adamw', 'params': dict(weight_decay=0.05)})
    tx = factory.build(schedule)
    state = create_train_state(model, tx)
    step = build_train_step(model, tx, schedule)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen,
                      device='cuda')
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    # an event at every step boundary and one synchronize at the end, as a
    # training loop runs: the host dispatches the next step while the card
    # works, and a step's time is the interval between its two events
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    print(f'train: DinoSeg vitl16_sat493m, bf16 compute, float32 params, AdamW + '
          f'cosine; {TRAIN_BATCH} tiles of {TILE}²; median {med * 1e3:.2f} ms/step '
          f'(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = '
          f'{TRAIN_BATCH / med:.1f} tiles/s; MFU {TRAIN_FLOPS / med / PEAK_BF16_FLOPS:.4f} '
          f'({TRAIN_FLOPS / 1e12:.2f} TFLOP/step / step time / 989 TFLOP/s); '
          f'peak memory {peak:.2f} GiB', flush=True)
    print(f'train: loss per step {" ".join(f"{v:.5f}" for v in losses)}', flush=True)
    print(f'train: grad_norm per step {" ".join(f"{v:.4f}" for v in norms)}; '
          f'learning_rate {metrics[-1]["learning_rate"].item():.6e}', flush=True)
    print(f'train: launches in {TIMED_STEPS} steps: attention_fwd {launches[0]}, '
          f'attention_bwd {launches[1]} (expected {24 * TIMED_STEPS} each)', flush=True)
    check(launches == (24 * TIMED_STEPS, 24 * TIMED_STEPS),
          f'train steps launched the attention kernels {launches} times')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    check(all(st['exp_avg'].dtype == torch.float32
              for st in state.optimizer.state.values()), 'AdamW state left float32')
    # the step never makes the host wait for the card: torch raises on any
    # synchronizing CUDA call in this mode
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, _ = step(state, (x, y))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print('train: one more step under torch.cuda.set_sync_debug_mode("error"): no host sync',
          flush=True)
    if profile:
        profile_run('one train step', lambda: step(state, (x, y)))

    # gradients of 2 tiles: kernels vs plain attention, same draws
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    loss_k, g_kernel = loss_and_grads(model, x[:2], y[:2], seed=5)
    for m in attns:
        m.attn_impl = 'xla'
    loss_p, g_plain = loss_and_grads(model, x[:2], y[:2], seed=5)
    for m in attns:
        m.attn_impl = None
    rel, worst, cos = compare_grads(g_kernel, g_plain)
    names = [n for n, _ in model.named_parameters()]
    qkv_cos = cos[names.index('vit.blocks.0.attn.qkv.weight')]
    print(f'train: gradients of 2 tiles, kernels vs plain attention: loss '
          f'{loss_k:.6f} vs {loss_p:.6f}; ||dg||/||g|| {rel:.3e}, worst per-tensor '
          f'cosine {worst:.6f}, block 0 qkv weight cosine {qkv_cos:.6f} '
          f'(limits {GRAD_REL_TOL}, {GRAD_COS_MIN})', flush=True)
    check(rel <= GRAD_REL_TOL and worst >= GRAD_COS_MIN,
          'kernel gradients disagree with plain attention gradients')
    del g_kernel, g_plain, state, step, metrics
    torch.cuda.empty_cache()

    # one 1024² step at B=2 with remat='full' against the same without
    xr = torch.randn(2, 2 * TILE, 2 * TILE, 3, generator=gen, device='cuda')
    yr = torch.randint(0, CLASSES, (2, 2 * TILE, 2 * TILE), generator=gen, device='cuda')
    torch.cuda.reset_peak_memory_stats()
    loss_n, g_plain = loss_and_grads(model, xr, yr, seed=7)
    peak_n = torch.cuda.max_memory_allocated() / 2**30
    noise = compare_grads(loss_and_grads(model, xr, yr, seed=7)[1], g_plain)[0]
    model.vit.remat = 'full'
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    loss_r, g_remat = loss_and_grads(model, xr, yr, seed=7)
    remat_launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    model.vit.remat = None
    rel_r, worst_r, _ = compare_grads(g_remat, g_plain)
    print(f'train: 1024² step at B=2 (N=4101), remat=full vs none: loss {loss_r:.6f} '
          f'vs {loss_n:.6f}; ||dg||/||g|| {rel_r:.3e} (two runs without remat: '
          f'{noise:.3e}), worst cosine {worst_r:.6f} (limit {REMAT_REL_TOL}); '
          f'launches {remat_launches} (expected (48, 24)); '
          f'peak memory {peak_r:.2f} vs {peak_n:.2f} GiB', flush=True)
    check(remat_launches == (48, 24), f'remat step launched {remat_launches}')
    check(math.isfinite(loss_r) and rel_r <= REMAT_REL_TOL,
          'remat gradients disagree with the step without remat')
    del model, g_plain, g_remat
    torch.cuda.empty_cache()
    check_flash_route(gen)
    return launches, med * 1e3


def check_flash_route(gen) -> None:
    """impl='flash' at N=16389 (a 2048² tile; B=1, H=2, D=64), forward and
    backward through the kernels, against the plain versions: the regime
    that the TPU's library flash kernel serves."""
    from ever_tpu_torch.ops import attention as A

    qkv = torch.randn(1, FLASH_N, 3, 2, D, generator=gen, device='cuda').to(torch.bfloat16)
    qkv.requires_grad_()
    q, k, v = qkv.unbind(2)
    rope = rope_tables(FLASH_N, 'cuda', torch.bfloat16, grid=128)
    do = torch.randn(1, FLASH_N, 2, D, generator=gen, device='cuda').to(torch.bfloat16)
    A.fused_attention.launches = A.fused_attention_bwd.launches = 0
    o = A.attention(q, k, v, impl='flash', rope=rope)
    o.backward(do)
    torch.cuda.synchronize()
    launches = (A.fused_attention.launches, A.fused_attention_bwd.launches)
    q32, k32, v32 = (t.detach().float() for t in (q, k, v))
    ro, rlse = A.attention_reference(q32, k32, v32, rope=f32_rope(rope), return_lse=True)
    refs = A.attention_bwd_reference(q32, k32, v32, ro, rlse, do.float(),
                                     rope=f32_rope(rope))
    delta = o.detach().float() - ro
    rms_o = (delta.norm() / ro.norm()).item()
    parts, ok = [], rms_o <= ATTN_O_RMS_TOL and delta.abs().max().item() <= ATTN_O_MAX_TOL
    for name, g, r in zip(('dq', 'dk', 'dv'), qkv.grad.unbind(2), refs):
        d = g.float() - r
        rel, err = (d.norm() / r.norm()).item(), d.abs().max().item()
        parts.append(f'{name} rel {rel:.3e} max|d| {err:.3e}')
        ok = ok and rel <= ATTN_BWD_RMS_TOL and err <= ATTN_BWD_MAX_TOL * r.abs().max().item()
    print(f'train: impl=flash at N={FLASH_N} (B=1, H=2): ||do||/||o|| {rms_o:.3e}, '
          f'{"; ".join(parts)}; launches {launches} (expected (1, 1))', flush=True)
    check(launches == (1, 1), f'flash route launched {launches}')
    check(ok, 'flash route disagrees with the plain versions')


def pool_inputs(gen, shape, dtype, ties):
    """x (a BatchNorm output's scale, or small integers for ties), the
    forward's out and a random upstream gradient, all [N, H, W, C] views of
    NCHW tensors in channels_last memory, as the ResNet stem makes them."""
    if ties:
        x = torch.randint(-2, 3, shape, generator=gen, device='cuda').to(dtype)
    else:
        x = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    out = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    g = torch.randn(out.shape, generator=gen, device='cuda').to(dtype)
    return x, out, g


def check_maxpool(gen) -> float:
    """K8 against its plain version at every case, and against the library
    backward on float32 inputs without ties; the largest error."""
    from ever_tpu_torch.ops import pool as P

    errs = []
    for shape, dtype, ties in POOL_CASES:
        x, out, g = pool_inputs(gen, shape, dtype, ties)
        dx = P.max_pool_32_bwd(x, out, g)
        torch.cuda.synchronize()
        ref = P.max_pool_32_bwd_reference(x, out, g)
        err = (dx.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        name = f'maxpool_bwd {list(shape)} {str(dtype)[6:]}{" ties" if ties else ""}'
        extra = ''
        if ties:
            # with ties a window's gradient reaches every tied maximum:
            # more of dx is nonzero than the library's one-winner backward
            lib = torch.ops.aten.max_pool2d_with_indices_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), [3, 3], [2, 2], [1, 1],
                [1, 1], False, torch.nn.functional.max_pool2d(
                    x.permute(0, 3, 1, 2), 3, 2, 1, return_indices=True)[1])
            extra = (f', nonzero dx {int((dx != 0).sum())} vs '
                     f'{int((lib != 0).sum())} with one winner per window')
        print(f'kernels: {name}: max|dx-plain| {err:.3e} (max|dx| {scale:.3e}, '
              f'tolerance {POOL_TOL}·max){extra}', flush=True)
        check(dx.dtype == dtype and dx.shape == x.shape, f'{name}: dx is {dx.dtype} '
              f'{tuple(dx.shape)}')
        check(bool(torch.isfinite(dx).all()), f'{name}: non-finite dx')
        check(err <= POOL_TOL * scale, f'{name} disagrees with its plain version')
        errs.append(err)

    # against the library backward where no window holds a tie: distinct
    # float32 integers (float32 normals at the main shape hold some
    # exact ties), so both give each window's gradient to its one maximum
    shape = (2, 64, 64, 64)
    x = torch.randperm(math.prod(shape), generator=gen, device='cuda').float().view(shape)
    xc = x.permute(0, 3, 1, 2)
    out, idx = torch.nn.functional.max_pool2d(xc, 3, 2, 1, return_indices=True)
    g = torch.randn(out.shape, generator=gen, device='cuda').permute(0, 2, 3, 1).contiguous()
    dx = P.max_pool_32_bwd(x, out.permute(0, 2, 3, 1).contiguous(), g)
    lib = torch.ops.aten.max_pool2d_with_indices_backward(
        g.permute(0, 3, 1, 2), xc, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
    lib_err = (dx - lib.permute(0, 2, 3, 1)).abs().max().item()
    print(f'kernels: maxpool_bwd {list(shape)} float32 without ties: max|dx-library| '
          f'{lib_err:.3e} (max|dx| {dx.abs().max().item():.3e}, tolerance 1e-6·max)',
          flush=True)
    check(lib_err <= 1e-6 * dx.abs().max().item(),
          'maxpool_bwd disagrees with the library backward without ties')
    return max(errs)


def phase_maxpool(gen):
    """K8 checked at every case and timed at the main shape: its record."""
    from ever_tpu_torch.ops import pool as P

    err = check_maxpool(gen)
    x, out, g = pool_inputs(gen, POOL_SHAPE, torch.bfloat16, False)
    ms = cuda_ms(lambda: P.max_pool_32_bwd(x, out, g), iters=100)
    plain_ms = cuda_ms(lambda: P.max_pool_32_bwd_reference(x, out, g), iters=5)
    x32, out32, g32 = (t.float().contiguous() for t in (x, out, g))
    f32_ms = cuda_ms(lambda: P.max_pool_32_bwd(x32, out32, g32), iters=50)
    # yardstick only: the library backward given the forward's indices
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    idx = torch.nn.functional.max_pool2d(xc, 3, 2, 1, return_indices=True)[1]
    library_ms = cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        gc, xc, [3, 3], [2, 2], [1, 1], [1, 1], False, idx), iters=100)
    # x, out and g read once, dx written once; a compare and an add for each
    # window covering each input (1, 2 or 4 by row and column parity: 2.25
    # on average), on the CUDA cores
    n = x.numel()
    nbytes = (2 * n + 2 * out.numel()) * x.element_size()
    flops = 2 * 2.25 * n
    bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    print(f'kernels: maxpool_bwd {ms:.4f} ms/launch ({nbytes / ms / 1e9:.3f} TB/s), '
          f'plain {plain_ms:.4f} ms, library (max_pool2d_with_indices_backward) '
          f'{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, '
          f'{flops / 1e6:.0f} M operations); float32 inputs {f32_ms:.4f} ms/launch',
          flush=True)
    return dict(name='maxpool_bwd', route='cuda', source='ever_tpu_torch/csrc/maxpool_bwd.cu',
                replaces='ever_tpu/ops/pool.py:53', launches=None, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def seeded_conv_init_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights for a conv net: kernels ~N(0, 2/fan_in) (He),
    BatchNorm weights ~N(1, 0.1²), biases ~N(0, 0.02²)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_((2.0 / fan_in) ** 0.5 * torch.randn(p.shape, generator=gen,
                                                            device=p.device))
            elif name.endswith('weight'):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen, device=p.device))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device=p.device))


def set_compute_dtype(model, dtype: str) -> None:
    """FarSeg and its encoder each cast their input to their config's dtype."""
    model.config.dtype = model.encoder.config.dtype = dtype


def phase_farseg_train(gen, profile: bool):
    """The FarSeg train path, then the float32 gradient check; returns the
    trained model and the K8 launches of the timed steps."""
    from torch.utils.flop_counter import FlopCounterMode

    from ever_tpu_torch.core.builder import make_learningrate, make_model, make_optimizer
    from ever_tpu_torch.ops import pool as P
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    t0 = time.perf_counter()
    model = make_model({'type': 'FarSeg', 'params': FARSEG})
    seeded_conv_init_(model, gen)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    schedule = make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.01, power=0.9, max_iters=1000)})
    factory, _ = make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    tx = factory.build(schedule)
    state = create_train_state(model, tx)
    step = build_train_step(model, tx, schedule)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    print(f'farseg: FarSeg-R50 bf16 compute, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, built in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    with FlopCounterMode(display=False) as counter:   # the first warm-up step
        state, _ = step(state, (x, y))
    step_flops = counter.get_total_flops()
    for _ in range(WARMUP_STEPS - 1):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P.max_pool_32_bwd.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = P.max_pool_32_bwd.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    print(f'farseg: train, bf16 compute, float32 params, SGD momentum 0.9 + poly; '
          f'{TRAIN_BATCH} tiles of {TILE}²; median {med * 1e3:.2f} ms/step (min '
          f'{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {TRAIN_BATCH / med:.1f} '
          f'tiles/s; MFU {step_flops / med / PEAK_BF16_FLOPS:.4f} ({step_flops / 1e12:.3f} '
          f'TFLOP/step by FlopCounterMode / step time / 989 TFLOP/s); peak memory '
          f'{peak:.2f} GiB', flush=True)
    print(f'farseg: loss per step {" ".join(f"{v:.5f}" for v in losses)}', flush=True)
    print(f'farseg: grad_norm per step {" ".join(f"{v:.4f}" for v in norms)}; '
          f'learning_rate {metrics[-1]["learning_rate"].item():.6e}', flush=True)
    moved = sum(not torch.equal(b, stats0[n]) for n, b in model.named_buffers())
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    print(f'farseg: maxpool_bwd launches in {TIMED_STEPS} steps: {launches} (expected '
          f'{TIMED_STEPS}); running statistics moved in {moved} of '
          f'{len(stats0)} buffers, all finite: {finite}', flush=True)
    check(launches == TIMED_STEPS, f'FarSeg steps launched K8 {launches} times')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    check(finite and moved == len(stats0), 'running statistics not finite or not moved')
    if profile:
        profile_run('one FarSeg train step', lambda: step(state, (x, y)))
    del state, step, metrics
    torch.cuda.empty_cache()

    # gradients of 2 tiles at float32 compute: K8 against the library backward
    set_compute_dtype(model, 'float32')
    resnet = model.encoder.resnet
    loss_k, g_kernel = loss_and_grads(model, x[:2], y[:2], seed=0)
    resnet.maxpool_impl = 'reduce_window'
    loss_l, g_lib = loss_and_grads(model, x[:2], y[:2], seed=0)
    noise = compare_grads(loss_and_grads(model, x[:2], y[:2], seed=0)[1], g_lib)[0]
    resnet.maxpool_impl = 'pallas'
    set_compute_dtype(model, 'bfloat16')
    rel, worst, cos = compare_grads(g_kernel, g_lib)
    names = [n for n, _ in model.named_parameters()]
    stem_cos = cos[names.index('encoder.resnet.conv1.weight')]
    print(f'farseg: gradients of 2 tiles at float32, K8 vs reduce_window: loss '
          f'{loss_k:.6f} vs {loss_l:.6f}; ||dg||/||g|| {rel:.3e} (two runs of '
          f'reduce_window: {noise:.3e}), worst per-tensor cosine {worst:.7f} '
          f'({names[cos.index(worst)]}), stem conv cosine {stem_cos:.7f} (limits '
          f'{FARSEG_GRAD_REL_TOL}, {FARSEG_GRAD_COS_MIN})', flush=True)
    check(rel <= FARSEG_GRAD_REL_TOL and worst >= FARSEG_GRAD_COS_MIN,
          'K8 gradients disagree with the library max pool backward')
    del g_kernel, g_lib
    torch.cuda.empty_cache()
    return model, launches


def phase_farseg_serve(gen, model, profile: bool) -> None:
    """One 4096² scene through tiled_inference with the trained FarSeg in
    bf16 compute; the forward launches no K8."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.ops import pool as P

    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    torch.cuda.reset_peak_memory_stats()
    P.max_pool_32_bwd.launches = 0
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches = P.max_pool_32_bwd.launches
    n_tiles = (SCENE // STRIDE) ** 2
    tiles = torch.stack([scene[i * TILE:(i + 1) * TILE, :TILE] for i in range(TILE_BATCH)])
    with torch.no_grad():
        batch_ms = cuda_ms(lambda: model(tiles), iters=5, warmup=2)
    print(f'farseg: serve {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; tile batch of {TILE_BATCH}: {batch_ms:.2f} ms; '
          f'maxpool_bwd launches {launches} (K8 is a backward: serving launches none); '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    if profile:
        with torch.no_grad():
            profile_run('one FarSeg serving tile batch', lambda: model(tiles))
    check(launches == 0, f'serving launched K8 {launches} times')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    check(float((out.sum(-1) - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')


def ln_inputs(gen, rows, width, dtype):
    """x with a nonzero row mean, γ ~ U(0.5, 1.5), β ~ N(0, 0.1²) (float32)
    and an upstream gradient dy, on the card."""
    x = (2 * torch.randn(rows, width, generator=gen, device='cuda') + 1).to(dtype)
    w = torch.rand(width, generator=gen, device='cuda') + 0.5
    b = 0.1 * torch.randn(width, generator=gen, device='cuda')
    dy = torch.randn(rows, width, generator=gen, device='cuda').to(dtype)
    return x, w, b, dy


def rel_norm(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def kernel_ln_bwd_path(x, dy, w) -> str:
    """The path the built K5 library picks for these operands (with a fresh
    dx and partial-sum buffer, as the wrapper gives it)."""
    import ctypes
    from ever_tpu_torch.ops import _build
    from ever_tpu_torch.ops import norm as N

    fn = _build.load('layernorm').ever_layernorm_bwd_path
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    dx, partial = torch.empty_like(x), N._bwd_partial(*x.shape, x.device)
    return N.BWD_PATHS[fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                          partial.data_ptr(), N._KERNEL_DTYPES[x.dtype], x.shape[1])]


def check_layernorm(gen):
    """K4 and K5 against their plain versions at every case (K5 given K4's
    mean and rstd, on the path the case wants, which the wrapper must
    predict and the kernel take), and K5 twice on the same inputs (the same
    bits); the largest error of each, on its output's scale."""
    from ever_tpu_torch.ops import norm as N

    fwd_errs, bwd_errs = [], []
    for rows, width, dtype, path in LN_CASES:
        x, w, b, dy = ln_inputs(gen, rows, width, dtype)
        paths = (N.layer_norm_bwd_path(x, dy, w), kernel_ln_bwd_path(x, dy, w))
        y, mean, rstd = N.layer_norm_fwd(x, w, b, LN_EPS)
        dx, dw, db = N.layer_norm_bwd(x, dy, w, mean, rstd)
        dx2, dw2, db2 = N.layer_norm_bwd(x, dy, w, mean, rstd)
        torch.cuda.synchronize()
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(db, db2)
        ry, rmean, rrstd = N.layer_norm_reference(x, w, b, LN_EPS)
        rdx, rdw, rdb = N.layer_norm_bwd_reference(x, dy, w, mean, rstd)
        err_y = (y.float() - ry.float()).abs().max().item() / ry.float().abs().max().item()
        err_dx = (dx.float() - rdx.float()).abs().max().item() / rdx.float().abs().max().item()
        err_stat = max((mean - rmean).abs().max().item() / rmean.abs().max().item(),
                       (rstd - rrstd).abs().max().item() / rrstd.abs().max().item())
        err_dw, err_db = rel_norm(dw, rdw), rel_norm(db, rdb)
        name = f'layernorm [{rows}, {width}] {str(dtype)[6:]}'
        print(f'kernels: {name}: max|y-plain| {err_y:.3e}·max|y|, mean/rstd {err_stat:.3e} '
              f'relative; max|dx-plain| {err_dx:.3e}·max|dx|, ||d dgamma||/||dgamma|| '
              f'{err_dw:.3e}, ||d dbeta||/||dbeta|| {err_db:.3e} (tolerances {LN_TOL}·max, '
              f'{LN_STAT_TOL}, {LN_DW_TOL}); K5 path {paths[1]} (wrapper predicts '
              f'{paths[0]}, case wants {path}); two K5 calls bit-equal: {same}', flush=True)
        check(paths == (path, path), f'{name}: K5 took the path {paths}')
        check(same, f'{name}: two K5 calls on the same inputs differ')
        outs = (y, dx, mean, rstd, dw, db)
        check(y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
              and dw.dtype == db.dtype == torch.float32, f'{name}: wrong output types')
        check(all(bool(torch.isfinite(t).all()) for t in outs), f'{name}: non-finite output')
        check(err_y <= LN_TOL and err_stat <= LN_STAT_TOL, f'{name}: K4 disagrees with '
              'its plain version')
        check(err_dx <= LN_TOL and err_dw <= LN_DW_TOL and err_db <= LN_DW_TOL,
              f'{name}: K5 disagrees with its plain version')
        fwd_errs.append((y.float() - ry.float()).abs().max().item())
        bwd_errs.append(max((dx.float() - rdx.float()).abs().max().item(),
                            (dw - rdw).abs().max().item(), (db - rdb).abs().max().item()))
    return max(fwd_errs), max(bwd_errs)


def phase_layernorm(gen):
    """K4 and K5 checked at every case and timed at the main shape: their
    records for the report."""
    from ever_tpu_torch.ops import norm as N

    fwd_err, bwd_err = check_layernorm(gen)
    x, w, b, dy = ln_inputs(gen, LN_ROWS, EMBED, torch.bfloat16)
    _, mean, rstd = N.layer_norm_fwd(x, w, b, LN_EPS)
    # device times from CUDA graphs: a launch's host cost is larger than
    # these kernels' time (host_ms, printed beside, times back-to-back
    # calls from Python)
    fwd_ms = graph_ms(lambda: N.layer_norm_fwd(x, w, b, LN_EPS), iters=200)
    bwd_ms = graph_ms(lambda: N.layer_norm_bwd(x, dy, w, mean, rstd), iters=200)
    fwd_host = cuda_ms(lambda: N.layer_norm_fwd(x, w, b, LN_EPS), iters=200)
    fwd_plain = graph_ms(lambda: N.layer_norm_reference(x, w, b, LN_EPS), iters=20)
    bwd_plain = graph_ms(lambda: N.layer_norm_bwd_reference(x, dy, w, mean, rstd), iters=20)
    x32, dy32 = x.float(), dy.float()
    f32_fwd = graph_ms(lambda: N.layer_norm_fwd(x32, w, b, LN_EPS), iters=100)
    f32_bwd = graph_ms(lambda: N.layer_norm_bwd(x32, dy32, w, mean, rstd), iters=100)
    # yardsticks only: the library's LayerNorm forward and backward on the
    # same bf16 tensors (γ and β in bf16, as the port's default LayerNorm)
    wb, bb = w.to(x.dtype), b.to(x.dtype)
    fwd_lib = graph_ms(lambda: torch.ops.aten.native_layer_norm(x, [EMBED], wb, bb, LN_EPS),
                       iters=200)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [EMBED], wb, bb, LN_EPS)
    bwd_lib = graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [EMBED], lmean, lrstd, wb, bb, [True, True, True]), iters=200)
    # bytes: K4 reads x, γ, β and writes y, mean, rstd; K5 reads x, dy, γ,
    # mean, rstd and writes dx, dγ, dβ.  About 8 and 12 float32 operations
    # per element on the CUDA cores, far below the bytes' time
    n, e = x.numel(), x.element_size()
    fwd_bytes = 2 * n * e + 2 * EMBED * 4 + 2 * LN_ROWS * 4
    bwd_bytes = 3 * n * e + 3 * EMBED * 4 + 2 * LN_ROWS * 4
    fwd_bound, fwd_by = bound(8.0 * n, fwd_bytes, PEAK_F32_FLOPS)
    bwd_bound, bwd_by = bound(12.0 * n, bwd_bytes, PEAK_F32_FLOPS)
    print(f'kernels: layernorm_fwd {fwd_ms:.4f} ms/launch ({fwd_bytes / fwd_ms / 1e9:.3f} '
          f'TB/s), plain {fwd_plain:.4f} ms, library (native_layer_norm) {fwd_lib:.4f} ms, '
          f'bound {fwd_bound:.4f} ms ({fwd_bytes / 1e6:.1f} MB); float32 inputs '
          f'{f32_fwd:.4f} ms/launch; host_ms {fwd_host:.4f} (calls from Python)', flush=True)
    print(f'kernels: layernorm_bwd {bwd_ms:.4f} ms/launch ({bwd_bytes / bwd_ms / 1e9:.3f} '
          f'TB/s), plain {bwd_plain:.4f} ms, library (native_layer_norm_backward) '
          f'{bwd_lib:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_bytes / 1e6:.1f} MB); float32 '
          f'inputs {f32_bwd:.4f} ms/launch', flush=True)
    split = kernel_split(lambda: N.layer_norm_bwd(x, dy, w, mean, rstd), LN_BWD_KERNELS,
                         calls=50)
    print('kernels: layernorm_bwd split by kernel (profiler, device ms per call): '
          f'rows {split["rows"]:.4f} ({bwd_bytes / split["rows"] / 1e9:.3f} TB/s); '
          f'partial sums {split["partial sums"]:.4f}', flush=True)
    src = 'ever_tpu_torch/csrc/layernorm.cu'
    return (dict(name='layernorm_fwd', route='cuda', source=src,
                 replaces='ever_tpu/ops/norm.py:48', launches=None, max_abs_err=fwd_err,
                 ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound, bound_by=fwd_by,
                 library_ms=fwd_lib),
            dict(name='layernorm_bwd', route='cuda', source=src,
                 replaces='ever_tpu/ops/norm.py:61', launches=None, max_abs_err=bwd_err,
                 ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound, bound_by=bwd_by,
                 library_ms=bwd_lib))


@contextlib.contextmanager
def fused_layer_norm():
    """``EVER_FUSED_LN=1`` while a model is built (the port reads it then)."""
    old = os.environ.get('EVER_FUSED_LN')
    os.environ['EVER_FUSED_LN'] = '1'
    try:
        yield
    finally:
        if old is None:
            del os.environ['EVER_FUSED_LN']
        else:
            os.environ['EVER_FUSED_LN'] = old


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    from ever_tpu_torch.ops import attention as A, norm as N, pool as P, quant as Q

    for fn in (A.fused_attention, A.fused_attention_bwd, P.max_pool_32_bwd,
               N.layer_norm_fwd, N.layer_norm_bwd, Q.quantize_int8_values,
               Q.int8_matmul_t):
        fn.launches = 0


def counts():
    """(K1, K2, K4, K5) launches since the last reset."""
    from ever_tpu_torch.ops import attention as A, norm as N

    return (A.fused_attention.launches, A.fused_attention_bwd.launches,
            N.layer_norm_fwd.launches, N.layer_norm_bwd.launches)


def phase_fused_ln(gen, profile: bool):
    """DinoSeg ViT-L/16 under EVER_FUSED_LN=1: train steps, gradients and
    a tile batch against the default-LN model, one scene; returns the K4
    and K5 launches of the timed steps."""
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.core.builder import make_learningrate, make_optimizer
    from ever_tpu_torch.ops.norm import FusedLayerNorm
    from ever_tpu_torch.parallel.spmd import build_train_step, create_train_state

    with fused_layer_norm():
        model = build_dinoseg(gen)
    n_fused = sum(isinstance(m, FusedLayerNorm) for m in model.modules())
    check(n_fused == LN_PER_FORWARD, f'{n_fused} FusedLayerNorm modules, expected '
          f'{LN_PER_FORWARD}')
    plain = build_dinoseg(gen)                      # the default LayerNorm
    schedule = make_learningrate({'type': 'cosine', 'params': dict(
        base_lr=1e-4, max_iters=1000)})
    factory, _ = make_optimizer({'type': 'adamw', 'params': dict(weight_decay=0.05)})
    tx = factory.build(schedule)
    state = create_train_state(model, tx)
    step = build_train_step(model, tx, schedule)
    x = torch.randn(TRAIN_BATCH, TILE, TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, CLASSES, (TRAIN_BATCH, TILE, TILE), generator=gen, device='cuda')
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TIMED_STEPS):
        state, m = step(state, (x, y))
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = train_launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
    med = sorted(times)[len(times) // 2]
    losses = [m['cls_loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    want = (24 * TIMED_STEPS, 24 * TIMED_STEPS, LN_PER_FORWARD * TIMED_STEPS,
            LN_PER_FORWARD * TIMED_STEPS)
    print(f'fused-LN: train, DinoSeg vitl16_sat493m with EVER_FUSED_LN=1, bf16 compute, '
          f'float32 params, AdamW + cosine; {TRAIN_BATCH} tiles of {TILE}²; median '
          f'{med * 1e3:.2f} ms/step (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) '
          f'= {TRAIN_BATCH / med:.1f} tiles/s; MFU {TRAIN_FLOPS / med / PEAK_BF16_FLOPS:.4f}; '
          f'peak memory {peak:.2f} GiB', flush=True)
    print(f'fused-LN: loss per step {" ".join(f"{v:.5f}" for v in losses)}; grad_norm '
          f'{" ".join(f"{v:.4f}" for v in norms)}', flush=True)
    print(f'fused-LN: launches in {TIMED_STEPS} steps (K1, K2, K4, K5): {launches} '
          f'(expected {want})', flush=True)
    check(launches == want, f'fused-LN train steps launched {launches}, expected {want}')
    check(all(math.isfinite(v) for v in losses + norms), 'non-finite loss or grad_norm')
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'parameters left float32')
    if profile:
        profile_run('one fused-LN train step', lambda: step(state, (x, y)))
    del state, step, metrics
    torch.cuda.empty_cache()

    # gradients of 2 tiles: fused LayerNorm vs the default one, same weights
    plain.load_state_dict(model.state_dict())
    loss_f, g_fused = loss_and_grads(model, x[:2], y[:2], seed=5)
    loss_p, g_plain = loss_and_grads(plain, x[:2], y[:2], seed=5)
    rel, worst, cos = compare_grads(g_fused, g_plain)
    names = [n for n, _ in model.named_parameters()]
    print(f'fused-LN: gradients of 2 tiles, fused vs default LayerNorm: loss {loss_f:.6f} '
          f'vs {loss_p:.6f}; ||dg||/||g|| {rel:.3e}, worst per-tensor cosine {worst:.6f} '
          f'({names[cos.index(worst)]}), block 0 norm1 weight cosine '
          f'{cos[names.index("vit.blocks.0.norm1.weight")]:.6f} (limits '
          f'{FUSED_LN_GRAD_REL_TOL}, {FUSED_LN_GRAD_COS_MIN})', flush=True)
    check(rel <= FUSED_LN_GRAD_REL_TOL and worst >= FUSED_LN_GRAD_COS_MIN,
          'fused-LN gradients disagree with the default LayerNorm\'s')
    del g_fused, g_plain
    torch.cuda.empty_cache()

    # serving: bf16 parameters, one scene, one tile batch against the default
    model.to(torch.bfloat16)
    plain.to(torch.bfloat16)
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES, tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    reset_counts()
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches = counts()
    n_tiles = (SCENE // STRIDE) ** 2
    batches = n_tiles // TILE_BATCH
    want = (24 * batches, 0, LN_PER_FORWARD * batches, 0)
    print(f'fused-LN: serve {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; launches (K1, K2, K4, K5) {launches} (expected '
          f'{want})', flush=True)
    check(launches == want, f'fused-LN scene launched {launches}, expected {want}')
    check(tuple(out.shape) == (SCENE, SCENE, CLASSES), f'bad output shape {tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'non-finite probabilities')
    check(float((out.sum(-1) - 1).abs().max()) < 1e-3, 'class probabilities do not sum to 1')
    tiles = torch.stack([scene[i * TILE:(i + 1) * TILE, :TILE] for i in range(TILE_BATCH)])
    with torch.no_grad():
        fused_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: plain(tiles), iters=3, warmup=1)
        p_fused, p_plain = model(tiles), plain(tiles)
    diff = (p_fused - p_plain).abs()
    agree = (p_fused.argmax(-1) == p_plain.argmax(-1)).float().mean().item()
    print(f'fused-LN: tile batch of {TILE_BATCH}: {fused_ms:.2f} ms with the fused '
          f'LayerNorm, {plain_ms:.2f} ms with the default; max|dp| {diff.max().item():.3e}, '
          f'mean|dp| {diff.mean().item():.3e} (tolerances {SLICE_MAX_TOL}, {SLICE_MEAN_TOL}), '
          f'argmax agreement {agree:.4f}', flush=True)
    check(diff.max().item() <= SLICE_MAX_TOL and diff.mean().item() <= SLICE_MEAN_TOL,
          'fused-LN and default-LN models disagree on a tile batch')
    if profile:
        with torch.no_grad():
            profile_run('one fused-LN serving tile batch', lambda: model(tiles))
    return train_launches[2], train_launches[3]


def check_quantize(gen) -> int:
    """K6 against its plain version in both modes at every shape (exactly),
    and the stochastic mode's error statistics at the first; the largest
    |kernel - plain| over all of them, in int8 steps."""
    from ever_tpu_torch.ops import quant as Q

    worst = 0
    for i, (m, k) in enumerate(QUANT_SHAPES):
        x = torch.randn(m, k, generator=gen, device='cuda')
        for stochastic in (True, False):
            q, s = Q.quantize_int8(x, seed=1, stochastic=stochastic)
            torch.cuda.synchronize()
            rq, rs = Q.quantize_int8_reference(x, seed=1, stochastic=stochastic)
            same = torch.equal(q, rq) and torch.equal(s, rs)
            worst = max(worst, int((q.int() - rq.int()).abs().max()))
            mode = 'stochastic' if stochastic else 'nearest'
            print(f'kernels: quantize [{m}, {k}] {mode}: equal to the plain version '
                  f'{same} ({int((q != rq).sum())} values differ), scale {s.item():.6g}',
                  flush=True)
            check(q.dtype == torch.int8 and q.shape == x.shape, f'quantize [{m}, {k}]: '
                  f'values are {q.dtype} {tuple(q.shape)}')
            check(same, f'quantize [{m}, {k}] {mode} differs from its plain version')
        if i:
            continue
        # stochastic rounding: |q·s - x| < s, and unbiased.  The error of one
        # element is (1 - f)·s or -f·s with f the fraction of x/s, of
        # variance f(1 - f)·s²: the mean's σ follows from the data.  float32
        # rounding of x/s, of the added u and of q·s at |x/s| <= 127 adds at
        # most three half-ulps of 127, 1.2e-5·s.
        q, s = Q.quantize_int8(x, seed=1, stochastic=True)
        s = s.item()
        err = q.float() * s - x
        v = x / s
        frac = v - torch.floor(v)
        sigma = s * math.sqrt((frac * (1 - frac)).double().mean().item() / x.numel())
        mean_err = err.double().mean().item()
        q2, _ = Q.quantize_int8(x, seed=2, stochastic=True)
        differ = (q2 != q).float().mean().item()
        print(f'kernels: quantize [{m}, {k}] stochastic: max|q·s-x| '
              f'{err.abs().max().item():.4e} (scale {s:.4e}), mean(q·s-x) {mean_err:.3e} '
              f'(σ {sigma:.3e}, limit 5σ); seed 2 vs seed 1: {differ:.4f} of the values '
              f'differ', flush=True)
        check(err.abs().max().item() <= s * (1 + 2 ** -15), 'stochastic rounding error '
              'exceeds one step')
        check(abs(mean_err) <= 5 * sigma, 'stochastic rounding is biased')
        check(differ > 0.1, 'seeds 1 and 2 round alike')
    return worst


def kernel_mm_path(x_q, w_t) -> str:
    """The path the built K7 library picks for these operands."""
    import ctypes
    from ever_tpu_torch.ops import _build
    from ever_tpu_torch.ops import quant as Q

    fn = _build.load('int8_matmul').ever_int8_matmul_path
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return Q.MM_PATHS[fn(x_q.data_ptr(), w_t.data_ptr(), x_q.shape[1])]


def check_int8_matmul(gen) -> float:
    """K7 against its plain version at every case, exactly, on the path the
    case is meant to take (the wrapper's prediction and the kernel's own
    choice must both name it); the largest |kernel - plain| over the cases."""
    from ever_tpu_torch.ops import quant as Q

    worst = 0.0
    for m, k, n, offset, path in MM_CASES:
        buf = torch.randint(-128, 128, (m * k + 16,), generator=gen, device='cuda',
                            dtype=torch.int8)
        xq = buf[offset:offset + m * k].view(m, k)
        wq = torch.randint(-128, 128, (k, n), generator=gen, device='cuda', dtype=torch.int8)
        wt = wq.t().contiguous()
        xs = torch.tensor([[0.0131]], device='cuda')
        ws = torch.tensor([[0.00217]], device='cuda')
        paths = (Q.int8_matmul_path(xq, wt), kernel_mm_path(xq, wt))
        out = Q.int8_matmul_t(xq, xs, wt, ws)
        torch.cuda.synchronize()
        ref = Q.int8_matmul_reference(xq, xs, wq, ws)
        same = torch.equal(out, ref)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        print(f'kernels: int8_matmul [{m}, {k}] x [{k}, {n}] (x_q offset {offset}): path '
              f'{paths[1]} (wrapper predicts {paths[0]}, case wants {path}); equal to the '
              f'plain version {same} (max|d| {err:.3e}, max|out| '
              f'{ref.abs().max().item():.3e})', flush=True)
        check(paths == (path, path), f'int8_matmul [{m}, {k}] x [{k}, {n}] took {paths}')
        check(out.dtype == torch.float32 and out.shape == (m, n), f'int8_matmul: out is '
              f'{out.dtype} {tuple(out.shape)}')
        check(same, f'int8_matmul [{m}, {k}] x [{k}, {n}] differs from its plain version')
    return worst


def phase_quant(gen):
    """K6 and K7 checked, the QuantDense layer driven at the serving shape
    and held against float32, then all timed: their records."""
    from ever_tpu_torch.ops import quant as Q

    q_err, mm_err = check_quantize(gen), check_int8_matmul(gen)
    m, k = QUANT_SHAPES[0]
    n = MM_CASES[0][2]
    kernel = 0.02 * torch.randn(k, n, generator=gen, device='cuda')
    bias = 0.02 * torch.randn(n, generator=gen, device='cuda')
    x = torch.randn(m, k, generator=gen, device='cuda')
    reset_counts()
    layer = Q.QuantDense.from_params({'kernel': kernel, 'bias': bias}, seed=3, device='cuda')
    out = layer(x)
    torch.cuda.synchronize()
    launches = (Q.quantize_int8_values.launches, Q.int8_matmul_t.launches)
    ref = x @ kernel + bias
    rel = rel_norm(out, ref)
    # each operand's rounding error has variance s²·E[f(1 - f)] per element,
    # s²/6 stochastically and s²/12 to nearest, independent of the values:
    # the product's relative error is about the root of the two operands'
    # error-to-signal ratios
    noise = (layer.w_scale.item() ** 2 / kernel.square().mean().item()
             + (x.abs().amax().item() / 127) ** 2 / x.square().mean().item())
    # the same product rounded to nearest, composed from its parts as the
    # layer composes them: tools/quant_check.py's mode and limit
    w_n, ws_n = Q.quantize_int8(kernel, stochastic=False)
    x_n, xs_n = Q.quantize_int8(x, stochastic=False)
    rel_nearest = rel_norm(Q.int8_matmul_t(x_n, xs_n, w_n.t().contiguous(), ws_n) + bias, ref)
    print(f'quant: QuantDense.from_params [{k}, {n}] with bias, x [{m}, {k}]: '
          f'||y - (x @ w + b)|| / ||x @ w + b|| {rel:.4e} with stochastic rounding (the '
          f'card\'s default; its noise predicts {math.sqrt(noise / 6):.4e}, limit 1.1× that), '
          f'{rel_nearest:.4e} to nearest (predicted {math.sqrt(noise / 12):.4e}, limit '
          f'{QUANT_REL_TOL}); launches (K6, K7) {launches} (expected (2, 1): the weights, then '
          f'the activation)', flush=True)
    check(out.dtype == torch.float32 and out.shape == (m, n) and bool(torch.isfinite(out).all()),
          'QuantDense output is not finite float32 of the right shape')
    check(rel <= 1.1 * math.sqrt(noise / 6), 'stochastic QuantDense disagrees with float32')
    check(rel_nearest < QUANT_REL_TOL, 'QuantDense to nearest disagrees with float32')
    check(launches == (2, 1), f'QuantDense launched {launches}')

    # K6 alone: the values of the activation at its scale, stochastic (the
    # serving path) and to nearest
    s = torch.clamp(x.abs().amax() / 127.0, min=1e-8).reshape(1, 1)
    q_ms = graph_ms(lambda: Q.quantize_int8_values(x, s, 1, True), iters=50)
    qn_ms = graph_ms(lambda: Q.quantize_int8_values(x, s, 1, False), iters=50)
    q_plain = graph_ms(lambda: Q.quantize_int8_values_reference(x, s, 1, True), iters=3)
    # yardstick only: the library's per-tensor quantization, to nearest
    s_value = s.item()
    q_lib = graph_ms(lambda: torch.quantize_per_tensor(x, s_value, 0, torch.qint8), iters=50)
    q_bytes = x.numel() * 5
    q_bound, q_by = bound(3.0 * x.numel(), q_bytes, PEAK_F32_FLOPS)
    print(f'kernels: quantize_int8 [{m}, {k}] {q_ms:.4f} ms/launch stochastic '
          f'({q_bytes / q_ms / 1e9:.3f} TB/s), {qn_ms:.4f} to nearest; plain {q_plain:.4f} ms; '
          f'library (quantize_per_tensor, nearest) {q_lib:.4f} ms; bound {q_bound:.4f} ms '
          f'({q_bytes / 1e6:.1f} MB)', flush=True)

    # K7 alone on QuantDense's operands; the [K, N] API with its per-call
    # transpose; the library's int8 and bf16 products of the same shape
    xq, xs = Q.quantize_int8(x, seed=1)
    wt, ws = layer.weight_t, layer.w_scale
    wq = wt.t().contiguous()
    mm_ms = graph_ms(lambda: Q.int8_matmul_t(xq, xs, wt, ws), iters=20)
    api_ms = graph_ms(lambda: Q.int8_matmul(xq, xs, wq, ws), iters=20)
    mm_plain = graph_ms(lambda: Q.int8_matmul_reference(xq, xs, wq, ws), iters=3)
    mm_lib = graph_ms(lambda: torch._int_mm(xq, wt.t()), iters=20)
    xb, wb = x.to(torch.bfloat16), kernel.to(torch.bfloat16)
    bf16_ms = graph_ms(lambda: xb @ wb, iters=20)
    layer_ms = cuda_ms(lambda: layer(x), iters=20)
    ops = 2.0 * m * k * n
    mm_bytes = m * k + k * n + 4 * m * n
    mm_bound, mm_by = bound(ops, mm_bytes, PEAK_INT8_OPS)
    print(f'kernels: int8_matmul [{m}, {k}] x [{k}, {n}] {mm_ms:.4f} ms/launch '
          f'({ops / mm_ms / 1e9:.1f} TOP/s), with the [K, N] transpose {api_ms:.4f} ms; plain '
          f'{mm_plain:.4f} ms; library torch._int_mm {mm_lib:.4f} ms, bf16 matmul '
          f'{bf16_ms:.4f} ms; bound {mm_bound:.4f} ms ({ops / 1e9:.1f} G operations)',
          flush=True)
    print(f'quant: QuantDense layer at x [{m}, {k}]: {layer_ms:.4f} ms per call from Python '
          f'(scale, K6, K7, bias)', flush=True)
    return (dict(name='quantize_int8', route='cuda', source='ever_tpu_torch/csrc/quant_int8.cu',
                 replaces='ever_tpu/ops/quant.py:35', launches=launches[0],
                 max_abs_err=float(q_err), ms=q_ms, plain_ms=q_plain, bound_ms=q_bound,
                 bound_by=q_by, library_ms=q_lib),
            dict(name='int8_matmul', route='cuda', source='ever_tpu_torch/csrc/int8_matmul.cu',
                 replaces='ever_tpu/ops/quant.py:110', launches=launches[1],
                 max_abs_err=mm_err, ms=mm_ms, plain_ms=mm_plain, bound_ms=mm_bound,
                 bound_by=mm_by, library_ms=mm_lib))


# the trainer phase: the project template's DinoSeg config, its data and
# run length replaced by seeded in-memory crops (LoveDA needs image files)
TEMPLATE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'project_template', 'configs', 'dinoseg_vitl_loveda.py')
TRAINER_ITERS, RESUME_ITERS, EVAL_SCENE, EVAL_BATCH = 8, 10, 2 * TILE, 2
# a timing run without periodic checkpoints: every logged interval of the
# runs above holds one 3.6 GB save
TIMING_ITERS = 12
# d4 TTA of a 1024² scene against per-tile tta() calls: the same model and
# kernels, but 16 tiles a forward against 1, so cuBLAS tiles the bf16
# products differently and each of the 24 blocks rounds differently: the
# regime of the serve phase's kernel-against-plain tile batch, with its limits
TTA_MAX_TOL, TTA_MEAN_TOL = SLICE_MAX_TOL, SLICE_MEAN_TOL


def register_smoke_data():
    """Register ``smoke_scenes`` in the port's DATASET registry: seeded
    float32 images ``[n, size, size, 3]`` with uint8 masks over 7 classes
    and 2 % ignored (255) pixels, made in bulk from ``seed``."""
    import numpy as np
    from ever_tpu_torch.core import registry
    from ever_tpu_torch.interface import ERDataset

    @registry.DATASET.register('smoke_scenes')
    class SmokeScenes(ERDataset):
        def set_default_config(self):
            self.config.update(dict(num_samples=16, image_size=TILE, seed=0))

        def __init__(self, config=None):
            super().__init__(config)
            c = self.config
            rng = np.random.default_rng(c.seed)
            shape = (c.num_samples, c.image_size, c.image_size)
            self.x = rng.standard_normal(shape + (3,), dtype=np.float32)
            self.y = rng.integers(0, CLASSES, shape, dtype=np.uint8)
            self.y[rng.random(shape, dtype=np.float32) < 0.02] = 255

        def __len__(self):
            return self.config.num_samples

        def __getitem__(self, idx):
            return self.x[idx], self.y[idx]


def d4_transforms():
    """The 8 symmetries in ``d4_tta``'s order, as the port's transforms:
    rotations by 0-3 quarter turns, then the same after a horizontal flip."""
    from ever_tpu_torch.interface.transform_base import Transform
    from ever_tpu_torch.magic import transform as T

    class FlipThen(Transform):
        """A horizontal flip, then ``rotation``; inverted in reverse."""

        def __init__(self, rotation):
            self.flip, self.rotation = T.HorizontalFlip(), rotation

        def transform(self, x):
            return self.rotation.transform(self.flip.transform(x))

        def inv_transform(self, y):
            return self.flip.inv_transform(self.rotation.inv_transform(y))

    rots = [T.Identity(), T.Rotate90k(1), T.Rotate90k(2), T.Rotate90k(3)]
    return rots + [FlipThen(r) for r in rots]


def trainer_run(model_dir: str, num_iters: int, seed: int, init_state=None, opts=(),
                sync_free: bool = False):
    """``get_trainer('th_ddp')().run()`` of the template config into
    ``model_dir`` (``opts``: more config overrides); returns the launcher
    and what it logged, evaluated and saved.  ``sync_free``: the training
    loop runs under ``torch.cuda.set_sync_debug_mode('error')``, which
    raises on any synchronizing CUDA call (the logged steps' event waits are
    not one)."""
    from ever_tpu_torch.trainer import get_trainer

    train = dict(num_samples=16, image_size=TILE, seed=seed, total_batch_size=TRAIN_BATCH,
                 sampler_type='StepDistributedSampler')
    test = dict(num_samples=4, image_size=EVAL_SCENE, seed=seed + 1, batch_size=EVAL_BATCH,
                sampler_type='SequentialSampler')
    argv = ['--config_path', TEMPLATE_CONFIG, '--model_dir', model_dir,
            'data.train.type', 'smoke_scenes', 'data.train.params', repr(train),
            'data.test.type', 'smoke_scenes', 'data.test.params', repr(test),
            'train.num_iters', str(num_iters), 'train.save_ckpt_interval_epoch', '1',
            'train.eval_after_train', 'True', 'train.log_interval_step', '2', *opts]
    record = dict(logged=[], evals=[], saves=[])

    def wire(launcher):
        if init_state is not None:
            launcher.set_pretrained_state(init_state)
        train_log, evaluate = launcher.logger.train_log, launcher.evaluate
        save = launcher.checkpoint.save

        def timed_save(filename=None):
            t0 = time.perf_counter()
            save(filename)
            record['saves'].append(time.perf_counter() - t0)

        def logged(step, num_iters, loss_dict, data_time, time_cost, lr):
            record['logged'].append((step, dict(loss_dict), data_time, time_cost))
            return train_log(step, num_iters, loss_dict, data_time, time_cost, lr)

        def evaluated(data_loader, config=None):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            table = evaluate(data_loader, config)
            torch.cuda.synchronize()
            record['evals'].append((table, time.perf_counter() - t0,
                                    [a - b for a, b in zip(counts(), before)],
                                    len(data_loader)))
            return table

        launcher.logger.train_log, launcher.evaluate = logged, evaluated
        launcher.checkpoint.save = timed_save
        if sync_free:
            loop = launcher._train_loop

            def checked_loop(*args, **kwargs):
                torch.cuda.set_sync_debug_mode('error')
                try:
                    return loop(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            launcher._train_loop = checked_loop

    reset_counts()
    out = get_trainer('th_ddp', argv=argv)().run(after_construct_launcher_callbacks=[wire])
    torch.cuda.synchronize()
    record['launches'] = counts()
    return out['launcher'], record


def record_confusion(seen: list):
    """Wrap ``ConfusionMatrix.forward`` to keep, for every batch counted, the
    device it counted on, its matrix and the labels and predictions copied
    to the host; returns the undo."""
    from ever_tpu_torch.metric.confusion_matrix import ConfusionMatrix

    forward = ConfusionMatrix.forward

    def recorded(self, y_true, y_pred):
        cm = forward(self, y_true, y_pred)
        pred = y_pred.argmax(dim=-1) if y_pred.ndim == y_true.ndim + 1 else y_pred
        seen.append((y_pred.device.type, cm, torch.as_tensor(y_true).cpu().numpy(),
                     pred.cpu().numpy()))
        return cm

    ConfusionMatrix.forward = ConfusionMatrix.update = recorded

    def undo():
        ConfusionMatrix.forward = ConfusionMatrix.update = forward
    return undo


def check_run(name: str, launcher, record: dict, steps: int, evals: int) -> None:
    """Finite losses, the step count, the checkpoint index and the exact
    launches of a trainer run: K1 24 a train step and an eval batch, K2 24
    a train step; the evaluation's own share of K1 and no K2."""
    from ever_tpu_torch.core.checkpoint import CheckPoint

    losses = [d['total_loss'] for _, d, _, _ in record['logged']]
    k1, k2 = record['launches'][:2]
    want_k1 = 24 * (steps + evals * record['evals'][-1][3])
    info = CheckPoint.load_checkpoint_info(launcher.model_dir)
    print(f'trainer: {name}: step {launcher.global_step}, logged steps '
          f'{[s for s, _, _, _ in record["logged"]]}, loss {" ".join(f"{v:.5f}" for v in losses)}; '
          f'last checkpoint {info["last"]}; attention_fwd {k1} (expected {want_k1}), '
          f'attention_bwd {k2} (expected {24 * steps}); evaluation launches '
          f'{[e[2][:2] for e in record["evals"]]}', flush=True)
    check(all(math.isfinite(v) for v in losses), f'{name}: non-finite loss')
    check(info['last']['name'] == f'checkpoint-{launcher.global_step}.ckpt'
          and os.path.exists(os.path.join(launcher.model_dir, info['last']['name'])),
          f'{name}: checkpoint_info names no last checkpoint')
    check((k1, k2) == (want_k1, 24 * steps), f'{name}: launches {(k1, k2)}')
    check(len(record['evals']) == evals and all(
        tuple(e[2][:2]) == (24 * e[3], 0) for e in record['evals']),
        f'{name}: evaluation launches')


def phase_trainer(gen, seed: int, bare_ms: float, smi: str) -> None:
    """The config-driven run: train, evaluate, checkpoint, resume and serve
    under d4 TTA the template's DinoSeg ViT-L/16 through the port's
    ``Trainer``."""
    import shutil
    import tempfile

    import numpy as np
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.magic.transform import tta
    from ever_tpu_torch.ops import attention as A

    register_smoke_data()
    init = build_dinoseg(gen)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trainer_') as tmp:
        # a: the run, b: the evaluation's matrix against the host's
        seen = []
        undo = record_confusion(seen)
        try:
            la, ra = trainer_run(os.path.join(tmp, 'a'), TRAINER_ITERS, seed, init_state)
        finally:
            undo()
        check_run('run', la, ra, TRAINER_ITERS, 1)
        table = ra['evals'][0][0]
        print(f'trainer: evaluation of {len(seen)} batches of {EVAL_BATCH} {EVAL_SCENE}² '
              f'scenes after {TRAINER_ITERS} steps:\n{table}', flush=True)
        dumps = sorted(os.listdir(os.path.join(la.model_dir, 'cm')))
        card_cm = np.load(os.path.join(la.model_dir, 'cm', dumps[-1]))
        truth = np.concatenate([y.reshape(-1) for _, _, y, _ in seen])
        pred = np.concatenate([p.reshape(-1) for _, _, _, p in seen])
        valid = truth != 255
        host_cm = np.bincount(truth[valid].astype(np.int64) * CLASSES + pred[valid],
                              minlength=CLASSES * CLASSES).reshape(CLASSES, CLASSES)
        print(f'trainer: confusion matrix counted on {sorted({d for d, _, _, _ in seen})}, '
              f'{int(card_cm.sum())} pixels; equal to np.bincount of the host copies: '
              f'{bool(np.array_equal(card_cm, host_cm))}', flush=True)
        check(len(seen) == 2 and all(d == 'cuda' for d, _, _, _ in seen),
              'the evaluation did not count its matrix on the card')
        check(np.array_equal(card_cm, host_cm) and int(host_cm.sum()) == int(valid.sum()),
              "the card's confusion matrix differs from the host's")
        del la, ra, seen
        torch.cuda.empty_cache()

        # c: resume to 10 steps against a fresh 10-step run
        lb, rb = trainer_run(os.path.join(tmp, 'a'), RESUME_ITERS, seed)
        check_run('resumed run', lb, rb, RESUME_ITERS - TRAINER_ITERS, 1)
        check(rb['logged'][0][0] == TRAINER_ITERS + 2, 'the resumed run did not start at '
              f'step {TRAINER_ITERS}')
        resumed = [p.detach().clone() for p in lb.model.parameters()]
        del lb, rb
        shutil.rmtree(os.path.join(tmp, 'a'))
        torch.cuda.empty_cache()
        lc, rc = trainer_run(os.path.join(tmp, 'c'), RESUME_ITERS, seed, init_state)
        check_run('fresh run', lc, rc, RESUME_ITERS, 1)
        # the train step is deterministic (K1, K2, cuBLAS, and DinoSeg's
        # logits upsampled by matrix products, whose backward adds no atomics)
        # and the batches are seeded by the step: the two runs agree bit for bit
        delta = max(float((a - b.detach()).abs().max())
                    for a, b in zip(resumed, lc.model.parameters()))
        print(f'trainer: {TRAINER_ITERS} steps + resume to {RESUME_ITERS} against '
              f'{RESUME_ITERS} steps at once: max|dp| {delta:.3e} (gate: equal bits)',
              flush=True)
        check(delta == 0.0, 'the resumed run differs from the unbroken run')
        del resumed

        # e: times through the Launcher (with a save every 2 steps, then
        # without), the checkpoint saves, the evaluation and the TTA scene
        def medians(record):
            logged = record['logged'][2:]
            return ([s for s, _, _, _ in logged],
                    sorted(t for _, _, _, t in logged)[len(logged) // 2],
                    sorted(d for _, _, d, _ in logged)[len(logged) // 2])

        steps_c, per_step_c, data_c = medians(rc)
        saves = sorted(rc['saves'])
        size = os.path.getsize(os.path.join(lc.model_dir, f'checkpoint-{RESUME_ITERS}.ckpt'))
        eval_secs = rc['evals'][0][1]
        model = lc.model
        del lc, rc
        shutil.rmtree(os.path.join(tmp, 'c'))
        torch.cuda.empty_cache()
        ld, rd = trainer_run(os.path.join(tmp, 'd'), TIMING_ITERS, seed, init_state,
                             opts=('train.save_ckpt_interval_epoch', '1000',
                                   'train.eval_after_train', 'False'), sync_free=True)
        check(rd['launches'][:2] == (24 * TIMING_ITERS, 24 * TIMING_ITERS)
              and len(rd['saves']) == 1 and not rd['evals'],
              f'timing run: launches {rd["launches"][:2]}, {len(rd["saves"])} saves')
        steps_d, per_step_d, data_d = medians(rd)
        del ld, rd
        torch.cuda.empty_cache()
        print(f'trainer: {smi}: through the Launcher median {per_step_d * 1e3:.2f} ms/step '
              f'over logged steps {steps_d} without periodic checkpoints and without a host sync (loading, '
              f'callbacks and copies {data_d * 1e3:.2f} ms/step of it), against '
              f'{bare_ms:.2f} ms/step for build_train_step alone (train phase); with a '
              f'checkpoint every 2 steps {per_step_c * 1e3:.2f} ms/step over logged steps '
              f'{steps_c} ({data_c * 1e3:.2f} of it loading and callbacks); '
              f'{len(saves)} checkpoint saves of {size / 1e9:.2f} GB, median '
              f'{saves[len(saves) // 2]:.2f} s ({size / 1e9 / saves[len(saves) // 2]:.2f} '
              f'GB/s); evaluation {eval_secs / 4:.3f} s per {EVAL_SCENE}² scene', flush=True)

    # d: the trained model under d4 TTA against per-tile tta() calls
    scene = torch.randn(EVAL_SCENE, EVAL_SCENE, 3, generator=gen, device='cuda')
    sizes = []

    def predict(tiles):
        sizes.append(tiles.shape[0])
        return model(tiles)

    def scene_secs(**kw):
        tiled_inference(model, scene, TILE, TILE, CLASSES, tile_batch=2, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tiled_inference(model, scene, TILE, TILE, CLASSES, tile_batch=2, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    reset_counts()
    got = tiled_inference(predict, scene, TILE, TILE, CLASSES, tile_batch=2, tta='d4')
    torch.cuda.synchronize()
    k1 = A.fused_attention.launches
    want = torch.zeros_like(got)
    d4 = d4_transforms()
    with torch.no_grad():
        for y in range(0, EVAL_SCENE, TILE):
            for x in range(0, EVAL_SCENE, TILE):
                tile = scene[None, y:y + TILE, x:x + TILE]
                want[y:y + TILE, x:x + TILE] = tta(model, tile, d4)[0].float()
    diff = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    n_tiles = (EVAL_SCENE // TILE) ** 2
    print(f'trainer: tiled_inference(tta="d4") of a {EVAL_SCENE}² scene, tile_batch=2: '
          f'model calls of {sizes} tiles, attention_fwd {k1} (expected '
          f'{24 * n_tiles // 2}); against per-tile tta() max|dprob| {diff.max().item():.3e}, '
          f'mean {diff.mean().item():.3e} (limits {TTA_MAX_TOL}, {TTA_MEAN_TOL}), argmax '
          f'agreement {agree:.4f}', flush=True)
    check(sizes == [8 * 2] * (n_tiles // 2) and k1 == 24 * n_tiles // 2,
          f'd4 TTA ran {sizes} tiles a call and {k1} K1 launches')
    check(bool(torch.isfinite(got).all()) and diff.max().item() <= TTA_MAX_TOL
          and diff.mean().item() <= TTA_MEAN_TOL, 'd4 TTA disagrees with per-tile tta()')
    plain, _ = scene_secs()
    d4_secs, _ = scene_secs(tta='d4')
    print(f'trainer: {smi}: the {EVAL_SCENE}² scene at {n_tiles / plain:.1f} tiles/s '
          f'({plain * 1e3:.1f} ms) without TTA, {n_tiles / d4_secs:.1f} tiles/s '
          f'({d4_secs * 1e3:.1f} ms) with tta="d4"', flush=True)
    del model
    torch.cuda.empty_cache()


def check_build_notes() -> None:
    """ptxas's report on every kernel library: each library's most registers
    a thread and its spilled bytes, and no note that a ``wgmma`` was
    serialized (C7510-C7520)."""
    import re
    from ever_tpu_torch.ops import _build

    notes = []
    for name in _build.SOURCES:
        log = _build.build_log(name)
        regs = [int(n) for n in re.findall(r'Used (\d+) registers', log)]
        spills = sum(int(n) for n in re.findall(r'(\d+) bytes spill stores', log))
        notes += [line.strip() for line in log.splitlines() if 'serialized' in line]
        print(f'build: {name}: {len(regs)} kernels, at most {max(regs, default=0)} '
              f'registers a thread, {spills} bytes of spill stores', flush=True)
    for line in notes:
        print(f'build: {line}', flush=True)
    check(not notes, f'ptxas serialized wgmmas: {len(notes)} notes')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='trace one tile batch and one train step of each '
                             'model with torch.profiler')
    parser.add_argument('--seed', type=int, default=0,
                        help="seed of the random weights, inputs and the trainer "
                             "phase's data")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script needs one GPU',
              file=sys.stderr)
        return 1
    from ever_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}; allow_tf32: matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f'build: {", ".join(f"{n} {s:.1f} s" for n, s in secs.items())}; '
          f'total {time.perf_counter() - t0:.1f} s', flush=True)
    check_build_notes()

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    fwd, bwd = phase_kernels(gen)
    pool = phase_maxpool(gen)
    phase_serve(gen, args.profile)
    (fwd['launches'], bwd['launches']), bare_ms = phase_train(gen, args.profile)
    model, pool['launches'] = phase_farseg_train(gen, args.profile)
    phase_farseg_serve(gen, model, args.profile)
    del model
    torch.cuda.empty_cache()
    ln_fwd, ln_bwd = phase_layernorm(gen)
    ln_fwd['launches'], ln_bwd['launches'] = phase_fused_ln(gen, args.profile)
    quant, matmul = phase_quant(gen)
    phase_trainer(gen, args.seed, bare_ms, smi)

    records = [fwd, bwd, pool, ln_fwd, ln_bwd, quant, matmul]
    for kernel in records:
        for key, value in kernel.items():
            check(value is not None and (not isinstance(value, float) or math.isfinite(value)),
                  f'kernel record {kernel["name"]} {key} missing')
    print(json.dumps({'kernels': records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
