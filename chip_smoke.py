#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. build   — compile every CUDA kernel of the path from ``ever_tpu_torch/csrc``
             with ``nvcc``.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes (and, for attention, also at head dim
             128 without RoPE, and from float32 inputs, the type of a
             default DinoSeg), then timed beside its bound and one PyTorch
             library call computing the same function.
3. slice   — DinoSeg ViT-L/16 (``vitl16_sat493m``, 24 blocks, width 1024,
             16 heads) in bf16 with seeded random weights, served through
             ``tiled_inference`` over one 4096² scene (512² tiles, stride
             512, ``tile_batch=8``: 64 tiles, 8 batches).  Every attention
             call (N = 1029 tokens) goes through the kernel: 24 × 8 = 192
             launches per scene.  The output must be finite probabilities,
             and one tile batch through the kernel must match the same batch
             with the kernel swapped for its plain version.
4. report  — a ``{"kernels": [...]}`` line, the card's name and power limit,
             and the result line ``{"ok": true, "device": {...}}``.

``--profile`` adds a ``torch.profiler`` trace of one tile batch to phase 3:
device busy time against wall time, and the kernels that take the most
device time.

It imports nothing of JAX and needs one CUDA card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
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
# one tile batch, kernel path vs plain path, both bf16 through 24 blocks:
# the two attentions round differently in every block
SLICE_MAX_TOL, SLICE_MEAN_TOL = 5e-2, 5e-3


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


def rope_tables(n_tokens: int, device, dtype=torch.bfloat16) -> tuple:
    """The main path's RoPE tables at 512² tiles: the ViT's 32×32 patch
    tables with identity rows for the 5 prefix tokens (cls + 4 storage) and
    for any tail pad rows, in ``dtype`` — as ``SelfAttention`` builds them."""
    from ever_tpu_torch.module.vit import RopePositionEmbedding, token_rope
    sin, cos = RopePositionEmbedding(EMBED, H, rescale_coords=2.0)(
        TILE // 16, TILE // 16, device=device)
    sin, cos = token_rope(sin, cos, prefix=5, tail=n_tokens - 5 - sin.shape[0])
    return sin.to(dtype), cos.to(dtype)


def phase_kernels(gen) -> dict:
    from ever_tpu_torch.ops import attention as A

    dev = torch.device('cuda')
    errs = []
    bf16, f32 = torch.bfloat16, torch.float32
    # (batch, heads, tokens, n_valid, head dim, RoPE, type): the main path's
    # shape, the same with stack padding, ViT-7B's head dim 128 without
    # RoPE, and the main path's shape from float32 inputs
    for b, h, s, n_valid, d, with_rope, dtype in (
            (B, H, S, None, D, True, bf16), (B, H, S + 3, S, D, True, bf16),
            (1, 32, S, S - 100, 128, False, bf16), (B, H, S, None, D, True, f32)):
        qkv = torch.randn(b, s, 3, h, d, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(2)                      # strided views, as in the model
        rope = rope_tables(s, dev, dtype) if with_rope else None
        o, lse = A.fused_attention(q, k, v, n_valid=n_valid, rope=rope)
        torch.cuda.synchronize()
        ro, rlse = A.attention_reference(
            q.float(), k.float(), v.float(), n_valid=n_valid,
            rope=None if rope is None else (rope[0].float(), rope[1].float()),
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

    # timing at the main path's shape: S=1029, no pad, RoPE on
    qkv = torch.randn(B, S, 3, H, D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    rope = rope_tables(S, dev)
    ms = cuda_ms(lambda: A.fused_attention(q, k, v, rope=rope), iters=50)
    # the float32 instance (a default DinoSeg's type), for the record only
    q32, k32, v32 = (t.float() for t in (q, k, v))
    rope32 = rope_tables(S, dev, torch.float32)
    f32_ms = cuda_ms(lambda: A.fused_attention(q32, k32, v32, rope=rope32), iters=50)
    plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, rope=rope), iters=10)
    # yardstick only: one PyTorch call on the same, already rotated, tensors
    qr, kr = A._rope_outside(q, k, rope, 'bnhd')
    qr, kr, vr = (t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr), iters=50)
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4 + 2 * S * D * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f'kernels: attention_fwd {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, '
          f'SDPA {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms '
          f'({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), '
          f'{flops / ms / 1e9:.1f} TFLOP/s; float32 inputs {f32_ms:.4f} ms/launch',
          flush=True)
    return dict(name='attention_fwd', route='cuda',
                source='ever_tpu_torch/csrc/attention_fwd.cu',
                replaces='ever_tpu/ops/attention.py:175', launches=None,
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=library_ms)


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


def profile_batch(model, tiles) -> None:
    """Device time of one tile batch by kernel, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(tiles)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f'profile: one tile batch under the profiler: {wall_ms:.2f} ms wall, '
          f'{busy_ms:.2f} ms of kernels, {len(kernels)} kernel names', flush=True)
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f'profile: {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x '
              f'{e.key[:100]}', flush=True)


def phase_slice(gen, kernel: dict, profile: bool) -> None:
    from ever_tpu_torch import tiled_inference
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.module.vit import SelfAttention
    from ever_tpu_torch.ops import attention as A

    cfg = {'type': 'DinoSeg', 'params': dict(
        backbone=dict(name='vitl16_sat493m'), classes=CLASSES, dtype='bfloat16')}
    t0 = time.perf_counter()
    with torch.device('cuda'):                      # initialise on the card
        model = make_model(cfg)
    seeded_init_(model, gen)
    model.eval()
    scene = torch.randn(SCENE, SCENE, 3, generator=gen, device='cuda')
    torch.cuda.synchronize()
    print(f'slice: DinoSeg vitl16_sat493m bf16, '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, '
          f'built in {time.perf_counter() - t0:.1f} s', flush=True)

    def serve():
        out = tiled_inference(model, scene, TILE, STRIDE, CLASSES,
                              tile_batch=TILE_BATCH)
        torch.cuda.synchronize()
        return out

    serve()                                         # warm-up scene
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention.launches = 0
    t0 = time.perf_counter()
    out = serve()
    secs = time.perf_counter() - t0
    launches = A.fused_attention.launches
    kernel['launches'] = launches
    n_tiles = (SCENE // STRIDE) ** 2
    print(f'slice: {n_tiles} tiles in {secs * 1e3:.1f} ms/scene = '
          f'{n_tiles / secs:.1f} tiles/s; attention_fwd launches {launches} '
          f'(expected {24 * n_tiles // TILE_BATCH}); peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    check(launches == 24 * n_tiles // TILE_BATCH,
          f'attention kernel launched {launches} times, expected 192')
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
    print(f'slice: tile batch of {TILE_BATCH}: {batch_ms:.2f} ms with the kernel, '
          f'{plain_batch_ms:.2f} ms with plain attention; kernel vs plain '
          f'max|dp| {diff.max().item():.3e}, mean|dp| {diff.mean().item():.3e} '
          f'(tolerances {SLICE_MAX_TOL}, {SLICE_MEAN_TOL}), argmax agreement '
          f'{agree:.4f}', flush=True)
    check(diff.max().item() <= SLICE_MAX_TOL and diff.mean().item() <= SLICE_MEAN_TOL,
          'kernel path and plain path disagree on a tile batch')

    # a default DinoSeg is float32: its attention goes through the kernel too
    model.float()
    with torch.no_grad():
        f32_batch_ms = cuda_ms(lambda: model(tiles), iters=3, warmup=1)
        A.fused_attention.launches = 0
        p32 = model(tiles)
        torch.cuda.synchronize()
    launches32 = A.fused_attention.launches
    agree32 = (p32.argmax(-1) == p_kernel.argmax(-1)).float().mean().item()
    print(f'slice: the same tile batch in float32: {f32_batch_ms:.2f} ms, '
          f'attention_fwd launches {launches32} (expected 24), argmax agreement '
          f'with bf16 {agree32:.4f}', flush=True)
    check(launches32 == 24, f'float32 model launched the kernel {launches32} times')
    check(bool(torch.isfinite(p32).all()), 'non-finite float32 probabilities')
    model.to(torch.bfloat16)
    if profile:
        profile_batch(model, tiles)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='trace one tile batch with torch.profiler')
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

    gen = torch.Generator(device='cuda').manual_seed(0)
    kernel = phase_kernels(gen)
    phase_slice(gen, kernel, args.profile)

    for key, value in kernel.items():
        check(value is not None and (not isinstance(value, float) or math.isfinite(value)),
              f'kernel record {key} missing')
    print(json.dumps({'kernels': [kernel]}), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
