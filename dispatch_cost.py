"""Host cost of the port's kernel wrappers, compared across checkouts.

    python3 dispatch_cost.py DIR [DIR ...]

Each DIR is a checkout that holds ``ever_tpu_torch/``.  The script runs each
checkout's package in a process of its own on one CUDA card, in the order
given and then in reverse (A B B A), so that a drift of the host or of the
card over the call falls on every checkout alike.  Kernel libraries built
for the first checkout are copied to the others where their sources hash
alike (``ops._build`` names a library by that hash).

Each run times, on the same seeded inputs:

- ``layer_norm_fwd`` (K4) at [8232, 1024] bf16, and ``layer_norm``, the
  fused-LN module's path, under ``torch.no_grad``;
- ``fused_attention`` (K1) at B=8, N=1029, H=16, D=64 bf16 with RoPE;
- the ResNet stem's max pool (``impl='pallas'``) at [8, 256, 256, 64] bf16
  under ``torch.no_grad``;
- the gradients of ``layer_norm`` (K5) and of that pool (K8), each from a
  kept graph;
- a DinoSeg ViT-L/16 tile batch (8 × 512² × 3, bf16 parameters, seeded
  weights), with the plain LayerNorm and with ``EVER_FUSED_LN=1``.

Beside them, in the same process and alternately, it times the host's
microseconds per call of the K4, K1 and K7 wrappers against their bare
kernel launchers (``_launch_fwd``, ``_launch_mm``), and of the pool through
its gradient-recording op against ``F.max_pool2d``: the wrappers' own
dispatch cost, free of what moves from one process to the next.

For each it prints the milliseconds per call from CUDA events around
back-to-back calls (the host sets that rate when its work per call exceeds
the card's) and the host's microseconds per call (the wall time to issue a
burst of calls after a synchronisation, the card's queue never full), each
the median and the least of nine repeats (the least is the cost with the
fewest interruptions from other work on a shared host), with the card's
name and power limit.  The
whole table is written to ``chiprun_out/dispatch_cost.json``.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPEATS = 9


def smi() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'


def worker() -> dict:
    """One checkout's timings; the package is imported from the working
    directory."""
    import torch
    from ever_tpu_torch.core.builder import make_model
    from ever_tpu_torch.module.ops import max_pool
    import torch.nn.functional as F
    from ever_tpu_torch.ops import _build, attention as A, norm as N, pool as P, quant as Q

    _build.build(['attention_fwd', 'layernorm', 'maxpool_bwd', 'int8_matmul'])
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)

    def event_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_us(fn, iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        return secs / iters * 1e6

    def timed(fn, iters, burst, counter=None):
        before = counter.launches if counter is not None else 0
        fn()
        torch.cuda.synchronize()
        if counter is not None and counter.launches == before:
            raise RuntimeError('the call launched no kernel')
        ms = [event_ms(fn, iters) for _ in range(REPEATS)]
        us = [host_us(fn, burst) for _ in range(REPEATS)]
        return dict(ms=statistics.median(ms), ms_min=min(ms),
                    host_us=statistics.median(us), host_us_min=min(us))

    def extra_host_us(wrapped, direct, counter, burst=50):
        """The wrapper's host µs a call over the bare call it wraps, both
        timed in this process, alternately, REPEATS times: the least of
        each and the median of the paired differences."""
        before = counter.launches if counter is not None else 0
        wrapped()
        torch.cuda.synchronize()
        if counter is not None and counter.launches == before:
            raise RuntimeError('the call launched no kernel')
        pairs = [(host_us(wrapped, burst), host_us(direct, burst)) for _ in range(REPEATS)]
        return dict(wrapper_us=min(a for a, _ in pairs), direct_us=min(b for _, b in pairs),
                    extra_us_median=statistics.median(a - b for a, b in pairs))

    def pool(t):
        return max_pool(t, 3, 2, ((1, 1), (1, 1)), impl='pallas')

    def backward(fn, *inputs):
        leaves = [t.detach().requires_grad_() for t in inputs]
        y = fn(*leaves)
        return lambda: torch.autograd.grad(y, leaves, torch.ones_like(y), retain_graph=True)

    out = {}
    x, w, b = randn(8232, 1024), randn(1024, dtype=torch.float32), randn(1024, dtype=torch.float32)
    with torch.no_grad():
        out['K4 layer_norm_fwd [8232,1024]'] = timed(
            lambda: N.layer_norm_fwd(x, w, b, 1e-6), 400, 50, N.layer_norm_fwd)
        out['K4 layer_norm [8232,1024]'] = timed(
            lambda: N.layer_norm(x, w, b, 1e-6), 400, 50, N.layer_norm_fwd)
        q, k, v = (randn(8, 1029, 16, 64) for _ in range(3))
        sin, cos = randn(1029, 64), randn(1029, 64)
        out['K1 fused_attention B8 N1029 H16 D64'] = timed(
            lambda: A.fused_attention(q, k, v, rope=(sin, cos)), 100, 50, A.fused_attention)
        xp = randn(8, 256, 256, 64)
        out['max_pool pallas [8,256,256,64]'] = timed(lambda: pool(xp), 200, 50)
        xq = torch.randint(-127, 128, (8232, 1024), generator=gen, device='cuda',
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (1024, 1024), generator=gen, device='cuda',
                           dtype=torch.int8)
        one = torch.ones(1, 1, device='cuda')
        dispatch = {
            'K4 layer_norm_fwd over its launcher': extra_host_us(
                lambda: N.layer_norm_fwd(x, w, b, 1e-6), lambda: N._launch_fwd(x, w, b, 1e-6),
                N.layer_norm_fwd),
            'K1 fused_attention over its launcher': extra_host_us(
                lambda: A.fused_attention(q, k, v, rope=(sin, cos)),
                lambda: A._launch_fwd(q, k, v, 'bnhd', None, (sin, cos)), A.fused_attention),
            'K7 int8_matmul_t over its launcher': extra_host_us(
                lambda: Q.int8_matmul_t(xq, one, wq, one), lambda: Q._launch_mm(xq, one, wq, one),
                Q.int8_matmul_t),
        }
    xg = xp.detach().requires_grad_()
    dispatch['max_pool pallas with a gradient over F.max_pool2d'] = extra_host_us(
        lambda: pool(xg), lambda: F.max_pool2d(xg.permute(0, 3, 1, 2), 3, 2, 1), None)
    out['dispatch'] = dispatch
    # the training path: the gradient through the registered backward
    out['K5 layer_norm backward [8232,1024]'] = timed(
        backward(lambda *t: N.layer_norm(*t, 1e-6), x, w, b), 400, 50, N.layer_norm_bwd)
    out['K8 max_pool backward [8,256,256,64]'] = timed(
        backward(pool, xp), 200, 50, P.max_pool_32_bwd)
    with torch.no_grad():
        for fused in ('0', '1'):
            os.environ['EVER_FUSED_LN'] = fused          # read when the model is built
            with torch.device('cuda'):
                model = make_model({'type': 'DinoSeg', 'params': dict(
                    backbone=dict(name='vitl16_sat493m'), classes=7, dtype='bfloat16')})
            for p in model.parameters():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen, device='cuda'))
            model = model.to(bf16).eval()
            tiles = torch.randn(8, 512, 512, 3, generator=gen, device='cuda')
            out[f'DinoSeg tile batch EVER_FUSED_LN={fused}'] = timed(
                lambda: model(tiles), 10, 3, A.fused_attention)
            del model
            torch.cuda.empty_cache()
    return out


def copy_builds(src: str, dst: str) -> None:
    """Kernel libraries built under checkout ``src`` into ``dst``'s build
    directory, where absent: a library's name holds the hash of its
    sources, so ``dst`` loads only what its own sources would build."""
    out = os.path.join(dst, 'ever_tpu_torch', '_build')
    os.makedirs(out, exist_ok=True)
    for path in glob.glob(os.path.join(src, 'ever_tpu_torch', '_build', 'lib*')):
        target = os.path.join(out, os.path.basename(path))
        if not os.path.exists(target):
            shutil.copy2(path, target)


def main() -> int:
    if sys.argv[1:] == ['--worker']:
        print(json.dumps(worker()), flush=True)
        return 0
    trees = [os.path.abspath(d) for d in sys.argv[1:]]
    if not trees or any(not os.path.isdir(os.path.join(d, 'ever_tpu_torch')) for d in trees):
        print(__doc__, file=sys.stderr)
        return 2
    card = smi()
    rows = []
    for i, tree in enumerate(trees + trees[::-1]):
        if i:
            copy_builds(trees[0], tree)
        env = dict(os.environ, PYTHONPATH=tree)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--worker'],
                              cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(dict(tree=tree, run=i, seconds=time.perf_counter() - t0, times=res))
        for name, t in res.pop('dispatch').items():
            print(f'{os.path.basename(tree)} run {i}: {name}: {t["extra_us_median"]:.1f} us/call '
                  f'more host time (least {t["wrapper_us"]:.1f} against {t["direct_us"]:.1f}) '
                  f'({card})', flush=True)
        for name, t in res.items():
            print(f'{os.path.basename(tree)} run {i}: {name}: {t["ms"]:.4f} ms/call (least '
                  f'{t["ms_min"]:.4f}), host {t["host_us"]:.1f} us/call (least '
                  f'{t["host_us_min"]:.1f}) ({card})', flush=True)
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'dispatch_cost.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    print(json.dumps(dict(card=card, runs=len(rows))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
