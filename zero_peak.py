"""Peak memory of the ZeRO-3 step, compared across checkouts.

    python3 zero_peak.py DIR [DIR ...]

Each DIR is a checkout that holds ``ever_tpu_torch/`` and ``chip_smoke.py``.
For each, in the order given, two gloo ranks share one CUDA card and train
``chip_smoke.zero_state``'s model, DinoSeg ViT-L/16 (bf16 compute, float32
parameters, AdamW), replicated under DDP and at ZeRO-3, 3 steps each on 4
tiles of 512² a rank: the phase ``zero`` of that checkout's
``chip_smoke.py`` without its checkpoints.  Each rank reports, for the last
step, ``torch.cuda.max_memory_allocated`` above what it holds at rest
before that step (a count of bytes, which no drift of the host moves), and
each step's milliseconds.  The kernels are built in each checkout before
its ranks start.  Each rank's line is printed with the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

STEPS = 3


def rank_main(tree: str, rank: int, init: str, out: str) -> None:
    """One rank: both layouts of ``tree``'s phase ``zero``, its peaks."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from ever_tpu_torch.core import dist
    from ever_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_dist_env(init, 2, rank, backend='gloo')
    mesh = make_mesh()
    gen = torch.Generator(device='cuda').manual_seed(18)
    x = torch.randn(cs.ZERO_BATCH, cs.TILE, cs.TILE, 3, generator=gen, device='cuda')
    y = torch.randint(0, cs.CLASSES, (cs.ZERO_BATCH, cs.TILE, cs.TILE), generator=gen,
                      device='cuda')
    rows = slice(rank * cs.ZERO_BATCH // 2, (rank + 1) * cs.ZERO_BATCH // 2)
    res = {}
    for level in (0, 3):
        state, step, _ = cs.zero_state(0, level, mesh)
        ms = []
        for i in range(STEPS):
            torch.cuda.synchronize()
            if i == STEPS - 1:
                rest = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, _ = step(state, (x[rows], y[rows]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[level] = dict(rest=rest, peak=torch.cuda.max_memory_allocated() - rest, ms=ms)
        del state, step
        torch.cuda.empty_cache()
    with open(os.path.join(out, f'rank{rank}.json'), 'w') as f:
        json.dump(res, f)


def run_tree(tree: str) -> list:
    """Both ranks of ``tree``; their results."""
    subprocess.run([sys.executable, '-c', 'from ever_tpu_torch.ops import _build; '
                    "_build.build(['attention_fwd', 'attention_bwd'])"], cwd=tree, check=True)
    with tempfile.TemporaryDirectory(prefix='zero_peak_') as out:
        init = f'file://{out}/rendezvous'
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--rank', tree,
                                   str(r), init, out], cwd=tree) for r in range(2)]
        try:
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            raise RuntimeError(f'zero_peak: a rank of {tree} exited {codes}')
        results = []
        for r in range(2):
            with open(os.path.join(out, f'rank{r}.json')) as f:
                results.append(json.load(f))
        return results


def main(argv) -> int:
    if argv[:1] == ['--rank']:
        rank_main(argv[1], int(argv[2]), argv[3], argv[4])
        return 0
    import torch
    if not argv or not torch.cuda.is_available():
        print('zero_peak: needs one GPU and at least one checkout', file=sys.stderr)
        return 1
    trees = [os.path.abspath(t) for t in argv]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    for tree in trees:
        for r, res in enumerate(run_tree(tree)):
            for level, got in res.items():
                name = 'ZeRO-3' if level == '3' else 'replicated (DDP)'
                print(f'zero_peak: {smi}: {tree}: rank {r}: {name}: step {STEPS} peak '
                      f'{got["peak"] / 2**30:.3f} GiB above {got["rest"] / 2**30:.3f} GiB at '
                      f'rest; ms/step {" ".join(f"{t:.1f}" for t in got["ms"])}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
