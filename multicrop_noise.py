"""How far apart two bf16 attention paths leave DINOv3's multi-crop gradients.

``chip_smoke.py`` phase 12 (f) holds the gradients of a multi-crop forward
and backward through the attention kernels K1/K2 against the same pass
with plain attention (``attn_impl='xla'``), both in bf16.  This script
repeats that pass on several draws of weights and crops and holds both
bf16 paths against plain attention in float32 (TF32 off), so that the
distance between the two bf16 paths can be read against bf16's own
rounding of the model.  For each draw it prints ``||dg||/||g||`` and the
worst per-tensor cosine of K1/K2 against plain bf16, of K1/K2 against
float32 and of plain bf16 against float32, and phase 12 (f)'s gate on
them: K1/K2's distance from float32 and its worst per-tensor 1 - cosine,
each over the plain bf16 path's (at most ``chip_smoke.MULTICROP_REL_RATIO``),
and K1/K2's worst cosine against float32 (at least
``chip_smoke.MULTICROP_COS_FLOOR``).  It exits 1 when a draw fails the
gate.

Run from the repository root on one GPU (it builds K1 and K2 first):

    python3 multicrop_noise.py [--draws 5] [--seed 1000]
"""

import argparse
import subprocess
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--draws', type=int, default=5)
    ap.add_argument('--seed', type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('multicrop_noise: no CUDA device; this script needs one GPU', file=sys.stderr)
        return 1

    import chip_smoke as cs
    from ever_tpu_torch.module.vit import SAT_CONFIGS, DINOHead, DinoVisionTransformer
    from ever_tpu_torch.ops import _build

    _build.build(['attention_fwd', 'attention_bwd'])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for draw in range(args.draws):
        gen = torch.Generator(device='cuda').manual_seed(args.seed + draw)
        with torch.device('cuda'):
            vit = DinoVisionTransformer(**{**SAT_CONFIGS['vitl16_sat493m'],
                                           'untie_global_and_local_cls_norm': True})
            head = DINOHead(vit.embed_dim, **cs.DINO_HEAD)
        cs.seeded_init_(vit, gen)
        cs.seeded_init_(head, gen)
        net = torch.nn.ModuleDict(dict(vit=vit, head=head))
        crops = [torch.randn(cs.GLOBAL_CROPS, cs.TILE, cs.TILE, 3, generator=gen,
                             device='cuda').bfloat16(),
                 torch.randn(cs.LOCAL_CROPS, cs.LOCAL_SIZE, cs.LOCAL_SIZE, 3, generator=gen,
                             device='cuda').bfloat16()]

        def grads(impl, dtype):
            """Phase 12 (f)'s sum loss over both crops' DINOHead outputs,
            with ``impl`` in every block and the crops in ``dtype``."""
            for blk in vit.blocks:
                blk.attn.attn_impl = impl
            net.zero_grad(set_to_none=True)
            outs = net['vit']([c.to(dtype) for c in crops], train=True,
                              generator=torch.Generator(device='cuda').manual_seed(3))
            sum(net['head'](outs[i]['x_norm_clstoken']).float().sum() for i in (0, 1)).backward()
            out = {n: p.grad.detach().float().clone() for n, p in net.named_parameters()
                   if p.grad is not None}
            net.zero_grad(set_to_none=True)
            return out

        kernel, plain, f32 = (grads(None, torch.bfloat16), grads('xla', torch.bfloat16),
                              grads('xla', torch.float32))
        names = sorted(f32)

        def distance(got, want):
            rel, worst, cos = cs.compare_grads([got[n] for n in names], [want[n] for n in names])
            return rel, worst, f'{rel:.3e} (worst cosine {worst:.7f}, {names[cos.index(worst)]})'

        k_rel, k_cos, k_text = distance(kernel, f32)
        p_rel, p_cos, p_text = distance(plain, f32)
        ratio, cos_ratio = k_rel / p_rel, (1 - k_cos) / max(1 - p_cos, 1e-12)
        held = (ratio <= cs.MULTICROP_REL_RATIO and cos_ratio <= cs.MULTICROP_REL_RATIO
                and k_cos >= cs.MULTICROP_COS_FLOOR)
        failed += not held
        print(f'multicrop_noise: draw {draw} (seed {args.seed + draw}): K1/K2 vs plain bf16 '
              f'{distance(kernel, plain)[2]}; K1/K2 vs float32 {k_text}; plain bf16 vs '
              f'float32 {p_text}; gate: ratio {ratio:.4f}, 1 - cosine ratio {cos_ratio:.4f} '
              f'(limits {cs.MULTICROP_REL_RATIO}), K1/K2 worst cosine {k_cos:.7f} (floor '
              f'{cs.MULTICROP_COS_FLOOR}): '
              f'{"held" if held else "FAILED"}', flush=True)
        del vit, head, net, kernel, plain, f32
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
