"""DINOv3-style Vision Transformer and the DinoSeg head (PyTorch port).

Counterpart of ``ever_tpu/module/vit.py``: ``DinoVisionTransformer`` with
axial RoPE (with its train-time coordinate augmentation), storage tokens,
LayerScale, Mlp/SwiGLU FFN, stochastic depth, per-block ``remat`` and
``get_intermediate_layers``; the size ladder ``VIT_SPECS``, the satellite
configs ``SAT_CONFIGS``; ``DinoSeg`` with its eval and train branches;
and ``ViTEncoder``, the trunk's taps as a feature pyramid for FPN-style
heads.
Inputs are NHWC, as in the JAX package.  Parameter names follow the torch
DINOv3 reference (``blocks.{i}.attn.qkv.weight`` …), so ``util.weight_io``
moves weights across.

Precision: explicit casts, no ``torch.autocast``.  Every layer computes in
its input's dtype and casts its own parameters to it (flax ``Dense(dtype=)``
does the same), so the parameters stay float32 while ``DinoSeg`` with
``dtype='bfloat16'`` runs in bf16: it casts its input, ``_tokens`` casts the
cls/storage tokens to the input's dtype, and the residual stream stays bf16
through every block.  A cast of a parameter that already has the compute
dtype is free, so a serving model may hold bf16 parameters
(``model.to(torch.bfloat16)``) and computes the same numbers.

LayerNorm: ``LayerNorm`` (torch's two-pass statistics) by default; with
``EVER_FUSED_LN=1`` set when the model is built, the fused LayerNorm of
``ops/norm.py`` (the JAX kernels' one-pass statistics, K4 and K5 on the
card), with the same parameters.

Randomness in training (RoPE coordinate augmentation, drop-path) comes from
an explicit ``torch.Generator`` passed to ``forward(..., generator=)``, never
from the global one, and is drawn outside the blocks, so that a block
recomputed under ``remat`` sees the same draws.

The trunk's ``forward`` also takes a list of crops (DINOv3's multi-crop
forward: global crops, then local ones, each a batch) and returns a list
of feature dicts; ``DINOHead`` is the DINO projection head over the cls
tokens.  The causal text-attention family (``CausalSelfAttention``,
``CausalSelfAttentionBlock``, ``LinearKMaskedBias``, ``ListForwardMixin``)
is plain PyTorch: the JAX package computes it through XLA's
``dot_product_attention``, no Pallas kernel.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module import loss as L
from ever_tpu_torch.module.ops import _scaled_shape, downsample_bilinear, upsample_bilinear
from ever_tpu_torch.ops.attention import _rotate_half, attention, pad_target
from ever_tpu_torch.ops.norm import FusedLayerNorm
from ever_tpu_torch.parallel import spatial as _spatial
from ever_tpu_torch.parallel.mesh import data_shard

__all__ = ['Linear', 'LayerNorm', 'RopePositionEmbedding', 'RMSNorm',
           'LayerScale', 'Mlp', 'SwiGLUFFN', 'token_rope', 'drop_path', 'drop_path_mask',
           'SelfAttention', 'SelfAttentionBlock', 'PatchEmbed',
           'DinoVisionTransformer', 'DinoSeg', 'VIT_SPECS', 'SAT_CONFIGS',
           'cat_keep_shapes', 'uncat_with_shapes', 'DINOHead', 'ListForwardMixin',
           'LinearKMaskedBias', 'CausalSelfAttention', 'CausalSelfAttentionBlock',
           'ViTEncoder', 'rope_apply', 'rope_rotate_half', 'make_2tuple', 'init_weights_vit']


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype (see the module
    docstring)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that computes in its input's dtype (its statistics in
    float32, as PyTorch's kernels keep them)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def _make_layer_norm(dim: int, eps: float) -> nn.LayerNorm:
    """The ViT's LayerNorm: :class:`LayerNorm`, or with ``EVER_FUSED_LN=1``
    the fused one (:class:`~ever_tpu_torch.ops.norm.FusedLayerNorm`: K4
    forward, K5 backward on the card), as ``ever_tpu/module/vit.py``'s
    ``_make_layer_norm`` picks.  Both hold the same float32 ``weight`` and
    ``bias``.  The JAX module reads the variable each time it is applied;
    the port reads it when the model is built.  Default off, as in the JAX
    package."""
    if os.environ.get('EVER_FUSED_LN', '0') == '1':
        return FusedLayerNorm(dim, eps)
    return LayerNorm(dim, eps)


rope_rotate_half = _rotate_half


def rope_apply(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Token features rotated by the axial position angles (``[N, D]`` sin
    and cos tables): ``x·cos + rotate_half(x)·sin``, what the attention
    kernels apply to q and k."""
    return x * cos + rope_rotate_half(x) * sin


class RopePositionEmbedding(nn.Module):
    """Axial RoPE angle tables ``(sin, cos)``, each ``[H*W, D_head]`` f32.

    The train-time coordinate augmentation (``shift_coords``,
    ``jitter_coords``, ``rescale_coords``) is one :meth:`draw` from a
    generator, passed to ``forward`` as ``shift`` ([2], added), ``jitter``
    ([2], multiplied) and ``rescale`` ([1], multiplied), in that order.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 base: Optional[float] = 100.0,
                 min_period: Optional[float] = None,
                 max_period: Optional[float] = None,
                 normalize_coords: str = 'separate',
                 shift_coords: Optional[float] = None,
                 jitter_coords: Optional[float] = None,
                 rescale_coords: Optional[float] = None):
        super().__init__()
        if embed_dim % (4 * num_heads) != 0:
            raise ValueError('embed_dim must be divisible by 4*num_heads for '
                             'axial RoPE')
        if normalize_coords not in ('min', 'max', 'separate'):
            raise ValueError(f'Unknown normalize_coords: {normalize_coords}')
        self.d_head = embed_dim // num_heads
        self.base = base
        self.min_period = min_period
        self.max_period = max_period
        self.normalize_coords = normalize_coords
        self.shift_coords = shift_coords
        self.jitter_coords = jitter_coords
        self.rescale_coords = rescale_coords

    def periods(self, device=None) -> torch.Tensor:
        n = self.d_head // 4
        if self.base is not None:
            return self.base ** (2 * torch.arange(n, dtype=torch.float32, device=device)
                                 / (self.d_head // 2))
        base = self.max_period / self.min_period
        periods = base ** torch.linspace(0, 1, n, dtype=torch.float32, device=device)
        return periods / base * self.max_period

    @property
    def augments(self) -> bool:
        return any(r is not None for r in (self.shift_coords, self.jitter_coords,
                                           self.rescale_coords))

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One draw of the configured coordinate augmentations, on the
        generator's device: shift ~ U(-s, s), jitter = exp(U(-log j, log j)),
        rescale = exp(U(-log r, log r)), as the JAX package draws them."""
        def uniform(n, bound):
            u = torch.rand(n, generator=generator, device=generator.device)
            return (2 * u - 1) * bound

        aug = {}
        if self.shift_coords is not None:
            aug['shift'] = uniform(2, self.shift_coords)
        if self.jitter_coords is not None:
            aug['jitter'] = torch.exp(uniform(2, math.log(self.jitter_coords)))
        if self.rescale_coords is not None:
            aug['rescale'] = torch.exp(uniform(1, math.log(self.rescale_coords)))
        return aug

    def forward(self, H: int, W: int, device=None,
                shift: Optional[torch.Tensor] = None,
                jitter: Optional[torch.Tensor] = None,
                rescale: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.normalize_coords == 'max':
            denom_h = denom_w = max(H, W)
        elif self.normalize_coords == 'min':
            denom_h = denom_w = min(H, W)
        else:
            denom_h, denom_w = H, W
        ch = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / denom_h
        cw = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / denom_w
        coords = torch.stack(torch.meshgrid(ch, cw, indexing='ij'), dim=-1)
        coords = coords.reshape(H * W, 2) * 2.0 - 1.0
        if shift is not None:
            coords = coords + shift.to(coords.device)[None, :]
        if jitter is not None:
            coords = coords * jitter.to(coords.device)[None, :]
        if rescale is not None:
            coords = coords * rescale.to(coords.device)
        periods = self.periods(device)
        angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
        angles = angles.reshape(H * W, -1).repeat(1, 2)
        return torch.sin(angles), torch.cos(angles)


class RMSNorm(nn.Module):
    """Root-mean-square norm, computed in f32 (reference default eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = float(init_value)
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """fc1 → GELU (tanh approximation, flax's ``nn.gelu`` default) → fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate='tanh'))


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward: ``w3(silu(w1 x) * w2 x)``.  The gate width is
    ``int(hidden * 2/3)`` rounded up to ``align_to`` (the JAX package fuses
    w1/w2 into one ``w12`` matmul; the weight converter splits it)."""

    def __init__(self, dim: int, hidden: int, out: int, align_to: int = 8):
        super().__init__()
        d = int(hidden * 2 / 3)
        gate = d + (-d % align_to)
        self.w1 = Linear(dim, gate)
        self.w2 = Linear(dim, gate)
        self.w3 = Linear(gate, out)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


def token_rope(sin: torch.Tensor, cos: torch.Tensor, prefix: int,
               tail: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Patch RoPE tables ``[HW, D]`` → tables for the whole token stack
    ``[prefix | HW patches | tail pads]``: the prefix (cls + storage) and
    the tail get identity rows (sin=0, cos=1), so those tokens do not
    rotate."""
    d = sin.shape[1]
    return (torch.cat([sin.new_zeros(prefix, d), sin, sin.new_zeros(tail, d)]),
            torch.cat([cos.new_ones(prefix, d), cos, cos.new_ones(tail, d)]))


def drop_path_mask(batch: int, rate: float,
                   generator: torch.Generator) -> torch.Tensor:
    """The [B] keep mask of one residual branch: each sample keeps it with
    probability ``1 - rate`` (a Bernoulli draw, as ``jax.random.bernoulli``),
    drawn from ``generator`` on its device.  Inside a data-parallel step
    over R ranks the draws are those of the global batch of R·B, and rank r
    keeps its slice ``[r·B, (r+1)·B)``: the step then draws what one process
    draws for the global batch.  Under a spatial step every rank holds the
    same B samples (strips of them) and draws the same B."""
    rank, ranks = (0, 1) if _spatial.current() is not None else data_shard()
    u = torch.rand(batch * ranks, generator=generator, device=generator.device)
    return (u < 1.0 - rate)[rank * batch:(rank + 1) * batch]


def drop_path(x: torch.Tensor, rate: float,
              keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample stochastic depth: ``x * keep / (1 - rate)`` with ``keep``
    the [B] 0/1 mask of the samples that keep the branch (None: no drop)."""
    if keep is None or rate == 0.0:
        return x
    mask = keep.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    return x * mask / (1.0 - rate)


class SelfAttention(nn.Module):
    """Fused-QKV multi-head attention with RoPE on the patch tokens.

    q/k/v are strided views of the packed ``[B, N, 3, H, D]`` projection; the
    attention kernel reads them in place.  Under a spatial step the tokens
    are the prefix and this strip's patch rows, and ``rope`` the whole
    tile's patch tables: the queries attend to the whole tile's keys
    (``parallel/spatial.py``, "Attention over strips").
    """

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 proj_bias: bool = True, attn_impl: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim, bias=proj_bias)

    def forward(self, x, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                n_valid: Optional[int] = None):
        return self.proj(self._attend(self.qkv(x), rope, n_valid))

    def _attend(self, qkv, rope, n_valid):
        """The ``num_heads`` heads' attention over a packed ``[B, N, 3·H·D]``
        projection (q, then k, then v, each head by head): ``[B, N, H·D]``."""
        b, n, width = qkv.shape
        h = self.num_heads
        packed = qkv.view(b, n, 3, h, width // (3 * h))
        q, k, v = packed.unbind(2)                                   # [B, N, H, D]
        real = n if n_valid is None else n_valid
        strips = _spatial.current()
        if strips is not None:
            k, v, rope = self._strip_keys(packed, rope, real, n, strips)
            n_valid = None
        elif rope is not None:
            rope = token_rope(*rope, prefix=real - rope[0].shape[0], tail=n - real)
        if rope is not None:
            rope = tuple(t.to(q.dtype) for t in rope)
        out = attention(q, k, v, impl=self.attn_impl, layout='bnhd',
                        n_valid=n_valid, rope=rope)
        return out.reshape(b, n, width // 3)

    @staticmethod
    def _strip_keys(packed, rope, real: int, n: int, strips):
        """Under a spatial step: the whole tile's keys and values ``[B,
        S_kv, H, D]``, the prefix's then every strip's patch rows gathered
        in strip order, and the stacked RoPE tables of this rank's queries
        (its strip's rows of the whole tile's ``rope``) and of the keys."""
        if rope is None:
            raise ValueError('attention under a spatial step needs the RoPE tables of the '
                             'whole tile\'s patch grid, to place each strip\'s tokens')
        patches = rope[0].shape[0] // strips.k          # this strip's patch tokens
        prefix = real - patches
        kv = torch.cat([packed[:, :prefix, 1:],
                        strips.gather_rows(packed[:, prefix:real, 1:])], dim=1)
        rows = slice(strips.s * patches, (strips.s + 1) * patches)
        sin_q, cos_q = token_rope(rope[0][rows], rope[1][rows], prefix=prefix, tail=n - real)
        sin_k, cos_k = token_rope(*rope, prefix=prefix, tail=0)
        k, v = kv.unbind(2)
        return k, v, (torch.cat([sin_q, sin_k]), torch.cat([cos_q, cos_k]))


class SelfAttentionBlock(nn.Module):
    """Pre-norm attention + FFN block with optional LayerScale and
    stochastic depth (``drop_path_rate``; the masks come in as ``drop``)."""

    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 qkv_bias: bool = False, layerscale_init: Optional[float] = None,
                 ffn_layer: str = 'mlp', norm: str = 'ln', norm_eps: float = 1e-6,
                 attn_impl: Optional[str] = None, drop_path_rate: float = 0.0):
        super().__init__()
        hidden = int(dim * ffn_ratio)
        self.drop_path_rate = drop_path_rate
        norm_cls = RMSNorm if norm == 'rms' else _make_layer_norm
        self.norm1 = norm_cls(dim, norm_eps)
        self.attn = SelfAttention(dim, num_heads, qkv_bias, attn_impl=attn_impl)
        self.norm2 = norm_cls(dim, norm_eps)
        if ffn_layer.startswith('swiglu'):
            align = int(ffn_layer[len('swiglu'):] or 8)
            self.mlp = SwiGLUFFN(dim, hidden, dim, align_to=align)
        else:
            self.mlp = Mlp(dim, hidden, dim)
        use_ls = layerscale_init is not None
        self.ls1 = LayerScale(dim, layerscale_init) if use_ls else nn.Identity()
        self.ls2 = LayerScale(dim, layerscale_init) if use_ls else nn.Identity()

    def forward(self, x, rope=None, n_valid: Optional[int] = None,
                drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``drop``: the [B] keep masks of the two residual branches, or
        None (no stochastic depth)."""
        keep1, keep2 = (None, None) if drop is None else drop
        y = self.ls1(self.attn(self.norm1(x), rope, n_valid))
        x = x + drop_path(y, self.drop_path_rate, keep1)
        y = self.ls2(self.mlp(self.norm2(x)))
        return x + drop_path(y, self.drop_path_rate, keep2)


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC image → ``[N, h*w, C]`` tokens and ``(h, w)``,
    in the image's dtype."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        p = self.proj
        y = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype),
                     p.bias.to(x.dtype), stride=p.stride)
        n, c, h, w = y.shape
        return y.flatten(2).transpose(1, 2), (h, w)


# name → (depth, embed_dim, heads, ffn_ratio, ffn_layer)
VIT_SPECS = {
    'vit_small': (12, 384, 6, 4.0, 'mlp'),
    'vit_base': (12, 768, 12, 4.0, 'mlp'),
    'vit_large': (24, 1024, 16, 4.0, 'mlp'),
    'vit_so400m': (27, 1152, 18, 3.7777778, 'swiglu'),
    'vit_huge2': (32, 1280, 20, 4.0, 'swiglu'),
    'vit_giant2': (40, 1536, 24, 4.0, 'swiglu'),
    'vit_7b': (40, 4096, 32, 3.0, 'swiglu'),
}

# satellite-pretrained configurations (LayerNorm eps 1e-5, rope rescale 2)
SAT_CONFIGS = {
    'vitl16_sat493m': dict(vit_type='vit_large', patch_size=16,
                           n_storage_tokens=4, layerscale_init=1e-5,
                           qkv_bias=True, norm_eps=1e-5,
                           pos_embed_rope_rescale_coords=2.0),
    'vit7b16_sat493m': dict(vit_type='vit_7b', patch_size=16,
                            n_storage_tokens=4, layerscale_init=1e-5,
                            qkv_bias=False, ffn_layer='swiglu64', norm_eps=1e-5,
                            drop_path_rate=0.4,
                            untie_global_and_local_cls_norm=True,
                            pos_embed_rope_rescale_coords=2.0),
}


_REMAT_MODES = (None, 'full', 'dots')


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat='dots'``: keep the outputs of
    the 2-d matrix products (the linear layers), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class DinoVisionTransformer(nn.Module):
    """ViT trunk.  ``forward`` returns a dict with ``x_norm_clstoken``,
    ``x_storage_tokens``, ``x_norm_patchtokens`` and the patch ``grid``.

    It computes in its input's dtype.  ``pad_tokens=True`` pads the token
    stack once after the patch embedding to
    :func:`~ever_tpu_torch.ops.attention.pad_target` and threads ``n_valid``
    through every block, as the JAX model does on the TPU.  The CUDA kernels
    mask a ragged length themselves, so the default (None) is off.

    Training follows the ``train`` argument (not ``nn.Module.training``), as
    in the JAX package: with ``train=True`` every block gets freshly drawn
    RoPE coordinate augmentations, when configured, and per-sample
    stochastic depth at the same ``drop_path_rate`` for every block, both
    drawn from ``generator`` outside the blocks.  ``remat`` (None | 'full' |
    'dots') checkpoints each block with ``torch.utils.checkpoint`` when a
    gradient is recorded: 'full' recomputes the whole block in the backward,
    'dots' keeps the outputs of its 2-d matrix products (selective
    checkpointing), the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``.

    Under a spatial step (``parallel/spatial.py``) the input is this rank's
    strip of the tile: the tokens are the prefix and the strip's patch
    rows, the RoPE tables are made for the whole tile's grid, and each
    attention layer gathers the other strips' keys and values.

    ``forward`` of a list (or tuple) of crops returns a list of feature
    dicts, one a crop, with the same parameters.  With
    ``untie_global_and_local_cls_norm`` and ``train``, crop index 1, and
    only that one, normalises its cls and storage tokens with
    ``local_cls_norm`` (the reference's "assume second entry of list
    corresponds to local crops"); every other crop and call takes
    ``cls_norm`` (``untie_cls_and_patch_norms``) or the final ``norm``.
    """

    def __init__(self, vit_type: str = 'vit_large', patch_size: int = 16,
                 n_storage_tokens: int = 4, layerscale_init: Optional[float] = None,
                 drop_path_rate: float = 0.0, qkv_bias: bool = True,
                 ffn_layer: Optional[str] = None, norm_eps: Optional[float] = None,
                 pos_embed_rope_base: float = 100.0,
                 pos_embed_rope_normalize_coords: str = 'separate',
                 pos_embed_rope_shift_coords: Optional[float] = None,
                 pos_embed_rope_jitter_coords: Optional[float] = None,
                 pos_embed_rope_rescale_coords: Optional[float] = None,
                 pos_embed_rope_min_period: Optional[float] = None,
                 pos_embed_rope_max_period: Optional[float] = None,
                 norm: str = 'ln', untie_cls_and_patch_norms: bool = False,
                 untie_global_and_local_cls_norm: bool = False,
                 attn_impl: Optional[str] = None,
                 pad_tokens: Optional[bool] = None,
                 remat: Optional[str] = None, in_chans: int = 3):
        super().__init__()
        if remat not in _REMAT_MODES:
            raise ValueError(f"remat must be None, 'full' or 'dots', got {remat!r}")
        depth, dim, heads, ffn_ratio, spec_ffn = VIT_SPECS[vit_type]
        self.embed_dim, self.num_heads, self.depth = dim, heads, depth
        self.n_storage_tokens = n_storage_tokens
        self.drop_path_rate = drop_path_rate
        self.untie_global_and_local_cls_norm = untie_global_and_local_cls_norm
        self.pad_tokens = pad_tokens
        self.remat = remat
        if norm_eps is None:
            norm_eps = 1e-5 if norm == 'rms' else 1e-6
        self.patch_embed = PatchEmbed(in_chans, dim, patch_size)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        if n_storage_tokens > 0:
            self.storage_tokens = nn.Parameter(
                0.02 * torch.randn(1, n_storage_tokens, dim))
        self.rope_embed = RopePositionEmbedding(
            dim, heads,
            base=None if pos_embed_rope_min_period else pos_embed_rope_base,
            min_period=pos_embed_rope_min_period,
            max_period=pos_embed_rope_max_period,
            normalize_coords=pos_embed_rope_normalize_coords,
            shift_coords=pos_embed_rope_shift_coords,
            jitter_coords=pos_embed_rope_jitter_coords,
            rescale_coords=pos_embed_rope_rescale_coords)
        self.blocks = nn.ModuleList([SelfAttentionBlock(
            dim, heads, ffn_ratio, qkv_bias=qkv_bias,
            layerscale_init=layerscale_init, ffn_layer=ffn_layer or spec_ffn,
            norm=norm, norm_eps=norm_eps, attn_impl=attn_impl,
            drop_path_rate=drop_path_rate)
            for _ in range(depth)])
        norm_cls = RMSNorm if norm == 'rms' else _make_layer_norm
        self.norm = norm_cls(dim, norm_eps)
        self.cls_norm = norm_cls(dim, norm_eps) if untie_cls_and_patch_norms else None
        self.local_cls_norm = (norm_cls(dim, norm_eps) if untie_global_and_local_cls_norm
                               else None)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def _tokens(self, x):
        tokens, (h, w) = self.patch_embed(x)
        n = tokens.shape[0]
        prefix = [self.cls_token.expand(n, -1, -1)]
        if self.n_storage_tokens > 0:
            prefix.append(self.storage_tokens.expand(n, -1, -1))
        return torch.cat([t.to(x.dtype) for t in prefix] + [tokens], dim=1), (h, w)

    def _stack_pad(self, tokens):
        """Stack-level token padding (see ``pad_tokens``): ``(tokens,
        n_valid)``, where ``n_valid=None`` means unpadded."""
        n = tokens.shape[1]
        target = pad_target(n)
        if not self.pad_tokens or target == n:
            return tokens, None
        return F.pad(tokens, (0, 0, 0, target - n)), n

    def _block(self, blk, tokens, rope, n_valid, drop):
        if self.remat is None or not torch.is_grad_enabled():
            return blk(tokens, rope, n_valid, drop)
        context = _ckpt.noop_context_fn
        if self.remat == 'dots':
            context = functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _save_matmuls)
        return _ckpt.checkpoint(_spatial.recomputable(blk), tokens, rope, n_valid, drop,
                                use_reentrant=False, context_fn=context)

    def _run_blocks(self, x, keep, train: bool = False,
                    generator: Optional[torch.Generator] = None):
        """Tokens through every block: the outputs of the blocks in ``keep``
        and the patch grid ``(h, w)``."""
        tokens, hw = self._tokens(x)
        tokens, n_valid = self._stack_pad(tokens)
        augs = train and self.rope_embed.augments
        drops = train and self.drop_path_rate > 0
        if (augs or drops) and generator is None:
            raise ValueError('training with RoPE augmentation or drop-path '
                             'draws from a generator: pass generator=')
        # the tables cover the whole tile's patch grid: under a spatial step
        # hw is this strip's rows of it
        strips = _spatial.current()
        grid = hw if strips is None else (hw[0] * strips.k, hw[1])
        rope = None if augs else self.rope_embed(*grid, device=tokens.device)
        outs = []
        for i, blk in enumerate(self.blocks):
            if augs:
                rope = self.rope_embed(*grid, device=tokens.device,
                                       **self.rope_embed.draw(generator))
            drop = None
            if drops:
                drop = tuple(drop_path_mask(tokens.shape[0], self.drop_path_rate,
                                            generator) for _ in range(2))
            tokens = self._block(blk, tokens, rope, n_valid, drop)
            if i in keep:
                outs.append(tokens)
        return outs, hw

    def _norm_prefix_patches(self, t, hw, local_crop: bool = False):
        n_prefix = 1 + self.n_storage_tokens
        h, w = hw
        prefix_norm = self.cls_norm
        if local_crop and self.local_cls_norm is not None:
            prefix_norm = self.local_cls_norm
        if prefix_norm is not None:
            return (prefix_norm(t[:, :n_prefix]),
                    self.norm(t[:, n_prefix:n_prefix + h * w]))
        normed = self.norm(t)
        return normed[:, :n_prefix], normed[:, n_prefix:n_prefix + h * w]

    def forward_features(self, x, train: bool = False,
                         generator: Optional[torch.Generator] = None,
                         local_crop: bool = False):
        """The last block's tokens normalised: a dict of
        ``x_norm_clstoken``, ``x_storage_tokens``, ``x_norm_patchtokens``
        and the patch ``grid``.  ``local_crop`` (in training) takes
        ``local_cls_norm`` for the cls and storage tokens, where the model
        has one."""
        (tokens,), hw = self._run_blocks(x, {self.depth - 1}, train, generator)
        cls_and_storage, patches = self._norm_prefix_patches(tokens, hw, local_crop and train)
        return dict(x_norm_clstoken=cls_and_storage[:, 0],
                    x_storage_tokens=cls_and_storage[:, 1:],
                    x_norm_patchtokens=patches, grid=hw)

    def get_intermediate_layers(self, x, n: Union[int, Sequence[int]] = 1,
                                reshape: bool = False,
                                return_class_token: bool = False,
                                norm: bool = True, train: bool = False,
                                generator: Optional[torch.Generator] = None):
        """Dense features of the last ``n`` blocks (or the listed blocks)."""
        idxs = (set(range(self.depth - n, self.depth)) if isinstance(n, int)
                else set(i % self.depth for i in n))
        outs, (h, w) = self._run_blocks(x, idxs, train, generator)
        n_prefix = 1 + self.n_storage_tokens
        results = []
        for t in outs:
            if norm:
                cls_and_storage, patches = self._norm_prefix_patches(t, (h, w))
                cls = cls_and_storage[:, 0]
            else:
                patches, cls = t[:, n_prefix:n_prefix + h * w], t[:, 0]
            if reshape:
                patches = patches.reshape(patches.shape[0], h, w, self.embed_dim)
            results.append((patches, cls) if return_class_token else patches)
        return results

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            return [self.forward_features(xi, train, generator, local_crop=i == 1)
                    for i, xi in enumerate(x)]
        return self.forward_features(x, train, generator)


def make_2tuple(x):
    """``(x, x)``, or a pair as it is."""
    if isinstance(x, tuple):
        assert len(x) == 2
        return x
    return (x, x)


def init_weights_vit(module: nn.Module, name: str = '') -> None:
    """The trunk's initialisation of one module, in place (the reference's
    spelling, applied over a tree by ``dinov3.utils.named_apply``): a
    Linear's weight truncated normal with std 0.02 and its bias 0; a
    LayerNorm, RMSNorm or LayerScale back to its initial values."""
    if isinstance(module, nn.Linear):
        nn.init.trunc_normal_(module.weight, std=0.02)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    elif isinstance(module, nn.LayerNorm):
        module.reset_parameters()
    elif isinstance(module, RMSNorm):
        nn.init.ones_(module.weight)
    elif isinstance(module, LayerScale):
        module.gamma.data.fill_(module.init_value)


def cat_keep_shapes(x_list):
    """``[B, N_i, D]`` token tensors flattened into one ``[ΣB·N_i, D]``,
    with what :func:`uncat_with_shapes` needs to split it back: one call of
    a token-wise module serves crops of several sizes."""
    shapes = [x.shape for x in x_list]
    num_tokens = [math.prod(s[:-1]) for s in shapes]
    flat = torch.cat([x.reshape(-1, x.shape[-1]) for x in x_list], dim=0)
    return flat, shapes, num_tokens


def uncat_with_shapes(flat, shapes, num_tokens):
    """The inverse of :func:`cat_keep_shapes` (the last axis may have
    changed width)."""
    return [part.reshape(*s[:-1], flat.shape[-1])
            for part, s in zip(torch.split(flat, list(num_tokens)), shapes)]


class DINOHead(nn.Module):
    """The DINO projection head: an MLP (``mlp0`` .. ``mlp{n-2}``, each
    followed by tanh GELU) to ``bottleneck_dim`` (``mlp{n-1}``), the rows
    L2-normalised (norm in float32, floored at 1e-6), then the
    weight-normalised prototypes: ``prototypes`` is a ``[bottleneck_dim,
    out_dim]`` matrix whose columns are normalised (floor 1e-6) when
    applied, as the JAX package's ``DINOHead`` holds them."""

    def __init__(self, in_dim: int, out_dim: int = 65536, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [bottleneck_dim]
        for i in range(n_layers):
            self.add_module(f'mlp{i}', Linear(dims[i], dims[i + 1]))
        self.prototypes = nn.Parameter(0.02 * torch.randn(bottleneck_dim, out_dim))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f'mlp{i}')(x)
            if i < self.n_layers - 1:
                x = F.gelu(x, approximate='tanh')
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        x = x / norm.clamp(min=1e-6).to(x.dtype)
        w = self.prototypes
        w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp(min=1e-6)
        return x @ w.to(x.dtype)


class ListForwardMixin:
    """Runs a token-wise module over a list of ``[B, N_i, C]`` tensors as
    one call on their concatenation (:func:`cat_keep_shapes`)."""

    def forward_list(self, x_list):
        flat, shapes, num_tokens = cat_keep_shapes(x_list)
        return uncat_with_shapes(self(flat), shapes, num_tokens)


class LinearKMaskedBias(Linear):
    """The fused-QKV projection whose bias is multiplied by the buffer
    ``bias_mask`` (ones, zeros over the K third): a K bias only shifts
    every logit of a softmax row equally.  The mask is a buffer, so a
    checkpoint may override it."""

    def __init__(self, in_features: int, out_features: int):
        if out_features % 3:
            raise ValueError(f'out_features must be a multiple of 3, got {out_features}')
        super().__init__(in_features, out_features)
        nn.init.zeros_(self.bias)
        mask = torch.ones(out_features)
        mask[out_features // 3:2 * out_features // 3] = 0.0
        self.register_buffer('bias_mask', mask)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), (self.bias * self.bias_mask).to(x.dtype))


class CausalSelfAttention(nn.Module):
    """Multi-head attention with a fused QKV projection and a causal mask
    (``is_causal``), by PyTorch's ``scaled_dot_product_attention`` (the JAX
    package's is ``jax.nn.dot_product_attention``, a library call).

    Under a spatial step x ``[B, n, C]`` is this rank's strip of the tile's
    token sequence in row-major order, tokens ``[s·n, (s+1)·n)``: every
    strip's keys and values are gathered in strip order
    (``Strips.gather_rows``; backward, each strip gets the sum over the
    axis of its rows' gradients), and query i attends to key j where ``j ≤
    s·n + i``, an explicit mask (``is_causal`` aligns the first query with
    the first key)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 proj_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim, bias=proj_bias)

    def forward(self, x, is_causal: bool = True):
        b, n, c = x.shape
        h = self.num_heads
        packed = self.qkv(x).view(b, n, 3, h, c // h)
        strips = _spatial.current()
        if strips is None:
            q, k, v = packed.permute(2, 0, 3, 1, 4)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=is_causal)
        else:
            q = packed[:, :, 0].transpose(1, 2)
            k, v = strips.gather_rows(packed[:, :, 1:]).permute(2, 0, 3, 1, 4)
            mask = None
            if is_causal:
                rows = torch.arange(n, device=x.device)[:, None] + strips.s * n
                mask = torch.arange(k.shape[2], device=x.device)[None] <= rows
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CausalSelfAttentionBlock(nn.Module):
    """Pre-norm causal attention + MLP block (``attention_norm``,
    ``attention``, ``ffn_norm``, ``feed_forward``), with LayerScale when
    ``ls_init_value`` is set."""

    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, is_causal: bool = True,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.is_causal = is_causal
        self.attention_norm = LayerNorm(dim, norm_eps)
        self.attention = CausalSelfAttention(dim, num_heads)
        self.ffn_norm = LayerNorm(dim, norm_eps)
        self.feed_forward = Mlp(dim, int(dim * ffn_ratio), dim)
        use_ls = bool(ls_init_value)
        self.ls1 = LayerScale(dim, ls_init_value) if use_ls else nn.Identity()
        self.ls2 = LayerScale(dim, ls_init_value) if use_ls else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attention(self.attention_norm(x), self.is_causal))
        return x + self.ls2(self.feed_forward(self.ffn_norm(x)))


for _name in VIT_SPECS:
    registry.MODEL.register(
        _name, (lambda n: lambda **kw: DinoVisionTransformer(vit_type=n, **kw))(_name))
for _name, _cfg in SAT_CONFIGS.items():
    registry.MODEL.register(
        _name, (lambda c: lambda **kw: DinoVisionTransformer(**{**c, **kw}))(_cfg))


@registry.MODEL.register()
class DinoSeg(ERModule):
    """DINOv3 dense segmentation: ViT trunk + light 1x1 head + bilinear
    upsample to the input resolution.

    ``forward(x, y=None, train=False, generator=None)`` takes NHWC
    ``[B, H, W, C]`` and computes in ``config.dtype`` (the parameters stay
    float32 unless the caller casts them).  With ``train=True`` and labels
    ``y`` ``[B, H, W]`` it returns the loss dict: ``cls_loss`` (softmax
    cross-entropy) and, when ``loss.dice`` is configured, ``dice_loss``;
    otherwise the class probabilities ``[B, H, W, classes]`` in f32.  The
    logits are upsampled in f32.  ``generator`` feeds the trunk's train-time
    draws.
    """

    def set_default_config(self):
        self.config.update(dict(
            backbone=dict(
                name='vitl16_sat493m',   # SAT_CONFIGS key or VIT_SPECS key
                drop_path_rate=0.0,
                attn_impl=None,          # None=auto | 'xla' | 'fused' | 'flash'
                remat=None,              # None | 'full' | 'dots' (per block)
            ),
            classes=7,
            head=dict(hidden=0, n_taps=1),
            loss=dict(ignore_index=255, ce=dict(), dice=None),
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        bcfg = dict(self.config.backbone)
        name = bcfg.pop('name', 'vitl16_sat493m')
        bcfg.pop('pretrained', None)
        kwargs = dict(SAT_CONFIGS.get(name, {}))
        if not kwargs:
            if name not in VIT_SPECS:
                raise ValueError(f'unknown ViT backbone {name!r}; expected one '
                                 f'of {sorted(VIT_SPECS)} or {sorted(SAT_CONFIGS)}')
            kwargs['vit_type'] = name
        kwargs.update(bcfg)
        self.vit = DinoVisionTransformer(**kwargs)
        n_taps = int(self.config.head.get('n_taps', 1))
        feat = self.vit.embed_dim * n_taps
        hidden = int(self.config.head.get('hidden', 0))
        self.head_hidden = Linear(feat, hidden) if hidden else None
        self.head_classifier = Linear(hidden or feat, int(self.config.classes))

    def forward(self, x, y=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        n_taps = int(self.config.head.get('n_taps', 1))
        taps = self.vit.get_intermediate_layers(
            x.to(getattr(torch, self.config.dtype)), n=n_taps, reshape=True,
            train=train, generator=generator)
        feat = taps[0] if n_taps == 1 else torch.cat(taps, dim=-1)
        if self.head_hidden is not None:
            feat = F.gelu(self.head_hidden(feat), approximate='tanh')
        logits = self.head_classifier(feat).float()
        scale = x.shape[1] / logits.shape[1]
        logits = upsample_bilinear(logits, (int(logits.shape[1] * scale),
                                            int(logits.shape[2] * scale)))
        if train and y is not None:
            lcfg = self.config.loss
            ignore = int(lcfg.get('ignore_index', 255))
            out = dict(cls_loss=L.softmax_ce_loss_with_logits(
                logits, y, ignore_index=ignore))
            if lcfg.get('dice'):
                out['dice_loss'] = L.dice_loss_with_logits(
                    logits, y, ignore_index=ignore, **dict(lcfg.dice))
            return out
        return torch.softmax(logits, dim=-1)


@registry.MODEL.register()
class ViTEncoder(ERModule):
    """The ViT trunk as a multi-scale encoder for FPN-style heads
    (``ever_tpu/module/vit.py`` ``ViTEncoder``, the same config keys).

    ``forward(x, train=False, generator=None)`` takes NHWC ``[B, H, W, 3]``,
    computes in ``config.dtype`` and returns the normalised patch tokens of
    the blocks in ``out_indices`` (by default the last of each quarter of
    the depth) as NCHW features on the patch grid, as the port's other
    encoders return theirs.  With ``pyramid`` (the default) exactly four
    taps are resized by 4, 2, 1 and 0.5 to output strides 4, 8, 16 and 32
    of a patch-16 trunk: the two upsamplings by :func:`upsample_bilinear`
    and the halving by :func:`downsample_bilinear` (``jax.image.resize``'s
    antialiased weights), all as matrix products, so a train step's
    gradients are the same bits every run.  They compute in float32 unless
    the taps are bfloat16, as the JAX package's ``resize``.  Under a
    spatial step each tap is the strip's patch rows and each resize its
    strip form (``module/ops.py`` ``_strip_resize``).
    """

    def set_default_config(self):
        self.config.update(dict(
            vit_type='vit_large',
            patch_size=16,
            n_storage_tokens=4,
            drop_path_rate=0.0,
            out_indices=None,         # default: the last block of each quarter
            pyramid=True,             # resize the taps to os4/8/16/32
            attn_impl=None,           # None=auto | 'xla' | 'fused' | 'flash'
            remat=None,               # None | 'full' | 'dots' (per block)
            dtype='float32',
        ))

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        c = self.config
        self.vit = DinoVisionTransformer(
            vit_type=c.vit_type, patch_size=c.patch_size, n_storage_tokens=c.n_storage_tokens,
            drop_path_rate=c.drop_path_rate, attn_impl=c.attn_impl, remat=c.get('remat'))

    def out_indices(self):
        depth = self.vit.depth
        return list(self.config.out_indices or
                    [depth // 4 - 1, depth // 2 - 1, 3 * depth // 4 - 1, depth - 1])

    def out_channels(self) -> Tuple[int, ...]:
        return (self.vit.embed_dim,) * len(self.out_indices())

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        indices = self.out_indices()
        taps = self.vit.get_intermediate_layers(
            x.to(getattr(torch, self.config.dtype)), n=indices, reshape=True, train=train,
            generator=generator)
        if not self.config.pyramid:
            return [t.permute(0, 3, 1, 2) for t in taps]
        scales = (4.0, 2.0, 1.0, 0.5)
        if len(taps) != len(scales):
            raise ValueError(
                f'pyramid=True expects exactly {len(scales)} out_indices (os4/os8/os16/os32 '
                f'levels), got {len(taps)} ({indices}); set pyramid=False for a flat tap list')
        out = []
        for t, s in zip(taps, scales):
            shape = _scaled_shape(t.shape[1], t.shape[2], s, 'ViTEncoder\'s pyramid')
            if s > 1:
                t = upsample_bilinear(t if t.dtype == torch.bfloat16 else t.float(),
                                      shape).to(t.dtype)
            elif s < 1:
                t = downsample_bilinear(t, shape)
            out.append(t.permute(0, 3, 1, 2))
        return out
