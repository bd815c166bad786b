"""DINOv3-style Vision Transformer and the DinoSeg head (PyTorch port).

Counterpart of ``ever_tpu/module/vit.py``: ``DinoVisionTransformer`` with
axial RoPE, storage tokens, LayerScale, Mlp/SwiGLU FFN and
``get_intermediate_layers``; the size ladder ``VIT_SPECS``, the satellite
configs ``SAT_CONFIGS``; and ``DinoSeg``'s inference path.  Inputs are NHWC,
as in the JAX package.  Parameter names follow the torch DINOv3 reference
(``blocks.{i}.attn.qkv.weight`` …), so ``util.weight_io`` moves weights
across.

Not ported yet (the ViT training slice): the training branch of DinoSeg and
its losses, drop-path in training, RoPE coordinate augmentation, ``remat``,
and the causal text-attention family.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.core import registry
from ever_tpu_torch.interface.module import ERModule
from ever_tpu_torch.module.ops import resize
from ever_tpu_torch.ops.attention import attention, pad_target

__all__ = ['RopePositionEmbedding', 'RMSNorm', 'LayerScale', 'Mlp',
           'SwiGLUFFN', 'token_rope', 'SelfAttention', 'SelfAttentionBlock', 'PatchEmbed',
           'DinoVisionTransformer', 'DinoSeg', 'VIT_SPECS', 'SAT_CONFIGS']


class RopePositionEmbedding(nn.Module):
    """Axial RoPE angle tables ``(sin, cos)``, each ``[H*W, D_head]`` f32.

    Inference only: the train-time coordinate augmentations (shift, jitter,
    rescale) are kept as configuration for the training slice.
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

    def forward(self, H: int, W: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
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
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """fc1 → GELU (tanh approximation, flax's ``nn.gelu`` default) → fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

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
        self.w1 = nn.Linear(dim, gate)
        self.w2 = nn.Linear(dim, gate)
        self.w3 = nn.Linear(gate, out)

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


class SelfAttention(nn.Module):
    """Fused-QKV multi-head attention with RoPE on the patch tokens.

    q/k/v are strided views of the packed ``[B, N, 3, H, D]`` projection; the
    attention kernel reads them in place.
    """

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 proj_bias: bool = True, attn_impl: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)

    def forward(self, x, rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                n_valid: Optional[int] = None):
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(b, n, 3, h, c // h).unbind(2)   # [B, N, H, D]
        rope2d = None
        if rope is not None:
            real = n if n_valid is None else n_valid
            sin, cos = token_rope(*rope, prefix=real - rope[0].shape[0], tail=n - real)
            rope2d = (sin.to(q.dtype), cos.to(q.dtype))
        out = attention(q, k, v, impl=self.attn_impl, layout='bnhd',
                        n_valid=n_valid, rope=rope2d)
        return self.proj(out.reshape(b, n, c))


class SelfAttentionBlock(nn.Module):
    """Pre-norm attention + FFN block with optional LayerScale."""

    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 qkv_bias: bool = False, layerscale_init: Optional[float] = None,
                 ffn_layer: str = 'mlp', norm: str = 'ln', norm_eps: float = 1e-6,
                 attn_impl: Optional[str] = None):
        super().__init__()
        hidden = int(dim * ffn_ratio)
        norm_cls = RMSNorm if norm == 'rms' else nn.LayerNorm
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

    def forward(self, x, rope=None, n_valid: Optional[int] = None):
        x = x + self.ls1(self.attn(self.norm1(x), rope, n_valid))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC image → ``[N, h*w, C]`` tokens and ``(h, w)``."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        y = self.proj(x.permute(0, 3, 1, 2))
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


class DinoVisionTransformer(nn.Module):
    """ViT trunk.  ``forward`` returns a dict with ``x_norm_clstoken``,
    ``x_storage_tokens``, ``x_norm_patchtokens`` and the patch ``grid``.

    ``pad_tokens=True`` pads the token stack once after the patch embedding
    to :func:`~ever_tpu_torch.ops.attention.pad_target` and threads
    ``n_valid`` through every block, as the JAX model does on the TPU.  The
    CUDA kernel masks a ragged length itself, so the default (None) is off.
    ``drop_path_rate`` and ``untie_global_and_local_cls_norm`` only act in
    training, which this port does not run yet.
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
        if remat is not None:
            raise NotImplementedError('remat arrives with the ViT training slice')
        depth, dim, heads, ffn_ratio, spec_ffn = VIT_SPECS[vit_type]
        self.embed_dim, self.num_heads, self.depth = dim, heads, depth
        self.n_storage_tokens = n_storage_tokens
        self.drop_path_rate = drop_path_rate
        self.untie_global_and_local_cls_norm = untie_global_and_local_cls_norm
        self.pad_tokens = pad_tokens
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
            norm=norm, norm_eps=norm_eps, attn_impl=attn_impl)
            for _ in range(depth)])
        norm_cls = RMSNorm if norm == 'rms' else nn.LayerNorm
        self.norm = norm_cls(dim, norm_eps)
        self.cls_norm = norm_cls(dim, norm_eps) if untie_cls_and_patch_norms else None
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def _tokens(self, x):
        x = x.to(self.cls_token.dtype)
        tokens, (h, w) = self.patch_embed(x)
        n = tokens.shape[0]
        prefix = [self.cls_token.expand(n, -1, -1)]
        if self.n_storage_tokens > 0:
            prefix.append(self.storage_tokens.expand(n, -1, -1))
        return torch.cat(prefix + [tokens], dim=1), (h, w)

    def _stack_pad(self, tokens):
        """Stack-level token padding (see ``pad_tokens``): ``(tokens,
        n_valid)``, where ``n_valid=None`` means unpadded."""
        n = tokens.shape[1]
        target = pad_target(n)
        if not self.pad_tokens or target == n:
            return tokens, None
        return F.pad(tokens, (0, 0, 0, target - n)), n

    def _run_blocks(self, x, keep):
        """Tokens through every block: the outputs of the blocks in ``keep``
        and the patch grid ``(h, w)``."""
        tokens, hw = self._tokens(x)
        tokens, n_valid = self._stack_pad(tokens)
        rope = self.rope_embed(*hw, device=tokens.device)
        outs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, rope, n_valid)
            if i in keep:
                outs.append(tokens)
        return outs, hw

    def _norm_prefix_patches(self, t, hw):
        n_prefix = 1 + self.n_storage_tokens
        h, w = hw
        if self.cls_norm is not None:
            return (self.cls_norm(t[:, :n_prefix]),
                    self.norm(t[:, n_prefix:n_prefix + h * w]))
        normed = self.norm(t)
        return normed[:, :n_prefix], normed[:, n_prefix:n_prefix + h * w]

    def forward_features(self, x):
        (tokens,), hw = self._run_blocks(x, {self.depth - 1})
        cls_and_storage, patches = self._norm_prefix_patches(tokens, hw)
        return dict(x_norm_clstoken=cls_and_storage[:, 0],
                    x_storage_tokens=cls_and_storage[:, 1:],
                    x_norm_patchtokens=patches, grid=hw)

    def get_intermediate_layers(self, x, n: Union[int, Sequence[int]] = 1,
                                reshape: bool = False,
                                return_class_token: bool = False,
                                norm: bool = True):
        """Dense features of the last ``n`` blocks (or the listed blocks)."""
        idxs = (set(range(self.depth - n, self.depth)) if isinstance(n, int)
                else set(i % self.depth for i in n))
        outs, (h, w) = self._run_blocks(x, idxs)
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

    def forward(self, x):
        return self.forward_features(x)


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

    ``forward(x)`` takes NHWC ``[B, H, W, C]`` and returns class
    probabilities ``[B, H, W, classes]`` in f32.  The training branch
    (``train=True`` with labels → loss dict) arrives with the ViT training
    slice.
    """

    def set_default_config(self):
        self.config.update(dict(
            backbone=dict(
                name='vitl16_sat493m',   # SAT_CONFIGS key or VIT_SPECS key
                drop_path_rate=0.0,
                attn_impl=None,          # None=auto | 'xla' | 'fused' | 'flash'
                remat=None,
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
        self.head_hidden = nn.Linear(feat, hidden) if hidden else None
        self.head_classifier = nn.Linear(hidden or feat, int(self.config.classes))
        self.to(getattr(torch, self.config.dtype))

    def forward(self, x, y=None, train: bool = False):
        if train:
            raise NotImplementedError('DinoSeg training arrives with the ViT '
                                      'training slice')
        n_taps = int(self.config.head.get('n_taps', 1))
        taps = self.vit.get_intermediate_layers(x, n=n_taps, reshape=True)
        feat = taps[0] if n_taps == 1 else torch.cat(taps, dim=-1)
        if self.head_hidden is not None:
            feat = F.gelu(self.head_hidden(feat), approximate='tanh')
        logits = self.head_classifier(feat)
        logits = resize(logits, scale=x.shape[1] / logits.shape[1],
                        method='bilinear').float()
        return torch.softmax(logits, dim=-1)
