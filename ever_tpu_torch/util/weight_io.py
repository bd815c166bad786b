"""Carry weights from the JAX package's models into the port.

The port names its parameters after the torch DINOv3 reference
(``blocks.{i}.attn.qkv.weight``, ``blocks.{i}.ls1.gamma``,
``patch_embed.proj.weight``, ``norm.weight`` …), so these converters are the
inverse of the JAX package's ``convert_torch_dinov3_vit``.  Layout changes:
Dense ``[in, out]`` → Linear ``[out, in]``; conv HWIO → OIHW; norm ``scale``
→ ``weight``; the fused SwiGLU ``w12`` splits into ``w1``/``w2``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ['flatten_params', 'convert_flax_dinov3_vit', 'convert_flax_dinoseg']

_BLOCK_RE = re.compile(r'^block(\d+)/(.+)$')


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """A nested params dict, or a flat ``{'a/b': array}`` one, as flat
    ``'a/b'`` keys without a leading ``params/`` collection."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if hasattr(node, 'items'):
            for k, v in node.items():
                walk(v, f'{prefix}{k}/')
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree, '')
    return {(k[len('params/'):] if k.startswith('params/') else k): v
            for k, v in flat.items()}


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _linear(sd, name, leaf, v):
    if leaf == 'kernel':
        sd[f'{name}.weight'] = _tensor(v.T)
    elif leaf == 'bias':
        sd[f'{name}.bias'] = _tensor(v)
    else:
        raise KeyError(f'unexpected Dense leaf {name}/{leaf}')


_NORM_LEAF = {'scale': 'weight', 'bias': 'bias'}


def _norm(sd, name, leaf, v):
    sd[f'{name}.{_NORM_LEAF[leaf]}'] = _tensor(v)


def convert_flax_dinov3_vit(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``DinoVisionTransformer`` params → the port's trunk ``state_dict``.

    The training-only ``local_cls_norm`` is dropped; any other key the port
    does not know raises ``KeyError``.
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(params).items():
        if key in ('cls_token', 'storage_tokens'):
            sd[key] = _tensor(v)
        elif key == 'patch_embed/proj/kernel':
            sd['patch_embed.proj.weight'] = _tensor(np.transpose(v, (3, 2, 0, 1)))
        elif key == 'patch_embed/proj/bias':
            sd['patch_embed.proj.bias'] = _tensor(v)
        elif key.split('/')[0] in ('norm', 'cls_norm'):
            base, leaf = key.split('/')
            _norm(sd, base, leaf, v)
        elif key.startswith('local_cls_norm/'):
            continue
        else:
            m = _BLOCK_RE.match(key)
            if m is None:
                raise KeyError(f'unmapped ViT parameter {key!r}')
            i, rest = m.groups()
            parts = rest.split('/')
            base = f'blocks.{i}.' + '.'.join(parts[:-1])
            leaf = parts[-1]
            if parts[0] in ('norm1', 'norm2'):
                _norm(sd, base, leaf, v)
            elif parts[0] in ('ls1', 'ls2'):
                sd[f'{base}.gamma'] = _tensor(v)
            elif rest.startswith('mlp/w12/'):
                half = v.shape[-1] // 2
                for j, part in enumerate((v[..., :half], v[..., half:])):
                    _linear(sd, f'blocks.{i}.mlp.w{j + 1}', leaf, part)
            else:
                _linear(sd, base, leaf, v)
    return sd


def convert_flax_dinoseg(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``DinoSeg`` params (``params/vit/block{i}/...``,
    ``params/head_classifier/...``) → the port's ``DinoSeg`` ``state_dict``."""
    flat = flatten_params(params)
    trunk = {k[len('vit/'):]: v for k, v in flat.items() if k.startswith('vit/')}
    sd = {f'vit.{k}': v for k, v in convert_flax_dinov3_vit(trunk).items()}
    for key, v in flat.items():
        if key.startswith('vit/'):
            continue
        name, leaf = key.split('/')
        if name not in ('head_classifier', 'head_hidden'):
            raise KeyError(f'unmapped DinoSeg parameter {key!r}')
        _linear(sd, name, leaf, v)
    return sd
