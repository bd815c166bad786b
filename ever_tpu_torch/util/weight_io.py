"""Carry weights from the JAX package's models into the port.

The port names its parameters after the reference torch modules, so these
converters are the inverses of the JAX package's ``convert_torch_*``: the
ViT after torch DINOv3 (``blocks.{i}.attn.qkv.weight``,
``blocks.{i}.ls1.gamma``, ``patch_embed.proj.weight`` …), the inverse of
``convert_torch_dinov3_vit``; the ResNet after torchvision
(``conv1.weight``, ``layer1.0.bn2.running_var``,
``layer2.0.downsample.0.weight``), the inverse of ``convert_torch_resnet``;
the FarSeg head after the reference ``FarSegHead``, the inverse of
``convert_torch_farseg_head`` without its bias fold (the port has the JAX
package's bias-free content and re-encoder convs).  Layout changes: Dense
``[in, out]`` → Linear ``[out, in]``; conv HWIO → OIHW; norm ``scale`` →
``weight``; BatchNorm's ``batch_stats`` ``mean``/``var`` → the buffers
``running_mean``/``running_var``; the fused SwiGLU ``w12`` splits into
``w1``/``w2``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ['flatten_params', 'convert_flax_dinov3_vit', 'convert_flax_dinoseg',
           'convert_flax_resnet', 'convert_flax_farseg']

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


# -- conv nets: ResNet and FarSeg -------------------------------------------

# flax leaf → torch leaf (conv kernels are also transposed HWIO → OIHW)
_CONV_NET_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
                  'mean': 'running_mean', 'var': 'running_var'}

_BN = '/BatchNorm_0'
# JAX module path (below the trunk) → torchvision module name
_RESNET_RULES = [
    ('conv1', 'conv1'), ('bn1' + _BN, 'bn1'),
    ('stem_conv1', 'stem.0'), ('stem_bn1' + _BN, 'stem.1'),
    ('stem_conv2', 'stem.3'), ('stem_bn2' + _BN, 'stem.4'),
    ('stem_conv3', 'stem.6'), ('stem_bn3' + _BN, 'stem.7'),
    (r'layer(\d)/block(\d+)/(conv\d)', r'layer\1.\2.\3'),
    (r'layer(\d)/block(\d+)/(bn\d)' + _BN, r'layer\1.\2.\3'),
    (r'layer(\d)/block(\d+)/downsample_conv', r'layer\1.\2.downsample.0'),
    (r'layer(\d)/block(\d+)/downsample_bn' + _BN, r'layer\1.\2.downsample.1'),
]
# JAX FarSegHead module path → the reference FarSegHead's module name
_FARSEG_HEAD_RULES = [
    (r'fpn/(fpn_inner\d+|fpn_layer\d+)(/Conv_0)?', r'fpn.\1.0'),
    (r'fpn/(fpn_inner\d+|fpn_layer\d+)/Norm_0' + _BN, r'fpn.\1.1'),
    (r'fs_relation/scene_enc(\d+)_fc1', r'fs_relation.scene_encoder.\1.0'),
    (r'fs_relation/scene_enc(\d+)_fc2', r'fs_relation.scene_encoder.\1.2'),
    ('fs_relation/scene_enc_fc1', 'fs_relation.scene_encoder.0'),
    ('fs_relation/scene_enc_fc2', 'fs_relation.scene_encoder.2'),
    (r'fs_relation/content_enc(\d+)/Conv_0', r'fs_relation.content_encoders.\1.0'),
    (r'fs_relation/content_enc(\d+)/Norm_0' + _BN, r'fs_relation.content_encoders.\1.1'),
    (r'fs_relation/feature_reenc(\d+)/Conv_0', r'fs_relation.feature_reencoders.\1.0'),
    (r'fs_relation/feature_reenc(\d+)/Norm_0' + _BN,
     r'fs_relation.feature_reencoders.\1.1'),
    (r'fpn_decoder/block(\d+)_conv(\d+)/Conv_0', r'fpn_decoder.blocks.\1.\2.0'),
    (r'fpn_decoder/block(\d+)_conv(\d+)/Norm_0' + _BN, r'fpn_decoder.blocks.\1.\2.1'),
    ('fpn_decoder/classifier', 'fpn_decoder.classifier.0'),
]
# the port's module prefix → (JAX path prefix, rules below it)
_RESNET_TREES = [('', '', _RESNET_RULES), ('resnet.', 'resnet/', _RESNET_RULES)]
_FARSEG_TREES = [('encoder.resnet.', 'encoder/resnet/', _RESNET_RULES),
                 ('head.', 'head/', _FARSEG_HEAD_RULES)]


def _variables(params: Any, batch_stats: Any) -> Dict[str, np.ndarray]:
    """Flat ``'path/leaf'`` keys of params and batch statistics together:
    ``params`` may be a params tree or a whole ``{'params', 'batch_stats'}``
    variables dict; ``batch_stats`` a separate tree."""
    flat = {}
    for key, v in flatten_params(params).items():
        flat[key[len('batch_stats/'):] if key.startswith('batch_stats/') else key] = v
    if batch_stats is not None:
        flat.update(flatten_params(batch_stats))
    return flat


def _convert_conv_net(flat: Dict[str, np.ndarray], trees, what: str
                      ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flat.items():
        path, leaf = key.rsplit('/', 1)
        name = None
        for torch_prefix, jax_prefix, rules in trees:
            if not path.startswith(jax_prefix):
                continue
            rest = path[len(jax_prefix):]
            for pattern, template in rules:
                m = re.fullmatch(pattern, rest)
                if m is not None:
                    name = torch_prefix + m.expand(template)
                    break
            if name is not None:
                break
        if name is None or leaf not in _CONV_NET_LEAF:
            raise KeyError(f'unmapped {what} variable {key!r}')
        if leaf == 'kernel':
            v = np.transpose(v, (3, 2, 0, 1))
        sd[f'{name}.{_CONV_NET_LEAF[leaf]}'] = _tensor(v)
    return sd


def convert_flax_resnet(params: Any, batch_stats: Any = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``ResNet`` params and batch statistics → the port's ``ResNet``
    ``state_dict`` (torchvision names, running buffers included); a
    ``ResNetEncoder`` tree (``resnet/...``) gives ``resnet.``-prefixed keys
    for the port's ``ResNetEncoder``.  Any variable left unmapped raises
    ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats), _RESNET_TREES, 'ResNet')


def convert_flax_farseg(params: Any, batch_stats: Any = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``FarSeg`` params and batch statistics (``encoder/resnet/...``,
    ``head/...``) → the port's ``FarSeg`` ``state_dict``, running buffers
    included.  Any variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats), _FARSEG_TREES, 'FarSeg')
