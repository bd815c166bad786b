"""Weights into the port: from files (``load_weights``), and from the JAX
package's models (the ``convert_flax_*`` converters).

:func:`load_weights` (counterpart of ``ever_tpu/util/weight_io.py``
``load_weights``) reads the reference's torch files of the ported families
(a DINOv3 ViT, a torchvision ResNet or DenseNet, the reference
``FarSegHead``, the reference's vendored HRNetV2, an ``efficientnet_pytorch``
EfficientNet, a ``resnest`` package ResNeSt, DINOv3's vendored ConvNeXt),
``.npz``
archives of the JAX package's flat ``params/...`` keys, and the port's own
checkpoints, and loads them non-strictly into a model: the subtree a file
lands in is the one where most of its keys land, a stem conv of another
channel count goes through :func:`patch_first_conv`, and missing,
unexpected and mismatched keys are logged.  The reference files convert as
the JAX package's ``convert_torch_*`` do: the DINOv3 ``qkv.bias_mask`` is
baked into the bias and ``mask_token``, ``rope_embed.*`` and
``local_cls_norm`` are dropped; a FarSeg head's content and re-encoder conv
biases fold into their BatchNorms' running means; HRNet's
``incre_modules``, ``downsamp_modules``, ``final_layer`` and ``classifier``
(its classification neck) are dropped, and so are the other families'
classification heads (EfficientNet's ``_conv_head``, top-level ``_bn1``
and ``_fc``; DenseNet's ``classifier`` and final ``features.norm5``;
ResNeSt's ``fc``; ConvNeXt's ``norm`` and ``head``).

The converters below carry the JAX package's parameters into the port.

The port names its parameters after the reference torch modules, so these
converters are the inverses of the JAX package's ``convert_torch_*``: the
ViT after torch DINOv3 (``blocks.{i}.attn.qkv.weight``,
``blocks.{i}.ls1.gamma``, ``patch_embed.proj.weight`` …), the inverse of
``convert_torch_dinov3_vit``; the ResNet after torchvision
(``conv1.weight``, ``layer1.0.bn2.running_var``,
``layer2.0.downsample.0.weight``), the inverse of ``convert_torch_resnet``;
the FarSeg head after the reference ``FarSegHead``, the inverse of
``convert_torch_farseg_head`` without its bias fold (the port has the JAX
package's bias-free content and re-encoder convs); HRNet after the
reference's vendored ``_hrnet.py`` (``transition1.1.0.0.weight``,
``stage3.0.branches.2.1.bn1.running_mean``,
``stage4.0.fuse_layers.3.0.2.1.weight``), the inverse of
``convert_torch_hrnet``; EfficientNet, DenseNet, ResNeSt and ConvNeXt
after ``efficientnet_pytorch`` (the JAX ``stage{s}_block{b}`` as the flat
``_blocks.{i}``), torchvision, the ``resnest`` package and DINOv3's
ConvNeXt, the inverses of their ``convert_torch_*``.  Modules the reference
files do not cover (FarSeg++'s relation, the SE and GC branches, P6/P7,
the decoder's GN and LN, ``DINOHead``, FactSeg, the change detectors and
the ASPP, PPM, DeepLabv3+ and HRNet heads, ``BiFPN``)
and FreeNet take names that map one to one onto the JAX package's, each
listed in the rules below; ``ViTEncoder`` holds the trunk as ``vit``, and
``Fp8Linear``, ``Fp8LinearKMaskedBias`` and ``LinearW24`` are Linears.  Layout changes: Dense
``[in, out]`` → Linear ``[out, in]`` (ConvNeXt's ``pwconv1``/``pwconv2``
too); conv HWIO → OIHW; norm ``scale`` →
``weight``; BatchNorm's ``batch_stats`` ``mean``/``var`` → the buffers
``running_mean``/``running_var``; the fused SwiGLU ``w12`` splits into
``w1``/``w2``.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ever_tpu_torch.core.device import get_device

__all__ = ['flatten_params', 'flatten_tree', 'unflatten_tree', 'convert_flax_dinov3_vit', 'convert_flax_dinoseg',
           'convert_flax_dino_head',
           'convert_flax_resnet', 'convert_flax_farseg', 'convert_flax_factseg',
           'convert_flax_change', 'convert_flax_hrnet', 'convert_flax_head',
           'convert_flax_encoder_head', 'convert_flax_efficientnet', 'convert_flax_densenet',
           'convert_flax_resnest', 'convert_flax_convnext', 'convert_flax_bifpn',
           'convert_flax_vit_encoder', 'convert_flax_freenet', 'convert_flax_linear',
           'convert_flax_dcgan', 'convert_flax_moe',
           'convert_flax_flat', 'convert_torch_dinov3_vit', 'convert_torch_farseg_head',
           'convert_torch_resnet', 'convert_torch_hrnet', 'convert_torch_efficientnet',
           'convert_torch_densenet', 'convert_torch_resnest', 'convert_torch_convnext',
           'patch_first_conv', 'read_weights', 'load_weights', 'LoadReport']

logger = logging.getLogger('ever_tpu_torch.weight_io')

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


def flatten_tree(tree: Any, prefix: str = '') -> Dict[str, np.ndarray]:
    """A nested dict as ``'a/b'``-joined flat keys of numpy arrays (the
    JAX package's ``.npz`` form)."""
    out: Dict[str, np.ndarray] = {}
    if hasattr(tree, 'items'):
        for k, v in tree.items():
            out.update(flatten_tree(v, f'{prefix}{k}/'))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`flatten_tree`."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


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
    """JAX ``DinoVisionTransformer`` params → the port's trunk ``state_dict``
    (``local_cls_norm`` included, for a trunk with
    ``untie_global_and_local_cls_norm``); a key the port does not know
    raises ``KeyError``.
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(params).items():
        if key in ('cls_token', 'storage_tokens'):
            sd[key] = _tensor(v)
        elif key == 'patch_embed/proj/kernel':
            sd['patch_embed.proj.weight'] = _tensor(np.transpose(v, (3, 2, 0, 1)))
        elif key == 'patch_embed/proj/bias':
            sd['patch_embed.proj.bias'] = _tensor(v)
        elif key.split('/')[0] in ('norm', 'cls_norm', 'local_cls_norm'):
            base, leaf = key.split('/')
            _norm(sd, base, leaf, v)
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


def convert_flax_vit_encoder(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``ViTEncoder`` params (``vit/...``) → the port's ``ViTEncoder``
    ``state_dict`` (``vit.`` and the trunk's names)."""
    flat = flatten_params(params)
    stray = [k for k in flat if not k.startswith('vit/')]
    if stray:
        raise KeyError(f'unmapped ViTEncoder parameters {stray[:3]!r}')
    return {f'vit.{k}': v for k, v in convert_flax_dinov3_vit(
        {k[len('vit/'):]: v for k, v in flat.items()}).items()}


_MOE_LEAVES = ('router', 'experts_fc1', 'experts_bias1', 'experts_fc2', 'experts_bias2')


def convert_flax_moe(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``MoEMlp`` params (a bare module's, or a tree with them under a
    path) → the port's ``MoEMlp`` ``state_dict``: the same names and shapes
    (both packages keep the experts' ``[E, in, out]`` layout), the path's
    ``/`` as ``.``; a leaf the module does not have raises ``KeyError``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(params).items():
        path, _, leaf = key.rpartition('/')
        if leaf not in _MOE_LEAVES:
            raise KeyError(f'unmapped MoEMlp parameter {key!r}')
        sd[(path.replace('/', '.') + '.' if path else '') + leaf] = _tensor(v)
    return sd


def convert_flax_linear(params: Any) -> Dict[str, torch.Tensor]:
    """The variables of JAX Dense-like layers (``Fp8Linear``,
    ``Fp8LinearKMaskedBias``, ``LinearW24``; a bare layer or a tree of
    them) → their ``state_dict``: each ``kernel`` ``[in, out]`` transposed
    to ``weight``, ``bias``, and the ``constants`` collection's
    ``bias_mask`` as the buffer of that name."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(params).items():
        key = key[len('constants/'):] if key.startswith('constants/') else key
        path, _, leaf = key.rpartition('/')
        base = path.replace('/', '.') + '.' if path else ''
        if leaf == 'kernel' and v.ndim == 2:
            sd[f'{base}weight'] = _tensor(v.T)
        elif leaf in ('bias', 'bias_mask'):
            sd[f'{base}{leaf}'] = _tensor(v)
        else:
            raise KeyError(f'unmapped linear variable {key!r}')
    return sd


def convert_flax_dino_head(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``DINOHead`` params → the port's ``DINOHead`` ``state_dict``:
    ``mlp{i}`` Dense → Linear, ``prototypes`` the same ``[bottleneck, out]``
    matrix."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(params).items():
        if key == 'prototypes':
            sd[key] = _tensor(v)
        elif re.fullmatch(r'mlp\d+/(kernel|bias)', key):
            _linear(sd, *key.split('/'), v)
        else:
            raise KeyError(f'unmapped DINOHead parameter {key!r}')
    return sd


# -- conv nets: ResNet and FarSeg -------------------------------------------

# flax leaf → torch leaf (conv kernels are also transposed HWIO → OIHW, Dense
# kernels [in, out] → [out, in]); ConvNeXt's layer scale and a Fusion's
# weights keep their names
_CONV_NET_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
                  'mean': 'running_mean', 'var': 'running_var', 'gamma': 'gamma',
                  'weights': 'weights'}

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
    # the SE and GC branches: flax's auto-named modules → se.fc1/fc2, and
    # GCNet's conv_mask and channel_{add,mul}_conv.{0,1,3}
    (r'layer(\d)/block(\d+)/SEBlock_0/Conv_0', r'layer\1.\2.se.fc1'),
    (r'layer(\d)/block(\d+)/SEBlock_0/Conv_1', r'layer\1.\2.se.fc2'),
    (r'layer(\d)/block(\d+)/ContextBlock2d_0/Conv_0', r'layer\1.\2.gc.conv_mask'),
    (r'layer(\d)/block(\d+)/ContextBlock2d_0/channel_(add|mul)_reduce',
     r'layer\1.\2.gc.channel_\3_conv.0'),
    (r'layer(\d)/block(\d+)/ContextBlock2d_0/channel_(add|mul)_ln',
     r'layer\1.\2.gc.channel_\3_conv.1'),
    (r'layer(\d)/block(\d+)/ContextBlock2d_0/channel_(add|mul)_expand',
     r'layer\1.\2.gc.channel_\3_conv.3'),
]
_NORM = r'/Norm_0/(BatchNorm|GroupNorm|LayerNorm)_0'


def _fpn_decoder_rules(fpns, decoders):
    """The rules of the FPNs and ``AssymetricDecoder``s named in each
    package as given (JAX path = port module name)."""
    rules = []
    for n in fpns:
        rules += [(rf'{n}/(fpn_inner\d+|fpn_layer\d+)(/Conv_0)?', rf'{n}.\1.0'),
                  (rf'{n}/(fpn_inner\d+|fpn_layer\d+)/Norm_0' + _BN, rf'{n}.\1.1'),
                  (rf'{n}/top_blocks/(p6|p7)', rf'{n}.top_blocks.\1')]
    for n in decoders:
        rules += [(rf'{n}/block(\d+)_conv(\d+)/Conv_0', rf'{n}.blocks.\1.\2.0'),
                  (rf'{n}/block(\d+)_conv(\d+)' + _NORM, rf'{n}.blocks.\1.\2.1'),
                  (f'{n}/classifier', f'{n}.classifier.0')]
    return rules


# JAX FarSegHead module path → the reference FarSegHead's module name
_FARSEG_HEAD_RULES = _fpn_decoder_rules(('fpn',), ('fpn_decoder',)) + [
    (r'fs_relation/content_enc(\d+)/Conv_0', r'fs_relation.content_encoders.\1.0'),
    (r'fs_relation/content_enc(\d+)/Norm_0' + _BN, r'fs_relation.content_encoders.\1.1'),
    (r'fs_relation/feature_reenc(\d+)/Conv_0', r'fs_relation.feature_reencoders.\1.0'),
    (r'fs_relation/feature_reenc(\d+)/Norm_0' + _BN,
     r'fs_relation.feature_reencoders.\1.1'),
]
# FarSeg's scene encoder: conv, ReLU, conv
_FS_RELATION_RULES = [
    (r'fs_relation/scene_enc(\d+)_fc1', r'fs_relation.scene_encoder.\1.0'),
    (r'fs_relation/scene_enc(\d+)_fc2', r'fs_relation.scene_encoder.\1.2'),
    ('fs_relation/scene_enc_fc1', 'fs_relation.scene_encoder.0'),
    ('fs_relation/scene_enc_fc2', 'fs_relation.scene_encoder.2'),
]
# FarSeg++'s (FSRelationV2): conv, GroupNorm, ReLU, twice; the projections
_SCENE_V2 = (('fc1', 0), ('gn1', 1), ('fc2', 3), ('gn2', 4))
_FS_RELATION_V2_RULES = [
    (rf'fs_relation/scene_enc(\d+)_{layer}', rf'fs_relation.scene_encoder.\1.{i}')
    for layer, i in _SCENE_V2] + [
    (f'fs_relation/scene_enc_{layer}', f'fs_relation.scene_encoder.{i}')
    for layer, i in _SCENE_V2] + [
    (r'fs_relation/project(\d+)_conv/Conv_0', r'fs_relation.project.\1.0'),
    (r'fs_relation/project(\d+)_conv/Norm_0' + _BN, r'fs_relation.project.\1.1'),
]
# FactSeg's two branches, and the change detectors' decoders, classifiers
# and ChangeMixin (its order-stacked conv0 kernel is the plain conv0's)
_FACTSEG_RULES = _fpn_decoder_rules(('fa_fpn', 'sem_fpn'), ('fa_decoder', 'sem_decoder')) + [
    (r'(fa_cls|sem_cls)', r'\1')]
_CHANGE_RULES = _fpn_decoder_rules(
    ('fpn',), ('decoder', 'sem_decoder', 'change_decoder', 'loc_decoder', 'dam_decoder')) + [
    (r'(seg_cls|sem_cls|change_cls|loc_cls|dam_cls)', r'\1'),
    (r'changemixin/(conv\d+)/Conv_0', r'changemixin.\1.0'),
    (r'changemixin/(conv\d+)/Norm_0' + _BN, r'changemixin.\1.1'),
    ('changemixin/cls', 'changemixin.cls'),
]
# HRNet: the JAX package's flat names → the reference _hrnet.py's nesting
# (a transition's new branch, i == t, has one more Sequential level)
_HRNET_BLOCK = r'stage(\d)_module(\d+)/branch(\d+)_block(\d+)'
_HRNET_RULES = [
    (r'(conv[12])', r'\1'), (r'(bn[12])' + _BN, r'\1'),
    (r'layer1_block(\d+)/(conv\d)', r'layer1.\1.\2'),
    (r'layer1_block(\d+)/(bn\d)' + _BN, r'layer1.\1.\2'),
    (r'layer1_block(\d+)/downsample_conv', r'layer1.\1.downsample.0'),
    (r'layer1_block(\d+)/downsample_bn' + _BN, r'layer1.\1.downsample.1'),
    (r'transition(\d)_\1_conv', r'transition\1.\1.0.0'),
    (r'transition(\d)_\1_bn' + _BN, r'transition\1.\1.0.1'),
    (r'transition(\d)_(\d)_conv', r'transition\1.\2.0'),
    (r'transition(\d)_(\d)_bn' + _BN, r'transition\1.\2.1'),
    (r'stage(\d)_module(\d+)/fuse(\d)_(\d)_conv', r'stage\1.\2.fuse_layers.\3.\4.0'),
    (r'stage(\d)_module(\d+)/fuse(\d)_(\d)_bn' + _BN, r'stage\1.\2.fuse_layers.\3.\4.1'),
    (r'stage(\d)_module(\d+)/fuse(\d)_(\d)_down(\d)_conv',
     r'stage\1.\2.fuse_layers.\3.\4.\5.0'),
    (r'stage(\d)_module(\d+)/fuse(\d)_(\d)_down(\d)_bn' + _BN,
     r'stage\1.\2.fuse_layers.\3.\4.\5.1'),
] + [  # a branch's BasicBlock: the ResNet block rules, two groups further on
    (_HRNET_BLOCK + pattern[len(r'layer(\d)/block(\d+)'):],
     r'stage\1.\2.branches.\3.\4' + re.sub(r'\\(\d)', lambda g: '\\' + str(int(g[1]) + 2),
                                        template[len(r'layer\1.\2'):]))
    for pattern, template in _RESNET_RULES if pattern.startswith(r'layer(\d)/block(\d+)/')]
# the four heads' blocks wherever they stand: ConvBlock (Conv_0, Norm_0),
# PoolBlock (its ConvBlock_0 as conv), SeparableConvBlock (SeparableConv2d_0
# as child 0: the depthwise conv, then the pointwise one), the classifier
_HEAD_RULES = [
    (r'(.+)/ConvBlock_0/Conv_0', r'\1.conv.0'),
    (r'(.+)/ConvBlock_0/Norm_0' + _BN, r'\1.conv.1'),
    (r'(.+)/SeparableConv2d_0/DepthwiseConv2d_0/Conv_0', r'\1.0.0'),
    (r'(.+)/SeparableConv2d_0/Conv_0', r'\1.0.1'),
    (r'(.+)/Conv_0', r'\1.0'),
    (r'(.+)/Norm_0' + _BN, r'\1.1'),
    ('classifier', 'classifier'),
]
# an FPN as a model's head: its lateral and output convs (bare or a
# ConvBlock's Conv_0 and Norm_0) and its top blocks
_FPN_RULES = [
    (r'(fpn_inner\d+|fpn_layer\d+)(/Conv_0)?', r'\1.0'),
    (r'(fpn_inner\d+|fpn_layer\d+)/Norm_0' + _BN, r'\1.1'),
    (r'top_blocks/(p6|p7)', r'top_blocks.\1'),
]
# EfficientNet, after its stage{s}_block{b} are renamed block{i}
# (_restaged_efficientnet): efficientnet_pytorch's names
_EFFICIENTNET_RULES = [
    ('stem_conv', '_conv_stem'), ('stem_bn' + _BN, '_bn0'),
    (r'block(\d+)/expand_conv', r'_blocks.\1._expand_conv'),
    (r'block(\d+)/expand_bn' + _BN, r'_blocks.\1._bn0'),
    (r'block(\d+)/dw_conv', r'_blocks.\1._depthwise_conv'),
    (r'block(\d+)/dw_bn' + _BN, r'_blocks.\1._bn1'),
    (r'block(\d+)/(se_reduce|se_expand)', r'_blocks.\1._\2'),
    (r'block(\d+)/project_conv', r'_blocks.\1._project_conv'),
    (r'block(\d+)/project_bn' + _BN, r'_blocks.\1._bn2'),
]
# DenseNet: torchvision's names
_DENSENET_RULES = [
    ('conv0', 'features.conv0'), ('norm0' + _BN, 'features.norm0'),
    (r'denseblock(\d+)_layer(\d+)/(conv\d)', r'features.denseblock\1.denselayer\2.\3'),
    (r'denseblock(\d+)_layer(\d+)/(norm\d)' + _BN, r'features.denseblock\1.denselayer\2.\3'),
    (r'transition(\d+)_conv', r'features.transition\1.conv'),
    (r'transition(\d+)_norm' + _BN, r'features.transition\1.norm'),
]
# ResNeSt: the resnest package's names (the deep stem as conv1.{0,1,3,4,6}
# and bn1, the split attention as conv2, the shortcut as downsample.{1,2})
_RESNEST_RULES = [
    ('stem_conv1', 'conv1.0'), ('stem_bn1' + _BN, 'conv1.1'),
    ('stem_conv2', 'conv1.3'), ('stem_bn2' + _BN, 'conv1.4'),
    ('stem_conv3', 'conv1.6'), ('stem_bn3' + _BN, 'bn1'),
    (r'layer(\d)_block(\d+)/(conv1|conv3)', r'layer\1.\2.\3'),
    (r'layer(\d)_block(\d+)/(bn1|bn3)' + _BN, r'layer\1.\2.\3'),
    (r'layer(\d)_block(\d+)/splat/(conv|fc1|fc2)', r'layer\1.\2.conv2.\3'),
    (r'layer(\d)_block(\d+)/splat/(bn0|bn1)' + _BN, r'layer\1.\2.conv2.\3'),
    (r'layer(\d)_block(\d+)/downsample_conv', r'layer\1.\2.downsample.1'),
    (r'layer(\d)_block(\d+)/downsample_bn' + _BN, r'layer\1.\2.downsample.2'),
]
# ConvNeXt: DINOv3's vendored names (its LayerNorms' scale and bias, the
# Dense pwconvs as Linears, the layer scale gamma/gamma as the block's gamma)
_CONVNEXT_RULES = [
    ('stem_conv', 'downsample_layers.0.0'), ('stem_norm', 'downsample_layers.0.1'),
    (r'down(\d)_norm', r'downsample_layers.\1.0'), (r'down(\d)_conv', r'downsample_layers.\1.1'),
    (r'stage(\d)_block(\d+)/(dwconv|norm|pwconv1|pwconv2)', r'stages.\1.\2.\3'),
    (r'stage(\d)_block(\d+)/gamma', r'stages.\1.\2'),
]
# BiFPN below its root: the fusions' auto-named Fusion_0 and
# SeparableConvBlock_0 as fusion and conv, the ConvBlocks' Conv_0 and Norm_0
_BIFPN_RULES = [
    (r'(up|down)(\d+)_adapter/Conv_0', r'\1\2_adapter.0'),
    (r'(up|down)(\d+)_adapter/Norm_0' + _BN, r'\1\2_adapter.1'),
    (r'down(\d+)/Conv_0', r'down\1.0'), (r'down(\d+)/Norm_0' + _BN, r'down\1.1'),
    (r'down(\d+)_bn' + _BN, r'down\1_bn'),
    (r'(bin|tri)_fusion(\d+)/Fusion_0', r'\1_fusion\2.fusion'),
    (r'(bin|tri)_fusion(\d+)/SeparableConvBlock_0/SeparableConv2d_0/DepthwiseConv2d_0/Conv_0',
     r'\1_fusion\2.conv.0.0'),
    (r'(bin|tri)_fusion(\d+)/SeparableConvBlock_0/SeparableConv2d_0/Conv_0',
     r'\1_fusion\2.conv.0.1'),
    (r'(bin|tri)_fusion(\d+)/SeparableConvBlock_0/Norm_0' + _BN, r'\1_fusion\2.conv.1'),
]
# FreeNet: the encoder's blocks, the spectral gates, the decoder's lateral
# and fusion ConvBlocks, the classifier
_FREENET_RULES = [
    (r'(enc\d+)/(conv\d)/Conv_0', r'\1.\2.0'),
    (r'(enc\d+)/(conv\d)' + _NORM, r'\1.\2.1'),
    (r'(enc\d+)/spec_attn/(reduce|expand)', r'\1.spec_attn.\2'),
    (r'(lat\d+|fuse\d+)/Conv_0', r'\1.0'),
    (r'(lat\d+|fuse\d+)' + _NORM, r'\1.1'),
    ('classifier', 'classifier'),
]
# the port's module prefix → (JAX path prefix, rules below it)
_RESNET_TREES = [('', '', _RESNET_RULES), ('resnet.', 'resnet/', _RESNET_RULES)]
_HRNET_TREES = [('', '', _HRNET_RULES), ('hrnet.', 'hrnet/', _HRNET_RULES)]
_ENCODER_TREE = ('encoder.resnet.', 'encoder/resnet/', _RESNET_RULES)


def _head_rules(flat: Dict[str, np.ndarray]):
    """The FarSeg head's rules: FarSeg++'s where its scene encoder has
    GroupNorms, else FarSeg's."""
    v2 = any(re.search(r'fs_relation/scene_enc\d*_?gn1/', k) for k in flat)
    return _FARSEG_HEAD_RULES + (_FS_RELATION_V2_RULES if v2 else _FS_RELATION_RULES)


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
                    name = torch_prefix + m.expand(template).replace('/', '.')
                    break
            if name is not None:
                break
        if name is None or leaf not in _CONV_NET_LEAF:
            raise KeyError(f'unmapped {what} variable {key!r}')
        if leaf == 'kernel':
            v = v.T if v.ndim == 2 else np.transpose(v, (3, 2, 0, 1))
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
    included: FarSeg and FarSeg++ (``relation_type='v2'``), the SE and GC
    branches, FPN ``top_blocks``, the decoder's BN, GN or LN.  Any variable
    left unmapped raises ``KeyError``."""
    flat = _variables(params, batch_stats)
    trees = [_ENCODER_TREE, ('head.', 'head/', _head_rules(flat))]
    return _convert_conv_net(flat, trees, 'FarSeg')


def convert_flax_factseg(params: Any, batch_stats: Any = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``FactSeg`` params and batch statistics (``encoder/resnet/...``,
    ``fa_fpn``, ``sem_fpn``, ``fa_decoder``, ``sem_decoder``, ``fa_cls``,
    ``sem_cls``) → the port's ``FactSeg`` ``state_dict``, running buffers
    included.  Any variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats),
                             [_ENCODER_TREE, ('', '', _FACTSEG_RULES)], 'FactSeg')


def convert_flax_change(params: Any, batch_stats: Any = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``ChangeStar``, ``ChangeMask`` or ``ChangeOS`` params and batch
    statistics → the port's model's ``state_dict``: the encoder, ``fpn``,
    the decoders (``decoder``, ``sem_decoder``, ``change_decoder``,
    ``loc_decoder``, ``dam_decoder``), the 1×1 classifiers and
    ``ChangeMixin``'s ``conv{i}`` and ``cls`` (an order-stacked
    ``conv0/Conv_0/kernel`` ``[3, 3, 2C, F]`` is the plain conv0's).  Any
    variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats),
                             [_ENCODER_TREE, ('', '', _CHANGE_RULES)], 'change detector')


def convert_flax_hrnet(params: Any, batch_stats: Any = None
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``HRNet`` params and batch statistics → the port's ``HRNet``
    ``state_dict`` (the reference ``_hrnet.py`` names, running buffers
    included, the SE and GC branches too); an ``HRNetEncoder`` tree
    (``hrnet/...``) gives ``hrnet.``-prefixed keys for the port's
    ``HRNetEncoder``.  Any variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats), _HRNET_TREES, 'HRNet')


def convert_flax_head(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """A JAX ``ASPPHead``, ``PPMHead``, ``Deeplabv3pHead`` or ``HRNetHead``
    (or one of their blocks: ``AtrousSpatialPyramidPool``,
    ``PyramidPoolModule``, ``Deeplabv3pDecoder``, ``SimpleFusion``) → the
    port's ``state_dict``, running buffers included.  Any variable left
    unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats), [('', '', _HEAD_RULES)], 'head')


def convert_flax_encoder_head(params: Any, batch_stats: Any = None
                              ) -> Dict[str, torch.Tensor]:
    """A JAX model that composes a ``ResNetEncoder``, ``HRNetEncoder``,
    ``EFNetEncoder``, ``DenseNetEncoder``, ``ResNeStEncoder``,
    ``ConvNeXtEncoder`` or ``ViTEncoder`` as ``encoder`` with one of the
    four heads, or an ``FPN``, as ``head`` (``encoder/resnet/``,
    ``encoder/hrnet/``, ``encoder/net/``, ``encoder/densenet/``,
    ``encoder/vit/``, ``head/``) → the port's ``state_dict`` of the same
    composition (``encoder.resnet.``, ``encoder.hrnet.``, ``encoder.net.``,
    ``encoder.densenet.``, ``encoder.vit.``, ``head.``).  Any variable left
    unmapped raises ``KeyError``."""
    flat = _variables(params, batch_stats)
    vit = {k[len('encoder/'):]: flat.pop(k) for k in [k for k in flat
                                                       if k.startswith('encoder/vit/')]}
    trees = [_ENCODER_TREE, ('encoder.hrnet.', 'encoder/hrnet/', _HRNET_RULES),
             ('head.', 'head/', _FPN_RULES + _HEAD_RULES)]
    family = _trunk_family(flat)
    if family is not None:
        attr, rules = _TRUNK_FAMILIES[family]
        if family == 'efficientnet':
            flat = _restaged_efficientnet(flat, None)
        trees.append((f'encoder.{attr}.', f'encoder/{attr}/', rules))
    sd = _convert_conv_net(flat, trees, 'encoder-head model')
    if vit:
        sd.update({f'encoder.{k}': v for k, v in convert_flax_vit_encoder(vit).items()})
    return sd


def convert_flax_freenet(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``FreeNet`` params → the port's ``FreeNet`` ``state_dict`` (the
    same module names).  Any variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, None), [('', '', _FREENET_RULES)], 'FreeNet')


_DCGAN_NAMES = [
    (r'G/fc', 'G.fc'), (r'G/bn_fc', 'G.bn_fc'), (r'G/up(\d+)', r'G.ups.\1'),
    (r'G/bn(\d+)', r'G.bns.\1'), (r'D/down(\d+)', r'D.downs.\1'), (r'D/logit', 'D.logit'),
]


def convert_flax_dcgan(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """JAX ``DCGAN`` params and batch statistics (or its whole variables
    dict) → the port's ``DCGAN`` ``state_dict``.  Dense kernels are
    transposed; convolution kernels ``[kh, kw, in, out]`` become ``[out, in,
    kh, kw]``; the generator's transposed-convolution kernels become ``[in,
    out, kh, kw]`` flipped in both spatial axes (flax's ``ConvTranspose``
    correlates with the kernel as stored, ``conv_transpose2d`` with it
    flipped); the discriminator's ``bn{i}`` (from ``i = 1``) is
    ``D.bns.{i-1}``.  Any variable left unmapped raises ``KeyError``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, v in _variables(params, batch_stats).items():
        path, leaf = key.rsplit('/', 1)
        name = None
        for pattern, template in _DCGAN_NAMES:
            m = re.fullmatch(pattern, path)
            if m is not None:
                name = m.expand(template)
                break
        dm = re.fullmatch(r'D/bn(\d+)', path)
        if dm is not None:
            name = f'D.bns.{int(dm.group(1)) - 1}'
        if name is None or leaf not in _CONV_NET_LEAF:
            raise KeyError(f'unmapped DCGAN variable {key!r}')
        if leaf == 'kernel':
            if v.ndim == 2:
                v = v.T
            elif '.ups.' in name:
                v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
            else:
                v = np.transpose(v, (3, 2, 0, 1))
        sd[f'{name}.{_CONV_NET_LEAF[leaf]}'] = _tensor(np.ascontiguousarray(v))
    return sd


def _trunk_trees(rules, attr: str):
    """A trunk's rules bare, under its encoder's ``attr`` and under a
    model's ``encoder``."""
    return [('', '', rules), (f'{attr}.', f'{attr}/', rules),
            (f'encoder.{attr}.', f'encoder/{attr}/', rules)]


_EFFICIENTNET_BLOCK = re.compile(r'(^|/)stage(\d+)_block(\d+)/')


def _restaged_efficientnet(flat: Dict[str, np.ndarray], model_name: Optional[str]
                           ) -> Dict[str, np.ndarray]:
    """EfficientNet's ``stage{s}_block{b}`` keys renamed ``block{i}``, i
    the flat index over the stages' block counts of ``model_name`` (else
    the variant whose block count the tree has)."""
    from ever_tpu_torch.module.efficientnet import EFFICIENTNET_SPECS, stage_repeats

    seen = {m.groups()[1:] for k in flat for m in [_EFFICIENTNET_BLOCK.search(k)] if m}
    if model_name is None:
        model_name = next((n for n in EFFICIENTNET_SPECS
                           if sum(stage_repeats(n)) == len(seen)), None)
        if model_name is None:
            raise ValueError(f'no EfficientNet variant has {len(seen)} blocks')
    starts = np.cumsum([0] + list(stage_repeats(model_name)))
    return {_EFFICIENTNET_BLOCK.sub(
        lambda m: f'{m.group(1)}block{starts[int(m.group(2))] + int(m.group(3))}/', k): v
        for k, v in flat.items()}


def convert_flax_efficientnet(params: Any, batch_stats: Any = None,
                              model_name: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """JAX ``EfficientNet`` params and batch statistics → the port's
    ``state_dict`` (efficientnet_pytorch's names, running buffers
    included): a bare trunk, an ``EFNetEncoder`` (``net/``, giving
    ``net.``) or a model's encoder (``encoder/net/``).  ``model_name`` is
    inferred from the block count when omitted.  Any variable left
    unmapped raises ``KeyError``."""
    flat = _restaged_efficientnet(_variables(params, batch_stats), model_name)
    return _convert_conv_net(flat, _trunk_trees(_EFFICIENTNET_RULES, 'net'), 'EfficientNet')


def convert_flax_densenet(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """JAX ``DenseNet`` params and batch statistics → the port's
    ``state_dict`` (torchvision's names, running buffers included): bare,
    under ``densenet/`` or ``encoder/densenet/``.  Any variable left
    unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats),
                             _trunk_trees(_DENSENET_RULES, 'densenet'), 'DenseNet')


def convert_flax_resnest(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """JAX ``ResNeSt`` params and batch statistics → the port's
    ``state_dict`` (the resnest package's names, running buffers
    included): bare, under ``net/`` or ``encoder/net/``.  Any variable
    left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats),
                             _trunk_trees(_RESNEST_RULES, 'net'), 'ResNeSt')


def convert_flax_convnext(params: Any) -> Dict[str, torch.Tensor]:
    """JAX ``ConvNeXt`` params → the port's ``state_dict`` (DINOv3's
    vendored names): bare, under ``net/`` or ``encoder/net/``.  Any
    variable left unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, None), _trunk_trees(_CONVNEXT_RULES, 'net'),
                             'ConvNeXt')


def convert_flax_bifpn(params: Any, batch_stats: Any = None) -> Dict[str, torch.Tensor]:
    """A JAX ``BiFPN`` layer's params and batch statistics → the port's
    ``BiFPN`` ``state_dict``, running buffers included.  Any variable left
    unmapped raises ``KeyError``."""
    return _convert_conv_net(_variables(params, batch_stats), [('', '', _BIFPN_RULES)], 'BiFPN')


# family → (its encoder's attribute, its rules)
_TRUNK_FAMILIES = {'efficientnet': ('net', _EFFICIENTNET_RULES),
                   'densenet': ('densenet', _DENSENET_RULES),
                   'resnest': ('net', _RESNEST_RULES), 'convnext': ('net', _CONVNEXT_RULES)}


def _trunk_family(keys) -> Optional[str]:
    """The new trunks' family of a flat JAX tree, told apart by their
    module names."""
    if any(re.search(r'(^|/)stage\d+_block\d+/dw_conv/', k) for k in keys):
        return 'efficientnet'
    if any(re.search(r'(^|/)denseblock\d+_layer\d+/', k) for k in keys):
        return 'densenet'
    if any('/splat/' in k for k in keys):
        return 'resnest'
    if any(re.search(r'(^|/)stage\d_block\d+/dwconv/', k) for k in keys):
        return 'convnext'
    return None


def convert_flax_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flat archive of the JAX package's variables (``params/...`` and
    ``batch_stats/...`` keys, as its ``.npz`` files hold them) → port names:
    a DinoSeg or a bare DINOv3 trunk, a FactSeg, a ChangeStar, ChangeMask
    or ChangeOS, a FarSeg, another encoder-head model, a bare FarSeg head,
    an EfficientNet, DenseNet, ResNeSt or ConvNeXt trunk (bare, under its
    encoder's attribute, or as a model's encoder under a head), a
    ``ViTEncoder`` (bare or under a head), a FreeNet, Dense-like layers
    (``Fp8Linear``, ``LinearW24``: kernels, biases and bias masks alone),
    an HRNet (bare or under ``hrnet/``) or a ResNet (bare or under
    ``resnet/``), told apart by their keys."""
    flat = _variables(flat, None)
    keys = list(flat)
    family = _trunk_family(keys)
    if family is not None:
        if any(k.startswith('head/') for k in keys):
            return convert_flax_encoder_head(flat)
        return {'efficientnet': convert_flax_efficientnet, 'densenet': convert_flax_densenet,
                'resnest': convert_flax_resnest, 'convnext': convert_flax_convnext}[family](flat)
    if any(k.endswith('cls_token') for k in keys):
        if any(k.startswith('encoder/vit/') for k in keys):
            return convert_flax_encoder_head(flat)
        if any(k.startswith('head_') for k in keys):
            return convert_flax_dinoseg(flat)
        if any(k.startswith('vit/') for k in keys):
            return convert_flax_vit_encoder(flat)
        return convert_flax_dinov3_vit(flat)
    if any(k.startswith('enc0/spec_attn/') for k in keys):
        return convert_flax_freenet(flat)
    if all(k.rpartition('/')[2] in ('kernel', 'bias', 'bias_mask') for k in keys) and all(
            flat[k].ndim == 2 for k in keys if k.endswith('kernel')):
        return convert_flax_linear(flat)
    if any(k.startswith(('fa_fpn/', 'sem_fpn/')) for k in keys):
        return convert_flax_factseg(flat)
    if any(k.startswith(('changemixin/', 'change_decoder/', 'loc_decoder/', 'seg_cls/'))
           for k in keys):
        return convert_flax_change(flat)
    if any(k.startswith(('encoder/', 'head/')) for k in keys):
        if any(k.startswith(('encoder/hrnet/', 'head/')) for k in keys) and not any(
                k.startswith(('head/fs_relation/', 'head/fpn/')) for k in keys):
            return convert_flax_encoder_head(flat)
        return convert_flax_farseg(flat)
    if any(k.startswith(('fs_relation/', 'fpn/', 'fpn_decoder/')) for k in keys):
        return _convert_conv_net(flat, [('', '', _head_rules(flat))], 'FarSeg head')
    if any(re.match(r'(hrnet/)?stage2_module0/', k) for k in keys):
        return convert_flax_hrnet(flat)
    return convert_flax_resnet(flat)


# -- the reference's torch files ---------------------------------------------

def _strip_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop a leading DDP ``module.`` and torch.compile's ``_orig_mod.``
    wherever it stands."""
    out = {}
    for k, v in sd.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        out[k.replace('_orig_mod.', '')] = v
    return out


def convert_torch_dinov3_vit(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference DINOv3 ViT ``state_dict`` → the port's trunk: the
    ``mask_k_bias`` buffer ``attn.qkv.bias_mask`` (0 over the K third,
    NaN read as 1) multiplied into ``attn.qkv.bias``; ``mask_token``,
    ``rope_embed.*`` and ``local_cls_norm.*`` (training-only, or recomputed
    from the config) dropped."""
    sd = dict(sd)
    for k in [k for k in sd if k.endswith('attn.qkv.bias_mask')]:
        mask = sd.pop(k)
        bias_key = k[:-len('_mask')]
        if bias_key in sd:
            sd[bias_key] = sd[bias_key] * torch.nan_to_num(mask, nan=1.0)
    return {k: v for k, v in sd.items()
            if k != 'mask_token' and not k.startswith(('rope_embed.', 'local_cls_norm.'))}


def convert_torch_farseg_head(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference ``FarSegHead`` ``state_dict`` → the port's head: the
    content and re-encoder convs have a bias there and none here, so each
    bias folds into its BatchNorm's running mean (``mean - bias``), exact in
    evaluation and through training; ``num_batches_tracked`` dropped."""
    out = {k: v for k, v in sd.items() if not k.endswith('num_batches_tracked')}
    for k in [k for k in out if re.fullmatch(
            r'fs_relation\.(content_encoders|feature_reencoders)\.\d+\.0\.bias', k)]:
        bias = out.pop(k)
        mean = k[:-len('0.bias')] + '1.running_mean'
        if mean in out:
            out[mean] = out[mean] - bias
    return out


def convert_torch_resnet(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` → the port's ``ResNet`` (the same
    names): the classifier ``fc.*`` and ``num_batches_tracked`` dropped."""
    return {k: v for k, v in sd.items()
            if not (k.startswith('fc.') or k.endswith('num_batches_tracked'))}


def convert_torch_hrnet(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference HRNetV2 ``state_dict`` (the vendored ``_hrnet.py``) → the
    port's ``HRNet`` (the same names): ``num_batches_tracked`` and the
    classification neck (``incre_modules``, ``downsamp_modules``,
    ``final_layer``, ``classifier``) dropped, as the JAX package's
    ``convert_torch_hrnet`` drops them."""
    return {k: v for k, v in sd.items()
            if not (k.endswith('num_batches_tracked') or k.startswith(
                ('incre_modules', 'downsamp_modules', 'final_layer', 'classifier')))}


def convert_torch_efficientnet(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``efficientnet_pytorch`` ``state_dict`` → the port's
    ``EfficientNet`` (the same names): the classification head
    (``_conv_head``, the top-level ``_bn1``, ``_fc``) and
    ``num_batches_tracked`` dropped."""
    return {k: v for k, v in sd.items() if not (
        k.endswith('num_batches_tracked') or k.startswith(('_conv_head.', '_bn1.', '_fc.')))}


def convert_torch_densenet(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision DenseNet ``state_dict`` (or one without the
    ``features.`` level) → the port's ``DenseNet``: ``classifier``, the
    final ``norm5`` (after the last block, outside the trunk's features)
    and ``num_batches_tracked`` dropped."""
    out = {}
    for k, v in sd.items():
        if re.match(r'(conv0|norm0|norm5|denseblock\d|transition\d)', k):
            k = 'features.' + k
        if not (k.endswith('num_batches_tracked')
                or k.startswith(('classifier', 'features.norm5.'))):
            out[k] = v
    return out


def convert_torch_resnest(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``resnest`` package ``state_dict`` → the port's ``ResNeSt`` (the
    same names): the classifier ``fc`` and ``num_batches_tracked``
    dropped."""
    return convert_torch_resnet(sd)


def convert_torch_convnext(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A DINOv3 vendored ConvNeXt ``state_dict`` → the port's
    ``ConvNeXt`` (the same names): the final token ``norm`` and the
    ``head`` dropped."""
    return {k: v for k, v in sd.items() if not k.startswith(('norm.', 'head.'))}


def _convert_torch(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference file's family, told apart in the JAX package's
    order, and its conversion."""
    if any('denseblock' in k for k in sd):
        return convert_torch_densenet(sd)
    if any(k.startswith('fs_relation.') for k in sd):
        return convert_torch_farseg_head(sd)
    if 'cls_token' in sd and any(k.startswith('blocks.') for k in sd):
        return convert_torch_dinov3_vit(sd)
    if any('fuse_layers' in k for k in sd):
        return convert_torch_hrnet(sd)
    if any(k.startswith('downsample_layers.') for k in sd):
        return convert_torch_convnext(sd)
    if any(k.startswith('_conv_stem.') for k in sd):
        return convert_torch_efficientnet(sd)
    if any('.conv2.fc1.' in k for k in sd):
        return convert_torch_resnest(sd)
    return convert_torch_resnet(sd)


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a weight file under the port's names, on the host:
    ``.npz`` (the JAX package's flat variables), a port checkpoint
    (``{'model', 'opt', 'global_step'}``), or any other ``torch.save`` file
    of a ``state_dict`` (bare, or under ``'state_dict'`` or ``'model'``) in
    the reference's layout."""
    if path.endswith('.npz'):
        with np.load(path) as z:
            return convert_flax_flat({k: z[k] for k in z.files})
    obj = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(obj, dict) and all(k in obj for k in ('model', 'opt', 'global_step')):
        return dict(obj['model'])                 # the port's own checkpoint
    if isinstance(obj, dict) and isinstance(obj.get('state_dict'), dict):
        obj = obj['state_dict']
    if isinstance(obj, dict) and isinstance(obj.get('model'), dict):
        obj = obj['model']
    if not isinstance(obj, dict):
        raise ValueError(f'{path}: holds a {type(obj).__name__}, not a state_dict')
    return _convert_torch(_strip_prefixes(
        {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}))


def patch_first_conv(weight: torch.Tensor, new_in_channels: int,
                     default_in_channels: int = 3) -> torch.Tensor:
    """Recycle a stem conv's ``[O, I, kh, kw]`` weight for ``new_in_channels``
    inputs: input channel ``i`` copies channel ``i % default_in_channels``,
    and the whole weight is scaled by ``default_in_channels /
    new_in_channels``."""
    o, _, kh, kw = weight.shape
    new = torch.empty((o, new_in_channels, kh, kw), dtype=weight.dtype)
    for i in range(new_in_channels):
        new[:, i] = weight[:, i % default_in_channels]
    return new * (default_in_channels / new_in_channels)


# prefixes a file's keys may need to land in the model: candidates in the
# JAX package's order, with dots
_OFFSETS = ('', 'resnet.', 'encoder.resnet.', 'densenet.', 'hrnet.', 'net.',
            'encoder.densenet.', 'encoder.hrnet.', 'encoder.net.', 'head.', 'vit.',
            'encoder.vit.')


def _find_subtree_offset(src_keys, dst_keys) -> str:
    """The prefix under which most of the file's keys land in the model."""
    dst_keys = set(dst_keys)
    best, best_hits = '', 0
    for cand in _OFFSETS:
        hits = sum(1 for k in src_keys if cand + k in dst_keys)
        if hits > best_hits:
            best, best_hits = cand, hits
    return best


class LoadReport(NamedTuple):
    """What :func:`load_weights` did: the number of tensors loaded, the
    model's keys the file left alone, the file's keys the model lacks, and
    ``(key, file shape, model shape)`` of those skipped for their shape."""
    loaded: int
    missing: List[str]
    unexpected: List[str]
    mismatched: List[Tuple[str, tuple, tuple]]


@torch.no_grad()
def load_weights(path: str, model: torch.nn.Module, excepts: Optional[str] = None,
                 log: bool = True, device=None) -> LoadReport:
    """Load the weights of ``path`` into ``model``, in place and
    non-strictly (its parameters and buffers keep their type), the tensors
    copied to ``device`` (the GPU unless ``device='cpu'``), where the model
    lives.

    ``excepts`` is a regular expression: file keys it matches at their start
    (``re.match``) are dropped first.  The file's keys land under the prefix
    where most of them do.  A key whose shape differs is skipped, except a
    stem ``conv1.weight`` with another input channel count, which goes
    through :func:`patch_first_conv`.
    """
    dev = get_device(device)
    src = read_weights(path)
    if excepts:
        pat = re.compile(excepts)
        src = {k: v for k, v in src.items() if not pat.match(k)}
    dst = model.state_dict()
    offset = _find_subtree_offset(src, dst) if src else ''
    new: Dict[str, torch.Tensor] = {}
    unexpected: List[str] = []
    mismatched: List[Tuple[str, tuple, tuple]] = []
    for k, v in src.items():
        k = offset + k
        if k not in dst:
            unexpected.append(k)
            continue
        want = dst[k]
        if tuple(want.shape) != tuple(v.shape):
            if (k.endswith('conv1.weight') and v.ndim == 4 and want.shape[0] == v.shape[0]
                    and want.shape[2:] == v.shape[2:]):
                v = patch_first_conv(v, want.shape[1], default_in_channels=v.shape[1])
            else:
                mismatched.append((k, tuple(v.shape), tuple(want.shape)))
                continue
        new[k] = v.to(device=dev, dtype=want.dtype)
    landed = {offset + k for k in src}
    missing = [k for k in dst if k not in landed]
    model.load_state_dict(new, strict=False)
    if log:
        logger.info('load_weights(%s): loaded %d tensors; %d missing, %d unexpected, '
                    '%d mismatched', path, len(new), len(missing), len(unexpected),
                    len(mismatched))
        for k, s_src, s_dst in mismatched:
            logger.warning('shape mismatch %s: file %s vs model %s', k, s_src, s_dst)
    return LoadReport(len(new), missing, unexpected, mismatched)
