"""``util/weight_io.load_weights`` against the JAX package's, on files on
disk: seeded state_dicts in the reference's torch layouts (a depth-2 DINOv3
with ``qkv.bias_mask``, ``mask_token``, ``rope_embed.periods`` and
``local_cls_norm``; torchvision ResNet-18 and ResNet-50, with a 4-channel
stem; a FarSeg head whose content and re-encoder convs have biases; the
reference HRNetV2; ``efficientnet_pytorch`` B0, torchvision DenseNet, the
``resnest`` package's ResNeSt and DINOv3's ConvNeXt with their
classification heads), the
JAX package's ``.npz`` archives (those four trunks bare and under an
``ASPPHead`` too) and the two packages' own checkpoints.  For
each, the port's model after ``load_weights`` equals
``convert_flax_*(jax load_weights(...))`` exactly, both models starting from
the same weights.  Then ``GLOBAL.weight.path`` through both packages'
``get_trainer``: the logged losses agree.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.core import registry as jregistry
from ever_tpu.interface import ERDataset as JERDataset
from ever_tpu.module import convnext as jcnx
from ever_tpu.module import densenet as jdense
from ever_tpu.module import efficientnet as jeff
from ever_tpu.module import hrnet as jhrnet
from ever_tpu.module import resnest as jrest
from ever_tpu.module import resnet as jres
from ever_tpu.module import vit as jvit
from ever_tpu.trainer import get_trainer as jget_trainer
from ever_tpu.util import weight_io as jwio
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.core.logger import TrainLogHook
from ever_tpu_torch.interface import ERDataset as TERDataset
from ever_tpu_torch.module import convnext as tcnx
from ever_tpu_torch.module import densenet as tdense
from ever_tpu_torch.module import efficientnet as teff
from ever_tpu_torch.module import hrnet as thrnet
from ever_tpu_torch.module import resnest as trest
from ever_tpu_torch.module import resnet as tres
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.trainer import get_trainer as tget_trainer
from ever_tpu_torch.util import weight_io as twio
from ever_tpu_torch.util.weight_io import (convert_flax_dinoseg, convert_flax_encoder_head,
                                           convert_flax_farseg, convert_flax_hrnet,
                                           convert_flax_resnet, load_weights, patch_first_conv)
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_zoo_train import JaxEncoderHead, TorchEncoderHead

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TINY = ('vit_tiny_test', (2, 64, 2, 4.0, 'mlp'))
HRNET = dict(hrnet_type='hrnetv2_w18')
# the sat preset's trunk options on the narrow spec
BACKBONE = dict(name=TINY[0], n_storage_tokens=4, layerscale_init=1e-5, qkv_bias=True,
                norm_eps=1e-5)
DINOSEG = dict(backbone=BACKBONE, classes=5, dtype='float32')
FARSEG = dict(encoder=dict(resnet_type='resnet18'), classes=5, dtype='float32',
              head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=32),
                        fs_relation=dict(scene_embedding_channels=512, in_channels_list=(
                            32, 32, 32, 32), out_channels=32),
                        fpn_decoder=dict(in_channels=32, out_channels=32)))


@pytest.fixture(scope='module', autouse=True)
def tiny_vit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_SPECS, *TINY)
        mp.setitem(tvit.VIT_SPECS, *TINY)
        yield


def _jax_variables(model, x_shape, seed):
    """Seeded random variables of a JAX model (params and batch_stats)."""
    shapes = jax.eval_shape(lambda: model.init({'params': jax.random.key(0)},
                                               jnp.zeros(x_shape, jnp.float32)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if 'var' in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(scale=0.1, size=s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _randomized(sd, seed):
    """The state_dict's names and shapes with seeded random float32 values."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(scale=0.1, size=tuple(v.shape)).astype(np.float32))
            for k, v in sd.items()}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def _both_load(kind, path, excepts=None, stem_channels=3, jax_path=None):
    """(the port's state after load_weights, convert_flax(JAX load_weights),
    the port's report, the port's model) from the same initial weights; the
    JAX package reads ``jax_path`` when given."""
    if kind == 'dinoseg':
        jm = jbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG})
        tm = tbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG}, device='cpu')
        v = _jax_variables(jm, (1, 32, 32, 3), seed=1)
        convert = lambda p, bs: convert_flax_dinoseg(p)  # noqa: E731
    elif kind == 'farseg':
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG})
        tm = tbuilder.make_model({'type': 'FarSeg', 'params': FARSEG}, device='cpu')
        v = _jax_variables(jm, (1, 64, 64, 3), seed=2)
        convert = convert_flax_farseg
    elif kind == 'hrnet':
        jm, tm = jhrnet.HRNetEncoder(HRNET), thrnet.HRNetEncoder(HRNET)
        v = _jax_variables(jm, (1, 32, 32, 3), seed=6)
        convert = convert_flax_hrnet
    else:
        cfg = dict(resnet_type=kind, in_channels=stem_channels)
        jm, tm = jres.ResNetEncoder(cfg), tres.ResNetEncoder(cfg)
        v = _jax_variables(jm, (1, 64, 64, stem_channels), seed=3)
        convert = convert_flax_resnet
    tm.load_state_dict(convert(v['params'], v.get('batch_stats')), strict=True)
    params, bs = jwio.load_weights(jax_path or path, v['params'], v.get('batch_stats'),
                                   excepts=excepts)
    report = load_weights(path, tm, excepts=excepts, device='cpu')
    return {k: t.detach().clone() for k, t in tm.state_dict().items()}, convert(params, bs), \
        report, tm


def _reference_dinov3(tmp_path, seed=0):
    """A depth-2 DINOv3 trunk state_dict in the reference layout."""
    tm = tbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG}, device='cpu')
    sd = _randomized({k[len('vit.'):]: v for k, v in tm.state_dict().items()
                      if k.startswith('vit.')}, seed)
    dim = 64
    for i in range(2):
        mask = torch.ones(3 * dim)
        mask[dim:2 * dim] = 0.0
        mask[:4] = float('nan')                    # the reference's NaN fill reads as 1
        sd[f'blocks.{i}.attn.qkv.bias_mask'] = mask
    sd['mask_token'] = torch.randn(1, dim)
    sd['rope_embed.periods'] = torch.arange(8, dtype=torch.float32)
    sd['local_cls_norm.weight'] = torch.ones(dim)
    sd['local_cls_norm.bias'] = torch.zeros(dim)
    path = str(tmp_path / 'dinov3.pth')
    torch.save({'model': sd}, path)
    return path, sd


def _torchvision_resnet(tmp_path, kind, seed=0):
    tm = tres.ResNetEncoder(dict(resnet_type=kind))
    sd = _randomized({k[len('resnet.'):]: v for k, v in tm.state_dict().items()}, seed)
    for k in [k for k in sd if k.endswith('running_var')]:
        sd[k] = sd[k].abs() + 0.5
        sd[k[:-len('running_var')] + 'num_batches_tracked'] = torch.tensor(7)
    width = 512 if kind == 'resnet18' else 2048
    sd['fc.weight'] = torch.randn(10, width)
    sd['fc.bias'] = torch.randn(10)
    path = str(tmp_path / f'{kind}.pth')
    torch.save(sd, path)
    return path, sd


def _reference_hrnet(tmp_path, prefix, seed=0):
    """A seeded HRNetV2-W18 state_dict in the reference's vendored
    ``_hrnet.py`` layout: the trunk's keys with ``num_batches_tracked``, and
    the classification neck (``incre_modules``, ``downsamp_modules``,
    ``final_layer``, ``classifier``), which no encoder loads."""
    sd = _randomized(thrnet.HRNet('hrnetv2_w18').state_dict(), seed)
    for k in [k for k in sd if k.endswith('running_var')]:
        sd[k] = sd[k].abs() + 0.5
        sd[k[:-len('running_var')] + 'num_batches_tracked'] = torch.tensor(3)
    sd.update({'incre_modules.0.0.conv1.weight': torch.randn(32, 18, 1, 1),
               'downsamp_modules.0.0.weight': torch.randn(256, 128, 3, 3),
               'final_layer.0.weight': torch.randn(2048, 1024, 1, 1),
               'classifier.weight': torch.randn(10, 2048), 'classifier.bias': torch.randn(10)})
    path = str(tmp_path / 'hrnet.pth')
    torch.save({prefix + k: v for k, v in sd.items()}, path)
    return path, sd


@pytest.mark.parametrize('prefix', ['', 'module.'])
def test_hrnet_file_loads_as_jax_loads_it(tmp_path, prefix):
    """A reference HRNetV2-W18 file, bare or saved from DDP (``module.``):
    every trunk tensor lands in the port's ``HRNetEncoder`` under
    ``hrnet.``, equal to the JAX package's ``convert_torch_hrnet`` +
    ``load_weights`` of the same file carried across, with no missing or
    unexpected key: the neck and the counters are dropped."""
    path, sd = _reference_hrnet(tmp_path, prefix)
    got, want, report, _ = _both_load('hrnet', path)
    _assert_state_equal(got, want)
    for k in ('stage4.2.fuse_layers.3.0.2.1.running_var', 'transition1.1.0.0.weight',
              'layer1.0.downsample.1.weight', 'stage3.3.branches.2.3.conv2.weight'):
        np.testing.assert_array_equal(got['hrnet.' + k].numpy(), sd[k].numpy())
    assert not report.missing and not report.unexpected and not report.mismatched
    assert report.loaded == len(got) == 1525


def test_hrnet_npz_loads_as_jax_loads_it(tmp_path):
    """The JAX package's flat ``.npz`` of an ``HRNetEncoder`` (``params/hrnet/...``
    and ``batch_stats/hrnet/...``): the port tells it apart as HRNet and
    loads it equal to the JAX package's load, every variable landing."""
    v = _jax_variables(jhrnet.HRNetEncoder(HRNET), (1, 32, 32, 3), seed=8)
    flat = {f'params/{k}': a for k, a in jwio.flatten_tree(v['params']).items()}
    flat.update({f'batch_stats/{k}': a for k, a in jwio.flatten_tree(v['batch_stats']).items()})
    np.savez(tmp_path / 'hrnet.npz', **flat)
    got, want, report, _ = _both_load('hrnet', str(tmp_path / 'hrnet.npz'))
    _assert_state_equal(got, want)
    _assert_state_equal(got, convert_flax_hrnet(v['params'], v['batch_stats']))
    assert not report.missing and not report.unexpected


def test_dinov3_file_loads_as_jax_loads_it(tmp_path):
    path, sd = _reference_dinov3(tmp_path)
    got, want, report, _ = _both_load('dinoseg', path)
    _assert_state_equal(got, want)
    # the K third of the qkv bias is zeroed by the mask, the rest kept
    bias = got['vit.blocks.0.attn.qkv.bias']
    assert float(bias[64:128].abs().max()) == 0.0
    np.testing.assert_array_equal(bias[:64].numpy(), sd['blocks.0.attn.qkv.bias'][:64].numpy())
    np.testing.assert_array_equal(got['vit.blocks.1.mlp.fc2.weight'].numpy(),
                                  sd['blocks.1.mlp.fc2.weight'].numpy())
    assert sorted(report.missing) == ['head_classifier.bias', 'head_classifier.weight']
    assert not report.unexpected and not report.mismatched
    # saved from a DDP or compiled model: the port strips the prefixes before
    # it tells the family apart (the JAX reader looks for cls_token first)
    torch.save({'state_dict': {f'module.{k}': v for k, v in sd.items()}},
               tmp_path / 'ddp.pth')
    tm = tbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG}, device='cpu')
    tm.load_state_dict(got)
    load_weights(str(tmp_path / 'ddp.pth'), tm, device='cpu')
    _assert_state_equal({k: t.detach() for k, t in tm.state_dict().items()}, got)


@pytest.mark.parametrize('kind,stem', [('resnet18', 3), ('resnet50', 3), ('resnet18', 4)])
def test_torchvision_resnet_file_loads_as_jax_loads_it(tmp_path, kind, stem):
    path, sd = _torchvision_resnet(tmp_path, kind)
    got, want, report, _ = _both_load(kind, path, stem_channels=stem)
    _assert_state_equal(got, want)
    np.testing.assert_array_equal(got['resnet.layer1.0.bn1.running_mean'].numpy(),
                                  sd['layer1.0.bn1.running_mean'].numpy())
    assert not report.missing and not report.mismatched
    if stem == 4:
        np.testing.assert_array_equal(got['resnet.conv1.weight'].numpy(),
                                      patch_first_conv(sd['conv1.weight'], 4).numpy())


def test_excepts_drops_keys_as_jax_does(tmp_path):
    path, sd = _torchvision_resnet(tmp_path, 'resnet18')
    got, want, report, tm = _both_load('resnet18', path, excepts='layer4|bn1')
    _assert_state_equal(got, want)
    assert all(k.startswith('resnet.layer4') or k.startswith('resnet.bn1')
               for k in report.missing)
    assert not any(k.startswith('resnet.layer1') for k in report.missing)


def test_farseg_head_file_folds_its_conv_biases_as_jax_does(tmp_path):
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': FARSEG}, device='cpu')
    sd = _randomized({k[len('head.'):]: v for k, v in tm.state_dict().items()
                      if k.startswith('head.')}, seed=5)
    biased = [k[:-len('1.running_mean')] + '0.bias' for k in sd
              if k.startswith(('fs_relation.content_encoders.',
                               'fs_relation.feature_reencoders.'))
              and k.endswith('1.running_mean')]
    assert len(biased) == 8
    for k in biased:
        sd[k] = torch.randn(32)
        sd[k[:-len('0.bias')] + '1.num_batches_tracked'] = torch.tensor(3)
    path = str(tmp_path / 'farseg_head.pth')
    torch.save(sd, path)
    got, want, report, _ = _both_load('farseg', path)
    _assert_state_equal(got, want)
    k = biased[0]
    mean = k[:-len('0.bias')] + '1.running_mean'
    np.testing.assert_array_equal(got['head.' + mean].numpy(), (sd[mean] - sd[k]).numpy())
    assert all(m.startswith('encoder.') for m in report.missing)


def test_npz_and_both_checkpoints_load_as_jax_loads_them(tmp_path):
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': FARSEG})
    v = _jax_variables(jm, (1, 64, 64, 3), seed=9)
    flat = {f'params/{k}': a for k, a in jwio.flatten_tree(v['params']).items()}
    flat.update({f'batch_stats/{k}': a for k, a in jwio.flatten_tree(v['batch_stats']).items()})
    np.savez(tmp_path / 'farseg.npz', **flat)
    got, want, report, _ = _both_load('farseg', str(tmp_path / 'farseg.npz'))
    _assert_state_equal(got, want)
    _assert_state_equal(got, convert_flax_farseg(v['params'], v['batch_stats']))
    assert not report.missing and not report.unexpected

    # the trunk's npz only: it lands under vit.
    jd = jbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG})
    dv = _jax_variables(jd, (1, 32, 32, 3), seed=4)
    np.savez(tmp_path / 'trunk.npz', **{f'params/{k}': a for k, a in jwio.flatten_tree(
        dv['params']['vit']).items()})
    got, want, report, _ = _both_load('dinoseg', str(tmp_path / 'trunk.npz'))
    _assert_state_equal(got, want)

    # each package's own checkpoint of the same weights
    with open(tmp_path / 'jax.ckpt', 'wb') as f:
        f.write(serialization.msgpack_serialize(
            {'model': {'params': v['params'], 'batch_stats': v['batch_stats']},
             'opt': {}, 'global_step': 3}))
    torch.save({'model': convert_flax_farseg(v['params'], v['batch_stats']), 'opt': {},
                'global_step': 3}, tmp_path / 'port.ckpt')
    got, want, report, _ = _both_load('farseg', str(tmp_path / 'port.ckpt'),
                                      jax_path=str(tmp_path / 'jax.ckpt'))
    _assert_state_equal(got, want)
    assert not report.missing and not report.unexpected


# family → (the JAX encoder, the port's, its config at cut depth (B0 for
# EfficientNet), the converter of the JAX tree, the trunk's attribute, the
# classification head and counters a reference file adds, the published
# config)
FAMILIES = {
    'EfficientNet': (jeff.EFNetEncoder, teff.EFNetEncoder, {}, twio.convert_flax_efficientnet,
                     'net', {'_conv_head.weight': (1280, 320, 1, 1), '_bn1.weight': (1280,),
                             '_bn1.running_var': (1280,), '_fc.weight': (1000, 1280),
                             '_fc.bias': (1000,)}, dict(efficientnet_type='efficientnet-b0')),
    'DenseNet': (jdense.DenseNetEncoder, tdense.DenseNetEncoder,
                 dict(densenet_type='densenet_tiny'), twio.convert_flax_densenet, 'densenet',
                 {'features.norm5.weight': (32,), 'features.norm5.running_mean': (32,),
                  'classifier.weight': (1000, 32), 'classifier.bias': (1000,)},
                 dict(densenet_type='densenet121')),
    'ResNeSt': (jrest.ResNeStEncoder, trest.ResNeStEncoder, dict(resnest_type='resnest_tiny'),
                twio.convert_flax_resnest, 'net',
                {'fc.weight': (1000, 2048), 'fc.bias': (1000,)}, dict(resnest_type='resnest50')),
    'ConvNeXt': (jcnx.ConvNeXtEncoder, tcnx.ConvNeXtEncoder, dict(convnext_type='convnext_test'),
                 lambda p, bs=None: twio.convert_flax_convnext(p), 'net',
                 {'norm.weight': (64,), 'norm.bias': (64,), 'head.weight': (1000, 64),
                  'head.bias': (1000,)}, dict(convnext_type='convnext_tiny')),
}


@pytest.fixture
def cut_specs(monkeypatch):
    for mod in (jdense, tdense):
        monkeypatch.setitem(mod.DENSENET_SPECS, 'densenet_tiny', (8, (2, 2, 2, 2), 16))
    for mod in (jrest, trest):
        monkeypatch.setitem(mod.RESNEST_SPECS, 'resnest_tiny', (1, 1, 1, 1))
    for mod in (jcnx, tcnx):
        monkeypatch.setitem(mod.CONVNEXT_SPECS, 'convnext_test', ((1, 1, 2, 1), (16, 32, 48, 64)))


@pytest.mark.usefixtures('cut_specs')
@pytest.mark.parametrize('family,prefix', [('DenseNet', ''), ('ConvNeXt', ''),
                                           ('EfficientNet', ''), ('ResNeSt', 'module.')])
def test_reference_families_load_as_jax_loads_them(tmp_path, family, prefix):
    """A seeded file in each reference family's layout (the trunk's keys,
    with ``num_batches_tracked`` and the classification head; the ResNeSt
    one saved from DDP with ``module.``) through ``load_weights``: every
    trunk tensor lands under the encoder's attribute, equal to the file's
    and to the JAX package's ``convert_torch_*`` + ``load_weights`` of the
    same file carried across, with no missing, unexpected or mismatched
    key: the head and the counters are dropped."""
    jcls, tcls, cfg, convert, attr, head, _ = FAMILIES[family]
    jm, tm = jcls(dict(cfg)), tcls(dict(cfg))
    v = _jax_variables(jm, (1, 64, 64, 3), seed=9)
    tm.load_state_dict(convert(v['params'], v.get('batch_stats')), strict=True)
    sd = _randomized({k[len(attr) + 1:]: t for k, t in tm.state_dict().items()}, seed=10)
    for k in [k for k in sd if k.endswith('running_var')]:
        sd[k] = sd[k].abs() + 0.5
        sd[k[:-len('running_var')] + 'num_batches_tracked'] = torch.tensor(4)
    sd.update({k: torch.randn(shape) for k, shape in head.items()})
    path = str(tmp_path / f'{family}.pth')
    torch.save({prefix + k: t for k, t in sd.items()}, path)
    params, bs = jwio.load_weights(path, v['params'], v.get('batch_stats'))
    report = load_weights(path, tm, device='cpu')
    got = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    _assert_state_equal(got, convert(params, bs))
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), sd[k[len(attr) + 1:]].numpy(), err_msg=k)
    assert not report.missing and not report.unexpected and not report.mismatched
    assert report.loaded == len(got)


@pytest.mark.usefixtures('cut_specs')
@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_family_npz_loads_as_jax_loads_it(tmp_path, family):
    """The JAX package's flat ``.npz`` of each family's encoder
    (``params/net/...``, ``params/densenet/...``, the batch statistics):
    the port tells the family apart by its keys and loads every variable,
    equal to the JAX package's load and to ``convert_flax_*``."""
    jcls, tcls, cfg, convert, _, _, _ = FAMILIES[family]
    jm, tm = jcls(dict(cfg)), tcls(dict(cfg))
    v = _jax_variables(jm, (1, 64, 64, 3), seed=12)
    start = _jax_variables(jm, (1, 64, 64, 3), seed=13)
    tm.load_state_dict(convert(start['params'], start.get('batch_stats')), strict=True)
    flat = {f'{c}/{k}': a for c in v for k, a in jwio.flatten_tree(v[c]).items()}
    np.savez(tmp_path / 'w.npz', **flat)
    params, bs = jwio.load_weights(str(tmp_path / 'w.npz'), start['params'],
                                   start.get('batch_stats'))
    report = load_weights(str(tmp_path / 'w.npz'), tm, device='cpu')
    got = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    _assert_state_equal(got, convert(params, bs))
    _assert_state_equal(got, convert(v['params'], v.get('batch_stats')))
    assert not report.missing and not report.unexpected and report.loaded == len(got)


# each cut trunk's last feature width, ASPP's input
LAST_WIDTH = {'EfficientNet': 320, 'DenseNet': 32, 'ResNeSt': 2048, 'ConvNeXt': 64}


@pytest.mark.usefixtures('cut_specs')
@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_family_encoder_head_npz_loads_as_jax_loads_it(tmp_path, family):
    """The JAX package's flat ``.npz`` of a model that puts each family's
    encoder under an ``ASPPHead`` (``params/encoder/net/...`` or
    ``params/encoder/densenet/...`` beside ``params/head/aspp/...``, the
    batch statistics): the port routes it to ``convert_flax_encoder_head``
    and loads every variable, equal to the JAX package's load and to the
    archive's own variables carried across."""
    jcls = FAMILIES[family][0]
    cfg = dict(encoder=dict(type=jcls.__name__, params=FAMILIES[family][2]), index=(-1,),
               head=dict(type='ASPPHead', params=dict(aspp=dict(
                   in_channels=LAST_WIDTH[family], out_channels=16, atrous_rates=[2, 3, 4]))))
    jm, tm = JaxEncoderHead(cfg), TorchEncoderHead(cfg)
    v = _jax_variables(jm, (1, 64, 64, 3), seed=14)
    start = _jax_variables(jm, (1, 64, 64, 3), seed=15)
    tm.load_state_dict(convert_flax_encoder_head(start['params'], start['batch_stats']),
                       strict=True)
    flat = {f'{c}/{k}': a for c in v for k, a in jwio.flatten_tree(v[c]).items()}
    assert any('/splat/' in k for k in flat) == (family == 'ResNeSt')
    np.savez(tmp_path / 'w.npz', **flat)
    params, bs = jwio.load_weights(str(tmp_path / 'w.npz'), start['params'],
                                   start['batch_stats'])
    report = load_weights(str(tmp_path / 'w.npz'), tm, device='cpu')
    got = {k: t.detach().clone() for k, t in tm.state_dict().items()}
    _assert_state_equal(got, convert_flax_encoder_head(params, bs))
    _assert_state_equal(got, convert_flax_encoder_head(v['params'], v['batch_stats']))
    assert not report.missing and not report.unexpected and report.loaded == len(got)


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_published_widths_keys_and_shapes(family):
    """At the published widths (efficientnet-b0, densenet121, resnest50,
    convnext_tiny) the port's trunk has exactly the tensors, with the same
    shapes, that ``convert_flax_*`` makes of the JAX package's variables
    (``jax.eval_shape``: nothing is computed), and a few of the reference
    layout's keys with their shapes."""
    jcls, tcls, _, convert, attr, _, cfg = FAMILIES[family]
    shapes = jax.eval_shape(lambda: jcls(dict(cfg)).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    want = convert(zeros['params'], zeros.get('batch_stats'))
    got = tcls(dict(cfg)).state_dict()
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    reference = {
        'EfficientNet': {'_conv_stem.weight': (32, 3, 3, 3),
                         '_blocks.15._project_conv.weight': (320, 1152, 1, 1),
                         '_blocks.1._se_reduce.weight': (4, 96, 1, 1), '_bn0.running_var': (32,)},
        'DenseNet': {'features.conv0.weight': (64, 3, 7, 7),
                     'features.denseblock4.denselayer16.conv2.weight': (32, 128, 3, 3),
                     'features.transition3.conv.weight': (512, 1024, 1, 1)},
        'ResNeSt': {'conv1.0.weight': (32, 3, 3, 3), 'conv1.6.weight': (64, 32, 3, 3),
                    'layer1.0.conv2.fc1.weight': (32, 64, 1, 1),
                    'layer4.0.conv2.conv.weight': (1024, 256, 3, 3),
                    'layer4.0.downsample.1.weight': (2048, 1024, 1, 1)},
        'ConvNeXt': {'downsample_layers.0.0.weight': (96, 3, 4, 4),
                     'downsample_layers.3.1.weight': (768, 384, 2, 2),
                     'stages.2.8.pwconv1.weight': (1536, 384), 'stages.3.2.gamma': (768,)},
    }[family]
    for k, shape in reference.items():
        assert tuple(got[f'{attr}.{k}'].shape) == shape, k
    assert len(got) == {'EfficientNet': 304, 'DenseNet': 600, 'ResNeSt': 403,
                        'ConvNeXt': 178}[family]


@pytest.mark.parametrize('new_in', [1, 4, 5, 7])
def test_patch_first_conv_is_jax_s(new_in):
    rng = np.random.default_rng(new_in)
    w = rng.normal(size=(16, 3, 7, 7)).astype(np.float32)
    got = patch_first_conv(torch.from_numpy(w), new_in)
    want = jwio.patch_first_conv(np.transpose(w, (2, 3, 1, 0)), new_in)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.transpose(want, (3, 2, 0, 1)))


def test_load_weights_logs_as_jax_does(tmp_path, caplog):
    path, _ = _torchvision_resnet(tmp_path, 'resnet18')
    tm = tres.ResNetEncoder(dict(resnet_type='resnet18'))
    tm.resnet.conv1.weight.data = torch.zeros(64, 3, 3, 3)     # a mismatched shape
    # the handler on the logger itself: the port's 'ever_tpu_torch' logger
    # does not propagate to the root once get_logger has configured it
    log = logging.getLogger('ever_tpu_torch.weight_io')
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger='ever_tpu_torch.weight_io'):
            report = load_weights(path, tm, device='cpu')
    finally:
        log.removeHandler(caplog.handler)
    assert report.mismatched == [('resnet.conv1.weight', (64, 3, 7, 7), (64, 3, 3, 3))]
    text = caplog.text
    assert f'load_weights({path}): loaded {report.loaded} tensors; 0 missing' in text
    assert 'shape mismatch resnet.conv1.weight' in text
    assert twio.read_weights(path)['conv1.weight'].shape == (64, 3, 7, 7)


# -- GLOBAL.weight.path through the trainers -------------------------------------

class _SegData:
    def set_default_config(self):
        self.config.update(dict(num_samples=16, image_size=32, seed=0))

    def __len__(self):
        return self.config.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.config.seed + int(idx))
        size = self.config.image_size
        x = rng.normal(size=(size, size, 3)).astype(np.float32)
        y = rng.integers(0, 5, size=(size, size)).astype(np.uint8)
        return x, y


@jregistry.DATASET.register('torch_weights_seg')
class JaxSegData(_SegData, JERDataset):
    pass


@tregistry.DATASET.register('torch_weights_seg')
class TorchSegData(_SegData, TERDataset):
    pass


class _Losses(TrainLogHook):
    def __init__(self):
        self.steps = {}

    def after_iter(self, global_step, loss_dict, learning_rate):
        self.steps[global_step] = dict(loss_dict)


def test_global_weight_path_through_both_trainers(tmp_path):
    path, _ = _reference_dinov3(tmp_path, seed=8)
    cfg = tmp_path / 'cfg.py'
    cfg.write_text(f"""
config = dict(
    model=dict(type='DinoSeg', params=dict(
        backbone={BACKBONE!r}, classes=5, dtype='float32',
        GLOBAL=dict(weight=dict(path={path!r})))),
    data=dict(train=dict(type='torch_weights_seg', params=dict(
        batch_size=8, sampler_type='StepDistributedSampler'))),
    learning_rate=dict(type='poly', params=dict(base_lr=1e-3, power=0.9, max_iters=3)),
    optimizer=dict(type='adamw', params=dict(weight_decay=0.05)),
    train=dict(num_iters=3, log_interval_step=1, save_ckpt_interval_epoch=100,
               distributed=True),
)
""")
    jm = jbuilder.make_model({'type': 'DinoSeg', 'params': DINOSEG})
    head = _jax_variables(jm, (1, 32, 32, 3), seed=6)['params']
    runs = []
    for pkg in ('jax', 'port'):
        rec = _Losses()

        def wire(tl, pkg=pkg, rec=rec):
            if pkg == 'jax':
                tl.set_pretrained_state(params=head)
                tl.logger.register_train_log_hook(rec)
            else:
                tl.set_pretrained_state(convert_flax_dinoseg({'params': head}))
                tl.logger.register_train_log_hook(rec)
        argv = ['--config_path', str(cfg), '--model_dir', str(tmp_path / pkg)]
        if pkg == 'jax':
            jget_trainer('th_ddp', argv=argv)().run(after_construct_launcher_callbacks=[wire])
        else:
            out = tget_trainer('th_ddp', argv=argv + ['--device', 'cpu'])().run(
                after_construct_launcher_callbacks=[wire])
            model = out['launcher'].model
        runs.append(rec.steps)
    assert sorted(runs[0]) == sorted(runs[1]) == [1, 2, 3]
    for step in runs[0]:
        for k in ('cls_loss', 'total_loss', 'grad_norm'):
            np.testing.assert_allclose(runs[1][step][k], runs[0][step][k], rtol=2e-5,
                                       err_msg=f'{step} {k}')
    # the file's trunk reached the port's model: the K bias stays masked
    assert float(model.vit.blocks[0].attn.qkv.bias.detach()[64:128].abs().max()) < 1e-2
