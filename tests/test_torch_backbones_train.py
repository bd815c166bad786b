"""The slice as a whole: a user's segmentation model composed from a
registered encoder, a neck of registered ops and a classifier, one SGD
step through both packages' train steps, on the CPU.

Two compositions, each written once per package as a user writes it (an
``ERModule`` whose ``encoder`` comes from ``MODEL``, a ``ListIndex`` of
the features, the neck's ops in order, the logits in float32 and a CE
loss):

- EfficientNet-B0 (full depth) → taps 1-4 (os4-os32: 24, 40, 112, 320)
  → a 1×1 conv-BN per level to 16 (``ChannelReduction``) → one
  ``BiFPN(16, (4, 8, 16, 32))`` → a 1×1 classifier on the os4 output,
  ×4 bilinear: EfficientDet-D0's pairing, narrowed;
- DenseNet cut to ``densenet_tiny`` (growth 8, blocks (2, 2, 2, 2)) →
  ``FPN`` (32) → ``AssymetricDecoder`` (16, to os4, with its classifier
  and ×4 bilinear), FarSeg's decoder as configured.

Both in float64 at 64², B=2, 5 classes (the fusion weights drawn in
[0.5, 1.5], so no fast-normalize ReLU cuts a path), SGD with momentum 0.9
and a poly schedule, drop-connect off on both sides (the two packages draw other
masks; ``test_torch_efficientnet.py`` holds the draws).  The loss, grad
norm and learning rate agree to rtol 1e-5 (the loss is float32 in both,
the bilinear resizes are float32 in both whatever the input, and B0's SE
pools accumulate in float32), and every parameter and running statistic
after the step to 1e-6 absolute (a step of lr·g with lr 0.05 moves the
rounding of g by less).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.core import registry as jregistry
from ever_tpu.interface.module import ERModule as JERModule
from ever_tpu.module import densenet as jdense
from ever_tpu.module import efficientnet as jeff
from ever_tpu.module import loss as jloss
from ever_tpu.module import ops as jops
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch import module as tmodule
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.interface.module import ERModule as TERModule
from ever_tpu_torch.module import densenet as tdense
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.module import ops as tops
from ever_tpu_torch.module.fpn import logits_nhwc
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util import weight_io as twio
from test_torch_bifpn import _fusion_weights_positive
from test_torch_efficientnet import _NoDropEfficientNet
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _seeded

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CLASSES = 5
MODELS = {
    'b0_bifpn': dict(
        encoder=dict(type='EFNetEncoder', params=dict(efficientnet_type='efficientnet-b0')),
        index=(1, 2, 3, 4),
        neck=[dict(type='ChannelReduction', params=dict(in_channels_list=(24, 40, 112, 320),
                                                        out_channels=16)),
              dict(type='BiFPN', params=dict(in_channels=16, feature_strides=(4, 8, 16, 32)))],
        classifier=16),
    'densenet_fpn': dict(
        encoder=dict(type='DenseNetEncoder', params=dict(densenet_type='densenet_tiny')),
        index=None,
        neck=[dict(type='FPN', params=dict(in_channels_list=(32, 32, 32, 32), out_channels=32)),
              dict(type='AssymetricDecoder', params=dict(
                  in_channels=32, out_channels=16, classifier_config=dict(
                      num_classes=CLASSES, scale_factor=4)))],
        classifier=None),
}


def _jax_op(spec):
    """A neck op of the JAX package by name: ``OP``, else ``module.ops``,
    with the config keys it has (``ChannelReduction`` infers its input
    widths)."""
    cls = jregistry.OP.get(spec['type']) or getattr(jops, spec['type'])
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in spec['params'].items() if k in fields})


class JaxBackboneSeg(JERModule):
    """The JAX package's composition: encoder → ListIndex → neck → [1×1
    classifier, ×4 bilinear] → CE."""

    def set_default_config(self):
        self.config.update(dict(encoder={}, index=None, neck=[], classifier=None,
                                classes=CLASSES, dtype='float32'))

    def setup(self):
        c = self.config
        self.encoder = jregistry.MODEL[c.encoder.type](
            dict(c.encoder.params.to_dict(), dtype=c.dtype))
        self.select = jops.ListIndex(tuple(c.index)) if c.index else None
        dtype = jnp.dtype(c.dtype)
        self.neck = [_jax_op(dict(n.to_dict(), params=dict(n.params.to_dict(), dtype=dtype)))
                     for n in c.neck]
        if c.classifier:
            self.cls = nn.Conv(c.classes, (1, 1), dtype=dtype)

    def __call__(self, x, y=None, train: bool = False):
        feats = self.encoder(x.astype(jnp.dtype(self.config.dtype)), train)
        if self.select is not None:
            feats = self.select(feats)
        for op in self.neck:
            feats = op(feats, train)
        if self.config.classifier:
            feats = jops.resize(self.cls(feats[0]), scale=4.0, method='bilinear')
        logits = feats.astype(jnp.float32)
        if train and y is not None:
            return dict(cls_loss=jloss.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return jax.nn.softmax(logits, axis=-1)


class TorchBackboneSeg(TERModule):
    """The same composition in the port."""

    def set_default_config(self):
        self.config.update(dict(encoder={}, index=None, neck=[], classifier=None,
                                classes=CLASSES, dtype='float32'))

    def __init__(self, config=None):
        super().__init__(config)
        c = self.config
        self.encoder = tregistry.MODEL[c.encoder.type](
            dict(c.encoder.params.to_dict(), dtype=c.dtype))
        self.select = tops.ListIndex(tuple(c.index)) if c.index else None
        self.neck = torch.nn.ModuleList(
            (tregistry.OP.get(n.type) or getattr(tmodule, n.type))(**n.params.to_dict())
            for n in c.neck)
        self.cls = tops.Conv2d(c.classifier, c.classes, 1, bias=True) if c.classifier else None

    def forward(self, x, y=None, train: bool = False, generator=None):
        if isinstance(self.encoder, tmodule.EFNetEncoder):
            feats = self.encoder(x, train, generator)
        else:
            feats = self.encoder(x, train)
        if self.select is not None:
            feats = self.select(feats)
        for op in self.neck:
            feats = op(feats, train)
        logits = (logits_nhwc(self.cls, feats[0]) if self.cls is not None
                  else feats.permute(0, 2, 3, 1).float())
        if train and y is not None:
            return dict(cls_loss=tloss.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return torch.softmax(logits, dim=-1)


def convert(v, name):
    """The JAX composition's variables under the port's names."""
    flat = twio._variables(v.get('params', v), v.get('batch_stats'))
    enc = {k: a for k, a in flat.items() if k.startswith('encoder/')}
    rest = {k: a for k, a in flat.items() if not k.startswith('encoder/')}
    if name == 'b0_bifpn':
        sd = twio.convert_flax_efficientnet(enc, None, 'efficientnet-b0')
        rules = [(r'neck_0/reduce(\d)/Conv_0', r'neck.0.reduce\1.0'),
                 (r'neck_0/reduce(\d)/Norm_0/BatchNorm_0', r'neck.0.reduce\1.1'),
                 ('cls', 'cls')]
        trees = [('', '', rules), ('neck.1.', 'neck_1/', twio._BIFPN_RULES)]
    else:
        sd = twio.convert_flax_densenet(enc)
        trees = [('', '', twio._fpn_decoder_rules(('neck_0',), ('neck_1',)))]
    sd.update({k.replace('neck_0.', 'neck.0.').replace('neck_1.', 'neck.1.'): t
               for k, t in twio._convert_conv_net(rest, trees, name).items()})
    return sd


@pytest.fixture
def cut_and_no_drop(monkeypatch):
    for mod in (jdense, tdense):
        monkeypatch.setitem(mod.DENSENET_SPECS, 'densenet_tiny', (8, (2, 2, 2, 2), 16))
    monkeypatch.setattr(jeff, 'EfficientNet', _NoDropEfficientNet)


def _sgd(b):
    sched = b.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.05, power=0.9, max_iters=20)})
    factory, _ = b.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    return sched, factory.build(sched)


@pytest.mark.usefixtures('cut_and_no_drop')
@pytest.mark.parametrize('name', sorted(MODELS))
def test_one_sgd_step_matches_jax(name):
    cfg = dict(MODELS[name], dtype='float64')
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3))
    y = rng.integers(0, CLASSES, size=(2, 64, 64)).astype(np.int32)
    y[:, 0, :5] = 255
    with jax.enable_x64(True):
        jm = JaxBackboneSeg(cfg)
        v = _fusion_weights_positive(_seeded(jm, jnp.asarray(x), seed=0))
        jsched, jtx = _sgd(jbuilder)
        jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                  batch_stats=v['batch_stats'],
                                  opt_state=jtx.init(v['params']))
        jstate, jmet = jspmd.build_train_step(jm, jtx, jsched, donate=False)(
            jstate, (jnp.asarray(x), jnp.asarray(y)))
    tm = TorchBackboneSeg(cfg).double()
    for m in tm.modules():
        if isinstance(m, tmodule.efficientnet.MBConv):
            m.drop_connect_rate = 0.0
    tm.load_state_dict(convert(v, name), strict=True)
    tsched, ttx = _sgd(tbuilder)
    tstate = tspmd.create_train_state(tm, ttx)
    tstate, tmet = tspmd.build_train_step(tm, ttx, tsched)(
        tstate, (torch.from_numpy(x), torch.from_numpy(y)))
    assert set(tmet) == set(jmet) == {'cls_loss', 'total_loss', 'grad_norm', 'learning_rate'}
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    sd = tm.state_dict()
    want = convert({'params': jstate.params, 'batch_stats': jstate.batch_stats}, name)
    assert set(want) == set(sd)
    before = convert(v, name)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
        moved += not np.array_equal(w.numpy(), before[k].numpy())
    assert moved > 0.9 * len(want)


def test_compositions_build_through_the_registries():
    """Each neck op resolves in the port's ``OP`` registry (BiFPN, FPN,
    AssymetricDecoder) or its ``module`` namespace (ChannelReduction), as
    in the JAX package's; each encoder through ``builder.make_model``."""
    for cfg in MODELS.values():
        m = tbuilder.make_model({'type': cfg['encoder']['type'], 'params': {}}, device='cpu')
        assert type(m).__name__ == cfg['encoder']['type']
        for n in cfg['neck']:
            assert (n['type'] in tregistry.OP) == (n['type'] in jregistry.OP)
            assert hasattr(tmodule, n['type']) and hasattr(ever_tpu.module, n['type'])
