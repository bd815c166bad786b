"""The slice as a whole: a user's segmentation model composed from a
registered encoder and head, one SGD step through both packages' train
steps, on the CPU.

Two compositions, each written once per package as a user writes it (an
``ERModule`` whose ``encoder`` and ``head`` come from the registry, a
``ListIndex`` between them where the head takes some of the features, the
logits in float32 and a CE loss):

- HRNet-W18 + ``HRNetHead`` (18 + 36 + 72 + 144 = 270 wide), the trunk
  cut to one module a stage and one block a branch (both packages' depth
  constants patched for the test): every kind of layer and fuse stays,
  and the JAX step compiles in seconds rather than minutes;
- DeepLabv3+ on ResNet-18 at output stride 16 with
  ``maxpool_impl='pallas'`` (the JAX side's Pallas max-pool backward in
  interpret mode, as its own tests run it; the port's K8 wrapper on its
  plain version), the decoder narrowed to 16 channels.

Both in float64 at 64², B=2, 5 classes, SGD with momentum 0.9 and a poly
schedule.  The loss, grad norm and learning rate agree to rtol 1e-5 (the
loss is float32 in both, and the heads' resizes are float32 in the JAX
package whatever the input), and every parameter and running statistic
after the step to 1e-6 absolute (a step of lr·g with lr 0.05 moves the
rounding of g by less).  The ASPP's dropout (0.5 inside
``Deeplabv3pDecoder``) is off on both sides: the two packages draw other
masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.core import registry as jregistry
from ever_tpu.interface.module import ERModule as JERModule
from ever_tpu.module import heads as jheads
from ever_tpu.module import hrnet as jhrnet
from ever_tpu.module import loss as jloss
from ever_tpu.module import ops as jops
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.interface.module import ERModule as TERModule
from ever_tpu_torch.module import heads as theads
from ever_tpu_torch.module import hrnet as thrnet
from ever_tpu_torch.module import loss as tloss
from ever_tpu_torch.module import ops as tops
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_encoder_head
from test_torch_heads import _NoDropASPP
from test_torch_resnet import one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _seeded

pytestmark = pytest.mark.usefixtures('one_torch_thread')

CLASSES = 5
MODELS = {
    'hrnet_w18': dict(encoder=dict(type='HRNetEncoder', params=dict(hrnet_type='hrnetv2_w18')),
                      head=dict(type='HRNetHead', params=dict(
                          hrnet_decoder=dict(in_channels=18 + 36 + 72 + 144))),
                      index=None),
    'deeplabv3p_r18': dict(
        encoder=dict(type='ResNetEncoder', params=dict(
            resnet_type='resnet18', output_stride=16, maxpool_impl='pallas')),
        head=dict(type='Deeplabv3pHead', params=dict(deeplabv3p_decoder=dict(
            os4_feature_channels=64, os16_feature_channels=512, aspp_channels=16,
            reduction_dim=8, out_channels=16))),
        index=(0, 3)),
}


class JaxEncoderHead(JERModule):
    """The JAX package's composition: encoder → [ListIndex] → head → CE."""

    def set_default_config(self):
        self.config.update(dict(encoder={}, head={}, index=None, classes=CLASSES,
                                dtype='float32'))

    def setup(self):
        c = self.config
        self.encoder = jregistry.MODEL[c.encoder.type](
            dict(c.encoder.params.to_dict(), dtype=c.dtype))
        self.head = jregistry.MODEL[c.head.type](
            dict(c.head.params.to_dict(), num_classes=c.classes, dtype=c.dtype))
        self.select = jops.ListIndex(tuple(c.index)) if c.index else None

    def __call__(self, x, y=None, train: bool = False):
        feats = self.encoder(x.astype(jnp.dtype(self.config.dtype)), train)
        if self.select is not None:
            feats = self.select(feats)
        logits = self.head(feats, train).astype(jnp.float32)
        if train and y is not None:
            return dict(cls_loss=jloss.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return jax.nn.softmax(logits, axis=-1)


class TorchEncoderHead(TERModule):
    """The same composition in the port."""

    def set_default_config(self):
        self.config.update(dict(encoder={}, head={}, index=None, classes=CLASSES,
                                dtype='float32'))

    def __init__(self, config=None):
        super().__init__(config)
        c = self.config
        self.encoder = tregistry.MODEL[c.encoder.type](
            dict(c.encoder.params.to_dict(), dtype=c.dtype))
        self.head = tregistry.MODEL[c.head.type](
            dict(c.head.params.to_dict(), num_classes=c.classes, dtype=c.dtype))
        self.select = tops.ListIndex(tuple(c.index)) if c.index else None

    def forward(self, x, y=None, train: bool = False, generator=None):
        feats = self.encoder(x, train)
        if self.select is not None:
            feats = self.select(feats)
        logits = self.head(feats, train, generator).permute(0, 2, 3, 1).float()
        if train and y is not None:
            return dict(cls_loss=tloss.softmax_ce_loss_with_logits(logits, y, ignore_index=255))
        return torch.softmax(logits, dim=-1)


@pytest.fixture
def cut_hrnet_without_dropout(monkeypatch):
    """Both packages' HRNet at one module a stage and one block a branch,
    and the JAX ASPP without dropout."""
    for mod in (jhrnet, thrnet):
        monkeypatch.setattr(mod, 'STAGE_MODULES', (1, 1, 1))
        monkeypatch.setattr(mod, 'BLOCKS_PER_BRANCH', 1)
    monkeypatch.setattr(jheads, 'AtrousSpatialPyramidPool', _NoDropASPP)


def _sgd(b):
    sched = b.make_learningrate({'type': 'poly', 'params': dict(
        base_lr=0.05, power=0.9, max_iters=20)})
    factory, _ = b.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    return sched, factory.build(sched)


@pytest.mark.usefixtures('cut_hrnet_without_dropout')
@pytest.mark.parametrize('name', sorted(MODELS))
def test_one_sgd_step_matches_jax(name):
    cfg = dict(MODELS[name], dtype='float64')
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3))
    y = rng.integers(0, CLASSES, size=(2, 64, 64)).astype(np.int32)
    y[:, 0, :5] = 255
    with jax.enable_x64(True):
        jm = JaxEncoderHead(cfg)
        v = _seeded(jm, jnp.asarray(x), seed=0)
        jsched, jtx = _sgd(jbuilder)
        jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                                  batch_stats=v['batch_stats'],
                                  opt_state=jtx.init(v['params']))
        jstate, jmet = jspmd.build_train_step(jm, jtx, jsched, donate=False)(
            jstate, (jnp.asarray(x), jnp.asarray(y)))
    tm = TorchEncoderHead(cfg).double()
    tm.load_state_dict(convert_flax_encoder_head(v), strict=True)
    for m in tm.modules():
        if isinstance(m, theads.AtrousSpatialPyramidPool):
            m.dropout_rate = 0.0
    tsched, ttx = _sgd(tbuilder)
    tstate = tspmd.create_train_state(tm, ttx)
    tstate, tmet = tspmd.build_train_step(tm, ttx, tsched)(
        tstate, (torch.from_numpy(x), torch.from_numpy(y)))
    assert set(tmet) == set(jmet) == {'cls_loss', 'total_loss', 'grad_norm', 'learning_rate'}
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    sd = tm.state_dict()
    want = convert_flax_encoder_head(jstate.params, jstate.batch_stats)
    assert set(want) == set(sd)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
        moved += not np.array_equal(w.numpy(), convert_flax_encoder_head(v)[k].numpy())
    assert moved > 0.9 * len(want)
    if name == 'deeplabv3p_r18':
        assert tm.encoder.resnet.maxpool_impl == 'pallas'


def test_compositions_build_through_the_registry():
    """The encoders and heads of both compositions resolve through the
    port's ``builder.make_model`` under the JAX package's names."""
    for cfg in MODELS.values():
        for part in ('encoder', 'head'):
            m = tbuilder.make_model({'type': cfg[part]['type'], 'params': cfg[part]['params']},
                                    device='cpu')
            assert type(m).__name__ == cfg[part]['type']
