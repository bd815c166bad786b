"""Int8 W8A8 post-training quantization in the port (``ops/ptq.py``)
against the JAX package's ``ever_tpu/ops/ptq.py``, on the CPU.

The products run on K7's plain version (the op ``ever_tpu_torch::
int8_matmul_t`` on CPU tensors).  Cases, as ``tests/test_ptq.py`` has them:
convs and a dense layer whose values lie on the int8 grid equal the
floating-point layer and the JAX int8 layer exactly (five conv
geometries); the running max over calibration batches; percentile
calibration, whose subsample must be taken in the JAX package's NHWC
order; the filters; a conv outside the int8 vocabulary left in floating
point; then a narrow FarSeg-R18 and a 2-block ``vit_small`` quantized in
both packages from the same weights and the same calibration batch: the
int8 weights and their scales bit-equal, the input scales within 1e-5
(float32 sums in other orders move the abs-max), and the W8A8 outputs
close (``_close``).  Int8 networks are chaotic at the bin boundaries: the
two packages' float32 activations differ in their last bits, an
activation at a rounding boundary takes the next int8 bin in one of them,
and every layer after it sees a changed input, so the differing int8
inputs multiply with depth (traced layer by layer, the first quantized
layers' int8 inputs agree exactly and the decoder's differ widely), and
a narrow model's W8A8 output moves about as far under a perturbation of
its input in the last float32 bits.  So ``_close`` holds the W8A8
outputs' centred cosine above 0.98 and their mean |difference| within
1.5x the JAX W8A8 output's mean error against floating point.  It is an
envelope for whole models and does not test the arithmetic (a wrong
rescale, bias or scale order could pass it): the layers' arithmetic is
held by the exact checks, on the grid and off it (single layers at real
scales, with per-channel weight scales and biases, equal to the JAX
``ptq_apply`` bit for bit).  Last, ``tiled_inference`` with
``make_ptq_predict_fn`` over a scene.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import traverse_util

from ever_tpu.core import builder as jbuilder
from ever_tpu.magic.tiled import tiled_inference as jtiled
from ever_tpu.module import vit as jvit
from ever_tpu.ops import ptq as jptq
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.magic.tiled import tiled_inference as ttiled
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.module.ops import Conv2d
from ever_tpu_torch.ops import ptq as tptq
from ever_tpu_torch.ops import quant as Q
from ever_tpu_torch.util.weight_io import convert_flax_dinov3_vit, convert_flax_farseg
from test_torch_resnet import one_torch_thread, seeded_variables  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# W8A8 outputs of the two packages: their mean |difference| within this
# multiple of the JAX W8A8 output's mean error against floating point
# (module docstring); for whole models only, the arithmetic is held exactly
# by test_int8_layer_exact_off_grid
MODEL_TOL = 1.5


def _close(got, want, fp):
    got, want, fp = np.asarray(got), np.asarray(want), np.asarray(fp)
    assert got.shape == want.shape
    assert np.abs(got - want).mean() <= MODEL_TOL * np.abs(want - fp).mean()
    assert _centred_cos(got, want) > 0.98


def nhwc(t):
    return np.asarray(t.detach().permute(0, 2, 3, 1))


def _grid_kernel(rng, kh, kw, cin, cout):
    """An integer HWIO kernel whose per-output-channel abs-max is 127, so
    w_scale == 1 and the int8 grid holds it exactly."""
    k = rng.integers(-126, 127, (kh, kw, cin, cout)).astype(np.float32)
    k[0, 0, 0, :] = 127.0
    return k


class _OneConv(fnn.Module):
    features: int = 8
    strides: tuple = (1, 1)
    groups: int = 1
    dilation: tuple = (1, 1)
    padding: str = 'SAME'

    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(self.features, (3, 3), strides=self.strides, padding=self.padding,
                        kernel_dilation=self.dilation, feature_group_count=self.groups,
                        use_bias=False, name='c')(x)


@pytest.mark.parametrize('case', [
    dict(), dict(strides=(2, 2)), dict(groups=4), dict(dilation=(2, 2)), dict(padding='VALID'),
], ids=['default', 'stride2', 'groups4', 'dilation2', 'valid'])
def test_int8_conv_exact_on_grid(case):
    """On-grid values round-trip exactly: the port's int8 conv (padding,
    lax's asymmetric SAME at stride 2, groups as one K7 launch each,
    dilation) equals its floating-point conv and the JAX int8 conv, and its
    int8 weights are the JAX ones."""
    rng = np.random.default_rng(0)
    cin = cout = 8
    groups = case.get('groups', 1)
    k = _grid_kernel(rng, 3, 3, cin // groups, cout)
    x = rng.integers(-126, 127, (2, 16, 16, cin)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0                                   # x_scale == 1
    jm = _OneConv(features=cout, **case)
    jv = {'params': {'c': {'kernel': jnp.asarray(k)}}}
    jqv = jptq.ptq_quantize(jm, jv, [jnp.asarray(x)], apply_kwargs=dict(train=False))
    want = np.asarray(jptq.ptq_apply(jm, jqv, jnp.asarray(x), train=False))

    conv = Conv2d(cin, cout, 3, stride=case.get('strides', (1, 1))[0],
                  padding=0 if case.get('padding') == 'VALID' else 'same',
                  dilation=case.get('dilation', (1, 1))[0], groups=groups)
    conv.weight.data = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
    qv = tptq.ptq_quantize(conv, None, [xt])
    with torch.no_grad():
        fp = conv(xt)
    before = Q.int8_matmul_t.launches
    got = tptq.ptq_apply(conv, qv, xt)
    assert Q.int8_matmul_t.launches == before                # the plain version
    assert torch.equal(got, fp)
    np.testing.assert_array_equal(nhwc(got), want)
    kq = np.asarray(jqv['ptq']['c']['kernel_q'])
    np.testing.assert_array_equal(qv['ptq']['']['kernel_q'].numpy(),
                                  np.transpose(kq, (3, 2, 0, 1)).reshape(cout, -1))


def test_dense_int8_exact_on_grid():
    """A dense layer on the grid: exact, and the JAX layer's values."""
    rng = np.random.default_rng(7)
    k = rng.integers(-126, 127, (16, 8)).astype(np.float32)
    k[0, :] = 127.0
    x = rng.integers(-126, 127, (4, 16)).astype(np.float32)
    x[0, 0] = 127.0

    class D(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.Dense(8, use_bias=False, name='d')(x)

    jm, jv = D(), {'params': {'d': {'kernel': jnp.asarray(k)}}}
    jqv = jptq.ptq_quantize(jm, jv, [jnp.asarray(x)], apply_kwargs=dict(train=False))
    lin = tvit.Linear(16, 8, bias=False)
    lin.weight.data = torch.from_numpy(k.T.copy())
    xt = torch.from_numpy(x)
    qv = tptq.ptq_quantize(lin, None, [xt])
    got = tptq.ptq_apply(lin, qv, xt)
    assert torch.equal(got, lin(xt).detach())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jptq.ptq_apply(jm, jqv, jnp.asarray(x))))
    np.testing.assert_array_equal(qv['ptq']['']['kernel_q'].numpy(),
                                  np.asarray(jqv['ptq']['d']['kernel_q']).T)


class _OneLayer(fnn.Module):
    """One flax layer with a bias, named ``l``: a conv (lax's SAME), a
    dense layer, or the ViT's masked-bias linear (its ``linear`` is the
    quantized Dense, its bias times ``bias_mask`` added after)."""
    kind: str = 'conv'
    features: int = 12
    kernel: int = 3
    strides: int = 1
    groups: int = 1
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        if self.kind == 'dense':
            return fnn.Dense(self.features, dtype=self.dtype, name='l')(x)
        if self.kind == 'masked':
            return jvit.LinearKMaskedBias(self.features, name='l')(x)
        return fnn.Conv(self.features, (self.kernel,) * 2, strides=(self.strides,) * 2,
                        padding='SAME', feature_group_count=self.groups, name='l')(x)


OFF_GRID = {
    'conv3x3-stride2-bias': dict(kind='conv', strides=2),
    'conv1x1-bias': dict(kind='conv', kernel=1, features=16),
    'conv3x3-groups4-bias': dict(kind='conv', groups=4),
    'dense-bias': dict(kind='dense'),
    'dense-bias-bf16': dict(kind='dense', dtype=jnp.bfloat16),
    'masked-bias-linear': dict(kind='masked'),
}


@pytest.mark.parametrize('case', list(OFF_GRID.values()), ids=list(OFF_GRID))
def test_int8_layer_exact_off_grid(case):
    """Off the grid, at real scales: random inputs (x_scale ≠ 1), kernels
    whose output channels span a 1000× range of abs-max (per-channel
    w_scale ≠ 1) and a random float32 bias.  The port's serving arithmetic
    (x·(1/x_scale) rounded half to even, the exact int32 product on K7's
    plain version, acc·(x_scale·w_scale) in float32, the float32 bias, the
    masked linear's bias·bias_mask, the cast to the layer's dtype) gives
    the JAX ``ptq_apply``'s bits, with bit-equal int8 weights and scales."""
    rng = np.random.default_rng(11)
    kind, cout = case['kind'], case.get('features', 12)
    groups, kh = case.get('groups', 1), case.get('kernel', 3)
    cin = 8 if kind == 'conv' else 16
    channel_range = np.exp(rng.uniform(-3.5, 3.5, cout)).astype(np.float32)
    if kind == 'conv':
        k = rng.normal(size=(kh, kh, cin // groups, cout)).astype(np.float32) * channel_range
        x = (3.0 * rng.normal(size=(2, 15, 17, cin))).astype(np.float32)
    else:
        k = rng.normal(size=(cin, cout)).astype(np.float32) * channel_range
        x = (3.0 * rng.normal(size=(3, 5, cin))).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    jm = _OneLayer(**case)
    dtype = case.get('dtype') or jnp.float32
    jx = jnp.asarray(x).astype(dtype)
    if kind == 'masked':
        jv = {'params': {'l': {'linear': {'kernel': jnp.asarray(k)}, 'bias': jnp.asarray(bias)}}}
        jv['constants'] = jm.init(jax.random.PRNGKey(0), jx)['constants']
        jname = 'l/linear'
    else:
        jv = {'params': {'l': {'kernel': jnp.asarray(k), 'bias': jnp.asarray(bias)}}}
        jname = 'l'
    jqv = jptq.ptq_quantize(jm, jv, [jx], apply_kwargs={})
    want = np.asarray(jptq.ptq_apply(jm, jqv, jx).astype(jnp.float32))
    jq = traverse_util.flatten_dict(jqv['ptq'], sep='/')

    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    if kind == 'conv':
        layer = Conv2d(cin, cout, kh, stride=case.get('strides', 1), groups=groups, bias=True)
        layer.weight.data = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
        xt = xt.permute(0, 3, 1, 2)
        kq_want = np.transpose(np.asarray(jq[f'{jname}/kernel_q']), (3, 2, 0, 1)).reshape(cout, -1)
    else:
        layer = (tvit.LinearKMaskedBias(cin, cout) if kind == 'masked'
                 else tvit.Linear(cin, cout))
        layer.weight.data = torch.from_numpy(k.T.copy())
        kq_want = np.asarray(jq[f'{jname}/kernel_q']).T
    layer.bias.data = torch.from_numpy(bias.copy())
    qv = tptq.ptq_quantize(layer, None, [xt])
    e = qv['ptq']['']
    np.testing.assert_array_equal(e['kernel_q'].numpy(), kq_want)
    np.testing.assert_array_equal(e['w_scale'].numpy(), np.asarray(jq[f'{jname}/w_scale']))
    assert float(e['x_scale']) == float(jq[f'{jname}/x_scale'])
    assert float(e['x_scale']) != 1.0 and np.ptp(e['w_scale'].numpy()) > 0.1
    predict = tptq.make_ptq_predict_fn(layer, qv)
    with torch.no_grad():
        got = predict(xt)
    assert predict.serving.int8_calls == 1 and got.dtype == xt.dtype
    got = got.float()
    np.testing.assert_array_equal(nhwc(got) if kind == 'conv' else got.numpy(), want)


class _JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(32, (3, 3), padding='SAME', use_bias=False, name='c1')(x)
        x = fnn.relu(x)
        x = fnn.Conv(16, (3, 3), strides=(2, 2), padding='SAME', name='c2')(x)
        x = fnn.relu(x)
        return fnn.Conv(7, (1, 1), name='head')(x)


class _TTiny(nn.Module):
    """The port's ``_JTiny``: NHWC in and out, convs on NCHW."""

    def __init__(self):
        super().__init__()
        self.c1 = Conv2d(8, 32, 3)
        self.c2 = Conv2d(32, 16, 3, stride=2, bias=True)
        self.head = Conv2d(16, 7, 1, bias=True)

    def forward(self, x, train=False):
        x = torch.relu(self.c1(x.permute(0, 3, 1, 2)))
        x = torch.relu(self.c2(x))
        return self.head(x).permute(0, 2, 3, 1)


@pytest.fixture(scope='module')
def tiny():
    """``_JTiny`` and ``_TTiny`` with the same seeded weights."""
    x = np.zeros((1, 16, 16, 8), np.float32)
    jm = _JTiny()
    jv = seeded_variables(jm, x, seed=3)
    tm = _TTiny()
    flat = traverse_util.flatten_dict(jv['params'], sep='/')
    sd = {}
    for key, v in flat.items():
        name, leaf = key.split('/')
        v = np.asarray(v)
        sd[f'{name}.weight' if leaf == 'kernel' else f'{name}.bias'] = torch.from_numpy(
            np.transpose(v, (3, 2, 0, 1)).copy() if leaf == 'kernel' else v.copy())
    tm.load_state_dict(sd)
    return jm, jv, tm


def test_calibration_running_max_across_batches(tiny):
    jm, jv, tm = tiny
    rng = np.random.default_rng(1)
    x_small = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    x_big = x_small * 10.0
    batches = [x_small, x_big, x_small]
    stats = tptq.calibrate_int8(tm, tm.state_dict(), [torch.from_numpy(b) for b in batches])
    jstats = jptq.calibrate_int8(jm, jv, [jnp.asarray(b) for b in batches],
                                 apply_kwargs=dict(train=False))
    assert float(stats['c1']) == float(np.abs(x_big).max())
    for name in ('c1', 'c2', 'head'):
        np.testing.assert_allclose(stats[name], float(jstats[name]['absmax']), rtol=1e-5)


def test_percentile_calibration_clips_outliers():
    """act_percentile: one outlier does not set the scale, the percentile
    model is more accurate than the abs-max one on clean inputs, and the
    statistic is the JAX one, also where the subsample is strided (an NCHW
    input of 2 129 920 values, stride 2, taken in NHWC order)."""
    rng = np.random.default_rng(7)
    conv = Conv2d(8, 8, 3)
    k = rng.normal(scale=1 / 8.5, size=(8, 8, 3, 3)).astype(np.float32)
    conv.weight.data = torch.from_numpy(k)
    x = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
    x[0, 0, 0, 0] = 1e3
    xt = torch.from_numpy(x)
    s_max = tptq.calibrate_int8(conv, None, [xt])['']
    s_pct = tptq.calibrate_int8(conv, None, [xt], act_percentile=99.9)['']
    assert s_max == pytest.approx(1e3, rel=1e-3) and s_pct < 10.0
    clean = torch.from_numpy(rng.normal(size=(2, 8, 16, 16)).astype(np.float32))
    fp = conv(clean).detach()
    errs = {}
    for name, pct in (('absmax', None), ('pct', 99.9)):
        qv = tptq.ptq_quantize(conv, None, [xt], act_percentile=pct)
        errs[name] = float((tptq.ptq_apply(conv, qv, clean) - fp).abs().max() / fp.abs().max())
    assert errs['pct'] < 0.1 and errs['pct'] < errs['absmax'] / 5

    big = rng.gamma(2.0, size=(1, 512, 520, 8)).astype(np.float32)
    jm = _OneConv()
    jv = {'params': {'c': {'kernel': jnp.asarray(np.transpose(k, (2, 3, 1, 0)))}}}
    want = jptq.calibrate_int8(jm, jv, [jnp.asarray(big)], apply_kwargs=dict(train=False),
                               act_percentile=99.9)['c']['absmax']
    got = tptq.calibrate_int8(conv, None, [torch.from_numpy(big).permute(0, 3, 1, 2)],
                              act_percentile=99.9)['']
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_filters_exclude_names_and_small_convs(tiny):
    jm, jv, tm = tiny
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 8)).astype(np.float32)
    stats = tptq.calibrate_int8(tm, None, [torch.from_numpy(x)])
    sd = tm.state_dict()
    qv = tptq.quantize_convs(sd, stats, except_re=r'\bhead\b')
    assert set(qv['ptq']) == {'c1', 'c2'}
    # head is a 1x1x16 conv: receptive volume 16 < 64
    qv2 = tptq.quantize_convs(sd, stats, min_in_features=64)
    assert set(qv2['ptq']) == {'c1', 'c2'}
    with pytest.raises(ValueError, match='no eligible'):
        tptq.quantize_convs(sd, stats, except_re='.')
    # the excluded conv runs in floating point, the rest in int8
    y = tptq.ptq_apply(tm, qv, torch.from_numpy(x))
    assert y.shape == (2, 8, 8, 7)
    jqv = jptq.quantize_convs(jv, jptq.calibrate_int8(jm, jv, [jnp.asarray(x)],
                                                      apply_kwargs=dict(train=False)),
                              except_re=r'\bhead\b')
    want = np.asarray(jptq.ptq_apply(jm, jqv, jnp.asarray(x), train=False))
    _close(y.detach().numpy(), want, np.asarray(jm.apply(jv, jnp.asarray(x))))


def test_uncovered_conv_falls_back_to_fp():
    """A circular-padded conv is outside the int8 vocabulary: serving gives
    the exact floating-point result though calibration recorded it."""
    conv = nn.Conv2d(8, 8, 3, padding=1, padding_mode='circular', bias=False)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 8, 8, 8)).astype(np.float32))
    qv = tptq.ptq_quantize(conv, None, [x])
    predict = tptq.make_ptq_predict_fn(conv, qv)
    with torch.no_grad():
        assert torch.equal(predict(x), conv(x))
    assert predict.serving.fp_layers == [''] and predict.serving.int8_calls == 0


# -- whole models against the JAX package ---------------------------------------------

NARROW = dict(
    encoder=dict(resnet_type='resnet18'),
    head=dict(fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=32),
              fs_relation=dict(scene_embedding_channels=512,
                               in_channels_list=(32,) * 4, out_channels=32),
              fpn_decoder=dict(in_channels=32, out_channels=32)),
    classes=5, dtype='float32')


def _ptq_as_params(ptq_tree):
    """The JAX ``'ptq'`` collection as two flat params trees the weight
    converters map to port names: ``kernel_q`` as the kernel with
    ``w_scale`` as the bias, and ``x_scale`` as the bias alone."""
    flat = traverse_util.flatten_dict(ptq_tree, sep='/')
    w, x = {}, {}
    for key, v in flat.items():
        path, leaf = key.rsplit('/', 1)
        v = np.asarray(v)
        if leaf == 'kernel_q':
            w[f'{path}/kernel'] = v.astype(np.float32)
        elif leaf == 'w_scale':
            w[f'{path}/bias'] = v
        else:
            x[f'{path}/bias'] = v.reshape(1)
    return w, x


def _check_quantized(qv, jqv, convert, kernel_to_port):
    """The port's ``'ptq'`` entries against the JAX collection, by name."""
    w, x = _ptq_as_params(jqv['ptq'])
    want_w, want_x = convert(w), convert(x)
    names = {k[:-len('.weight')] for k in want_w if k.endswith('.weight')}
    assert set(qv['ptq']) == names
    for name, e in qv['ptq'].items():
        kq = kernel_to_port(want_w[f'{name}.weight'])
        np.testing.assert_array_equal(e['kernel_q'].numpy(), kq.numpy().astype(np.int8))
        np.testing.assert_array_equal(e['w_scale'].numpy(), want_w[f'{name}.bias'].numpy())
        np.testing.assert_allclose(float(e['x_scale']), float(want_x[f'{name}.bias'][0]),
                                   rtol=1e-5)


def _centred_cos(a, b):
    a = np.asarray(a).ravel() - np.asarray(a).mean()
    b = np.asarray(b).ravel() - np.asarray(b).mean()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope='module')
def farseg():
    """The narrow FarSeg-R18 in both packages from one set of seeded
    variables, quantized from one calibration batch (min_in_features 64,
    eval mode, as ``export_model`` calibrates)."""
    rng = np.random.default_rng(5)
    calib = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': NARROW})
    jv = seeded_variables(jm, calib, seed=4)
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': NARROW}, device='cpu').eval()
    tm.load_state_dict(convert_flax_farseg(jv), strict=True)
    jqv = jptq.ptq_quantize(jm, jv, [jnp.asarray(calib)], apply_kwargs=dict(train=False),
                            min_in_features=64)
    qv = tptq.ptq_quantize(tm, tm.state_dict(), [torch.from_numpy(calib)],
                           apply_kwargs=dict(train=False), min_in_features=64)
    return jm, jv, jqv, tm, qv


def test_farseg_ptq_matches_jax(farseg):
    """Every conv of the narrow FarSeg quantized as the JAX package
    quantizes it, and the W8A8 probabilities close to the JAX W8A8 ones; each quantized layer call ran one (plain) K7 product."""
    jm, jv, jqv, tm, qv = farseg
    _check_quantized(qv, jqv, convert_flax_farseg, lambda w: w.reshape(w.shape[0], -1))
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    fp = np.asarray(jax.jit(lambda t: jm.apply(jv, t, train=False))(jnp.asarray(x)))
    want = np.asarray(jax.jit(jptq.make_ptq_predict_fn(jm, jqv, train=False))(jnp.asarray(x)))
    predict = tptq.make_ptq_predict_fn(tm, qv, train=False)
    with torch.no_grad():
        got = predict(torch.from_numpy(x)).numpy()
    assert predict.serving.int8_calls == len(qv['ptq']) and predict.serving.fp_layers == []
    _close(got, want, fp)
    assert _centred_cos(got, fp) > 0.98


def test_vit_dense_ptq_matches_jax(monkeypatch):
    """A 2-block ``vit_small`` trunk: the patch embedding (quantized at the
    ``PatchEmbed``) and each block's qkv, proj, fc1 and fc2 quantized as
    the JAX package quantizes them; the W8A8 patch tokens close to the JAX
    W8A8 ones and strongly correlated with the fp tokens."""
    spec = (2, 384, 6, 4.0, 'mlp')
    monkeypatch.setitem(jvit.VIT_SPECS, 'vit_small_2', spec)
    monkeypatch.setitem(tvit.VIT_SPECS, 'vit_small_2', spec)
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jvit.DinoVisionTransformer(vit_type='vit_small_2')
    jv = seeded_variables(jm, x, seed=9)
    tm = tvit.DinoVisionTransformer(vit_type='vit_small_2').eval()
    tm.load_state_dict(convert_flax_dinov3_vit(jv['params']), strict=True)
    jqv = jptq.ptq_quantize(jm, jv, [jnp.asarray(x)], apply_kwargs={}, min_in_features=64)
    qv = tptq.ptq_quantize(tm, tm.state_dict(), [torch.from_numpy(x)], min_in_features=64)
    assert len(qv['ptq']) == 2 * 4 + 1

    def convert(flat):
        return convert_flax_dinov3_vit({k: v for k, v in flat.items()})

    _check_quantized(qv, jqv, convert, lambda w: w.reshape(w.shape[0], -1))
    fp = np.asarray(jm.apply(jv, jnp.asarray(x))['x_norm_patchtokens'])
    want = np.asarray(jptq.ptq_apply(jm, jqv, jnp.asarray(x))['x_norm_patchtokens'])
    got = tptq.ptq_apply(tm, qv, torch.from_numpy(x))['x_norm_patchtokens'].detach().numpy()
    _close(got, want, fp)
    assert _centred_cos(got, fp) > 0.99


def test_farseg_ptq_through_tiled_inference(farseg):
    """``tiled_inference`` with ``make_ptq_predict_fn`` over a 96² scene
    (64² tiles, stride 32): close to the JAX package's W8A8 scene, and the same bits as the port's own tile batches."""
    jm, jv, jqv, tm, qv = farseg
    scene = np.random.default_rng(10).normal(size=(96, 96, 3)).astype(np.float32)
    want = np.asarray(jtiled(jptq.make_ptq_predict_fn(jm, jqv, train=False),
                             jnp.asarray(scene), 64, 32, 5, tile_batch=2))
    fp = np.asarray(jtiled(lambda t: jm.apply(jv, t, train=False), jnp.asarray(scene),
                           64, 32, 5, tile_batch=2))
    predict = tptq.make_ptq_predict_fn(tm, qv, train=False)
    got = ttiled(predict, scene, 64, 32, 5, tile_batch=2, device='cpu').numpy()
    assert got.shape == (96, 96, 5)
    _close(got, want, fp)
    assert _centred_cos(got, fp) > 0.98
    assert predict.serving.int8_calls == 2 * len(qv['ptq'])      # 4 tiles, 2 batches
