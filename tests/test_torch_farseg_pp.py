"""FarSeg++ and the FPN/decoder variants in the port against the JAX package,
on the CPU.

``FSRelationV2`` with and without ``scale_aware_proj``; the narrow FarSeg++
(ResNet-18 trunk, head width 64, ``relation_type='v2'``) in eval mode and
through three SGD steps in float64 in both packages at ``dropout_rate=0``
(the two packages' dropout generators cannot match); the channel and
classifier dropouts drawn from the step's generator; FPN ``top_blocks`` in
both modes; the decoder with ``norm`` 'gn', 'ln' and None and with
``align_corners``; and the converter over every new variable (a FarSeg
keeps a configured classifier ``dropout_rate``, which the JAX package's
FarSeg drops).  Weights are
seeded random draws in the JAX tree carried over by ``convert_flax_farseg``
(or a strict ``load_state_dict``); inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.module import fpn as jfpn
from ever_tpu.module import fs_relation as jfs
from ever_tpu.parallel import spmd as jspmd
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import fpn as tfpn
from ever_tpu_torch.module import fs_relation as tfs
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_farseg, flatten_params
from test_torch_farseg import CLASSES, NARROW, _batch, _close_state, _sgd
from test_torch_resnet import close, nchw, nhwc, one_torch_thread, seeded_variables  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

# the narrow FarSeg++: head width 64, so that the scene encoder's 32
# GroupNorm groups hold 2 channels each (at width 32 each holds one value
# of the 1×1 scene embedding, and the norm returns its bias)
HEAD_V2 = dict(relation_type='v2',
               fpn=dict(in_channels_list=(64, 128, 256, 512), out_channels=64),
               fs_relation=dict(scene_embedding_channels=512, in_channels_list=(64,) * 4,
                                out_channels=64),
               fpn_decoder=dict(in_channels=64, out_channels=32))
NARROW_V2 = dict(NARROW, head=HEAD_V2)


def _head_sd(variables, prefix):
    """The head module's variables (``params``, ``batch_stats``) under the
    port's names, through the FarSeg converter's head rules."""
    wrapped = {c: {'head': {prefix: variables[c]}} for c in variables}
    sd = convert_flax_farseg(wrapped)
    return {k[len(f'head.{prefix}.'):]: t for k, t in sd.items()}


def _seeded(module, *args, seed=0):
    """``seeded_variables``' draws for a module applied to ``args`` (a
    feature list here): kernels ~N(0, 1/fan_in), scales and variances
    ~U(0.5, 1.5), the rest ~N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda: module.init({'params': jax.random.key(0)}, *args))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(scale=fan_in ** -0.5, size=s.shape).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(scale=0.1, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _feats(widths, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, s, c)).astype(np.float32) for c, s in zip(widths, sizes)]


@pytest.mark.parametrize('scale_aware_proj', [False, True])
def test_fs_relation_v2_matches_jax(scale_aware_proj):
    """FSRelationV2 over four 32-wide levels and a 96-wide scene embedding,
    out width 64 (the scene GroupNorms: 32 groups of 2 channels), in eval
    mode (running statistics) and in train mode at dropout 0 (batch
    statistics over 128 to 512 values a channel): 1e-5 of the scale
    (float32 sums in other orders)."""
    feats = _feats((32,) * 4, (16, 16, 8, 8), seed=1)
    scene = np.random.default_rng(2).normal(size=(2, 1, 1, 96)).astype(np.float32)
    jm = jfs.FSRelationV2(96, (32,) * 4, 64, scale_aware_proj, dropout_rate=0.0)
    v = _seeded(jm, jnp.asarray(scene), [jnp.asarray(f) for f in feats])
    tm = tfs.FSRelationV2(96, (32,) * 4, 64, scale_aware_proj, dropout_rate=0.0)
    tm.load_state_dict(_head_sd(v, 'fs_relation'), strict=True)
    for train in (False, True):
        want = jm.apply(v, jnp.asarray(scene), [jnp.asarray(f) for f in feats], train,
                        mutable=['batch_stats'])[0]
        with torch.no_grad():
            got = tm(nchw(scene), [nchw(f) for f in feats], train)
        for g, w in zip(got, want):
            close(nhwc(g), w, 1e-5)


def _models(cfg, x, seed=0):
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': cfg})
    v = seeded_variables(jm, x, seed)
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    return jm, tm, v


@pytest.mark.parametrize('stem', ['conv', 's2d_input'])
def test_farseg_pp_eval_matches_jax(stem):
    """FarSeg++ (the narrow model, ``relation_type='v2'``) in eval mode at
    64², B=2: probabilities to 1e-5; with ``stem='s2d_input'`` on the
    folded batch too.  Every variable maps to one port key."""
    cfg = dict(NARROW_V2, encoder=dict(NARROW['encoder'], stem=stem))
    x, _ = _batch(2, 64, seed=1)
    if stem == 's2d_input':
        x = x.reshape(2, 32, 2, 32, 2, 3).transpose(0, 1, 3, 2, 4, 5).reshape(2, 32, 32, 12)
    jm, tm, v = _models(cfg, x)
    n_jax = len(flatten_params(v['params'])) + len(flatten_params(v['batch_stats']))
    assert len(convert_flax_farseg(v)) == n_jax == len(tm.state_dict())
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, CLASSES) and want.std() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def test_farseg_pp_three_sgd_steps_match_jax(x64):
    """Three SGD + momentum steps of the narrow FarSeg++ in float64 in both
    packages (``test_torch_farseg.py`` says why float64) at dropout 0:
    cls_loss, grad_norm and learning_rate each step to rtol 1e-5 (the
    float32 loss's rounding), then every parameter and running statistic
    to 1e-6 absolute."""
    cfg = dict(NARROW_V2, dtype='float64', head=dict(HEAD_V2, fs_relation=dict(
        HEAD_V2['fs_relation'], dropout_rate=0.0)))
    x, y = _batch(2, 64, seed=3)
    x = x.astype(np.float64)
    jm = jbuilder.make_model({'type': 'FarSeg', 'params': cfg})
    v = jax.tree.map(lambda a: a.astype(np.float64), seeded_variables(jm, x))
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu').double()
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    jsched, tx = _sgd('jax')
    jstate = jspmd.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                              batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
    jstep = jspmd.build_train_step(jm, tx, jsched, donate=False)
    tsched, rule = _sgd('torch')
    tstate = tspmd.create_train_state(tm, rule)
    tstep = tspmd.build_train_step(tm, rule, tsched)
    for _ in range(3):
        jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tmet = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    _close_state(tm, jstate.params, jstate.batch_stats, atol=1e-6)


def test_farseg_pp_dropouts_draw_from_the_step_generator():
    """With FarSeg++'s channel dropout (0.1, the default) and classifier
    dropout (0.1): train losses differ between two generators' seeds, are
    the same bits from the same seed, and the train step's per-step
    generator makes two runs of two steps bit-equal and their two steps'
    masks differ; eval mode draws nothing."""
    cfg = dict(NARROW_V2, head=dict(HEAD_V2, fpn_decoder=dict(
        HEAD_V2['fpn_decoder'], classifier_config=dict(dropout_rate=0.1))))
    x, y = _batch(2, 64, seed=4)
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
    assert tm.head.fs_relation.dropout_rate == 0.1
    assert tm.head.fpn_decoder.dropout_rate == 0.1
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss(seed):
        with torch.no_grad():
            return tm(xt, yt, train=True,
                      generator=torch.Generator().manual_seed(seed))['cls_loss']

    assert torch.equal(loss(0), loss(0)) and not torch.equal(loss(0), loss(1))
    with pytest.raises(ValueError, match='generator'):
        tm(xt, yt, train=True)
    with torch.no_grad():
        torch.testing.assert_close(tm(xt), tm(xt), rtol=0, atol=0)
    runs = []
    for _ in range(2):
        model = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu')
        model.load_state_dict(tm.state_dict())
        sched, rule = _sgd('torch')
        state = tspmd.create_train_state(model, rule)
        step = tspmd.build_train_step(model, rule, sched)
        losses = [float(step(state, (xt, yt))[1]['cls_loss']) for _ in range(2)]
        runs.append((losses, {k: t.clone() for k, t in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k, t in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], t, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize('top_blocks,levels', [('maxpool', 5), ('p6p7', 6)])
def test_fpn_top_blocks_match_jax(top_blocks, levels):
    """FPN with ``top_blocks``: a stride-2 1×1 max pool of P5, or RetinaNet's
    P6/P7 (3×3/2 convs with lax's asymmetric 'SAME' padding on an odd-sized
    P5), in BN mode: every level to 1e-5 of its scale, eval and train."""
    widths, sizes = (16, 24, 32, 48), (20, 10, 5, 3)
    feats = _feats(widths, sizes, seed=5)
    jm = jfpn.FPN(widths, 32, conv_norm='bn', conv_act=True, top_blocks=top_blocks)
    v = _seeded(jm, [jnp.asarray(f) for f in feats])
    tm = tfpn.FPN(widths, 32, conv_norm='bn', conv_act=True, top_blocks=top_blocks)
    tm.load_state_dict(_head_sd(v, 'fpn'), strict=True)
    for train in (False, True):
        want = jm.apply(v, [jnp.asarray(f) for f in feats], train, mutable=['batch_stats'])[0]
        with torch.no_grad():
            got = tm([nchw(f) for f in feats], train)
        assert len(got) == len(want) == levels
        for g, w in zip(got, want):
            close(nhwc(g), w, 1e-5)
    if top_blocks == 'p6p7':
        assert tuple(got[-2].shape[2:]) == (2, 2) and tuple(got[-1].shape[2:]) == (1, 1)


def test_p6p7_initialisation():
    """P6/P7 start from kaiming-uniform (a=1) weights, bound √(3/fan_in), and
    zero biases, as the JAX package initialises them."""
    m = tfpn.LastLevelP6P7(64)
    bound = (3 / (64 * 9)) ** 0.5
    for conv in (m.p6, m.p7):
        w = conv.weight.detach().abs().max().item()
        assert 0.9 * bound < w <= bound
        assert conv.bias.detach().abs().max().item() == 0.0


@pytest.mark.parametrize('align_corners', [False, True])
@pytest.mark.parametrize('norm', ['gn', 'ln', None, 'bn'])
def test_decoder_variants_match_jax(norm, align_corners):
    """AssymetricDecoder with BN/ReLU or GN, LN or no norm with tanh GELU,
    half-pixel or corner-aligned resizes (the ×2 steps and the classifier's
    ×4): the logits in eval mode to 1e-5 of the scale; in train mode with
    GN/LN (no batch statistics) too."""
    feats = _feats((32,) * 4, (16, 8, 4, 2), seed=6)
    cls = dict(scale_factor=4.0, num_classes=5, kernel_size=1)
    kw = dict(in_channels=32, out_channels=32, norm=norm, classifier_config=cls,
              align_corners=align_corners)
    jm = jfpn.AssymetricDecoder(**kw)
    v = _seeded(jm, [jnp.asarray(f) for f in feats])
    tm = tfpn.AssymetricDecoder(**kw)
    tm.load_state_dict(_head_sd(v, 'fpn_decoder'), strict=True)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    assert tuple(got.shape) == (2, 5, 64, 64)
    close(nhwc(got), want, 1e-5)
    if norm in ('gn', 'ln'):
        with torch.no_grad():
            got = tm([nchw(f) for f in feats], train=True)
        close(nhwc(got), jm.apply(v, [jnp.asarray(f) for f in feats], True), 1e-5)
