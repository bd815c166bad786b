"""The port's ResNet against the JAX package, on the CPU in float32.

Blocks in eval and train mode, ResNet-50's features at 64², output strides
8 and 16, the deep v1c stem and grouped convs, the running statistics after
one train forward (flax's biased-variance update), frozen BatchNorm,
``with_cp`` against no checkpointing, the SE and GC branches and their
plugin functions, and the folded-input stem (``stem='s2d_input'``) against
the JAX stem and the port's own conv stem.  Weights are seeded random draws in
the JAX tree, carried over by ``convert_flax_resnet``; inputs come from
numpy with a seed.  Tolerances: 1e-5 of the output's scale in eval mode
(float32 sums in other orders); 1e-4 in train mode, where the batch
variance divides (flax's one-pass E[x²] − E[x]² against PyTorch's
two-pass variance).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import resnet as jres
from ever_tpu_torch.module import resnet as tres
from ever_tpu_torch.util.weight_io import convert_flax_resnet


@contextlib.contextmanager
def torch_threads(n):
    """Torch's intra-op thread count set to ``n`` inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: in a parallel test run a process's default pool
    (a thread a core) contends with the other workers', and these small
    CPU steps slow tens of times (about 0.5 s to 15 s a step).  The port's
    test files that step models on the CPU take it for every test."""
    with torch_threads(1):
        yield


pytestmark = pytest.mark.usefixtures('one_torch_thread')

# small stand-ins registered in both packages' RESNET_SPECS: one block per
# stage, grouped (32 groups of 4) and with the deep v1c stem
TINY_SPECS = {
    'resnext_tiny': ('Bottleneck', (1, 1, 1, 1), 32, 4, False),
    'resnet_v1c_tiny': ('Bottleneck', (1, 1, 1, 1), 1, 64, True),
}


@pytest.fixture(autouse=True)
def tiny_specs(monkeypatch):
    for pkg in (jres, tres):
        for name, (block, *rest) in TINY_SPECS.items():
            monkeypatch.setitem(pkg.RESNET_SPECS, name, (getattr(pkg, block), *rest))


def seeded_variables(module, x, seed=0, **kw):
    """Seeded random variables in the JAX module's tree: kernels
    ~N(0, 1/fan_in), BN scales ~U(0.5, 1.5) and biases ~N(0, 0.1²), running
    means ~N(0, 0.1²) and variances ~U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init({'params': jax.random.key(0)},
                                                jnp.asarray(x), **kw))
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


def close(got, want, tol):
    """max |got - want| <= tol · max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, f'max error {err:.3e} against scale {scale:.3e}'


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _block_sd(variables):
    """A JAX block's variables as the port block's state_dict: the ResNet
    converter under a stage prefix, stripped again."""
    flat = {'params': {'layer1': {'block0': variables['params']}},
            'batch_stats': {'layer1': {'block0': variables['batch_stats']}}}
    return {k[len('layer1.0.'):]: v for k, v in convert_flax_resnet(flat).items()}


@pytest.mark.parametrize('kind,cin,filters,stride,dilation', [
    ('BasicBlock', 16, 16, 1, 1), ('BasicBlock', 8, 16, 2, 1),
    ('Bottleneck', 32, 8, 1, 2), ('Bottleneck', 16, 8, 2, 1)])
@pytest.mark.parametrize('train', [False, True])
def test_block_matches_jax(kind, cin, filters, stride, dilation, train):
    """One block (with a downsample shortcut where the stride or the width
    changes) in eval and in train mode: output, and in train mode the moved
    running statistics."""
    jcls, tcls = getattr(jres, kind), getattr(tres, kind)
    needs_ds = stride != 1 or cin != filters * tcls.expansion
    jblock = jcls(filters, stride, dilation, conv_dilation=dilation, downsample=needs_ds)
    x = _x((2, 8, 8, cin))
    v = seeded_variables(jblock, x)
    want, mut = jblock.apply(v, jnp.asarray(x), train=train, mutable=['batch_stats'])
    tblock = tcls(cin, filters, stride, dilation, dilation, downsample=needs_ds)
    tblock.load_state_dict(_block_sd(v), strict=True)
    got = tblock(nchw(x), train=train)
    close(nhwc(got), want, 1e-4 if train else 1e-5)
    sd = tblock.state_dict()
    for k, w in _block_sd({'params': v['params'], 'batch_stats': mut['batch_stats']}).items():
        if 'running' in k:
            close(sd[k].numpy(), w.numpy(), 1e-5)


def _both_resnets(seed=0, x_shape=(2, 64, 64, 3), **kw):
    jm = jres.ResNet(**kw)
    x = _x(x_shape, seed + 1)
    v = seeded_variables(jm, x, seed)
    tm = tres.ResNet(**kw)
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    return jm, tm, v, x


@pytest.mark.parametrize('kw', [
    dict(resnet_type='resnet50'),
    dict(resnet_type='resnet18', output_stride=8),
    dict(resnet_type='resnet18', output_stride=16, include_conv5=False),
    dict(resnet_type='resnext_tiny', output_stride=16),
    dict(resnet_type='resnet_v1c_tiny', maxpool_impl='pallas'),
])
def test_resnet_features_match_jax_in_eval(kw):
    """[c2, c3, c4, c5] at 64², B=2, in eval mode (running statistics)."""
    jm, tm, v, x = _both_resnets(**kw)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == (4 if kw.get('include_conv5', True) else 3)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-5)


def test_resnet_train_forward_moves_running_stats_like_flax():
    """One train forward of a ResNet-18 at 64², B=2: features, and every
    running mean and variance after flax's update (0.9·r + 0.1·batch, the
    biased batch variance; layer4 normalises over n = 2·2·2 = 8 values per
    channel, where the unbiased variance would be 8/7 of it)."""
    jm, tm, v, x = _both_resnets(resnet_type='resnet18', maxpool_impl='pallas')
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=['batch_stats']))(
        v, jnp.asarray(x))
    got = tm(nchw(x), train=True)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-4)
    sd = tm.state_dict()
    moved = convert_flax_resnet({'params': v['params'], 'batch_stats': mut['batch_stats']})
    stats = [k for k in moved if 'running' in k]
    assert len(stats) == 2 * 20                      # 17 BNs + 3 downsample BNs
    for k in stats:
        close(sd[k].numpy(), moved[k].numpy(), 1e-5)


def test_frozen_batchnorm_pins_statistics_like_jax():
    """batchnorm_trainable=False: a train forward normalises by the running
    statistics and leaves them as they were, as the JAX encoder does."""
    cfg = dict(resnet_type='resnext_tiny', batchnorm_trainable=False)
    jm = jres.ResNetEncoder(cfg)
    x = _x((2, 32, 32, 3))
    v = seeded_variables(jm, x)
    want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=['batch_stats'])
    tm = tres.ResNetEncoder(cfg)
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    got = tm(torch.from_numpy(x), train=True)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-5)
    for k, t in tm.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_with_cp_matches_no_checkpointing():
    """with_cp on every stage: the same features, parameter gradients and
    running statistics as without it.  The statistics move once per
    forward: the backward's recomputation of a stage leaves them alone."""
    _, plain, v, x = _both_resnets(resnet_type='resnet18', maxpool_impl='pallas')
    cp = tres.ResNet(resnet_type='resnet18', maxpool_impl='pallas', with_cp=(True,) * 4)
    cp.load_state_dict(convert_flax_resnet(v), strict=True)
    w = [torch.from_numpy(_x(s, 7 + i)) for i, s in enumerate(
        [(2, 64, 16, 16), (2, 128, 8, 8), (2, 256, 4, 4), (2, 512, 2, 2)])]
    grads, feats = [], []
    for model in (plain, cp):
        out = model(nchw(x), train=True)
        sum((f * wi).sum() for f, wi in zip(out, w)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        feats.append(out)
    for a, b in zip(*feats):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-6, msg=n)
    bufs = dict(cp.named_buffers())
    for n, b in plain.named_buffers():
        torch.testing.assert_close(bufs[n], b, rtol=0, atol=0, msg=n)
    stem_mean = convert_flax_resnet(v)['bn1.running_mean']
    assert not torch.equal(bufs['layer4.1.bn2.running_mean'],
                           convert_flax_resnet(v)['layer4.1.bn2.running_mean'])
    assert not torch.equal(bufs['bn1.running_mean'], stem_mean)


def _fold(x):
    """The 2×2 space-to-depth of an NHWC batch, channel (dy·2 + dx)·C + c."""
    b, h, w, c = x.shape
    return np.ascontiguousarray(x.reshape(b, h // 2, 2, w // 2, 2, c)
                                .transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c))


@pytest.mark.parametrize('kw', [dict(stem='s2d_input'), dict(se_ratio=16),
                                dict(gc_ratio=0.25)])
def test_unported_options_raise(kw):
    """The options that raised ``NotImplementedError`` before they were
    ported (the folded-input stem, the SE and the GC block) now build, and
    ResNet-18's features match the JAX package's with the same variables
    (every SE/GC weight a seeded draw, the GC expand not zero) at 64²,
    batch 2: in eval mode in float32 to 1e-5 of the scale, and after one
    train forward in float64 in both packages (the running statistics too)
    to 1e-6, float32's limit, as both packages pool the SE squeeze and the
    GC context in float32 (1e-6 measured at the GC's last stage; the
    folded stem alone agrees to 1e-13)."""
    x = _x((2, 64, 64, 3))
    if 'stem' in kw:
        x = _fold(x)
    jm = jres.ResNet(resnet_type='resnet18', **kw)
    v = seeded_variables(jm, x)
    tm = tres.ResNet(resnet_type='resnet18', **kw)
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-5)
    with jax.enable_x64(True):
        jm = jres.ResNet(resnet_type='resnet18', dtype=jnp.float64, **kw)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        want, mut = jax.jit(functools.partial(jm.apply, train=True, mutable=['batch_stats']))(
            v64, jnp.asarray(x, jnp.float64))
        want = [np.asarray(w) for w in want]
        moved = convert_flax_resnet({}, mut['batch_stats'])
    tm.double()
    tm.load_state_dict(convert_flax_resnet(v64), strict=True)
    with torch.no_grad():
        got = tm(nchw(x).double(), train=True)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-6)
    sd = tm.state_dict()
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), 1e-6)


@pytest.mark.parametrize('block', ['resnext_tiny'])
@pytest.mark.parametrize('kw', [dict(se_ratio=8), dict(gc_ratio=1 / 16),
                                dict(se_ratio=4, gc_ratio=1 / 8)])
def test_se_gc_blocks_match_jax(block, kw):
    """Grouped Bottlenecks (the BasicBlocks are above) with an SE branch,
    a GC branch or both (SE first, as in the JAX blocks): the last feature
    in eval mode to 1e-5 of its scale."""
    jm = jres.ResNet(resnet_type=block, **kw)
    x = _x((2, 32, 32, 3), seed=4)
    v = seeded_variables(jm, x)
    tm = tres.ResNet(resnet_type=block, **kw)
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))[-1]), jm.apply(v, jnp.asarray(x))[-1], 1e-5)


@pytest.mark.parametrize('stem', ['s2d_input', 's2d_input_pack2'])
def test_folded_input_stem_is_the_conv_stem(stem):
    """``stem='s2d_input'`` (and its pack2 variant) on the folded batch:
    the same bits as the port's ``stem='conv'`` on the unfolded batch with
    the same state_dict (depth-to-space is a permutation), and the JAX
    package's folded stem within 1e-5 of the scale.  A checkpoint moves
    between the stems unchanged."""
    x = _x((2, 48, 64, 3), seed=6)
    jm = jres.ResNet(resnet_type='resnet18', stem=stem)
    v = seeded_variables(jm, _fold(x))
    folded = tres.ResNet(resnet_type='resnet18', stem=stem)
    folded.load_state_dict(convert_flax_resnet(v), strict=True)
    plain = tres.ResNet(resnet_type='resnet18')
    plain.load_state_dict(folded.state_dict(), strict=True)
    assert folded.conv1.weight.shape == (64, 3, 7, 7)
    with torch.no_grad():
        got, ref = folded(nchw(_fold(x))), plain(nchw(x))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    want = jm.apply(v, jnp.asarray(_fold(x)))
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-5)


def test_folded_input_stem_takes_odd_folded_sizes():
    """A folded batch of odd size (17×13 → 34×26 unfolded) runs, as in the
    JAX package (``tests/test_model_zoo.py``), and matches it."""
    x = _x((1, 17, 13, 12), seed=8)
    jm = jres.ResNet(resnet_type='resnet18', stem='s2d_input')
    v = seeded_variables(jm, x)
    assert v['params']['conv1']['kernel'].shape == (7, 7, 3, 64)
    tm = tres.ResNet(resnet_type='resnet18', stem='s2d_input')
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    with torch.no_grad():
        got = tm(nchw(x))
    want = jm.apply(v, jnp.asarray(x))
    assert tuple(got[0].shape[2:]) == want[0].shape[1:3] == (9, 7)
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-5)


def test_deep_stem_takes_the_folded_input_as_it_comes():
    """The deep (v1c) stem ignores ``stem`` in the JAX package: its first
    3×3/2 conv reads the folded input's 4C channels.  The port does the
    same, and the features match to 1e-5 of the scale."""
    x = _fold(_x((2, 32, 32, 3), seed=10))
    jm = jres.ResNet(resnet_type='resnet_v1c_tiny', stem='s2d_input')
    v = seeded_variables(jm, x)
    assert v['params']['stem_conv1']['kernel'].shape == (3, 3, 12, 32)
    tm = tres.ResNet(resnet_type='resnet_v1c_tiny', stem='s2d_input')
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))[-1]), jm.apply(v, jnp.asarray(x))[-1], 1e-5)


@pytest.mark.parametrize('plugin', ['se_basic', 'se_bottleneck', 'gc_basic', 'gc_resnet'])
def test_plugins_keep_the_weights(plugin):
    """The plugin functions return a copy of the module with the branch in
    every block: the copy keeps every existing parameter and buffer, the
    original is unchanged, the new GC branch starts as the identity (so the
    features are unchanged), and an encoder's config carries the ratio."""
    from ever_tpu_torch.module import context_block as tgc, se_block as tse

    fn, ratio, key = {'se_basic': (tse.plugin_to_basicblock, 8, 'se_ratio'),
                      'se_bottleneck': (tse.plugin_to_bottleneck, 8, 'se_ratio'),
                      'gc_basic': (tgc.plugin_to_basicblock, 0.25, 'gc_ratio'),
                      'gc_resnet': (tgc.plugin_to_resnet, 0.25, 'gc_ratio')}[plugin]
    kind = 'resnet18' if plugin.endswith('basic') else 'resnext_tiny'
    enc = tres.ResNetEncoder(dict(resnet_type=kind))
    before = {k: t.clone() for k, t in enc.state_dict().items()}
    out = fn(enc, ratio)
    assert out.config[key] == ratio and enc.config[key] is None
    assert set(enc.state_dict()) == set(before)
    sd = out.state_dict()
    added = set(sd) - set(before)
    branch = 'se.' if key == 'se_ratio' else 'gc.'
    assert added and all(branch in k for k in added)
    for k, t in before.items():
        torch.testing.assert_close(sd[k], t, rtol=0, atol=0)
    stage = fn(enc.resnet.layer2, ratio)
    assert all(getattr(b, key[:2]) is not None for b in stage)
    assert enc.resnet.layer2[0].se is None and enc.resnet.layer2[0].gc is None
    if key == 'gc_ratio':
        x = torch.from_numpy(_x((1, 32, 32, 3), seed=12))
        with torch.no_grad():
            for a, b in zip(enc(x), out(x)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize('stem', ['s2d', 's2dw', 's2d3'])
def test_tpu_stems_are_the_plain_conv(stem):
    """The JAX package's folded stems compute the 7×7/2 conv with the same
    [7, 7, 3, 64] parameter: the port builds the plain conv for each, and
    the JAX model with the fold gives the port's features."""
    jm = jres.ResNet(resnet_type='resnext_tiny', stem=stem)
    x = _x((1, 32, 32, 3))
    v = seeded_variables(jm, x)
    tm = tres.ResNet(resnet_type='resnext_tiny', stem=stem, pack2_layer1=True)
    tm.load_state_dict(convert_flax_resnet(v), strict=True)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        close(nhwc(tm(nchw(x))[-1]), want[-1], 1e-5)
