"""The port's ResNet against the JAX package, on the CPU in float32.

Blocks in eval and train mode, ResNet-50's features at 64², output strides
8 and 16, the deep v1c stem and grouped convs, the running statistics after
one train forward (flax's biased-variance update), frozen BatchNorm, and
``with_cp`` against no checkpointing.  Weights are seeded random draws in
the JAX tree, carried over by ``convert_flax_resnet``; inputs come from
numpy with a seed.  Tolerances: 1e-5 of the output's scale in eval mode
(float32 sums in other orders); 1e-4 in train mode, where the batch
variance divides (flax's one-pass E[x²] − E[x]² against PyTorch's
two-pass variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.module import resnet as jres
from ever_tpu_torch.module import resnet as tres
from ever_tpu_torch.util.weight_io import convert_flax_resnet

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


@pytest.mark.parametrize('kw', [dict(stem='s2d_input'), dict(se_ratio=16),
                                dict(gc_ratio=0.25)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tres.ResNet(resnet_type='resnet18', **kw)


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
