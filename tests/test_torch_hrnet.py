"""HRNetV2 in the port against the JAX package, on the CPU.

HRNetV2-W18 at 64², B=2, in float64, from the same seeded weights in both
packages, the trunk cut to one module a stage and two blocks a branch (both
packages' depth constants patched): the four features of a train-mode
forward, the running statistics after it and the gradient of every
parameter (stem, layer1, each transition, each stage's branches and fuse
layers) for a seeded cotangent on each feature.  The cut keeps every kind
of layer and fuse; the JAX package's gradient of the full trunk takes
43–56 s op by op on a CPU and 74 s under ``jax.jit``, the cut one's about
13 s under jit.  The full trunk's names and shapes are held by the
converter test (1525 tensors) and its forward on the card.  Tolerance 1e-9 of the scale: both sides are
float64 throughout, and the fuse sums its terms in the same order.

Then ``frozen_stages`` (the optimizer's prefixes, the JAX package's with
dots, and a step that leaves exactly those parameters alone), ``norm_eval``
(running statistics pinned and used in training), ``with_cp`` (gradients
and running statistics bit-equal to the plain run, the statistics moved
once), ``pack_branches=True`` (the same ``state_dict`` in both packages),
the converter's coverage, the registry names and the shims.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.core import builder as jbuilder
from ever_tpu.module import hrnet as jhrnet
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.module import hrnet as thrnet
from ever_tpu_torch.parallel import spmd as tspmd
from ever_tpu_torch.util.weight_io import convert_flax_hrnet, flatten_params
from test_torch_resnet import close, one_torch_thread  # noqa: F401
from test_torch_zoo_ops import _nchw, _nhwc, _seeded, _x

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = 1e-9
W18 = dict(hrnet_type='hrnetv2_w18')


def _jax_w18(x, gs):
    """The JAX HRNetV2-W18 encoder in float64 on x from seeded variables:
    its train-mode features, new batch statistics and the parameter
    gradients of Σ feature · cotangent, under ``jax.jit``."""
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'HRNetEncoder', 'params': dict(W18, dtype='float64')})
        v = _seeded(jm, jnp.asarray(x))

        def loss(params):
            feats, mut = jm.apply({**v, 'params': params}, jnp.asarray(x), train=True,
                                  mutable=['batch_stats'])
            return sum((f * g).sum() for f, g in zip(feats, gs)), (feats, mut)

        (_, (feats, mut)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v['params'])
    return dict(v=v, x=x, feats=[np.asarray(f) for f in feats], stats=mut['batch_stats'],
                grads=grads, gs=gs)


def _cotangents():
    return [_x((2, 64 // s, 64 // s, c), seed=10 + i)
            for i, (s, c) in enumerate(zip((4, 8, 16, 32), thrnet.HRNET_WIDTHS['hrnetv2_w18']))]


@contextlib.contextmanager
def cut_depth():
    """Both packages' HRNet at one module a stage, two blocks a branch."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jhrnet, thrnet):
            mp.setattr(mod, 'STAGE_MODULES', (1, 1, 1))
            mp.setattr(mod, 'BLOCKS_PER_BRANCH', 2)
        yield


@pytest.fixture(scope='module')
def w18_cut():
    """The cut trunk (module docstring): the JAX features, statistics and
    gradient under jit, and the port's after the same forward and
    backward."""
    with cut_depth():
        ref = _jax_w18(_x((2, 64, 64, 3)), _cotangents())
        tm = _port(W18, ref['v'])
    feats = tm(torch.from_numpy(ref['x']), train=True)
    sum((f * _nchw(g)).sum() for f, g in zip(feats, ref['gs'])).backward()
    return ref, tm, feats


def _port(cfg, v, dtype=torch.float64):
    tm = tbuilder.make_model({'type': 'HRNetEncoder', 'params': dict(
        cfg, dtype=str(dtype).split('.')[1])}, device='cpu').to(dtype)
    tm.load_state_dict(convert_flax_hrnet(v), strict=True)
    return tm


def test_w18_features_and_running_statistics_match_jax(w18_cut):
    """The four features (strides 4, 8, 16, 32; 18, 36, 72, 144 wide) and
    every BatchNorm's running statistics after the train forward (flax's
    biased-variance update)."""
    ref, tm, feats = w18_cut
    assert [tuple(f.shape) for f in feats] == [(2, 18, 16, 16), (2, 36, 8, 8),
                                               (2, 72, 4, 4), (2, 144, 2, 2)]
    for got, want in zip(feats, ref['feats']):
        close(_nhwc(got), want, TOL)
    sd = tm.state_dict()
    moved = convert_flax_hrnet({}, ref['stats'])
    assert len(moved) == 2 * sum(hasattr(m, 'running_mean') for m in tm.modules())
    for k, w in moved.items():
        close(sd[k].numpy(), w.numpy(), TOL)


@pytest.mark.parametrize('part', ['hrnet.conv1', 'hrnet.bn2', 'hrnet.layer1', 'hrnet.transition1',
                                  'hrnet.stage2', 'hrnet.transition2', 'hrnet.stage3',
                                  'hrnet.transition3', 'hrnet.stage4'])
def test_w18_gradients_match_jax(w18_cut, part):
    """Every parameter's gradient of the cut trunk, by part (the stem,
    layer1, each transition and each stage's branches and fuse layers)."""
    ref, tm, _ = w18_cut
    want = convert_flax_hrnet(ref['grads'])
    params = dict(tm.named_parameters())
    names = [n for n in params if n.startswith(part + '.')]
    assert names
    for name in names:
        close(params[name].grad.numpy(), want[name].numpy(), TOL)


def test_converter_covers_every_variable():
    """Every JAX variable of the full W18 encoder maps to one port key, the
    port has no key without a value (1525 of them), and a bare trunk's
    tree gives the trunk's keys; a stray variable raises."""
    v = _seeded(jhrnet.HRNetEncoder(W18), jnp.zeros((1, 32, 32, 3)))
    sd = convert_flax_hrnet(v)
    n_jax = len(flatten_params(v['params'])) + len(flatten_params(v['batch_stats']))
    tm = thrnet.HRNetEncoder(W18)
    assert len(sd) == n_jax == len(tm.state_dict()) == 1525 and set(sd) == set(tm.state_dict())
    bare = convert_flax_hrnet(v['params']['hrnet'], v['batch_stats']['hrnet'])
    assert set(bare) == set(thrnet.HRNet('hrnetv2_w18').state_dict())
    with pytest.raises(KeyError, match='unmapped'):
        convert_flax_hrnet({'hrnet': {'extra': {'kernel': np.zeros((1, 1, 1, 1))}}})


@pytest.mark.parametrize('frozen_stages', [-1, 0, 1, 2, 3])
def test_frozen_stages_freeze_the_jax_prefixes(frozen_stages):
    """The port's ``frozen_param_prefixes`` are the JAX package's with dots
    for slashes, each names some parameters, and an SGD step through the
    train step leaves exactly the parameters under them unchanged."""
    cfg = dict(W18, frozen_stages=frozen_stages)
    want = jhrnet.HRNetEncoder(cfg).frozen_param_prefixes()
    tm = thrnet.HRNetEncoder(cfg)
    got = tm.frozen_param_prefixes()
    assert got == [p.replace('/', '.') for p in want]
    names = [n for n, _ in tm.named_parameters()]
    assert all(any(n.startswith(p) for n in names) for p in got)
    frozen = {n for n in names if n.startswith(tuple(got))}
    assert bool(frozen) == (frozen_stages >= 0)

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = tm

        def forward(self, x, y=None, train=False, generator=None):
            return {'probe_loss': sum(f.float().square().mean() for f in self.encoder(x, train))}

    model = Probe()
    factory, _ = tbuilder.make_optimizer({'type': 'sgd', 'params': dict(momentum=0.9)})
    tx = factory.build(0.1, frozen_prefixes=tuple('encoder.' + p for p in got) or None)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tspmd.create_train_state(model, tx)
    tspmd.build_train_step(model, tx)(state, (torch.from_numpy(_x((2, 64, 64, 3)).astype(
        np.float32)), torch.zeros(2, 64, 64, dtype=torch.long)))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n[len('encoder.'):] in frozen), n


def test_norm_eval_pins_the_running_statistics():
    """``norm_eval=True``: a train forward normalises by the running
    statistics (the eval forward's bits) and moves none of them, as the
    JAX package's ``bn_frozen``."""
    torch.manual_seed(0)
    tm = thrnet.HRNetEncoder(dict(W18, norm_eval=True))
    for m in tm.modules():
        if hasattr(m, 'running_var'):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    x = torch.from_numpy(_x((2, 32, 32, 3)).astype(np.float32))
    train = tm(x, train=True)
    ev = tm(x, train=False)
    assert all(torch.equal(a, b) for a, b in zip(train, ev))
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert all(m.frozen for m in tm.modules() if hasattr(m, 'frozen'))


def test_with_cp_matches_the_plain_run():
    """``with_cp=True`` (the trunk recomputed in the backward pass): the
    same features, gradients and running statistics, bit for bit; the
    statistics move once."""
    x = torch.from_numpy(_x((2, 32, 32, 3)).astype(np.float32))
    runs = []
    for with_cp in (False, True):
        torch.manual_seed(0)
        tm = thrnet.HRNetEncoder(dict(W18, with_cp=with_cp))
        feats = tm(x, train=True)
        sum(f.square().mean() for f in feats).backward()
        runs.append((feats, {n: p.grad for n, p in tm.named_parameters()}, tm.state_dict()))
    (f0, g0, s0), (f1, g1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(f0, f1))
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_pack_branches_is_the_same_state_dict():
    """``pack_branches=True`` (the JAX package's TPU layout of the same
    function): the port builds the same ``state_dict``, and the JAX
    package's packed tree (of the cut trunk) converts onto it."""
    x = jnp.zeros((1, 32, 32, 3))
    with cut_depth():
        jv = jax.eval_shape(lambda: jhrnet.HRNetEncoder(dict(W18, pack_branches=True)).init(
            jax.random.key(0), x))
        packed = thrnet.HRNetEncoder(dict(W18, pack_branches=True)).state_dict()
        plain = thrnet.HRNetEncoder(W18).state_dict()
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jv)
    assert {k: v.shape for k, v in packed.items()} == {k: v.shape for k, v in plain.items()}
    assert {k: v.shape for k, v in convert_flax_hrnet(zeros).items()} == {
        k: v.shape for k, v in plain.items()}


def test_registry_names_and_shims():
    """``hrnetv2_w18/w32/w40/w48`` build the trunks with their widths through
    ``builder.make_model``; the ``_hrnet`` and ``_resnets`` shims give the
    reference's spellings (``conv3x3``/``conv1x1`` take the input width)."""
    from ever_tpu_torch.module import _hrnet, _resnets
    for name, widths in thrnet.HRNET_WIDTHS.items():
        m = tbuilder.make_model({'type': name, 'params': {}}, device='cpu')
        assert isinstance(m, thrnet.HRNet)
        assert m.stage4[0].channels == widths
        assert isinstance(getattr(_hrnet, name)(pretrained=True), thrnet.HRNet)
    assert _hrnet.HighResolutionNet is thrnet.HRNet
    assert thrnet.HRNetEncoder(dict(hrnet_type='hrnetv2_w32')).output_channels() == (
        32, 64, 128, 256)
    r = _resnets.resnet18()
    assert sum(p.numel() for p in r.parameters()) == 11176512   # torchvision's, without fc
    c3 = _resnets.conv3x3(8, 16, stride=2, dilation=2)
    assert c3.weight.shape == (16, 8, 3, 3) and c3.padding == (2, 2) and c3.stride == (2, 2)
    assert c3.bias is None and _resnets.conv1x1(8, 4).weight.shape == (4, 8, 1, 1)
    lin = torch.nn.Conv2d(2, 3, 1)
    _hrnet.constant_init(lin, 0.5, bias=0.25)
    assert float(lin.weight.min()) == 0.5 and float(lin.bias.max()) == 0.25
    _hrnet.kaiming_init(lin)
    assert float(lin.bias.abs().max()) == 0.0
