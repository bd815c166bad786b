"""ViTEncoder in the port against the JAX package, on the CPU.

``vit_small`` cut to 4 blocks (``vit_small_d4``: width 384, 6 heads, 4
storage tokens, patch 16; a test-local entry patched into both packages'
``VIT_SPECS``, since the Pallas kernel's interpret mode compiles slowly
per block) at 64²: a 4×4 patch grid, 21 tokens.  The same seeded weights in both
packages (LayerNorm scales ~U(0.5, 1.5), so every block moves the
taps), float32, the JAX trunk's attention through its Pallas kernel in
interpret mode (``attn_impl='fused'``), as ``test_torch_vit.py`` runs it,
the port's through the kernels' plain versions; the JAX side under
``jax.jit``.  With the pyramid, the taps of blocks 0, 1, 2 and 3 resized
to 16², 8², 4² and 2², and the gradient of every parameter and of the
input for a seeded cotangent on each level; without it, the four taps on
the grid.  Then the 0.5× tap's antialiased halving against
``jax.image.resize`` on its own, and the ``ValueError`` for a pyramid of
other than four taps; a flat ``.npz`` of the JAX encoder's variables, bare
and beside an FPN head, through ``load_weights``.

Tolerance: 1e-4 of the scale for the taps and gradients after 4 blocks
of float32 arithmetic summed in different orders (measured 8.4e-7 on the
taps, 2.2e-6 on the parameters' gradients, 1.3e-6 on the input's), as
``test_torch_vit.py`` holds DinoSeg after 12; 1e-6 for the resize alone
(float32 rounding of the same weights).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ever_tpu.module  # noqa: F401  (registers the JAX models)
from ever_tpu.module import fpn as jfpn
from ever_tpu.module import vit as jvit
from ever_tpu.util.weight_io import flatten_tree
from ever_tpu_torch.core import registry as tregistry
from ever_tpu_torch.module import fpn as tfpn
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.module.ops import downsample_bilinear
from ever_tpu_torch.util.weight_io import (convert_flax_encoder_head, convert_flax_vit_encoder,
                                           load_weights)
from test_torch_resnet import close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = 1e-4
TEST_SPEC = ('vit_small_d4', (4, 384, 6, 4.0, 'mlp'))
CFG = dict(vit_type='vit_small_d4', attn_impl='fused')


@pytest.fixture(scope='module', autouse=True)
def test_spec():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_SPECS, *TEST_SPEC)
        yield


def _weights(jm, x):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x))
    rng = np.random.default_rng(7)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if 'scale' in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 0.05 if 'kernel' in name else 0.02
        return rng.normal(scale=std, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope='module', params=[True, False], ids=['pyramid', 'taps'])
def reference(request):
    """The JAX encoder's weights, outputs and (with the pyramid) the
    gradients of Σ output · cotangent for its params and input."""
    pyramid = request.param
    jm = jvit.ViTEncoder(dict(CFG, pyramid=pyramid))
    x = np.random.default_rng(11).normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = _weights(jm, jnp.asarray(x))
    shapes = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x)))
    gs = [np.random.default_rng(50 + i).normal(size=s.shape).astype(np.float32)
          for i, s in enumerate(shapes)]

    def loss(params, x):
        outs = jm.apply({'params': params}, x)
        return sum((o * g).sum() for o, g in zip(outs, gs)), outs

    if pyramid:
        (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            v['params'], jnp.asarray(x))
    else:
        outs, gp, gx = jax.jit(lambda p: jm.apply({'params': p}, jnp.asarray(x)))(
            v['params']), None, None
    return dict(pyramid=pyramid, x=x, v=v, gs=gs, outs=[np.asarray(o) for o in outs],
                gp=gp, gx=None if gx is None else np.asarray(gx))


def test_encoder_matches_jax(reference):
    r = reference
    tm = tvit.ViTEncoder(dict(CFG, pyramid=r['pyramid']))
    tm.load_state_dict(convert_flax_vit_encoder(r['v']), strict=True)
    x = torch.from_numpy(r['x']).requires_grad_()
    outs = tm(x)
    sides = [16, 8, 4, 2] if r['pyramid'] else [4] * 4
    assert [tuple(o.shape) for o in outs] == [(2, 384, s, s) for s in sides]
    assert tm.out_channels() == (384,) * 4
    for got, want in zip(outs, r['outs']):
        close(got.permute(0, 2, 3, 1).detach().numpy(), want, TOL)
    if r['gp'] is None:
        return
    sum((o * torch.from_numpy(g).permute(0, 3, 1, 2)).sum()
        for o, g in zip(outs, r['gs'])).backward()
    want = convert_flax_vit_encoder(r['gp'])
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for k, p in named.items():
        close(p.grad.numpy(), want[k].numpy(), TOL)
    close(x.grad.numpy(), r['gx'], TOL)


@pytest.mark.parametrize('hw', [(4, 4), (32, 32), (7, 5)])
def test_half_tap_matches_jax_image_resize(hw):
    """The 0.5× tap's resize alone (and its backward a matrix product):
    ``jax.image.resize``'s antialiased bilinear halving, odd sizes too."""
    h, w = hw
    t = np.random.default_rng(h * w).normal(size=(2, h, w, 6)).astype(np.float32)
    shape = (int(h * 0.5), int(w * 0.5))
    want = np.asarray(jax.image.resize(jnp.asarray(t), (2, *shape, 6), 'bilinear'))
    x = torch.from_numpy(t).requires_grad_()
    got = downsample_bilinear(x, shape)
    close(got.detach().numpy(), want, 1e-6)
    g = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, *shape, 6), 'bilinear'), jnp.asarray(t))
    close(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), 1e-6)


def test_default_taps_registry_and_pyramid_count():
    """The default taps are the last block of each quarter of the depth;
    ``ViTEncoder`` is in ``MODEL``; a pyramid of three taps raises the JAX
    package's ``ValueError``."""
    with torch.device('meta'):
        assert tregistry.MODEL['ViTEncoder'](dict(vit_type='vit_small')).out_indices() == [
            2, 5, 8, 11]
        assert tvit.ViTEncoder(dict(vit_type='vit_large')).out_indices() == [5, 11, 17, 23]
    three = tvit.ViTEncoder(dict(vit_type='vit_small_d4', out_indices=[0, 1, 3]))
    with pytest.raises(ValueError, match='expects exactly 4 out_indices'):
        three(torch.zeros(1, 32, 32, 3))
    flat = tvit.ViTEncoder(dict(vit_type='vit_small_d4', out_indices=[0, 1, 3], pyramid=False))
    assert [tuple(o.shape) for o in flat(torch.zeros(1, 32, 32, 3))] == [(1, 384, 2, 2)] * 3


class _JaxViTFPN(fnn.Module):
    """The JAX encoder under an FPN head (``encoder/vit/...``,
    ``head/fpn_inner{i}``, ``head/fpn_layer{i}``)."""

    def setup(self):
        self.encoder = jvit.ViTEncoder(dict(CFG, attn_impl='xla'))
        self.head = jfpn.FPN(in_channels_list=(384,) * 4, out_channels=16, conv_norm='bn')

    def __call__(self, x):
        return self.head(self.encoder(x))


class _TorchViTFPN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = tvit.ViTEncoder(dict(CFG))
        self.head = tfpn.FPN((384,) * 4, 16, conv_norm='bn')


@pytest.mark.parametrize('with_head', [False, True], ids=['bare', 'fpn_head'])
def test_npz_of_jax_variables_loads(tmp_path, with_head):
    """The JAX package's flat ``.npz`` (``params/vit/...``, or
    ``params/encoder/vit/...`` beside ``params/head/...`` and the batch
    statistics): every variable lands, equal to the converters'."""
    jm = _JaxViTFPN() if with_head else jvit.ViTEncoder(dict(CFG, attn_impl='xla'))
    tm = _TorchViTFPN() if with_head else tvit.ViTEncoder(dict(CFG))
    v = _weights(jm, jnp.zeros((1, 32, 32, 3), jnp.float32))
    flat = {f'{c}/{k}': a for c in v for k, a in flatten_tree(v[c]).items()}
    np.savez(tmp_path / 'w.npz', **flat)
    report = load_weights(str(tmp_path / 'w.npz'), tm, device='cpu', log=False)
    want = (convert_flax_encoder_head(v['params'], v['batch_stats']) if with_head
            else convert_flax_vit_encoder(v['params']))
    got = tm.state_dict()
    assert sorted(k for k in got if not k.endswith('num_batches_tracked')) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert not report.missing and not report.unexpected and not report.mismatched
