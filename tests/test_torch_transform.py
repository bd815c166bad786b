"""The port's transforms and test-time augmentation against
``ever_tpu.magic.transform``, on the CPU.

Each transform and its inverse on ``[2, 16, 16, 3]``; ``tta``,
``TestTimeAugmentation`` and ``d4_tta`` with a stub model that is not
equivariant (its output depends on the row), so a wrong inverse shows; and
``tiled_inference(tta='d4')``, with and without ``variables=``, against the
JAX ``tiled_inference`` with a narrow DinoSeg in float32 and a narrow
FarSeg in float64, the weights carried over by the converters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.magic import transform as jt
from ever_tpu.magic.tiled import tiled_inference as jax_tiled
from ever_tpu.module import vit as jvit
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.interface.transform_base import MultiTransform, Transform
from ever_tpu_torch.magic import transform as tt
from ever_tpu_torch.magic.tiled import tiled_inference as torch_tiled
from ever_tpu_torch.module import vit as tvit
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg, convert_flax_farseg
from test_torch_farseg import NARROW as FARSEG_NARROW
from test_torch_resnet import seeded_variables
from test_torch_trainer import TINY, _seeded_params

X = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)

_EXACT = [('Identity', ()), ('Rotate90k', (1,)), ('Rotate90k', (2,)), ('Rotate90k', (3,)),
          ('HorizontalFlip', ()), ('VerticalFlip', ()), ('Transpose', ())]


@pytest.mark.parametrize('name,args', _EXACT)
def test_transform_and_inverse_equal_jax(name, args):
    j, t = getattr(jt, name)(*args), getattr(tt, name)(*args)
    want = np.asarray(j.transform(jnp.asarray(X)))
    got = t.transform(torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.inv_transform(got).numpy(),
                                  np.asarray(j.inv_transform(jnp.asarray(want))))
    np.testing.assert_array_equal(t.inv_transform(got).numpy(), X)
    Transform.unit_test(t)


@pytest.mark.parametrize('kw', [dict(size=(24, 24)), dict(size=(8, 12)),
                                dict(scale_factor=0.5), dict(scale_factor=1.5)])
def test_scale_and_inverse_match_jax(kw):
    """Bilinear with half-pixel centres, antialiased when it shrinks (the
    triangle filter widened by the factor), both ways; 1e-5 (float32
    weights computed in other orders)."""
    j, t = jt.Scale(**kw), tt.Scale(**kw)
    want = np.asarray(j.transform(jnp.asarray(X)))
    got = t.transform(torch.from_numpy(X))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.inv_transform(got).numpy(),
                               np.asarray(j.inv_transform(jnp.asarray(want))),
                               rtol=0, atol=1e-5)


def test_scale_needs_exactly_one_of_size_and_factor():
    for kw in (dict(), dict(size=(4, 4), scale_factor=2.0)):
        with pytest.raises(ValueError, match='exactly one'):
            tt.Scale(**kw)
    with pytest.raises(ValueError):
        tt.Rotate90k(4)
    with pytest.raises(TypeError):
        MultiTransform(tt.Identity(), object())


W = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)


def _row(h):
    """A weight that grows down the rows: the stub model is not equivariant."""
    return np.linspace(0.5, 1.5, h, dtype=np.float32)[None, :, None, None]


def jax_model(x):
    return jnp.tanh(x @ jnp.asarray(W)) * jnp.asarray(_row(x.shape[1]))


def torch_model(x):
    return torch.tanh(x @ torch.from_numpy(W)) * torch.from_numpy(_row(x.shape[1]))


def test_tta_and_test_time_augmentation_match_jax():
    """A flip, a rotation, the transpose and a rescale, averaged; float32
    to 1e-6 (the rescale's weights: 1e-5)."""
    cfg_j = [jt.Identity(), jt.HorizontalFlip(), jt.Rotate90k(1), jt.Transpose(),
             jt.Scale(scale_factor=2.0)]
    cfg_t = [tt.Identity(), tt.HorizontalFlip(), tt.Rotate90k(1), tt.Transpose(),
             tt.Scale(scale_factor=2.0)]
    want = np.asarray(jt.tta(jax_model, jnp.asarray(X), cfg_j))
    got = tt.tta(torch_model, torch.from_numpy(X), cfg_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    wrapped = tt.TestTimeAugmentation(torch_model, cfg_t)
    np.testing.assert_allclose(wrapped(torch.from_numpy(X)).numpy(), want, rtol=0, atol=1e-5)
    assert not np.allclose(got.numpy(), torch_model(torch.from_numpy(X)).numpy(), atol=1e-2)


def test_d4_tta_matches_jax_in_one_call():
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return torch_model(x)

    want = np.asarray(jt.d4_tta(jax_model, jnp.asarray(X)))
    got = tt.d4_tta(counted, torch.from_numpy(X))
    assert calls == [16]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    d4 = [tt.Identity(), tt.Rotate90k(1), tt.Rotate90k(2), tt.Rotate90k(3)]
    flips = [_FlipThen(r) for r in d4]
    np.testing.assert_allclose(got.numpy(), tt.tta(torch_model, torch.from_numpy(X),
                                                   d4 + flips).numpy(), rtol=0, atol=1e-6)


class _FlipThen(Transform):
    """A horizontal flip, then ``rotation``; inverted in reverse."""

    def __init__(self, rotation):
        self.r = rotation

    def transform(self, x):
        return self.r.transform(torch.flip(x, dims=(2,)))

    def inv_transform(self, y):
        return torch.flip(self.r.inv_transform(y), dims=(2,))


# -- tiled_inference(tta='d4') with real models ------------------------------------

@pytest.fixture
def tiny_vit(monkeypatch):
    name, spec = TINY
    monkeypatch.setitem(jvit.VIT_SPECS, name, spec)
    monkeypatch.setitem(tvit.VIT_SPECS, name, spec)


@pytest.mark.parametrize('with_variables', [False, True])
def test_d4_tiled_dinoseg_matches_jax(tiny_vit, with_variables):
    """The narrow DinoSeg (2 blocks, width 64) over a 96² scene: 64² tiles at
    stride 48 in batches of 3 (4 tiles and 2 pads, so 24 tiles a call
    under d4).  float32 probabilities to 1e-5 (two blocks of float32 sums
    in other orders)."""
    cfg = dict(backbone=dict(name=TINY[0]), classes=5, dtype='float32')
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    params = _seeded_params()
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    state = convert_flax_dinoseg({'params': params})
    tmodel.load_state_dict(state, strict=True)
    image = np.random.default_rng(4).normal(size=(96, 96, 3)).astype(np.float32)
    predict = jax.jit(lambda v, t: jmodel.apply(v, t, train=False))
    want = np.asarray(jax_tiled(predict, jnp.asarray(image), 64, 48, 5, tile_batch=3,
                                tta='d4', variables={'params': params}))
    calls = []
    if with_variables:
        def tpredict(sd, t):
            calls.append(t.shape[0])
            return torch.func.functional_call(tmodel, sd, (t,))
        got = torch_tiled(tpredict, image, 64, 48, 5, tile_batch=3, tta='d4',
                          variables=state, device='cpu')
    else:
        def tpredict(t):
            calls.append(t.shape[0])
            return tmodel(t)
        got = torch_tiled(tpredict, image, 64, 48, 5, tile_batch=3, tta='d4', device='cpu')
    assert calls == [24, 24]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-5)
    plain = torch_tiled(tmodel, image, 64, 48, 5, tile_batch=3, device='cpu')
    assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-4)


def test_d4_tiled_farseg_matches_jax():
    """The narrow FarSeg in float64 (as ``test_torch_farseg.py``, for its
    BatchNorm) over an 80² scene, 64² tiles at stride 16 in batches of 2:
    float32 probabilities from float64 models to 1e-6."""
    cfg = dict(FARSEG_NARROW, dtype='float64')
    image = np.random.default_rng(5).normal(size=(80, 80, 3))
    with jax.enable_x64(True):
        jm = jbuilder.make_model({'type': 'FarSeg', 'params': cfg})
        v = jax.tree.map(lambda a: a.astype(np.float64),
                         seeded_variables(jm, image[None, :64, :64].astype(np.float32)))
        predict = jax.jit(lambda v, t: jm.apply(v, t, train=False))
        want = np.asarray(jax_tiled(predict, jnp.asarray(image), 64, 16, 5, tile_batch=2,
                                    tta='d4', variables=v))
    tm = tbuilder.make_model({'type': 'FarSeg', 'params': cfg}, device='cpu').double()
    tm.load_state_dict(convert_flax_farseg(v), strict=True)
    got = torch_tiled(tm, image, 64, 16, 5, tile_batch=2, tta='d4', device='cpu')
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_unknown_tta_raises():
    with pytest.raises(ValueError, match='tta'):
        torch_tiled(torch_model, np.zeros((16, 16, 3), np.float32), 16, 16, 4,
                    tta='flip', device='cpu')
