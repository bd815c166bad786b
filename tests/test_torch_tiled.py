"""Whole-scene tiled inference in the PyTorch port against the JAX package.

The predict function is the same fixed, context-dependent map in both
packages (each tile's output depends on the tile's mean, so a pad tile
pasted with weight 1 would change the canvas).  Canvases agree to 1e-5
(float32, the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ever_tpu.core import builder as jbuilder
from ever_tpu.magic.tiled import tiled_inference as jax_tiled
from ever_tpu_torch.core import builder as tbuilder
from ever_tpu_torch.magic.tiled import tiled_inference as torch_tiled
from ever_tpu_torch.util.weight_io import convert_flax_dinoseg

C, K = 3, 4
W = np.random.default_rng(0).normal(size=(C, K)).astype(np.float32)


def jax_predict(tiles):
    return jnp.tanh(tiles @ jnp.asarray(W) + tiles.mean(axis=(1, 2, 3))[:, None, None, None])


def torch_predict(tiles):
    return torch.tanh(tiles @ torch.from_numpy(W) + tiles.mean(dim=(1, 2, 3))[:, None, None, None])


def _scene(h, w, seed=1):
    return np.random.default_rng(seed).normal(size=(h, w, C)).astype(np.float32)


@pytest.mark.parametrize('h,w,k,stride,tile_batch', [
    (200, 150, 64, 48, 5),     # odd scene, overlaps, a tail batch with 3 pad tiles
    (200, 150, 64, 64, 4),     # no overlap
    (40, 50, 64, 32, 2),       # scene smaller than one tile: pad and crop
    (64, 100, 64, 36, 8),      # one tile row, all but 3 of a batch are pads
])
def test_canvas_matches_jax(h, w, k, stride, tile_batch):
    image = _scene(h, w)
    want = np.asarray(jax_tiled(jax_predict, jnp.asarray(image), k, stride, K,
                                tile_batch=tile_batch))
    got = torch_tiled(torch_predict, image, k, stride, K, tile_batch=tile_batch,
                      device='cpu').numpy()
    assert got.shape == (h, w, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stride_larger_than_tile_raises_in_both():
    image = _scene(80, 80)
    with pytest.raises(ValueError, match='stride'):
        jax_tiled(jax_predict, jnp.asarray(image), 32, 40, K)
    with pytest.raises(ValueError, match='stride'):
        torch_tiled(torch_predict, image, 32, 40, K, device='cpu')


@pytest.mark.parametrize('kw', [dict(), dict(tta='d4')])
def test_mesh_and_tta_not_ported_yet(kw):
    """``mesh=`` splits the tiles over the mesh's processes; the data mesh
    of one plain process gives the canvas without a mesh bit for bit, with
    or without d4 TTA.  Over two processes: ``test_torch_dist.py``."""
    from ever_tpu_torch.parallel.mesh import make_mesh
    image = _scene(100, 90)
    want = torch_tiled(torch_predict, image, 32, 24, K, tile_batch=3, device='cpu', **kw)
    got = torch_tiled(torch_predict, image, 32, 24, K, tile_batch=3, device='cpu',
                      mesh=make_mesh(), axis='data', **kw)
    assert torch.equal(got, want)


def test_dinoseg_scene_matches_jax():
    """The slice as a whole: a small ViT DinoSeg over a 96×80 scene, 64²
    tiles at stride 32 in batches of 3 (4 tiles and 2 pads), JAX package
    against the port with the same weights.  Tolerance 1e-4 (probabilities
    after 12 f32 blocks)."""
    import jax

    cfg = dict(backbone=dict(name='vit_small', layerscale_init=0.5,
                             n_storage_tokens=4, norm_eps=1e-5, attn_impl='xla'),
               classes=4, dtype='float32')
    jmodel = jbuilder.make_model({'type': 'DinoSeg', 'params': cfg})
    variables = jmodel.init({'params': jax.random.key(3)},
                            jnp.zeros((1, 64, 64, C), jnp.float32))
    image = _scene(96, 80, seed=4)
    want = np.asarray(jax_tiled(lambda v, t: jmodel.apply(v, t, train=False),
                                jnp.asarray(image), 64, 32, 4, tile_batch=3,
                                variables=variables))
    tmodel = tbuilder.make_model({'type': 'DinoSeg', 'params': cfg}, device='cpu')
    tmodel.load_state_dict(convert_flax_dinoseg(jax.device_get(variables)), strict=True)
    got = torch_tiled(tmodel, image, 64, 32, 4, tile_batch=3, device='cpu').numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
