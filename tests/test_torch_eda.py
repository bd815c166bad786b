"""``ever_tpu_torch.util.eda`` (no PIL) against ``ever_tpu.util.eda`` (PIL),
on grey and RGB PNGs written by the port's codec.

``thumbnail``: the JAX package returns PIL's thumbnail image; the port
returns its uint8 array, of the same size and within 1 grey level (PIL's
fixed-point bicubic after its box reduce, which the port follows step by
step).  ``render_multi_binary_mask``: the JAX package returns a ``P``
image; the port returns its index array and the palette as ``[n, 3]``
rows, both bit-equal, overlaps included (RGB masks raise in both).  A JPEG
or TIFF source raises, naming its format."""

import numpy as np
import pytest
from PIL import Image

from ever_tpu.util import eda as jeda
from ever_tpu_torch.data._png import write_png
from ever_tpu_torch.util import eda as teda

# (height, width, channels): grey and RGB, odd sizes whose reduce leaves
# partial blocks, one that reduces by different factors on the two axes
SHAPES = ((203, 317, None), (260, 193, 3), (517, 1030, None))
RATIOS = (0.1, 0.25, 0.37)
GREY_LEVELS = 1


def _image(rng, h, w, c):
    """A smooth gradient with noise (the content a thumbnail keeps) as
    uint8 ``[h, w]`` or ``[h, w, c]``."""
    shape = (h, w) if c is None else (h, w, c)
    ramp = np.add.outer(np.linspace(0, 120, h), np.linspace(0, 100, w))
    if c is not None:
        ramp = ramp[..., None] * np.linspace(0.5, 1.0, c)
    return np.clip(ramp + rng.normal(scale=20, size=shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, filter(None, s))))
@pytest.mark.parametrize('ratio', RATIOS)
def test_thumbnail_matches_pil(tmp_path, shape, ratio):
    """PIL's size exactly and its pixels within ``GREY_LEVELS``."""
    path = str(tmp_path / 'scene.png')
    write_png(path, _image(np.random.default_rng(sum(shape[:2])), *shape))
    want = np.asarray(jeda.thumbnail(path, ratio))
    got = teda.thumbnail(path, ratio)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= GREY_LEVELS


def test_thumbnail_of_an_image_that_fits_is_the_image(tmp_path):
    path = str(tmp_path / 'small.png')
    img = _image(np.random.default_rng(0), 20, 30, 3)
    write_png(path, img)
    np.testing.assert_array_equal(teda.thumbnail(path, 1.0), img)
    np.testing.assert_array_equal(np.asarray(jeda.thumbnail(path, 1.0)), img)


def _masks(tmp_path, channels=None):
    """Three 0/255 masks that overlap, and one with other values (127 and
    254 truncate to 0)."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(4):
        m = np.where(rng.random((40, 52)) < 0.3 + 0.1 * i, 255, 0).astype(np.uint8)
        if i == 3:
            m[rng.random(m.shape) < 0.3] = 127
            m[:5] = 254
        if channels:
            m = np.repeat(m[..., None], channels, -1)
        path = str(tmp_path / f'mask{i}.png')
        write_png(path, m)
        paths.append(path)
    return paths


def test_render_multi_binary_mask_matches_jax(tmp_path):
    paths = _masks(tmp_path)
    indexes = [1, 2, 3, 4]
    palette = [0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255, 255, 255, 0]
    indices, pal = teda.render_multi_binary_mask(paths, indexes, palette)
    want = jeda.render_multi_binary_mask(paths, indexes, palette)
    np.testing.assert_array_equal(indices, np.asarray(want))
    assert indices.dtype == np.uint8 and pal.dtype == np.uint8 and pal.shape == (5, 3)
    np.testing.assert_array_equal(pal.reshape(-1), np.asarray(want.getpalette()[:15]))
    assert set(np.unique(indices)) == {0, 1, 2, 3, 4}
    first = np.asarray(Image.open(paths[0])) == 255
    assert (indices[first] == 1).all()                 # earlier files win


def test_render_multi_binary_mask_of_rgb_masks_raises_as_jax(tmp_path):
    """RGB masks make a three-channel canvas, which PIL refuses to
    palettise in the JAX package; the port refuses it too."""
    paths = _masks(tmp_path, channels=3)
    with pytest.raises(ValueError):
        jeda.render_multi_binary_mask(paths, [1, 2, 3, 4], [0, 0, 0])
    with pytest.raises(ValueError, match='one-channel'):
        teda.render_multi_binary_mask(paths, [1, 2, 3, 4], [0, 0, 0])


@pytest.mark.parametrize('fmt,ext', [('JPEG', 'jpg'), ('TIFF', 'tif')])
def test_other_formats_raise_naming_them(tmp_path, fmt, ext):
    path = str(tmp_path / f'scene.{ext}')
    Image.fromarray(_image(np.random.default_rng(2), 32, 32, 3)).save(path, format=fmt)
    with pytest.raises(ValueError, match=fmt):
        teda.thumbnail(path)
    with pytest.raises(ValueError, match=fmt):
        teda.render_multi_binary_mask([path], [1], [0, 0, 0, 255, 255, 255])


def test_palette_png_thumbnail_raises(tmp_path):
    path = str(tmp_path / 'palette.png')
    Image.fromarray(np.zeros((16, 16), np.uint8), mode='P').save(path)
    with pytest.raises(ValueError, match='palette'):
        teda.thumbnail(path)
