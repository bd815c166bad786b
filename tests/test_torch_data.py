"""The port's datasets against the JAX package's, on files on disk.

``LoveDA`` over a small LoveDA tree (64² to 96² scenes, PNG written by PIL,
as the JAX package reads them): training crops over three epochs, full
validation scenes, ``eval_crop``, the no-data mapping and a test split
without masks give the JAX dataset's samples exactly.  ``GeoTileDataset``
gives the JAX dataset's patch index, patches and ``read_batch``, and its own
batched read (through a ``DataLoader``) equals its per-item path.  Both
readers' ``layout='s2d'`` (the space-to-depth fold that ``stem='s2d_input'``
takes) equals the JAX readers' and the port's own ``SpaceToDepth`` of the
``'hwc'`` samples, and the host library's s2d gather the JAX one's.  The
cross-validation splits are the JAX ones.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from ever_tpu.data import cross_validation as jcv
from ever_tpu.data.geotile import GeoTileDataset as JaxGeoTile
from ever_tpu.data.loveda import LoveDA as JaxLoveDA
from ever_tpu_torch.core import registry
from ever_tpu_torch.data import cross_validation as tcv
from ever_tpu_torch.data import SpaceToDepth
from ever_tpu_torch.data._png import write_png
from ever_tpu_torch.data.geotile import GeoTileDataset
from ever_tpu_torch.data.loveda import LoveDA


def make_loveda(root, sizes=(64, 80, 96), test_split=True):
    """Train/Val (and a mask-less Test) trees of both domains, one scene
    per size, masks in the official encoding (0 = no-data)."""
    rng = np.random.default_rng(0)
    splits = ('Train', 'Val', 'Test') if test_split else ('Train', 'Val')
    for split in splits:
        for dom in ('Urban', 'Rural'):
            d = root / split / dom
            (d / 'images_png').mkdir(parents=True)
            if split != 'Test':
                (d / 'masks_png').mkdir(parents=True)
            for i, size in enumerate(sizes):
                h, w = size, size + 8 * i
                img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / 'images_png' / f'{i}.png')
                if split != 'Test':
                    msk = rng.integers(0, 8, size=(h, w), dtype=np.uint8)
                    Image.fromarray(msk).save(d / 'masks_png' / f'{i}.png')
    return str(root)


@pytest.fixture(scope='module')
def loveda_root(tmp_path_factory):
    return make_loveda(tmp_path_factory.mktemp('loveda'))


def _assert_same_samples(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('cfg', [
    dict(split='train', crop_size=48, seed=3),
    dict(split='train', crop_size=72, seed=1, hflip=False),     # pads the 64² scenes
    dict(split='val', crop_size=48),                            # full scenes
    dict(split='val', crop_size=48, eval_crop=True),
    dict(split='test', crop_size=48),                           # no masks
    dict(split='train', crop_size=48, domains=('Rural',)),
], ids=['train', 'train-pad', 'val', 'eval-crop', 'test', 'rural'])
def test_loveda_samples_equal_jax(loveda_root, cfg):
    """Every sample, in epochs 0, 1 and 2 (the crops are reseeded per
    epoch), equals the JAX dataset's: float32 images, int32 masks with 0
    mapped to 255 and 1..7 to 0..6."""
    got_ds = LoveDA(dict(root=loveda_root, **cfg))
    want_ds = JaxLoveDA(dict(root=loveda_root, **cfg))
    assert got_ds.pairs == want_ds.pairs
    for epoch in range(3):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        _assert_same_samples(got_ds, want_ds)
    sample = got_ds[0]
    if cfg['split'] != 'test':
        assert sample[0].dtype == np.float32 and sample[1].dtype == np.int32
        assert set(np.unique(sample[1])) <= set(range(7)) | {255}


def test_loveda_is_registered_and_batches_through_its_loader(loveda_root):
    ds = registry.DATASET['loveda'](dict(root=loveda_root, split='val', crop_size=32,
                                         eval_crop=True, batch_size=4,
                                         sampler_type='SequentialSampler'))
    x, y = next(iter(ds.to_dataloader()))
    assert x.shape == (4, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (4, 32, 32) and y.dtype == torch.int32


def test_loveda_missing_masks_and_layouts_raise(tmp_path, loveda_root):
    root = make_loveda(tmp_path / 'partial', sizes=(64, 64), test_split=False)
    (tmp_path / 'partial' / 'Train' / 'Urban' / 'masks_png' / '1.png').unlink()
    with pytest.raises(FileNotFoundError, match='missing their mask'):
        LoveDA(dict(root=root, split='train'))
    with pytest.raises(FileNotFoundError, match='no LoveDA images'):
        LoveDA(dict(root=str(tmp_path / 'nowhere'), split='train'))
    # layout='s2d' reads (it raised until the folded stem was ported): its
    # samples are the JAX reader's
    cfg = dict(root=loveda_root, split='train', crop_size=48, layout='s2d')
    _assert_same_samples(LoveDA(cfg), JaxLoveDA(cfg))
    with pytest.raises(ValueError, match='layout'):
        LoveDA(dict(root=loveda_root, split='train', layout='chw'))


# -- GeoTile --------------------------------------------------------------------

@pytest.fixture(scope='module')
def geotile_scenes(tmp_path_factory):
    """Two PNG scenes of odd sizes (edge-shifted boxes, duplicates) and a
    .npy scene, each with a mask."""
    d = tmp_path_factory.mktemp('geotile')
    rng = np.random.default_rng(7)
    for name, (h, w) in (('a', (100, 130)), ('b', (64, 64))):
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(
            d / f'{name}_img.png')
        Image.fromarray(rng.integers(0, 7, size=(h, w), dtype=np.uint8)).save(
            d / f'{name}_mask.png')
    np.save(d / 'c_img.npy', rng.integers(0, 256, size=(70, 90, 3), dtype=np.uint8))
    np.save(d / 'c_mask.npy', rng.integers(0, 7, size=(70, 90), dtype=np.uint8))
    return d


def _geotile_cfg(d, **kw):
    pairs = [(str(d / f'{n}_img.{e}'), str(d / f'{n}_mask.{e}'))
             for n, e in (('a', 'png'), ('b', 'png'), ('c', 'npy'))]
    return dict(scene_pairs=pairs, patch_size=64, stride=48, **kw)


@pytest.mark.parametrize('image_dtype', ['float32', 'uint8'])
def test_geotile_index_patches_and_read_batch_equal_jax(geotile_scenes, image_dtype):
    cfg = _geotile_cfg(geotile_scenes, image_dtype=image_dtype)
    got, want = GeoTileDataset(cfg), JaxGeoTile(cfg)
    assert got._index == want._index and len(got) == len(want)
    # scene a's right edge shifts a box onto the previous column: deduplicated
    assert len(set(got._index)) == len(got._index)
    _assert_same_samples(got, want)
    idx = [5, 0, len(got) - 1, 3, 3]
    g, w = got.read_batch(idx), want.read_batch(idx)
    assert g is not NotImplemented and w is not NotImplemented
    for a, b in zip(g, w, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_geotile_read_batch_through_a_loader_equals_the_per_item_path(geotile_scenes):
    ds = GeoTileDataset(_geotile_cfg(geotile_scenes, batch_size=4,
                                     sampler_type='SequentialSampler'))
    calls = []
    read_batch = ds.read_batch
    ds.read_batch = lambda idx: calls.append(list(idx)) or read_batch(idx)
    batches = list(ds.to_dataloader())
    assert calls and all(len(c) <= 4 for c in calls)
    x = torch.cat([b[0] for b in batches])
    y = torch.cat([b[1] for b in batches])
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    for i in range(len(ds)):
        img, mask = ds[i]
        np.testing.assert_array_equal(x[i].numpy(), img)
        np.testing.assert_array_equal(y[i].numpy(), mask)


def test_geotile_falls_back_and_checks_channels(geotile_scenes, tmp_path):
    def double(img, mask):
        return img * 2, mask
    ds = GeoTileDataset(_geotile_cfg(geotile_scenes, transforms=[double]))
    assert ds.read_batch([0, 1]) is NotImplemented
    items = ds.__getitems__([0, 1])
    assert isinstance(items, list) and len(items) == 2
    np.testing.assert_array_equal(items[1][0], GeoTileDataset(_geotile_cfg(
        geotile_scenes))[1][0] * 2)
    Image.fromarray(np.zeros((64, 64, 4), np.uint8)).save(tmp_path / 'rgba.png')
    Image.fromarray(np.zeros((64, 64), np.uint8)).save(tmp_path / 'rgba_mask.png')
    pairs = _geotile_cfg(geotile_scenes)['scene_pairs'][:1] + [
        (str(tmp_path / 'rgba.png'), str(tmp_path / 'rgba_mask.png'))]
    mixed = GeoTileDataset(dict(scene_pairs=pairs, patch_size=64, stride=48))
    with pytest.raises(ValueError, match='channels'):
        mixed.read_batch([0, len(mixed) - 1])
    with pytest.raises(ValueError, match='smaller than'):
        GeoTileDataset(dict(scene_pairs=pairs, patch_size=128))
    # layout='s2d' reads (it raised until the folded stem was ported): its
    # read_batch, through the host library's s2d gather, is the JAX one's
    cfg = _geotile_cfg(geotile_scenes, layout='s2d')
    idx = [0, 7, 3]
    for a, b in zip(GeoTileDataset(cfg).read_batch(idx), JaxGeoTile(cfg).read_batch(idx),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='layout'):
        GeoTileDataset(_geotile_cfg(geotile_scenes, layout='chw'))


@pytest.mark.parametrize('cfg', [
    dict(split='train', crop_size=48, seed=3),
    dict(split='val', crop_size=48),                            # full scenes
    dict(split='test', crop_size=48),                           # no masks
], ids=['train', 'val', 'test'])
def test_loveda_s2d_equals_jax_and_folds_the_hwc_items(loveda_root, cfg):
    """``layout='s2d'``: every sample (epochs 0 and 1) equals the JAX
    reader's, and is the port's ``SpaceToDepth`` of the ``'hwc'`` sample,
    bit for bit: the image ``[H/2, W/2, 12]`` in channel order
    ``(dy·2 + dx)·3 + c``, the mask untouched at full resolution."""
    got_ds = LoveDA(dict(root=loveda_root, layout='s2d', **cfg))
    want_ds = JaxLoveDA(dict(root=loveda_root, layout='s2d', **cfg))
    hwc = LoveDA(dict(root=loveda_root, **cfg))
    for epoch in range(2):
        for ds in (got_ds, want_ds, hwc):
            ds.set_epoch(epoch)
        _assert_same_samples(got_ds, want_ds)
        for i in range(len(hwc)):
            plain, folded = hwc[i], got_ds[i]
            plain = plain if isinstance(plain, tuple) else (plain, None)
            folded = folded if isinstance(folded, tuple) else (folded, None)
            img, mask = SpaceToDepth()(*plain)
            h, w, _ = plain[0].shape
            assert folded[0].shape == (h // 2, w // 2, 12)
            np.testing.assert_array_equal(folded[0], img)
            assert mask is plain[1] or np.array_equal(folded[1], mask)
    x = hwc[0][0] if cfg['split'] != 'test' else hwc[0]
    np.testing.assert_array_equal(SpaceToDepth()(x)[0][3, 5, 7:9],
                                  x[6 + 1, 10 + 0, 1:3])     # dy=1, dx=0: block 2


@pytest.mark.parametrize('image_dtype', ['float32', 'uint8'])
def test_geotile_s2d_read_batch_equals_jax_and_the_per_item_path(geotile_scenes,
                                                                 image_dtype):
    """``GeoTileDataset(layout='s2d')``: the patch index and every per-item
    sample equal the JAX dataset's; ``read_batch``, gathered and folded by
    the host library (``extract_tiles_s2d``), equals both the JAX
    ``read_batch`` and the port's per-item path; a loader's batches come
    through it.  The masks stay [n, 64, 64]."""
    cfg = _geotile_cfg(geotile_scenes, layout='s2d', image_dtype=image_dtype)
    got, want = GeoTileDataset(cfg), JaxGeoTile(cfg)
    assert got._index == want._index
    _assert_same_samples(got, want)
    idx = [5, 0, len(got) - 1, 3, 3]
    g, w = got.read_batch(idx), want.read_batch(idx)
    assert g[0].shape == (5, 32, 32, 12) and g[1].shape == (5, 64, 64)
    for a, b in zip(g, w, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for pos, i in enumerate(idx):
        img, mask = got[i]
        np.testing.assert_array_equal(g[0][pos], img)
        np.testing.assert_array_equal(g[1][pos], mask)


def test_extract_tiles_s2d_equals_the_jax_host_gather():
    """The port's host gather in its s2d form against the JAX package's
    native ``extract_tiles_s2d``, byte for byte, over a 4-channel scene;
    odd tile sides and boxes outside the scene raise."""
    from ever_tpu.native import extract_tiles_s2d as jax_s2d
    from ever_tpu_torch.data import _tilekit

    scene = np.random.default_rng(3).integers(0, 256, size=(50, 70, 4), dtype=np.uint8)
    boxes = np.array([[0, 0], [10, 14], [34, 50], [2, 3]], np.int64)
    got = _tilekit.extract_tiles_s2d(scene, boxes, (16, 20))
    np.testing.assert_array_equal(got, jax_s2d(scene, boxes, (16, 20)))
    np.testing.assert_array_equal(
        got, np.stack([SpaceToDepth()(scene[y:y + 16, x:x + 20])[0] for y, x in boxes]))
    with pytest.raises(ValueError, match='even'):
        _tilekit.extract_tiles_s2d(scene, boxes, (15, 20))
    with pytest.raises(ValueError, match='outside'):
        _tilekit.extract_tiles_s2d(scene, np.array([[40, 0]]), (16, 20))


def test_png_written_by_the_port_reads_in_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(80, 70, 3), dtype=np.uint8)
    mask = rng.integers(0, 7, size=(80, 70), dtype=np.uint8)
    write_png(str(tmp_path / 's_img.png'), img, filter_type=4)
    write_png(str(tmp_path / 's_mask.png'), mask, filter_type=3)
    cfg = dict(image_glob=str(tmp_path / '*_img.png'), mask_glob=str(tmp_path / '*_mask.png'),
               patch_size=64, stride=32)
    _assert_same_samples(GeoTileDataset(cfg), JaxGeoTile(cfg))


# -- cross-validation -----------------------------------------------------------

class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize('n,k', [(23, 5), (10, 5), (7, 3)])
@pytest.mark.parametrize('distributed', [True, False])
def test_cross_validation_splits_equal_jax(n, k, distributed):
    got = tcv.CrossValSamplerGenerator(_Sized(n), distributed, seed=11).k_fold(k)
    want = jcv.CrossValSamplerGenerator(_Sized(n), distributed, seed=11).k_fold(k)
    assert len(got) == len(want) == k
    for (gt, gv), (wt, wv) in zip(got, want):
        assert type(gt).__name__ == type(wt).__name__
        assert list(gt.indices) == list(wt.indices)
        assert list(gv.indices) == list(wv.indices)
        for s in (gt, wt):
            s.set_step(3) if hasattr(s, 'set_step') else None
        assert list(iter(gt)) == list(iter(wt))
        assert list(iter(gv)) == list(iter(wv))
    g1 = tcv.make_CVSamplers(_Sized(n), i=1, k=k, distributed=distributed, seed=4)
    w1 = jcv.make_CVSamplers(_Sized(n), i=1, k=k, distributed=distributed, seed=4)
    assert list(g1[1].indices) == list(w1[1].indices)
