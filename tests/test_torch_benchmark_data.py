"""The port's LEVIR-CD, xView2 and iSAID readers against the JAX package's,
on seeded trees written by the port's PNG codec (a palette label by PIL,
which the codec does not write): the items of every split, over two
epochs of random crops, whole scenes and ``eval_crop``, are the JAX
readers' exactly.  And every config of ``project_template/configs`` builds
in the port's registry at its written widths and runs a forward.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import ever_tpu
from ever_tpu.data import benchmarks as jb
from ever_tpu_torch.core import registry
from ever_tpu_torch.core.config import import_config
from ever_tpu_torch.data import ISAID, ISAID_PALETTE, LEVIRCD, XView2
from ever_tpu_torch.data._png import write_png

SIZE = (40, 56)


def _image(rng, channels=3):
    return rng.integers(0, 256, SIZE + (channels,), dtype=np.uint8)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """LEVIR-CD with grey, RGB and palette labels (one split each), xView2
    with 5 (un-classified) in its post targets, iSAID with off-palette
    colours, an RGBA mask, a grey image and a class-coded 2-D mask."""
    root = tmp_path_factory.mktemp('benchmarks')
    rng = np.random.default_rng(0)
    for split, kind in (('train', 'grey'), ('val', 'rgb'), ('test', 'palette')):
        for sub in ('A', 'B', 'label'):
            (root / 'levir' / split / sub).mkdir(parents=True)
        for i in range(3):
            for sub in ('A', 'B'):
                write_png(str(root / 'levir' / split / sub / f'{i}.png'), _image(rng))
            lab = (rng.integers(0, 2, SIZE) * 255).astype(np.uint8)
            path = str(root / 'levir' / split / 'label' / f'{i}.png')
            if kind == 'grey':
                write_png(path, lab)
            elif kind == 'rgb':
                write_png(path, np.stack([lab, 255 - lab, lab], -1))
            else:
                img = Image.fromarray((lab > 0).astype(np.uint8) * 200, mode='P')
                img.putpalette([0, 0, 0] * 200 + [255, 255, 255] * 56)
                img.save(path)
    for split in ('train', 'hold'):
        for sub in ('images', 'targets'):
            (root / 'xview2' / split / sub).mkdir(parents=True)
        for i in range(3):
            d = root / 'xview2' / split
            write_png(str(d / 'images' / f's{i}_pre_disaster.png'), _image(rng))
            write_png(str(d / 'images' / f's{i}_post_disaster.png'), _image(rng))
            write_png(str(d / 'targets' / f's{i}_pre_disaster_target.png'),
                      rng.integers(0, 3, SIZE).astype(np.uint8))
            write_png(str(d / 'targets' / f's{i}_post_disaster_target.png'),
                      rng.integers(0, 6, SIZE).astype(np.uint8))
    colours = np.array(list(ISAID_PALETTE) + [(255, 0, 0), (1, 2, 3)], np.uint8)
    for split in ('train', 'val'):
        d = root / 'isaid' / split / 'images'
        d.mkdir(parents=True)
        for i in range(4):
            image = _image(rng)[..., 0] if i == 1 else _image(rng)
            write_png(str(d / f'P{i}.png'), image)
            mask = colours[rng.integers(0, len(colours), SIZE)]
            if i == 2:
                mask = np.concatenate([mask, np.full(SIZE + (1,), 255, np.uint8)], -1)
            if i == 3:
                mask = rng.integers(0, 16, SIZE).astype(np.uint8)
            write_png(str(d / f'P{i}_instance_color_RGB.png'), mask)
    return root


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name,port,ref,splits', [
    ('levir', LEVIRCD, jb.LEVIRCD, ('train', 'val', 'test')),
    ('xview2', XView2, jb.XView2, ('train', 'hold')),
    ('isaid', ISAID, jb.ISAID, ('train', 'val')),
])
@pytest.mark.parametrize('crop', [dict(crop_size=32), dict(crop_size=32, eval_crop=True),
                                  dict(crop_size=64)])
def test_reader_items_equal_jax(trees, name, port, ref, splits, crop):
    """Every item of every split, in two epochs, equal to the JAX reader's:
    train crops of 32² with the seeded flip, whole scenes (or centre crops
    with ``eval_crop``), and scenes padded up to a 64² crop."""
    for split in splits:
        cfg = dict(root=str(trees / name), split=split, seed=3, **crop)
        got, want = port(cfg), ref(cfg)
        assert len(got) == len(want) > 0
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for i in range(len(want)):
                _same(got[i], want[i])


def test_reader_label_contracts(trees):
    """The label sets: LEVIR-CD's change is 0/1 from every label kind with
    ``masks`` all 255; xView2's damage 5 is 255 and ``loc`` 0/1; iSAID's
    off-palette colours are 255, RGBA masks decode by their RGB, a grey
    image comes in 3 channels and a 2-D mask passes through (whole
    scenes: ``crop_size=0``)."""
    for split in ('train', 'val', 'test'):
        x, y = LEVIRCD(dict(root=str(trees / 'levir'), split=split, crop_size=0))[0]
        assert x.shape == SIZE + (6,) and set(np.unique(y['change'])) == {0, 1}
        assert (y['masks'] == 255).all() and y['masks'].shape == SIZE + (2,)
    xv = XView2(dict(root=str(trees / 'xview2'), split='hold'))
    raw = np.asarray(Image.open(trees / 'xview2' / 'hold' / 'targets' /
                                's0_post_disaster_target.png'))
    x, y = xv[0]
    assert (raw == 5).any() and np.array_equal(y['damage'] == 255, raw == 5)
    assert set(np.unique(y['loc'])) <= {0, 1}
    with pytest.raises(ValueError, match='dict labels'):
        XView2(dict(root=str(trees / 'xview2'), split='hold', transforms=[lambda a, b: (a, b)]))
    ds = ISAID(dict(root=str(trees / 'isaid'), split='val'))
    for i in range(4):
        x, y = ds[i]
        assert x.shape == SIZE + (3,) and x.dtype == np.float32
        raw = np.asarray(Image.open(trees / 'isaid' / 'val' / 'images' /
                                    f'P{i}_instance_color_RGB.png'))
        if raw.ndim == 2:
            np.testing.assert_array_equal(y, raw)
            continue
        off = ~np.isin(raw[..., :3].reshape(-1, 3).view('V3'),
                       np.array(list(ISAID_PALETTE), np.uint8).view('V3')).reshape(SIZE)
        assert off.any() and (y[off] == 255).all() and (y[~off] < 16).all()


def test_every_template_config_builds_in_the_port():
    """Each ``project_template/configs/*.py`` builds in the port's registry
    as written, on the meta device, its train dataset registered; the conv
    models run a 512² forward there (the written widths pass
    ``check_widths``: the change decoders and ChangeMixin take their real
    input widths)."""
    cfg_dir = os.path.join(os.path.dirname(ever_tpu.__file__), '..', 'project_template',
                           'configs')
    names = sorted(n for n in os.listdir(cfg_dir) if n.endswith('.py'))
    shapes = {}
    for name in names:
        cfg = import_config(os.path.abspath(os.path.join(cfg_dir, name)))
        assert cfg.data.train.type in registry.DATASET, name
        with torch.device('meta'):
            model = registry.MODEL[cfg.model.type](cfg.model.params)
            if cfg.model.type != 'DinoSeg':
                c = 6 if cfg.model.type.startswith('Change') else 3
                out = model(torch.zeros(2, 512, 512, c))
                shapes[cfg.model.type] = [tuple(o.shape[1:]) for o in
                                          (out if isinstance(out, tuple) else (out,))]
    assert len(names) >= 6
    assert shapes['FactSeg'] == [(512, 512, 16)]
    assert shapes['ChangeStar'] == [(512, 512, 1)] * 3
    assert shapes['ChangeMask'] == [(512, 512, 2), (512, 512, 2), (512, 512, 1)]
    assert shapes['ChangeOS'] == [(512, 512, 1), (512, 512, 5)]
