"""The port's ``preprocess`` package against the JAX package's, on the CPU.

- **The numpy family** (``segm``, ``albu``): every transform built with
  the same seed in both packages gives the same bits, call after call, on
  the same seeded image and mask; forked workers draw their own streams,
  each the JAX package's stream in the same process.
- **The host library's ``normalize_u8``**: bit-equal to the JAX package's
  native ``normalize_u8``, float32 and bfloat16.
- **The tensor family** (``thcomm``, ``thsegm``): after the same
  ``np.random.seed`` the same draws and the same values exactly, except
  ``THRandomScale``'s image, a float32 bilinear resize computed as two
  matrix products (JAX: its own resize), held within 1e-5 of the image's
  largest value; its mask is exact against the nearest-neighbour rule, and
  equal to JAX's except on the rows and columns whose sample position is a
  whole number, which XLA's CPU division rounds down
  (:func:`check_nearest_mask`).
- **The batched augmentation** (``device``): ``_apply_d4`` for all 8
  symmetries and the crops exactly equal to the JAX functions', and every
  sample of ``batch_augment`` exactly the JAX symmetry of the crop its
  draws name, normalised by the JAX arithmetic.
- **A reader's transforms**: ``LoveDA`` with a ``transforms`` list equal
  to the JAX reader with the JAX transforms, item by item, two epochs.
"""

import multiprocessing
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ever_tpu.data.loveda import LoveDA as JaxLoveDA
from ever_tpu.preprocess import albu as jalbu, device as jdev, segm as jsegm
from ever_tpu.preprocess import thcomm as jthcomm, thsegm as jthsegm
from ever_tpu_torch.data.loveda import LoveDA
from ever_tpu_torch.preprocess import albu as talbu, device as tdev, segm as tsegm
from ever_tpu_torch.preprocess import thcomm as tthcomm, thsegm as tthsegm
from test_torch_data import make_loveda
from test_torch_resnet import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MEAN = np.asarray((123.675, 116.28, 103.53), np.float32)
STD = np.asarray((58.395, 57.12, 57.375), np.float32)


def scene(h=36, w=44, c=3, dtype=np.float32, seed=0):
    """A seeded 0-255 image and an int32 mask over 7 classes and 255."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, size=(h, w, c)).astype(dtype)
    mask = rng.integers(0, 7, size=(h, w)).astype(np.int32)
    mask[rng.random((h, w)) < 0.1] = 255
    return image, mask


def assert_same(got, want):
    """Equal structure, dtypes, shapes and bits."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif want is None:
        assert got is None
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                     got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


NUMPY_CASES = {
    'hflip': lambda m: m.RandomHorizontalFlip(seed=5),
    'vflip': lambda m: m.RandomVerticalFlip(p=0.3, seed=5),
    'transpose': lambda m: m.RandomTranspose(seed=5),
    'rot90k': lambda m: m.RandomRotate90K(seed=5),
    'rot90k-p': lambda m: m.RandomRotate90K(k=(0, 1, 3), p=0.7, seed=5),
    'scale-list': lambda m: m.RandomScale(scales=[0.5, 0.75, 1.25], size_divisor=8, seed=5),
    'scale-range': lambda m: m.RandomScale(scale_range=(0.5, 1.5), size_divisor=None, seed=5),
    'scale-tiny': lambda m: m.RandomScale(scales=[0.1], size_divisor=16, seed=5),
    'discrete-scale': lambda m: m.RandomDiscreteScale([0.75, 1.25, 1.5], p=0.5,
                                                      size_divisor=16, seed=5),
    'crop': lambda m: m.RandomCrop(24, seed=5),
    'crop-pad': lambda m: m.RandomCrop((48, 40), image_pad_value=3.0, seed=5),
    'divisible-pad': lambda m: m.DivisiblePad(16, image_pad_value=1.0, mask_pad_value=9),
    'fixed-pad': lambda m: m.FixedPad((50, 40)),
    'normalize': lambda m: m.MeanStdNormalize(),
    'normalize-mean-std': lambda m: m.MeanStdNormalize(mean=(1, 2, 3), std=(4, 5, 6)),
    'to-array': lambda m: m.ToArray(),
    'to-tensor': lambda m: m.ToTensor(),
    'compose': lambda m: m.Compose([m.RandomRotate90K(seed=1), m.RandomCrop(30, seed=2),
                                    m.RandomHorizontalFlip(seed=3), m.MeanStdNormalize()]),
    'custom-op': lambda m: m.CustomOp(lambda x, y=None: (x * 2, y) if y is not None else x * 2),
    'space-to-depth': lambda m: m.SpaceToDepth(),
}


@pytest.mark.parametrize('masks', ['one', 'list', 'none'])
@pytest.mark.parametrize('name', sorted(NUMPY_CASES))
def test_numpy_family_is_bit_equal_to_jax(name, masks):
    """Six calls of the transform on the same seeded float32 image and a
    mask (one, a list of two, or none), then on a uint8 image: the outputs
    of both packages equal in structure, dtype, shape and bits."""
    got_t, want_t = NUMPY_CASES[name](tsegm), NUMPY_CASES[name](jsegm)
    for dtype in (np.float32, np.uint8):
        image, mask = scene(dtype=dtype)
        mask = {'one': mask, 'list': [mask, mask[::-1].copy()], 'none': None}[masks]
        for _ in range(6):
            assert_same(got_t(image, mask), want_t(image, mask))


def test_other_numpy_spellings_are_bit_equal_to_jax():
    image, mask = scene()
    chw = np.ascontiguousarray(np.moveaxis(image, -1, 0))
    assert_same(tsegm.ChannelFirstToLast()(chw, mask), jsegm.ChannelFirstToLast()(chw, mask))
    assert_same(tsegm.transpose(image), jsegm.transpose(image))
    for args in ((), (50, 60, 7.0, 4)):
        assert_same(talbu.ConstantPad(*args)(image, mask), jalbu.ConstantPad(*args)(image, mask))
    assert_same(talbu.ToTensor()(image, [mask, mask]), jalbu.ToTensor()(image, [mask, mask]))
    d = talbu.RandomDiscreteScale([0.5, 2.0], p=1.0, seed=2)
    assert_same(d(image, mask), jalbu.RandomDiscreteScale([0.5, 2.0], p=1.0, seed=2)(image, mask))
    with pytest.raises(ValueError, match='scales OR scale_range'):
        tsegm.RandomScale(scales=[1.0], scale_range=(0.5, 1.0))


def _draws_in_a_fork(queue, t, j):
    queue.put((os.getpid(), t.rng.random(4).tolist(), j.rng.random(4).tolist()))


def test_forked_workers_draw_their_own_streams():
    """Transforms built before a fork: each forked child reseeds from
    ``(seed, pid)``, so two children draw different streams, neither the
    parent's; in each child the port's stream is the JAX package's."""
    ctx = multiprocessing.get_context('fork')
    queue = ctx.Queue()
    t, j = tsegm.RandomCrop(8, seed=11), jsegm.RandomCrop(8, seed=11)
    parent = np.random.default_rng(11).random(4).tolist()
    procs = [ctx.Process(target=_draws_in_a_fork, args=(queue, t, j)) for _ in range(2)]
    for p in procs:
        p.start()
    results = [queue.get(timeout=60) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    (pid_a, port_a, jax_a), (pid_b, port_b, jax_b) = results
    assert pid_a != pid_b
    assert port_a == jax_a and port_b == jax_b
    assert port_a != port_b and parent not in (port_a, port_b)
    assert t.rng.random(4).tolist() == parent        # the parent keeps its stream


@pytest.mark.parametrize('channels', [1, 3, 5, 64])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_normalize_u8_is_bit_equal_to_the_jax_host_library(channels, dtype):
    from ever_tpu import native
    from ever_tpu_torch.data import _tilekit

    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, size=(2, 33, 70, channels), dtype=np.uint8)
    mean = rng.uniform(0, 255, channels).astype(np.float32)
    std = rng.uniform(1, 80, channels).astype(np.float32)
    want = native.normalize_u8(image, mean, std,
                               ml_dtypes.bfloat16 if dtype == 'bfloat16' else np.float32)
    assert native.HAS_NATIVE
    got = _tilekit.normalize_u8(image, mean, std,
                                torch.bfloat16 if dtype == 'bfloat16' else np.float32)
    if dtype == 'bfloat16':
        assert got.dtype == torch.bfloat16
        got, want = got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16)
    assert_same(got, want)


def test_normalize_u8_rejects_what_it_cannot_take():
    from ever_tpu_torch.data import _tilekit

    with pytest.raises(ValueError, match='uint8'):
        _tilekit.normalize_u8(np.zeros((4, 4, 3), np.float32), MEAN, STD)
    with pytest.raises(ValueError, match='1 to 64 channels'):
        _tilekit.normalize_u8(np.zeros((4, 4, 65), np.uint8), 0.0, 1.0)
    with pytest.raises(ValueError, match='float32 or torch.bfloat16'):
        _tilekit.normalize_u8(np.zeros((4, 4, 3), np.uint8), MEAN, STD, np.float16)


TENSOR_CASES = {
    'rot90k': lambda m: m.THRandomRotate90k(),
    'rot90k-fixed': lambda m: m.THRandomRotate90k(k=3),
    'hflip': lambda m: m.THRandomHorizontalFlip(),
    'vflip': lambda m: m.THRandomVerticalFlip(p=0.3),
    'crop': lambda m: m.THRandomCrop((20, 24)),
    'crop-pad': lambda m: m.THRandomCrop((50, 60)),
    'scale': lambda m: m.THRandomScale(),
    'scale-step': lambda m: m.THRandomScale((0.5, 1.5), 0.5),
}


@pytest.mark.parametrize('with_mask', [True, False])
@pytest.mark.parametrize('name', sorted(TENSOR_CASES))
def test_tensor_family_matches_jax_after_the_same_seed(name, with_mask):
    image, mask = scene()
    mask = mask if with_mask else None
    outs = {}
    for key, mod in (('jax', jthsegm), ('port', tthsegm)):
        np.random.seed(23)
        t = TENSOR_CASES[name](mod)
        outs[key] = [t(image, mask) for _ in range(4)]
    for got, want in zip(outs['port'], outs['jax']):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            if name.startswith('scale') and i == 0:
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
            elif name.startswith('scale'):
                check_nearest_mask(g, w, mask)
            else:
                np.testing.assert_array_equal(g, w)


def check_nearest_mask(got, want, mask):
    """The port's nearest resize of ``mask`` reads input ``floor((i + ½) ·
    m / n)`` for output ``i`` (torch's ``'nearest-exact'``), exactly.  The
    JAX package's reads the same input except where that position is a
    whole number: XLA on the CPU divides by the constant ``n`` through a
    reciprocal and rounds such a position below it (44 → 55: output 2 at
    1.9999999 reads input 1).  So the two must agree on every row and
    column whose position is not whole."""
    (m, mw), (n, nw) = mask.shape, got.shape
    rows = [(2 * i + 1) * m // (2 * n) for i in range(n)]
    cols = [(2 * j + 1) * mw // (2 * nw) for j in range(nw)]
    np.testing.assert_array_equal(got, mask[rows][:, cols])
    keep_r = np.array([(2 * i + 1) * m % (2 * n) != 0 for i in range(n)])
    keep_c = np.array([(2 * j + 1) * mw % (2 * nw) != 0 for j in range(nw)])
    np.testing.assert_array_equal(got[keep_r][:, keep_c], want[keep_r][:, keep_c])


def test_tensor_pipelines_match_jax():
    image, mask = scene(h=20, w=28)
    chw = np.ascontiguousarray(np.moveaxis(image, -1, 0))

    def pipeline(m):
        return m.Pipeline([m.ToTensor(), m.FuncWrapper(lambda x, y: (x * 1.0, y)),
                           m.THChannelFirst2(), m.THMeanStdNormalize2(),
                           m.THDivisiblePad(16, mask_pad_value=7, pad_to_size=(40, 40))])

    got, want = pipeline(tthcomm)(chw, mask), pipeline(jthcomm)(chw, mask)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hsi = np.random.default_rng(1).random((12, 10, 9)).astype(np.float32)   # > 8 bands: HWC
    for m in (tthcomm, jthcomm):
        assert tuple(m.THChannelFirst()(hsi).shape) == (12, 10, 9)
    np.testing.assert_array_equal(
        tthcomm.THMeanStdNormalize()(torch.as_tensor(image)).numpy(),
        np.asarray(jthcomm.THMeanStdNormalize()(image)))
    assert_same(tthcomm.THDivisiblePad(16)(image)[0].numpy(),
                np.asarray(jthcomm.THDivisiblePad(16)(image)[0]))


@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('k', [0, 1, 2, 3])
def test_apply_d4_equals_jax_for_every_symmetry(k, flip):
    image, mask = scene(h=6, w=6)
    for x in (image, mask):
        got = tdev._apply_d4(torch.as_tensor(x), k, flip)
        want = jdev._apply_d4(jnp.asarray(x), jnp.asarray(k), jnp.asarray(flip))
        assert_same(got.numpy(), np.asarray(want))


def test_crops_equal_jax_at_every_offset():
    """JAX's ``random_crop`` under 200 keys reaches each of the 20 windows
    of 3×2 in 6×5; the port's crop at each window's offsets equals it, and
    the port's ``random_crop`` draws every window too."""
    import jax

    image, mask = scene(h=6, w=5)
    want = {}
    for key in range(200):
        k = jax.random.PRNGKey(key)
        y = int(jax.random.randint(k, (), 0, 4))
        x = int(jax.random.randint(jax.random.fold_in(k, 1), (), 0, 4))
        want[y, x] = jdev.random_crop(k, jnp.asarray(image), (3, 2), jnp.asarray(mask))
    assert len(want) == 16
    for (y, x), (wi, wm) in want.items():
        yt, xt = torch.tensor([y]), torch.tensor([x])
        assert_same(tdev._crop_d4(torch.as_tensor(image)[None], (3, 2), yt, xt, None, None)[0]
                    .numpy(), np.asarray(wi))
        assert_same(tdev._crop_d4(torch.as_tensor(mask)[None], (3, 2), yt, xt, None, None)[0]
                    .numpy(), np.asarray(wm))
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        gi, gm = tdev.random_crop(gen, torch.as_tensor(image), (3, 2), torch.as_tensor(mask))
        match = [yx for yx, (wi, wm) in want.items()
                 if np.array_equal(gi.numpy(), np.asarray(wi))
                 and np.array_equal(gm.numpy(), np.asarray(wm))]
        assert len(match) == 1
        seen.add(match[0])
    assert len(seen) == 16


def test_dihedral_augment_draws_every_symmetry():
    image, mask = scene(h=5, w=5)
    sym = {(k, f): (np.asarray(jdev._apply_d4(jnp.asarray(image), k, f)),
                    np.asarray(jdev._apply_d4(jnp.asarray(mask), k, f)))
           for k in range(4) for f in (False, True)}
    gen = torch.Generator().manual_seed(1)
    seen = set()
    for _ in range(64):
        gi, gm = tdev.dihedral_augment(gen, torch.as_tensor(image), torch.as_tensor(mask))
        match = [s for s, (wi, wm) in sym.items()
                 if np.array_equal(gi.numpy(), wi) and np.array_equal(gm.numpy(), wm)]
        assert match
        seen.add(match[0])
    assert len(seen) == 8


@pytest.mark.parametrize('kw', [
    dict(crop_size=(12, 12)),
    dict(crop_size=(12, 12), normalize=False),
    dict(crop_size=(8, 14), dihedral=False),
    dict(),
    dict(crop_size=(12, 12), masks=False, mean=(1.0, 2.0, 3.0), std=(3.0, 2.0, 1.0)),
], ids=['crop-d4', 'no-normalize', 'crop-only', 'd4-only', 'no-masks'])
def test_batch_augment_samples_are_the_jax_symmetries_of_their_crops(kw):
    """Every sample equals the JAX ``_apply_d4`` of the window its draws
    name, normalised as the JAX ``batch_augment`` normalises; the output
    dtypes and shapes are the JAX ``batch_augment``'s."""
    import jax

    kw = dict(kw)
    with_masks = kw.pop('masks', True)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(6, 20, 20, 3), dtype=np.uint8)
    masks = rng.integers(0, 7, size=(6, 20, 20)).astype(np.int32) if with_masks else None
    gen = torch.Generator().manual_seed(3)
    got_i, got_m, draws = tdev.batch_augment(
        gen, torch.as_tensor(images), None if masks is None else torch.as_tensor(masks),
        return_draws=True, **kw)
    want_i, want_m = jdev.batch_augment(jax.random.PRNGKey(0), jnp.asarray(images),
                                        None if masks is None else jnp.asarray(masks), **kw)
    assert got_i.dtype == torch.float32 if kw.get('normalize', True) else torch.uint8
    assert tuple(got_i.shape) == want_i.shape and str(got_i.dtype)[6:] == str(want_i.dtype)
    assert (got_m is None) == (want_m is None)
    th, tw = kw.get('crop_size', (20, 20))
    mean = np.asarray(kw.get('mean', MEAN), np.float32)
    std = np.asarray(kw.get('std', STD), np.float32)
    for i in range(6):
        y, x = (int(draws['y'][i]), int(draws['x'][i])) if 'y' in draws else (0, 0)
        for src, got in ((images, got_i), (masks, got_m)):
            if src is None:
                continue
            want = jnp.asarray(src[i, y:y + th, x:x + tw])
            if 'k' in draws:
                want = jdev._apply_d4(want, jnp.asarray(int(draws['k'][i])),
                                      jnp.asarray(bool(draws['flip'][i])))
            if src is images and kw.get('normalize', True):
                want = (want.astype(jnp.float32) - jnp.asarray(mean)) / jnp.asarray(std)
            assert_same(got[i].numpy(), np.asarray(want))


def test_batch_augment_rejects_what_jax_cannot_do():
    images = torch.zeros(2, 10, 12, 3, dtype=torch.uint8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match='square'):
        tdev.batch_augment(gen, images)
    with pytest.raises(ValueError, match='square'):
        tdev.batch_augment(gen, images, crop_size=(4, 6))
    with pytest.raises(ValueError, match='does not fit'):
        tdev.batch_augment(gen, images, crop_size=(11, 11))


def test_loveda_transforms_equal_the_jax_readers(tmp_path):
    """A reader config's ``transforms`` list, the JAX package's transforms
    with the same seeds on the JAX reader: every item of two epochs
    equal."""
    root = make_loveda(tmp_path, sizes=(64, 80), test_split=False)

    def transforms(m):
        return [m.RandomDiscreteScale([0.75, 1.25, 1.5], p=0.5, size_divisor=16, seed=1),
                m.RandomCrop(32, seed=2), m.RandomRotate90K(seed=3),
                m.RandomTranspose(seed=4), m.RandomHorizontalFlip(seed=5),
                m.MeanStdNormalize()]

    cfg = dict(root=root, split='train', crop_size=48, seed=7)
    got_ds = LoveDA(dict(cfg, transforms=transforms(tsegm)))
    want_ds = JaxLoveDA(dict(cfg, transforms=transforms(jsegm)))
    for epoch in range(2):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert got[0].shape == (32, 32, 3)
            assert_same(got, want)
