"""Joint image and mask transforms on the host, numpy HWC (counterpart of
``ever_tpu/preprocess/segm.py``): the family a reader's ``transforms``
list holds, run in the loader's worker processes.

Every transform is ``t(image [H, W, C], mask [H, W] or a list of them) ->
(image, mask)``.  The random ones draw from their own ``np.random``
generator, seeded at construction: the same seed draws the JAX package's
values and gives its bits.  A forked worker reseeds from ``(seed, pid)``,
so that the workers do not replay one stream (and a resumed run cannot
repeat the augmentations bit for bit, as in the JAX package).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ever_tpu_torch.data._scene import SpaceToDepth
from ever_tpu_torch.preprocess.function import IMAGENET_MEAN, IMAGENET_STD

__all__ = ['Compose', 'CustomOp', 'ToArray', 'ToTensor', 'RandomHorizontalFlip',
           'RandomVerticalFlip', 'RandomTranspose', 'RandomRotate90K', 'RandomScale',
           'RandomDiscreteScale', 'RandomCrop', 'DivisiblePad', 'FixedPad', 'MeanStdNormalize',
           'SpaceToDepth', 'ChannelFirstToLast', 'transpose']


class _ForkSafeRNG:
    """``np.random.Generator`` facade that reseeds itself in forked children.

    Transforms are constructed in the parent process; a fork-based loader
    worker would otherwise inherit the parent's generator STATE and every
    worker would replay the identical augmentation stream.  In the creating
    process this is exactly ``default_rng(seed)``; a forked child draws from
    a deterministic per-(seed, pid) stream.
    """

    def __init__(self, seed=None):
        self._seed = seed
        self._pid = os.getpid()
        self._gen = np.random.default_rng(seed)

    def __getattr__(self, name):
        pid = os.getpid()
        if pid != self._pid:
            self._pid = pid
            self._gen = np.random.default_rng(
                np.random.SeedSequence(entropy=self._seed, spawn_key=(pid,)))
        return getattr(self._gen, name)


def _map_mask(mask, fn):
    """Apply ``fn`` to a single HW mask or each mask in a list/tuple
    (multi-task labels accepted by ``ToArray``)."""
    if mask is None:
        return None
    if isinstance(mask, (list, tuple)):
        return type(mask)(fn(m) for m in mask)
    return fn(mask)


class Compose:
    """Sequential pipeline (parity: ``preprocess/comm.py:4-20``): with no
    mask, transforms are called image-only and a bare image is returned."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image, mask=None):
        if mask is None:
            for t in self.transforms:
                out = t(image, mask)
                image = out[0] if isinstance(out, tuple) else out
            return image
        for t in self.transforms:
            image, mask = t(image, mask)
        return image, mask


class CustomOp:
    """Wrap a plain callable (parity: ``comm.py:23-34``): image-only fns
    are called ``fn(image)`` when there is no mask."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, image, mask=None):
        if mask is None:
            return self.fn(image)
        return self.fn(image, mask)


class ToArray:
    """float32 image / int32 mask(s) (parity: joint ``ToTensor``,
    ``segm.py:16-34`` and the multi-mask variant ``albu.py:22-28``; 255-keep
    is the default since masks stay integer).  ``mask`` may be a single HW
    array or a list of them (multi-task labels)."""

    def __call__(self, image, mask=None):
        image = np.asarray(image, np.float32)
        if mask is not None:
            if isinstance(mask, (list, tuple)):
                mask = type(mask)(np.asarray(m, np.int32) for m in mask)
            else:
                mask = np.asarray(mask, np.int32)
        return image, mask


class _RandomP:
    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = _ForkSafeRNG(seed)


class RandomHorizontalFlip(_RandomP):
    def __call__(self, image, mask=None):
        if self.rng.random() < self.p:
            image = np.ascontiguousarray(image[:, ::-1])
            mask = _map_mask(mask, lambda m: np.ascontiguousarray(m[:, ::-1]))
        return image, mask


class RandomVerticalFlip(_RandomP):
    def __call__(self, image, mask=None):
        if self.rng.random() < self.p:
            image = np.ascontiguousarray(image[::-1])
            mask = _map_mask(mask, lambda m: np.ascontiguousarray(m[::-1]))
        return image, mask


class RandomTranspose(_RandomP):
    def __call__(self, image, mask=None):
        if self.rng.random() < self.p:
            image = np.ascontiguousarray(np.swapaxes(image, 0, 1))
            mask = _map_mask(mask,
                             lambda m: np.ascontiguousarray(np.swapaxes(m, 0, 1)))
        return image, mask


class RandomRotate90K:
    """Rotate by k quarter turns with k drawn UNIFORMLY from ``k``
    (parity: ``segm.py:70-82``; the reference default (0,1,2,3) gives the
    identity probability 0.25).  ``p`` optionally gates applying any
    rotation (legacy surface): k=0 with prob 1-p, else uniform over the
    nonzero entries."""

    def __init__(self, k: Sequence[int] = (0, 1, 2, 3),
                 p: Optional[float] = None, seed: Optional[int] = None):
        self.k = tuple(int(x) for x in k)
        self.p = p
        self.rng = _ForkSafeRNG(seed)

    def __call__(self, image, mask=None):
        if self.p is not None:
            ks = [x for x in self.k if x] or [1, 2, 3]
            k = int(self.rng.choice(ks)) if self.rng.random() < self.p else 0
        else:
            k = int(self.rng.choice(self.k))
        if k:
            image = np.ascontiguousarray(np.rot90(image, k, axes=(0, 1)))
            mask = _map_mask(
                mask, lambda m: np.ascontiguousarray(np.rot90(m, k, axes=(0, 1))))
        return image, mask


def _resize_nearest(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    ys = (np.arange(shape[0]) * arr.shape[0] / shape[0]).astype(np.int64)
    xs = (np.arange(shape[1]) * arr.shape[1] / shape[1]).astype(np.int64)
    return arr[ys][:, xs]


def _resize_bilinear(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    h, w = arr.shape[:2]
    nh, nw = shape
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = arr.astype(np.float32)
    if a.ndim == 2:
        a = a[..., None]
        squeeze = True
    else:
        squeeze = False
    out = (a[y0][:, x0] * (1 - wy) * (1 - wx) + a[y1][:, x0] * wy * (1 - wx)
           + a[y0][:, x1] * (1 - wy) * wx + a[y1][:, x1] * wy * wx)
    return out[..., 0] if squeeze else out


class RandomScale:
    """Scale jitter (parity: ``segm.py:85-101``).

    The reference draws from a DISCRETE ``scales`` list and floor-snaps to
    ``size_divisor`` (``int(h*s)//d*d``).  Pass ``scales=[...]`` for that
    exact behavior; ``scale_range=(lo, hi)`` keeps the continuous-uniform
    variant (additive surface).  Snapped sizes are floored like the
    reference but never below one divisor (a 0-sized image would crash)."""

    def __init__(self, scales: Optional[Sequence[float]] = None,
                 size_divisor: Optional[int] = 32,
                 seed: Optional[int] = None,
                 scale_range: Optional[Tuple[float, float]] = None):
        if scales is not None and scale_range is not None:
            raise ValueError('pass scales OR scale_range, not both')
        self.scales = list(scales) if scales is not None else None
        self.scale_range = scale_range or (0.5, 2.0)
        self.size_divisor = size_divisor
        self.rng = _ForkSafeRNG(seed)

    def _target(self, h, w, s):
        nh, nw = int(h * s), int(w * s)
        if self.size_divisor:
            d = self.size_divisor
            nh = max(nh // d * d, d)
            nw = max(nw // d * d, d)
        return nh, nw

    def __call__(self, image, mask=None):
        s = (float(self.rng.choice(self.scales)) if self.scales is not None
             else float(self.rng.uniform(*self.scale_range)))
        nh, nw = self._target(image.shape[0], image.shape[1], s)
        image = _resize_bilinear(image, (nh, nw))
        mask = _map_mask(mask, lambda m: _resize_nearest(m, (nh, nw)))
        return image, mask


class RandomDiscreteScale(RandomScale):
    """Pick from a discrete scale set (parity: ``preprocess/albu.py:13-19``)."""

    def __init__(self, scales: Sequence[float], p: float = 0.5,
                 size_divisor: Optional[int] = None, seed: Optional[int] = None):
        super().__init__(scales=list(scales), size_divisor=size_divisor,
                         seed=seed)
        self.p = p

    def __call__(self, image, mask=None):
        if self.rng.random() >= self.p:
            return image, mask
        s = float(self.rng.choice(self.scales))
        nh, nw = self._target(image.shape[0], image.shape[1], s)
        image = _resize_bilinear(image, (nh, nw))
        mask = _map_mask(mask, lambda m: _resize_nearest(m, (nh, nw)))
        return image, mask


class RandomCrop:
    """Fixed-size crop with pad-if-small (mask pad 255)
    (parity: ``segm.py:104-129``)."""

    def __init__(self, size: Tuple[int, int], image_pad_value: float = 0.0,
                 mask_pad_value: int = 255, seed: Optional[int] = None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.image_pad_value = image_pad_value
        self.mask_pad_value = mask_pad_value
        self.rng = _ForkSafeRNG(seed)

    def __call__(self, image, mask=None):
        th, tw = self.size
        h, w = image.shape[:2]
        if h < th or w < tw:
            ph, pw = max(th - h, 0), max(tw - w, 0)
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)),
                           constant_values=self.image_pad_value)
            mask = _map_mask(mask, lambda m: np.pad(
                m, ((0, ph), (0, pw)), constant_values=self.mask_pad_value))
            h, w = image.shape[:2]
        y = int(self.rng.integers(0, h - th + 1))
        x = int(self.rng.integers(0, w - tw + 1))
        image = image[y:y + th, x:x + tw]
        mask = _map_mask(mask, lambda m: m[y:y + th, x:x + tw])
        return image, mask


class DivisiblePad:
    """Pad to size multiples (parity: ``segm.py:132-155``)."""

    def __init__(self, size_divisor: int, image_pad_value: float = 0.0,
                 mask_pad_value: int = 255):
        self.size_divisor = size_divisor
        self.image_pad_value = image_pad_value
        self.mask_pad_value = mask_pad_value

    def __call__(self, image, mask=None):
        h, w = image.shape[:2]
        nh = math.ceil(h / self.size_divisor) * self.size_divisor
        nw = math.ceil(w / self.size_divisor) * self.size_divisor
        image = np.pad(image, ((0, nh - h), (0, nw - w), (0, 0)),
                       constant_values=self.image_pad_value)
        mask = _map_mask(mask, lambda m: np.pad(
            m, ((0, nh - h), (0, nw - w)), constant_values=self.mask_pad_value))
        return image, mask


class FixedPad:
    """Pad to an exact minimum size (parity: ``segm.py:158-177`` and
    ``albu.ConstantPad``, ``albu.py:31-78``)."""

    def __init__(self, size: Tuple[int, int], image_pad_value: float = 0.0,
                 mask_pad_value: int = 255):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.image_pad_value = image_pad_value
        self.mask_pad_value = mask_pad_value

    def __call__(self, image, mask=None):
        h, w = image.shape[:2]
        ph, pw = max(self.size[0] - h, 0), max(self.size[1] - w, 0)
        image = np.pad(image, ((0, ph), (0, pw), (0, 0)),
                       constant_values=self.image_pad_value)
        mask = _map_mask(mask, lambda m: np.pad(
            m, ((0, ph), (0, pw)), constant_values=self.mask_pad_value))
        return image, mask


class MeanStdNormalize:
    """``(image − mean) / std`` in 0-255 space, float32.  uint8 images of at
    most 64 channels go through the host library's one-pass normalize
    (``data._tilekit.normalize_u8``, threads, the GIL released); other
    dtypes through numpy.  The two give the same bits as the JAX package's
    same paths."""

    def __init__(self, mean=None, std=None):
        self.mean = np.asarray(mean if mean is not None else IMAGENET_MEAN, np.float32)
        self.std = np.asarray(std if std is not None else IMAGENET_STD, np.float32)

    def __call__(self, image, mask=None):
        image = np.asarray(image)
        if image.dtype == np.uint8 and image.ndim >= 3 and image.shape[-1] <= 64:
            from ever_tpu_torch.data._tilekit import normalize_u8
            return normalize_u8(image, self.mean, self.std), mask
        return (image.astype(np.float32) - self.mean) / self.std, mask


class ChannelFirstToLast:
    """CHW → HWC adapter for reading NCHW sources (the NHWC analog of
    ``thcomm.THChannelFirst``)."""

    def __call__(self, image, mask=None):
        return np.ascontiguousarray(np.moveaxis(image, 0, -1)), mask


def transpose(img):
    """H/W transpose of an HWC array (parity: ``segm.py:10-13``, which is
    PIL-only; arrays are the native currency here)."""
    img = np.asarray(img)
    axes = (1, 0) + tuple(range(2, img.ndim))
    return np.transpose(img, axes)


# the reference's spelling of the joint image and mask conversion: arrays
# stay HWC numpy here
ToTensor = ToArray
