"""Geo-tile patch sampling over large scenes (counterpart of
``ever_tpu/data/geotile.py``), registered as ``'geotile'``.

A dataset is a set of large rasters (scenes); its samples are fixed-size
patches on a sliding-window grid (``magic/sliding_window.py``'s boxes, each
full-size), indexed once at construction.  Decoded scenes stay in a small
LRU.  Sources: ``.npy`` through a memory map and PNG through the port's
codec (``data/_png.py``); TIFF needs the ``tifffile`` package, and other
formats raise.

:meth:`GeoTileDataset.read_batch` gathers a whole batch of uint8 patches
with the port's host library (``csrc/tilekit.cpp``, one call per scene).  A
``DataLoader`` reaches it through ``__getitems__``, and
:func:`collate` passes its already-stacked result through; the result
equals the per-item path's.
"""

from __future__ import annotations

import glob as _glob
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ever_tpu_torch.core import registry
from ever_tpu_torch.data import _tilekit
from ever_tpu_torch.data._png import png_size, read_png
from ever_tpu_torch.data._scene import SpaceToDepth
from ever_tpu_torch.interface.dataloader import ERDataset, default_collate
from ever_tpu_torch.magic.sliding_window import sliding_window

__all__ = ['GeoTileDataset', 'read_raster', 'collate']


def read_raster(path: str) -> np.ndarray:
    """Decode a scene to numpy (``[H, W, C]`` images, ``[H, W]`` single-band
    masks)."""
    if path.endswith('.npy'):
        return np.load(path, mmap_mode='r')
    if path.endswith(('.tif', '.tiff')):
        try:
            import tifffile
        except ImportError:
            raise ImportError(f'{path}: reading TIFF needs the tifffile package, '
                              'which is not installed') from None
        return tifffile.imread(path)
    if path.endswith('.png'):
        return read_png(path)
    raise ValueError(f'{path}: the port reads .npy, .png and (with tifffile) '
                     '.tif scenes')


def _scene_size(path: str) -> Tuple[int, int]:
    if path.endswith('.npy'):
        arr = np.load(path, mmap_mode='r')
        return arr.shape[0], arr.shape[1]
    if path.endswith('.png'):
        return png_size(path)
    arr = read_raster(path)
    return arr.shape[0], arr.shape[1]


class _SceneCache:
    """LRU of decoded scenes, safe for a threaded reader: a scene being
    decoded by one thread is not decoded again by another."""

    def __init__(self, max_items: int = 4):
        self.max_items = max_items
        self._cache: 'OrderedDict[str, np.ndarray]' = OrderedDict()
        self._lock = threading.Lock()
        self._pending: dict = {}   # path -> Event of an in-flight decode

    def get(self, path: str) -> np.ndarray:
        while True:
            with self._lock:
                if path in self._cache:
                    self._cache.move_to_end(path)
                    return self._cache[path]
                ev = self._pending.get(path)
                if ev is None:
                    self._pending[path] = threading.Event()
                    break
            ev.wait()
        try:
            arr = read_raster(path)
            with self._lock:
                self._cache[path] = arr
                if len(self._cache) > self.max_items:
                    self._cache.popitem(last=False)
            return arr
        finally:
            with self._lock:
                self._pending.pop(path).set()


class _Batch(tuple):
    """What :meth:`GeoTileDataset.__getitems__` returns when
    :meth:`GeoTileDataset.read_batch` stacked the batch already."""


def collate(items):
    """``default_collate``, except that a batch read by ``read_batch``
    becomes tensors without another copy."""
    if isinstance(items, _Batch):
        out = tuple(torch.from_numpy(a) for a in items)
        return out if len(out) > 1 else out[0]
    return default_collate(items)


@registry.DATASET.register('geotile')
class GeoTileDataset(ERDataset):
    """Patch-grid dataset over paired (image, mask) scene files::

        dict(image_glob='.../images/*.png', mask_glob='.../masks/*.png',
             patch_size=512, stride=512, scene_pairs=None,  # or a list
             transforms=None, cache_scenes=4, image_dtype='float32',
             mask_dtype='int32')

    Scenes pair by sorted glob order (or ``scene_pairs``); ``len`` is the
    number of patches over all scenes.
    """

    collate_fn = staticmethod(collate)

    def set_default_config(self):
        self.config.update(dict(
            image_glob='',
            mask_glob='',
            scene_pairs=None,
            patch_size=512,
            stride=512,
            transforms=None,
            cache_scenes=4,
            layout='hwc',            # 'hwc' | 's2d' (stem='s2d_input')
            image_dtype='float32',   # 'uint8' keeps the raw bytes
            mask_dtype='int32',
        ))

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        if cfg.get('layout', 'hwc') not in ('hwc', 's2d'):
            raise ValueError(f"layout must be 'hwc' or 's2d', got {cfg.layout!r}")
        if cfg.scene_pairs:
            pairs = [tuple(p) for p in cfg.scene_pairs]
        else:
            images = sorted(_glob.glob(cfg.image_glob)) if cfg.image_glob else []
            masks = sorted(_glob.glob(cfg.mask_glob)) if cfg.mask_glob else []
            if cfg.mask_glob and len(images) != len(masks):
                raise ValueError(
                    f'image/mask scene count mismatch: {len(images)} images vs '
                    f'{len(masks)} masks (mask_glob={cfg.mask_glob!r})')
            pairs = list(zip(images, masks)) if masks else [(i, None) for i in images]
        self.scene_pairs: List[Tuple[str, Optional[str]]] = pairs
        self._cache = _SceneCache(cfg.cache_scenes)

        # the patch index: (scene, x0, y0)
        self._index: List[Tuple[int, int, int]] = []
        k, s = int(cfg.patch_size), int(cfg.stride)
        for si, (img_path, _) in enumerate(self.scene_pairs):
            h, w = _scene_size(img_path)
            if h < k or w < k:
                raise ValueError(
                    f'scene {img_path!r} is {h}x{w}, smaller than '
                    f'patch_size={k}; pad the scene or lower patch_size')
            seen = set()
            for x0, y0, _, _ in sliding_window((h, w), k, s):
                key = (int(x0), int(y0))
                if key not in seen:      # edge shifts can duplicate boxes
                    seen.add(key)
                    self._index.append((si, int(x0), int(y0)))
        _tilekit.load()       # build the gather's library before workers fork

    def __len__(self) -> int:
        return len(self._index)

    def read_batch(self, indices):
        """The patches of ``indices`` stacked, gathered by the host library
        in one call per scene: ``(images [n, k, k, C], masks [n, k, k])``
        (or the images alone; with ``layout='s2d'`` the images folded by
        the gather itself, ``[n, k/2, k/2, 4C]``), equal to the per-item
        path's.  Returns
        ``NotImplemented`` where it does not apply (python transforms,
        scenes that are not C-contiguous uint8, a mix of scenes with and
        without masks); the caller then takes the per-item path."""
        if self.config.get('transforms', None):
            return NotImplemented
        s2d = self.config.get('layout', 'hwc') == 's2d'
        k = int(self.config.patch_size)
        items = [self._index[int(i)] for i in indices]
        by_scene = {}
        for pos, (si, x0, y0) in enumerate(items):
            by_scene.setdefault(si, []).append((pos, x0, y0))
        if len({self.scene_pairs[si][1] is not None for si in by_scene}) > 1:
            return NotImplemented
        n = len(items)
        images = masks = None
        for si, entries in by_scene.items():
            img_path, mask_path = self.scene_pairs[si]
            scene = self._cache.get(img_path)
            if not _gatherable(scene):
                return NotImplemented
            mask_scene = None
            if mask_path is not None:
                mask_scene = self._cache.get(mask_path)
                if not _gatherable(mask_scene):
                    return NotImplemented
            c = scene.shape[2] if scene.ndim == 3 else 1
            if images is None:
                images = np.empty((n, k // 2, k // 2, 4 * c) if s2d else (n, k, k, c),
                                  np.uint8)
            elif (4 * c if s2d else c) != images.shape[-1]:
                raise ValueError(
                    f'scene {img_path!r} has {c} channels; the batch was '
                    f'allocated for {images.shape[-1] // (4 if s2d else 1)}: all scenes '
                    'of a GeoTileDataset must share a channel count')
            if mask_scene is not None:
                mc = mask_scene.shape[2] if mask_scene.ndim == 3 else 1
                if masks is None:
                    masks = np.empty((n, k, k, mc), np.uint8)
                elif mc != masks.shape[-1]:
                    raise ValueError(
                        f'mask scene {mask_path!r} has {mc} channels; the batch '
                        f'was allocated for {masks.shape[-1]}')
            boxes = np.asarray([(y0, x0) for _, x0, y0 in entries], np.int64)
            pos = [p for p, _, _ in entries]
            gather = _tilekit.extract_tiles_s2d if s2d else _tilekit.extract_tiles
            images[pos] = gather(scene, boxes, (k, k))
            if mask_scene is not None:
                masks[pos] = _tilekit.extract_tiles(mask_scene, boxes, (k, k))
        if self.config.get('image_dtype', 'float32') != 'uint8':
            images = images.astype(np.float32)
        if masks is None:
            return images
        if masks.shape[-1] == 1:       # single-band masks squeeze, as per item
            masks = masks[..., 0]
        return images, masks.astype(np.dtype(self.config.get('mask_dtype', 'int32')))

    def __getitems__(self, indices):
        """A ``DataLoader``'s batched read: :meth:`read_batch` where it
        applies, else the samples one by one."""
        batch = self.read_batch(indices)
        if batch is NotImplemented:
            return [self[i] for i in indices]
        return _Batch(batch if isinstance(batch, tuple) else (batch,))

    def __getitem__(self, idx: int):
        si, x0, y0 = self._index[int(idx)]
        img_path, mask_path = self.scene_pairs[si]
        k = int(self.config.patch_size)
        dt = np.uint8 if self.config.get('image_dtype', 'float32') == 'uint8' else np.float32
        image = np.asarray(self._cache.get(img_path)[y0:y0 + k, x0:x0 + k], dtype=dt)
        if image.ndim == 2:
            image = image[..., None]
        mask = None
        if mask_path is not None:
            mask = np.asarray(self._cache.get(mask_path)[y0:y0 + k, x0:x0 + k],
                              dtype=np.dtype(self.config.get('mask_dtype', 'int32')))
        for t in self.config.get('transforms', None) or ():
            image, mask = t(image, mask)
        if self.config.get('layout', 'hwc') == 's2d':
            image, mask = SpaceToDepth()(image, mask)
        if mask is None:
            return image
        return image, mask


def _gatherable(scene) -> bool:
    return (isinstance(scene, np.ndarray) and scene.dtype == np.uint8
            and scene.flags['C_CONTIGUOUS'])
