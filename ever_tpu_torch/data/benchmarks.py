"""The LEVIR-CD, xView2 and iSAID readers (counterpart of
``ever_tpu/data/benchmarks.py``), registered as ``'levircd'``, ``'xview2'``
and ``'isaid'``.  PNG files are decoded by the port's own codec
(``data/_png.py``; the card machine has no PIL), and each reader crops with
the seeded per-(epoch, index) crop and flip of ``data/_scene.py``.

- ``levircd``: ``{root}/{split}/{A,B,label}/*.png``.  Yields ``(x [H, W,
  6] t1‖t2 float32, {'masks': [H, W, 2], 'change': [H, W]})``: the change
  label is channel 0 of the label file ``> 127``; LEVIR-CD has no
  per-date semantic masks, so ``masks`` is all ``ignore_index`` (255).
- ``xview2``: ``{root}/{split}/images/{id}_{pre,post}_disaster.png`` and
  ``targets/{id}_{pre,post}_disaster_target.png``.  Yields ``(x [H, W, 6]
  pre‖post, {'loc': [H, W] 0/1, 'damage': [H, W] 0..4})``: ``loc`` is the
  pre-event target ``> 0``, and damage 5 (un-classified) is 255.
  ``transforms`` raise at construction: they cannot keep dict labels in
  step with the image.
- ``isaid``: ``{root}/{split}/images/*.png`` with
  ``{stem}_instance_color_RGB.png`` masks beside them or under
  ``Semantic_masks/images/``.  Yields ``(image [H, W, C] float32, mask [H,
  W] int32)``: the devkit palette (RGB of an RGBA mask) decodes to 0..15
  and any other colour to 255; a 2-D mask is already class-coded; a grey
  image is repeated to 3 channels.

Without labels a reader yields the image alone.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Tuple

import numpy as np

from ever_tpu_torch.core import registry
from ever_tpu_torch.data import _tilekit
from ever_tpu_torch.data._png import read_png
from ever_tpu_torch.data._scene import CroppedSceneDataset, require_all_or_none

__all__ = ['LEVIRCD', 'XView2', 'ISAID', 'ISAID_PALETTE']


def _hwc(img: np.ndarray) -> np.ndarray:
    """A channel axis on a grey frame, so that two dates concatenate to
    ``[H, W, 2C]``, not ``[H, 2W]``."""
    return img[..., None] if img.ndim == 2 else img


class _PngScenes(CroppedSceneDataset):
    def set_default_config(self):
        super().set_default_config()
        self.config.update(dict(ignore_index=255))

    def __init__(self, config=None):
        super().__init__(config)
        _tilekit.load()       # build the decoder's library before workers fork


@registry.DATASET.register('levircd')
class LEVIRCD(_PngScenes):
    """LEVIR-CD (Chen & Shi 2020), ``{root}/{split}/{A,B,label}/*.png``."""

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        split = str(cfg.split).lower()
        self.triples: List[Tuple[str, str, Optional[str]]] = []
        for ap in sorted(_glob.glob(os.path.join(cfg.root, split, 'A', '*.png'))):
            name = os.path.basename(ap)
            bp = os.path.join(cfg.root, split, 'B', name)
            lp = os.path.join(cfg.root, split, 'label', name)
            if os.path.exists(bp):
                self.triples.append((ap, bp, lp if os.path.exists(lp) else None))
        if not self.triples and cfg.root:
            raise FileNotFoundError(
                f'no LEVIR-CD pairs under {cfg.root}/{split} '
                '(expected .../A/*.png with matching B/ and label/)')
        require_all_or_none([(ap, lp) for ap, _, lp in self.triples], 'label')

    def __len__(self) -> int:
        return len(self.triples)

    def __getitem__(self, idx: int):
        ap, bp, lp = self.triples[int(idx)]
        t1, t2 = _hwc(read_png(ap)), _hwc(read_png(bp))
        change = None
        if lp is not None:
            change = read_png(lp) > 127
            if change.ndim == 3:
                change = change[..., 0]
            change = change.astype(np.int32)
        ig = int(self.config.ignore_index)
        t1, t2, change = self._pad_min(t1, 0), self._pad_min(t2, 0), self._pad_min(change, ig)
        p = self._crop_params(idx, t1.shape[0], t1.shape[1])
        t1, t2, change = self._apply(t1, p), self._apply(t2, p), self._apply(change, p)
        x = np.concatenate([t1, t2], axis=-1).astype(np.float32)
        for t in self.config.get('transforms', None) or ():
            x, change = t(x, change)
        if change is None:
            return x
        return x, dict(masks=np.full(change.shape + (2,), ig, np.int32), change=change)


@registry.DATASET.register('xview2')
class XView2(_PngScenes):
    """xView2/xBD (Gupta et al. 2019), ``images/`` and ``targets/`` per
    split.  Damage: 0 background, 1 no damage, 2 minor, 3 major, 4
    destroyed, 5 un-classified (→ ``ignore_index``)."""

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        split = str(cfg.split)
        tdir = os.path.join(cfg.root, split, 'targets')
        self.pairs: List[Tuple[str, str, Optional[str], Optional[str]]] = []
        for pp in sorted(_glob.glob(os.path.join(cfg.root, split, 'images',
                                                 '*_pre_disaster.png'))):
            post = pp.replace('_pre_disaster.png', '_post_disaster.png')
            if not os.path.exists(post):
                continue
            lt = os.path.join(tdir, os.path.basename(pp).replace('.png', '_target.png'))
            dt = os.path.join(tdir, os.path.basename(post).replace('.png', '_target.png'))
            self.pairs.append((pp, post, lt if os.path.exists(lt) else None,
                               dt if os.path.exists(dt) else None))
        if not self.pairs and cfg.root:
            raise FileNotFoundError(
                f'no xView2 scenes under {cfg.root}/{split} '
                '(expected images/*_pre_disaster.png with _post_disaster '
                'twins; optional targets/*_target.png)')
        require_all_or_none([(pp, lt) for pp, _, lt, _ in self.pairs], 'pre_disaster_target')
        require_all_or_none([(pp, dt) for pp, _, _, dt in self.pairs], 'post_disaster_target')
        if cfg.get('transforms', None):
            raise ValueError(
                'xview2 yields dict labels; per-pair transforms do not '
                'apply — use the dataset crop/hflip config or wrap samples')

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        pp, post, lt, dt = self.pairs[int(idx)]
        pre_img, post_img = _hwc(read_png(pp)), _hwc(read_png(post))
        ig = int(self.config.ignore_index)
        loc = damage = None
        if lt is not None:
            loc = (read_png(lt) > 0).astype(np.int32)
        if dt is not None:
            damage = read_png(dt).astype(np.int32)
            damage = np.where(damage == 5, ig, damage).astype(np.int32)
        pre_img, post_img = self._pad_min(pre_img, 0), self._pad_min(post_img, 0)
        loc, damage = self._pad_min(loc, ig), self._pad_min(damage, ig)
        p = self._crop_params(idx, pre_img.shape[0], pre_img.shape[1])
        pre_img, post_img = self._apply(pre_img, p), self._apply(post_img, p)
        loc, damage = self._apply(loc, p), self._apply(damage, p)
        x = np.concatenate([pre_img, post_img], axis=-1).astype(np.float32)
        if loc is None or damage is None:
            return x
        return x, dict(loc=loc, damage=damage)


# The iSAID devkit palette: classes 1..15 (0 the black background; any
# other colour is ignored).
ISAID_PALETTE = {
    (0, 0, 0): 0,
    (0, 0, 63): 1,       # ship
    (0, 191, 127): 2,    # storage tank
    (0, 63, 0): 3,       # baseball diamond
    (0, 63, 127): 4,     # tennis court
    (0, 63, 191): 5,     # basketball court
    (0, 63, 255): 6,     # ground track field
    (0, 127, 63): 7,     # bridge
    (0, 127, 127): 8,    # large vehicle
    (0, 0, 127): 9,      # small vehicle
    (0, 0, 191): 10,     # helicopter
    (0, 0, 255): 11,     # swimming pool
    (0, 63, 63): 12,     # roundabout
    (0, 127, 191): 13,   # soccer ball field
    (0, 127, 255): 14,   # plane
    (0, 100, 155): 15,   # harbor
}

# sorted packed-RGB keys and their classes: one searchsorted decodes a mask
_ISAID_PACKED = sorted(((r << 16) | (g << 8) | b, c) for (r, g, b), c in ISAID_PALETTE.items())
_ISAID_KEYS = np.asarray([k for k, _ in _ISAID_PACKED], np.int64)
_ISAID_VALS = np.asarray([c for _, c in _ISAID_PACKED], np.int32)


@registry.DATASET.register('isaid')
class ISAID(_PngScenes):
    """iSAID (Waqas Zamir et al. 2019), semantic flavour; a pre-tiled
    checkout of patches works unchanged (every patch is one sample)."""

    _MASK_SUFFIX = '_instance_color_RGB.png'

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        split = str(cfg.split).lower()
        img_dir = os.path.join(cfg.root, split, 'images')
        self.pairs: List[Tuple[str, Optional[str]]] = []
        for ip in sorted(_glob.glob(os.path.join(img_dir, '*.png'))):
            if ip.endswith(self._MASK_SUFFIX):
                continue
            stem = os.path.splitext(os.path.basename(ip))[0] + self._MASK_SUFFIX
            cands = (os.path.join(img_dir, stem),
                     os.path.join(cfg.root, split, 'Semantic_masks', 'images', stem))
            self.pairs.append((ip, next((c for c in cands if os.path.exists(c)), None)))
        if not self.pairs and cfg.root:
            raise FileNotFoundError(
                f'no iSAID images under {img_dir} (expected *.png with '
                f'*{self._MASK_SUFFIX} masks)')
        require_all_or_none(self.pairs, 'semantic mask')

    def __len__(self) -> int:
        return len(self.pairs)

    def _decode_mask(self, raw: np.ndarray) -> np.ndarray:
        if raw.ndim == 2:       # already class-coded
            return raw.astype(np.int32)
        rgb = raw[..., :3].astype(np.int64)
        packed = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
        pos = np.clip(np.searchsorted(_ISAID_KEYS, packed), 0, len(_ISAID_KEYS) - 1)
        hit = _ISAID_KEYS[pos] == packed
        return np.where(hit, _ISAID_VALS[pos], int(self.config.ignore_index)).astype(np.int32)

    def __getitem__(self, idx: int):
        ip, mp = self.pairs[int(idx)]
        image = _hwc(read_png(ip))
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        mask = self._decode_mask(read_png(mp)) if mp else None
        image = self._pad_min(image, 0)
        mask = self._pad_min(mask, int(self.config.ignore_index))
        p = self._crop_params(idx, image.shape[0], image.shape[1])
        image, mask = self._apply(image, p), self._apply(mask, p)
        image = image.astype(np.float32)
        for t in self.config.get('transforms', None) or ():
            image, mask = t(image, mask)
        if mask is None:
            return image
        return image, mask
