"""LoveDA (counterpart of ``ever_tpu/data/loveda.py``), registered as
``'loveda'``, reading a standard LoveDA checkout::

    {root}/{Train|Val|Test}/{Urban|Rural}/images_png/NNNN.png
                                          masks_png/NNNN.png

PNG files are decoded by the port's own codec (``data/_png.py``); the card
machine has no PIL.  Masks use the official encoding: 0 = no-data (→ 255,
the ignore index), classes 1..7 → 0..6.  Each scene is one sample: training
crops it to ``crop_size`` with the shared seeded crop and flip
(``data/_scene.py``); the other splits give the whole scene, or a centre
crop with ``eval_crop=True``.  Samples are ``(image [H, W, 3] float32, mask
[H, W] int32)``, or the image alone without masks.  ``layout='s2d'`` folds
the image after the transforms (``SpaceToDepth``: ``[H/2, W/2, 12]``, for
``stem='s2d_input'``); the mask stays at full resolution.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Tuple

import numpy as np

from ever_tpu_torch.core import registry
from ever_tpu_torch.data import _tilekit
from ever_tpu_torch.data._png import read_png
from ever_tpu_torch.data._scene import CroppedSceneDataset, SpaceToDepth, require_all_or_none

__all__ = ['LoveDA']

_SPLIT_DIR = {'train': 'Train', 'val': 'Val', 'test': 'Test'}


@registry.DATASET.register('loveda')
class LoveDA(CroppedSceneDataset):
    def set_default_config(self):
        super().set_default_config()
        self.config.update(dict(
            domains=('Urban', 'Rural'),
            layout='hwc',         # 'hwc' | 's2d' (stem='s2d_input')
        ))

    def __init__(self, config=None):
        super().__init__(config)
        cfg = self.config
        if cfg.get('layout', 'hwc') not in ('hwc', 's2d'):
            raise ValueError(f"layout must be 'hwc' or 's2d', got {cfg.layout!r}")
        split = _SPLIT_DIR.get(str(cfg.split).lower(), cfg.split)
        pairs: List[Tuple[str, Optional[str]]] = []
        for dom in cfg.domains:
            imgs = sorted(_glob.glob(os.path.join(cfg.root, split, dom, 'images_png', '*.png')))
            for ip in imgs:
                mp = os.path.join(cfg.root, split, dom, 'masks_png', os.path.basename(ip))
                pairs.append((ip, mp if os.path.exists(mp) else None))
        if not pairs and cfg.root:
            raise FileNotFoundError(
                f'no LoveDA images under {cfg.root}/{split} '
                f'(expected .../{{domain}}/images_png/*.png)')
        require_all_or_none(pairs, 'mask')
        self.pairs = pairs
        _tilekit.load()       # build the decoder's library before workers fork

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        img_path, mask_path = self.pairs[int(idx)]
        image = read_png(img_path)
        if image.ndim == 2:
            image = image[..., None]
        mask = None
        if mask_path is not None:
            raw = read_png(mask_path)
            # official encoding: 0 = no-data -> 255; 1..7 -> 0..6
            mask = np.where(raw == 0, 255, raw - 1).astype(np.int32)

        image = self._pad_min(image, 0)
        mask = self._pad_min(mask, 255)
        p = self._crop_params(idx, image.shape[0], image.shape[1])
        image, mask = self._apply(image, p), self._apply(mask, p)

        image = np.ascontiguousarray(image).astype(np.float32)
        if mask is not None:
            mask = np.ascontiguousarray(mask)
        for t in self.config.get('transforms', None) or ():
            image, mask = t(image, mask)
        if self.config.get('layout', 'hwc') == 's2d':
            image, mask = SpaceToDepth()(image, mask)
        if mask is None:
            return image
        return image, mask
