"""Shared scene-dataset plumbing (counterpart of ``ever_tpu/data/_scene.py``):
a seeded per-(epoch, index) random crop and horizontal flip for training,
full scenes (or a deterministic centre crop with ``eval_crop=True``) for
evaluation, and bottom/right padding to ``crop_size`` so that scenes smaller
than a crop still train.

The crop generator is ``np.random.default_rng((seed*1000003 + epoch)
*1000003 + idx)``, the JAX package's, so both packages cut the same crops.

``SpaceToDepth`` is the readers' ``layout='s2d'`` fold (the port's copy of
``ever_tpu/preprocess/segm.py`` ``SpaceToDepth``).
"""

from __future__ import annotations

import os

import numpy as np

from ever_tpu_torch.interface.dataloader import ERDataset

__all__ = ['CroppedSceneDataset', 'SpaceToDepth', 'require_all_or_none']


class SpaceToDepth:
    """Host-side 2×2 space-to-depth of a sample: ``[H, W, C]`` →
    ``[H/2, W/2, 4C]`` with channel ``(dy·2 + dx)·C + c``, what encoders
    with ``stem='s2d_input'`` take; the mask is returned untouched (labels
    stay at full resolution)."""

    def __init__(self, block: int = 2):
        self.block = int(block)

    def __call__(self, image, mask=None):
        b = self.block
        image = np.asarray(image)
        h, w, c = image.shape
        image = image.reshape(h // b, b, w // b, b, c)
        image = np.ascontiguousarray(image.transpose(0, 2, 1, 3, 4))
        return image.reshape(h // b, w // b, b * b * c), mask


def require_all_or_none(pairs, what: str) -> None:
    """Labels must be present for every sample or for none (a test split):
    a partial set would mix ``(x, y)`` tuples and bare images in a batch."""
    missing = [img for img, lab in pairs if lab is None]
    if missing and len(missing) != len(pairs):
        preview = ', '.join(os.path.basename(m) for m in missing[:5])
        raise FileNotFoundError(
            f'{len(missing)}/{len(pairs)} samples are missing their {what} '
            f'file (e.g. {preview}); provide labels for all samples or '
            'none (test split)')


class CroppedSceneDataset(ERDataset):
    def set_default_config(self):
        self.config.update(dict(
            root='',
            split='train',
            crop_size=512,
            random_crop=None,      # default: split == 'train'
            eval_crop=False,       # True: centre-crop the other splits too
            hflip=True,
            seed=0,
            transforms=None,
        ))

    def __init__(self, config=None):
        super().__init__(config)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:    # called by the iterator
        self._epoch = int(epoch)

    def _crop_here(self):
        """(cropping applies, the crop is random, crop size)."""
        cfg = self.config
        do_crop = cfg.random_crop
        if do_crop is None:
            do_crop = str(cfg.split).lower() == 'train'
        k = int(cfg.crop_size or 0)
        return (bool(do_crop) or bool(cfg.get('eval_crop', False))), bool(do_crop), k

    def _crop_params(self, idx: int, h: int, w: int):
        """(y0, x0, k, flip), or None when no crop applies; ``h`` and ``w``
        are the scene's size after :meth:`_pad_min`."""
        crop_here, do_crop, k = self._crop_here()
        if not (crop_here and k and h >= k and w >= k):
            return None
        if do_crop:
            rng = np.random.default_rng(
                (int(self.config.seed) * 1_000_003 + self._epoch) * 1_000_003 + idx)
            y0 = int(rng.integers(0, h - k + 1))
            x0 = int(rng.integers(0, w - k + 1))
            flip = bool(self.config.hflip) and bool(rng.integers(0, 2))
        else:
            y0, x0, flip = (h - k) // 2, (w - k) // 2, False
        return y0, x0, k, flip

    def _pad_min(self, arr, fill):
        """Pad bottom and right to ``crop_size`` when cropping applies
        (images with 0, labels with the ignore index)."""
        if arr is None:
            return None
        crop_here, _, k = self._crop_here()
        if not (crop_here and k):
            return arr
        ph, pw = max(0, k - arr.shape[0]), max(0, k - arr.shape[1])
        if not ph and not pw:
            return arr
        widths = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, widths, constant_values=fill)

    @staticmethod
    def _apply(arr, p):
        if arr is None or p is None:
            return arr
        y0, x0, k, flip = p
        arr = arr[y0:y0 + k, x0:x0 + k]
        if flip:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)
