"""The tensor family's random transforms (counterpart of
``ever_tpu/preprocess/thsegm.py``) on an HWC image and an HW mask, torch
tensors (or numpy arrays, taken as tensors) on the tensor's own device.

The draws come from ``np.random``, as in the JAX package and the
reference, so that after the same ``np.random.seed`` both packages draw the
same values.  The batched augmentation on the card, with its draws on the
device, is :func:`ever_tpu_torch.preprocess.device.batch_augment`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['THRandomRotate90k', 'THRandomHorizontalFlip', 'THRandomVerticalFlip',
           'THRandomCrop', 'THRandomScale']


def _ret(image, mask):
    return (image, mask) if mask is not None else image


class THRandomRotate90k:
    """Rotate image and mask by ``k`` quarter turns, or by a uniform draw
    from 0-3 when ``k`` is None."""

    def __init__(self, k=None):
        self.k = k

    def __call__(self, images, masks=None):
        k = int(np.random.choice([0, 1, 2, 3])) if self.k is None else self.k
        if k == 0:
            return _ret(images, masks)
        images = torch.rot90(torch.as_tensor(images), k, (0, 1))
        if masks is not None:
            masks = torch.rot90(torch.as_tensor(masks), k, (0, 1))
        return _ret(images, masks)


class _THRandomFlip:
    axis: int

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, images, masks=None):
        if self.p < np.random.uniform():
            return _ret(images, masks)
        images = torch.flip(torch.as_tensor(images), (self.axis,))
        if masks is not None:
            masks = torch.flip(torch.as_tensor(masks), (self.axis,))
        return _ret(images, masks)


class THRandomHorizontalFlip(_THRandomFlip):
    """Flip the width axis with probability ``p``."""
    axis = 1


class THRandomVerticalFlip(_THRandomFlip):
    """Flip the height axis with probability ``p``."""
    axis = 0


class THRandomCrop:
    """Pad with zeros at the bottom and right up to ``crop_size``, then a
    random ``crop_size`` window; returns a tuple."""

    def __init__(self, crop_size=(512, 512)):
        self.crop_size = crop_size

    def __call__(self, images, masks=None):
        images = torch.as_tensor(images)
        c_h, c_w = self.crop_size
        im_h, im_w = images.shape[:2]
        ph, pw = max(c_h - im_h, 0), max(c_w - im_w, 0)
        if ph or pw:
            images = F.pad(images, (0, 0, 0, pw, 0, ph))
            if masks is not None:
                masks = F.pad(torch.as_tensor(masks), (0, pw, 0, ph))
        im_h, im_w = images.shape[:2]
        ymin = int(np.random.randint(0, im_h - c_h + 1))
        xmin = int(np.random.randint(0, im_w - c_w + 1))
        images = images[ymin:ymin + c_h, xmin:xmin + c_w, :]
        if masks is None:
            return (images,)
        return images, torch.as_tensor(masks)[ymin:ymin + c_h, xmin:xmin + c_w]


class THRandomScale:
    """Rescale by one factor from ``scale_range`` in steps of
    ``scale_step``, drawn once at construction (as the reference does): the
    image bilinearly with corners aligned (float32), the mask by nearest
    neighbour in its dtype; returns a tuple."""

    def __init__(self, scale_range=(0.5, 2.0), scale_step=0.25):
        factors = np.linspace(scale_range[0], scale_range[1],
                              int((scale_range[1] - scale_range[0]) / scale_step) + 1)
        self.scale_factor = float(np.random.choice(factors))

    def __call__(self, images, masks=None):
        from ever_tpu_torch.module.ops import resize

        images = torch.as_tensor(images).float()
        out = [resize(images[None], scale=self.scale_factor, method='bilinear',
                      align_corners=True)[0]]
        if masks is not None:
            masks = torch.as_tensor(masks)
            m = resize(masks[None, :, :, None].float(), scale=self.scale_factor,
                       method='nearest')
            out.append(m[0, :, :, 0].to(masks.dtype))
        return tuple(out)
