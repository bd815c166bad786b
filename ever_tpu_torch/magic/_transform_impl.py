"""Invertible NHWC batch transforms and test-time augmentation (counterpart
of ``ever_tpu/magic/_transform_impl.py``).

Spatial axes are 1 and 2.  :func:`d4_tta` stacks the 8 symmetries of the
square on the batch axis and predicts them with one call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ever_tpu_torch.interface.transform_base import MultiTransform, Transform
from ever_tpu_torch.module.ops import resize

__all__ = ['Identity', 'Rotate90k', 'HorizontalFlip', 'VerticalFlip',
           'Transpose', 'Scale', 'tta', 'TestTimeAugmentation', 'd4_tta']


class Identity(Transform):
    def transform(self, inputs):
        return inputs

    def inv_transform(self, transformed_inputs):
        return transformed_inputs


class Rotate90k(Transform):
    def __init__(self, k: int = 1):
        if k not in (1, 2, 3):
            raise ValueError('k must be 1, 2 or 3')
        self.k = k

    def transform(self, inputs):
        return torch.rot90(inputs, self.k, dims=(1, 2))

    def inv_transform(self, transformed_inputs):
        return torch.rot90(transformed_inputs, 4 - self.k, dims=(1, 2))


class HorizontalFlip(Transform):
    def transform(self, inputs):
        return torch.flip(inputs, dims=(2,))

    inv_transform = transform


class VerticalFlip(Transform):
    def transform(self, inputs):
        return torch.flip(inputs, dims=(1,))

    inv_transform = transform


class Transpose(Transform):
    def transform(self, inputs):
        return inputs.transpose(1, 2)

    inv_transform = transform


class Scale(Transform):
    """Bilinear rescale (antialiased when it shrinks) whose inverse restores
    the shape of the last input it transformed.  Stateful, as in the JAX
    package: one instance per pipeline."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 scale_factor: Optional[float] = None):
        if (size is None) == (scale_factor is None):
            raise ValueError('Scale needs exactly one of size or '
                             f'scale_factor (got size={size!r}, '
                             f'scale_factor={scale_factor!r})')
        self.size = size
        self.scale_factor = scale_factor
        self.input_shape = None

    def transform(self, inputs):
        self.input_shape = inputs.shape
        if self.size is not None:
            return resize(inputs, shape=tuple(self.size), method='bilinear')
        return resize(inputs, scale=self.scale_factor, method='bilinear')

    def inv_transform(self, transformed_inputs):
        return resize(transformed_inputs, shape=tuple(self.input_shape[1:3]),
                      method='bilinear')


def tta(model: Callable, image, tta_config: Sequence[Transform]):
    """Apply each transform, predict, invert and average."""
    trans = MultiTransform(*tta_config)
    outs = trans.inv_transform([model(im) for im in trans.transform(image)])
    return sum(outs) / len(outs)


class TestTimeAugmentation:
    """A callable wrapper of ``module`` under :func:`tta`."""

    def __init__(self, module: Callable, tta_config: Sequence[Transform]):
        self.module = module
        self.trans = MultiTransform(*tta_config)

    def __call__(self, image):
        outs = self.trans.inv_transform([self.module(im)
                                         for im in self.trans.transform(image)])
        return sum(outs) / len(outs)


def d4_tta(model: Callable, image: torch.Tensor) -> torch.Tensor:
    """Full dihedral-group TTA in one call of ``model``.

    The 4 rotations of the image and of its horizontal flip are stacked on
    the batch axis (``[8N, H, W, C]``), predicted together, rotated back
    (``rot90`` by ``4 - k``), unflipped and averaged.  ``image`` is
    ``[N, H, W, C]`` with H == W.
    """
    variants = []
    for flip in (False, True):
        base = torch.flip(image, dims=(2,)) if flip else image
        for k in range(4):
            variants.append(torch.rot90(base, k, dims=(1, 2)))
    preds = model(torch.cat(variants, dim=0))
    outs = torch.chunk(preds, 8, dim=0)
    restored = []
    i = 0
    for flip in (False, True):
        for k in range(4):
            y = torch.rot90(outs[i], 4 - k, dims=(1, 2))
            if flip:
                y = torch.flip(y, dims=(2,))
            restored.append(y)
            i += 1
    return sum(restored) / 8.0
