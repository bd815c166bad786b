"""The reference's albumentations spellings on the numpy family
(counterpart of ``ever_tpu/preprocess/albu.py``): ``ToTensor``,
``ConstantPad`` and ``RandomDiscreteScale`` as plain ``(image, mask) ->
(image, mask)`` callables; no albumentations needed.
"""

from __future__ import annotations

from ever_tpu_torch.preprocess.segm import FixedPad, RandomDiscreteScale, ToArray

__all__ = ['ToTensor', 'ConstantPad', 'RandomDiscreteScale']


class ToTensor(ToArray):
    """The reference's spelling of :class:`ToArray`: HWC float32 images and
    int32 masks (one or a list)."""


class ConstantPad(FixedPad):
    """Pad at the bottom and right to at least ``(min_height,
    min_width)``; ``always_apply`` and ``p`` are accepted and ignored (the
    pad is deterministic)."""

    def __init__(self, min_height: int = 1024, min_width: int = 1024, value=None,
                 mask_value=None, always_apply: bool = False, p: float = 1.0):
        del always_apply, p
        super().__init__((min_height, min_width),
                         image_pad_value=0.0 if value is None else value,
                         mask_pad_value=255 if mask_value is None else mask_value)
