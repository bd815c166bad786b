"""The tensor family's containers and layout, normalisation and padding
transforms (counterpart of ``ever_tpu/preprocess/thcomm.py``), on HWC
torch tensors on the tensor's own device.  ``Pipeline`` splats a stage's
tuple into the next stage's arguments, as the reference's does; the
batched augmentation on the card is :func:`ever_tpu_torch.preprocess.
device.batch_augment`.
"""

from __future__ import annotations

import torch

from ever_tpu_torch.core.to import to_tensor
from ever_tpu_torch.preprocess import function as pF

__all__ = ['Pipeline', 'FuncWrapper', 'ToTensor', 'THChannelFirst', 'THChannelFirst2',
           'THMeanStdNormalize', 'THMeanStdNormalize2', 'THDivisiblePad']


class Pipeline:
    """Stages in order; a stage that returns a tuple has it splatted into
    the next stage's arguments."""

    def __init__(self, modules):
        self.modules = list(modules)

    def __call__(self, *inputs):
        for module in self.modules:
            inputs = module(*inputs) if isinstance(inputs, tuple) else module(inputs)
        return inputs


class FuncWrapper:
    """A plain callable as a stage."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *inputs):
        return self.fn(*inputs)


class ToTensor:
    """The inputs' numpy arrays as tensors on the host (a tuple)."""

    def __call__(self, *inputs):
        return to_tensor(inputs)


class THChannelFirst:
    """Ensures the HWC layout the port's models take: an input whose first
    axis has at most 8 entries is read as CHW (the reference's test for
    channel-first) and moved to HWC; any other input is already HWC, so
    hyperspectral stacks of more than 8 bands pass unchanged."""

    def __call__(self, image):
        if image.shape[0] > 8:
            return image
        return torch.as_tensor(image).permute(1, 2, 0)


class THChannelFirst2(THChannelFirst):
    """:class:`THChannelFirst` of the image, the other input passed on."""

    def __call__(self, image, other):
        return super().__call__(image), other


class THMeanStdNormalize:
    """``(image − mean) / std`` in 0-255 space, float32, on the image's
    device."""

    def __init__(self, mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375)):
        self._m = mean
        self._s = std

    def __call__(self, image):
        return pF.mean_std_normalize(torch.as_tensor(image), self._m, self._s)


class THMeanStdNormalize2(THMeanStdNormalize):
    """:class:`THMeanStdNormalize` of the image, the other input passed
    on."""

    def __call__(self, image, other):
        return super().__call__(image), other


class THDivisiblePad:
    """Pad the image (with 0) and the mask (with ``mask_pad_value``) at the
    bottom and right to multiples of ``size_divisor``, then to at least
    ``pad_to_size`` when given."""

    def __init__(self, size_divisor: int, mask_pad_value: int = 255, pad_to_size=None):
        self.size_divisor = size_divisor
        self.mask_pad_value = mask_pad_value
        self.pad_to_size = pad_to_size

    def _pad(self, x, value):
        x = pF.divisible_pad(x, self.size_divisor, value=value)
        if self.pad_to_size is not None:
            x = pF.pad_to_size(x, self.pad_to_size, value=value)
        return x

    def __call__(self, image, mask=None):
        image = self._pad(torch.as_tensor(image), 0.0)
        if mask is not None:
            mask = self._pad(torch.as_tensor(mask), self.mask_pad_value)
        return image, mask
