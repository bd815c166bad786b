"""Functional preprocessing on numpy arrays and torch tensors, NHWC
(counterpart of ``ever_tpu/preprocess/function.py``): the ImageNet mean and
standard deviation in 0-255 space, normalisation, and bottom/right padding
to a size multiple or a minimum size.  A tensor stays on its device; a
numpy array stays a numpy array.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics in 0-255 space
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

__all__ = ['mean_std_normalize', 'divisible_pad', 'pad_to_size', 'IMAGENET_MEAN',
           'IMAGENET_STD', 'th_mean_std_normalize', 'th_divisible_pad', 'th_pad_to_size']


def channel_constants(values: Sequence[float], device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``, made there by fills:
    no copy from the host, so no wait for the card."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def mean_std_normalize(image, mean: Sequence[float] = IMAGENET_MEAN,
                       std: Sequence[float] = IMAGENET_STD):
    """``(image − mean) / std`` in float32 over the last (channel) axis, any
    leading axes."""
    if torch.is_tensor(image):
        dev = image.device
        return (image.float() - channel_constants(mean, dev)) / channel_constants(std, dev)
    return (np.asarray(image, np.float32) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


def _pad_hw(image, ph: int, pw: int, value: float):
    """Pad H and W (the last two axes of a 2-D array, else the two before
    the channels) at the bottom and right."""
    channels = image.ndim != 2
    if torch.is_tensor(image):
        pad = (0, 0, 0, pw, 0, ph) if channels else (0, pw, 0, ph)
        return F.pad(image, pad, value=value)
    widths = [(0, 0)] * (image.ndim - 3) + [(0, ph), (0, pw), (0, 0)] if channels \
        else [(0, ph), (0, pw)]
    return np.pad(image, widths, constant_values=value)


def _hw(image) -> Tuple[int, int]:
    return tuple(image.shape) if image.ndim == 2 else tuple(image.shape[-3:-1])


def divisible_pad(image, size_divisor: int, value: float = 0.0):
    """Pad H and W at the bottom and right to multiples of
    ``size_divisor``; ``[..., H, W, C]`` or a bare ``[H, W]`` mask."""
    h, w = _hw(image)
    nh = math.ceil(h / size_divisor) * size_divisor
    nw = math.ceil(w / size_divisor) * size_divisor
    return _pad_hw(image, nh - h, nw - w, value)


def pad_to_size(image, size: Tuple[int, int], value: float = 0.0):
    """Pad H and W at the bottom and right to at least ``size``;
    ``[..., H, W, C]`` or a bare ``[H, W]`` mask."""
    h, w = _hw(image)
    return _pad_hw(image, max(size[0] - h, 0), max(size[1] - w, 0), value)


# the reference's th_ spellings
th_mean_std_normalize = mean_std_normalize
th_divisible_pad = divisible_pad
th_pad_to_size = pad_to_size
