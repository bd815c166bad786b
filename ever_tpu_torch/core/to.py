"""Host↔device transfer of nested batches (counterpart of
``ever_tpu/core/to.py``): tensors out of numpy arrays, and tensors onto a
device, recursing over dicts, lists and tuples."""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ever_tpu_torch.core.device import auto_device, cpu_device, get_device, gpu_device  # noqa: F401

__all__ = ['to_tensor', 'to_device', 'auto_device', 'cpu_device', 'gpu_device']


def to_tensor(data: Any) -> Any:
    """Every numpy array, numpy scalar or tensor of ``data`` as a tensor on
    the host; other leaves unchanged."""
    def convert(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.as_tensor(x)
        return x
    return tree_map(convert, data)


def to_device(data: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Every tensor (or numpy array) of ``data`` on ``device`` (the GPU
    unless ``device='cpu'``); a tensor already there is not copied.  Host
    memory is pinned first, so that the copy does not wait for the work the
    card has queued."""
    dev = get_device(device)

    def move(x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = torch.as_tensor(x)
        if not isinstance(x, torch.Tensor) or x.device == dev:
            return x
        if dev.type == 'cuda' and x.device.type == 'cpu' and not x.is_pinned():
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)
    return tree_map(move, data)
