"""The one place the port's entry points pick their device, and the
reference's device helpers (``auto_device``, ``cpu_device``,
``gpu_device``; ``ever_tpu/core/device.py``)."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ['get_device', 'auto_device', 'cpu_device', 'gpu_device']


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return ``cuda`` unless the caller asks for another device.

    The port runs on the GPU: with no CUDA device and no explicit
    ``device='cpu'`` this raises instead of quietly running on the CPU.
    Under ``torchrun`` (``LOCAL_RANK`` set) a card without an index is the
    process's own, ``cuda:{LOCAL_RANK}``, made the current device; a
    ``LOCAL_RANK`` past the device count raises unless the caller names a
    card (``cuda:0``), as processes sharing one card do.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run on the CPU')
    if dev.type == 'cuda' and 'LOCAL_RANK' in os.environ:
        if dev.index is None:
            local = int(os.environ['LOCAL_RANK'])
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f'LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA '
                    'device(s): one process drives one card; name a device '
                    '(e.g. cuda:0) to share one')
            dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
    return dev


def auto_device() -> torch.device:
    """The port's default device: the GPU (raises without one)."""
    return get_device()


def cpu_device() -> torch.device:
    return torch.device('cpu')


def gpu_device(id: Optional[int] = None) -> torch.device:
    """GPU ``id`` (0 by default); raises without a CUDA device."""
    return get_device(torch.device('cuda', id or 0))
