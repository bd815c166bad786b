"""The one place the port's entry points pick their device."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ['get_device']


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return ``cuda`` unless the caller asks for another device.

    The port runs on the GPU: with no CUDA device and no explicit
    ``device='cpu'`` this raises instead of quietly running on the CPU.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run on the CPU')
    return dev
