"""Process helpers (counterpart of ``ever_tpu/core/dist.py``).

Read from ``torch.distributed`` when a process group is initialised, and
otherwise the run is rank 0 of 1.  The port drives one card per process, so
the global device count is the world size.  Several processes (DDP) are the
parallel slice (``ROADMAP.md`` A.9); nothing here starts a process group.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch.distributed as tdist

__all__ = ['get_world_size', 'get_rank', 'get_global_device_count',
           'is_main_process', 'main_process_only', 'synchronize',
           'all_gather_host']


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_world_size() -> int:
    """Number of processes (1 when no process group is initialised)."""
    return tdist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    """This process's rank (0 when no process group is initialised)."""
    return tdist.get_rank() if _initialized() else 0


def get_global_device_count() -> int:
    """Cards in the run: one per process."""
    return get_world_size()


def is_main_process() -> bool:
    return get_rank() == 0


def main_process_only(fn: Callable) -> Callable:
    """Decorator: run ``fn`` on rank 0 only; other ranks get None."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


def synchronize() -> None:
    """Barrier across processes (a no-op in one process)."""
    if get_world_size() > 1:
        tdist.barrier()


def all_gather_host(value) -> list:
    """Every process's ``value`` (any picklable host object), in rank
    order, on every process."""
    if get_world_size() == 1:
        return [value]
    out = [None] * get_world_size()
    tdist.all_gather_object(out, value)
    return out
