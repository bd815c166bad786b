"""Process helpers (counterpart of ``ever_tpu/core/dist.py``).

Read from ``torch.distributed`` when a process group is initialised, and
otherwise the run is rank 0 of 1.  The port drives one card per process, so
the global device count is the world size.  :func:`init_dist_env` starts
the group from ``torchrun``'s environment (or from explicit arguments).

Collectives on device tensors are ``all_reduce`` and ``broadcast`` only:
gloo supports no other on CUDA tensors, and the same code runs under NCCL
and gloo.  Host objects (confusion matrices, loss dicts) travel through the
``*_object`` collectives, pickled.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch
import torch.distributed as tdist

__all__ = ['get_world_size', 'get_rank', 'get_local_device_count',
           'get_global_device_count', 'is_main_process', 'main_process_only',
           'init_dist_env', 'synchronize', 'broadcast_one_to_all',
           'all_gather_host', 'all_gather', 'gather', 'reduce_loss_dict']


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_world_size() -> int:
    """Number of processes (1 when no process group is initialised)."""
    return tdist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    """This process's rank (0 when no process group is initialised)."""
    return tdist.get_rank() if _initialized() else 0


def get_local_device_count() -> int:
    """Cards this process drives: one."""
    return 1


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


def init_dist_env(coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  backend: Optional[str] = None,
                  device=None) -> None:
    """Start the process group (``ever_tpu/core/dist.py`` ``init_dist_env``).

    Under ``torchrun`` the rank, world size and rendezvous come from its
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); ``coordinator_address`` (an init method such as
    ``tcp://localhost:29500`` or ``file:///path``), ``num_processes`` and
    ``process_id`` name them explicitly.  A no-op in a plain single process
    and when a group exists already.  The backend is ``nccl`` for a CUDA
    device and ``gloo`` for the CPU, ``device`` being the one the caller
    will train on (``core.device.get_device``'s default: the card), unless
    ``backend`` names one.  A failed init raises: there is no fallback to
    another backend or to the CPU.
    """
    if _initialized():
        return
    if coordinator_address is None and num_processes is None \
            and 'WORLD_SIZE' not in os.environ:
        return
    if backend is None:
        from ever_tpu_torch.core.device import get_device
        backend = 'gloo' if get_device(device).type == 'cpu' else 'nccl'
    world = int(num_processes if num_processes is not None else os.environ['WORLD_SIZE'])
    rank = int(process_id if process_id is not None else os.environ['RANK'])
    tdist.init_process_group(backend=backend, init_method=coordinator_address or 'env://',
                             world_size=world, rank=rank)


def synchronize() -> None:
    """Barrier across processes (a no-op in one process)."""
    if get_world_size() > 1:
        tdist.barrier()


def broadcast_one_to_all(value):
    """Rank 0's ``value`` on every rank: a tensor through ``broadcast`` (in
    place, on its device), anything else pickled."""
    if get_world_size() == 1:
        return value
    if torch.is_tensor(value):
        tdist.broadcast(value, src=0)
        return value
    box = [value]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_host(value) -> list:
    """Every process's ``value`` (any picklable host object), in rank
    order, on every process."""
    if get_world_size() == 1:
        return [value]
    out = [None] * get_world_size()
    tdist.all_gather_object(out, value)
    return out


all_gather = all_gather_host


def gather(value, dst: int = 0) -> list:
    """Every process's ``value`` in rank order on rank ``dst``; the other
    ranks get ``[]``.  Every rank pays the all-gather's traffic, as in the
    JAX package."""
    if get_world_size() == 1:
        return [value]
    gathered = all_gather_host(value)
    return gathered if get_rank() == dst else []


def reduce_loss_dict(loss_dict: dict) -> dict:
    """The mean over processes of a dict of host (or 0-d tensor) losses,
    on rank 0; the other ranks get their own dict back."""
    if get_world_size() < 2:
        return loss_dict
    keys = sorted(loss_dict)
    gathered = all_gather_host([float(loss_dict[k]) for k in keys])
    if get_rank() != 0:
        return loss_dict
    return {k: sum(g[i] for g in gathered) / len(gathered) for i, k in enumerate(keys)}
