"""Seeding (counterpart of ``ever_tpu/util/seedlib.py``): Python's, numpy's
and torch's generators, with the per-rank offset of ``device_specific``."""

from __future__ import annotations

import random

import numpy as np
import torch

from ever_tpu_torch.core.dist import get_rank

__all__ = ['seed_everything', 'seed_torch', 'worker_init_fn']


def seed_everything(seed: int = 2333, deterministic: bool = False,
                    device_specific: bool = False) -> int:
    """Seed ``random``, numpy and torch (every CUDA device too); returns the
    seed used (``seed + rank`` when ``device_specific``).  ``deterministic``
    also selects deterministic cuDNN kernels, as the reference does."""
    if device_specific:
        seed = seed + get_rank()
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return seed


seed_torch = seed_everything


def worker_init_fn(worker_id: int, num_workers: int, rank: int,
                   seed: int = 2333) -> None:
    """A loader worker's seed: ``num_workers * rank + worker_id + seed``."""
    worker_seed = num_workers * rank + worker_id + seed
    np.random.seed(worker_seed)
    random.seed(worker_seed)
