"""Per-process samplers (counterpart of ``ever_tpu/data/distributed.py``).

The same numpy code as the JAX package, so that for the same seed, step and
epoch every sampler yields the same index order there and here.  "rank" and
"world" come from ``core/dist.py`` (rank 0 of 1 without a process group).

- :class:`StepDistributedSampler` reshuffles with a ``seed + step``
  generator, pads to a divisible size and takes ``rank::world``; the
  iterator reseeds it each step (``Iterator.set_seed_for_dist_sampler``), and
  the order of an epoch is the one drawn when the epoch's first batch is.
- :class:`DistributedNonOverlapSeqSampler`: sequential, non-overlapping,
  unpadded partitions for exact distributed evaluation.
- :class:`DistributedInfiniteSampler`: an infinite stream with a windowed
  shuffle.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch.utils.data

from ever_tpu_torch.core import dist

__all__ = [
    'Sampler',
    'StepDistributedSampler',
    'StepDistributedRandomSubsetSampler',
    'DistributedNonOverlapSeqSampler',
    'DistributedNonOverlapSubsetSeqSampler',
    'DistributedInfiniteSampler',
    'RandomSampler',
    'SequentialSampler',
    'SubsetSampler',
    'SubsetRandomSampler',
    'as_ddp_inference_loader',
    'with_sampler',
]


def _resolve(num_replicas: Optional[int], rank: Optional[int]):
    if num_replicas is None:
        num_replicas = dist.get_world_size()
    if rank is None:
        rank = dist.get_rank()
    if not 0 <= rank < num_replicas:
        raise ValueError(f'invalid rank {rank} for world size {num_replicas}')
    return num_replicas, rank


class Sampler:
    """Iterable of dataset indices; ``len`` is the per-process epoch length."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    # step/epoch hooks duck-typed by the Iterator
    def set_step(self, step: int) -> None:
        pass

    def set_epoch(self, epoch: int) -> None:
        pass


class StepDistributedSampler(Sampler):
    def __init__(self, dataset, *, num_replicas=None, rank=None, seed: int = 0,
                 shuffle: bool = True):
        self.dataset = dataset
        self.num_replicas, self.rank = _resolve(num_replicas, rank)
        self.seed = seed
        self.shuffle = shuffle
        self.step = 0
        self.num_samples = int(math.ceil(len(dataset) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_step(self, step: int) -> None:
        self.step = step

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.step)
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self):
        indices = self._order()
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        assert len(indices) == self.total_size
        yield from indices[self.rank:self.total_size:self.num_replicas].tolist()

    def __len__(self):
        return self.num_samples


class StepDistributedRandomSubsetSampler(StepDistributedSampler):
    """Step-seeded shuffle over an explicit index subset (CV folds)."""

    def __init__(self, indices: Sequence[int], *, num_replicas=None, rank=None, seed: int = 0):
        self.indices = np.asarray(indices)
        super().__init__(self.indices, num_replicas=num_replicas, rank=rank,
                         seed=seed, shuffle=True)

    def _order(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.step)
        return self.indices[rng.permutation(len(self.indices))]


class DistributedNonOverlapSeqSampler(Sampler):
    def __init__(self, dataset, num_replicas=None, rank=None):
        self.dataset = dataset
        self.num_replicas, self.rank = _resolve(num_replicas, rank)
        n = len(dataset)
        counts = [n // self.num_replicas] * self.num_replicas
        for i in range(n % self.num_replicas):
            counts[i] += 1
        self.num_samples = counts
        self.total_size = n
        assert sum(counts) == n

    def __iter__(self):
        start = sum(self.num_samples[:self.rank])
        end = sum(self.num_samples[:self.rank + 1])
        yield from range(start, end)

    def __len__(self):
        return self.num_samples[self.rank]


class DistributedNonOverlapSubsetSeqSampler(Sampler):
    def __init__(self, indices: Sequence[int], num_replicas=None, rank=None):
        self.indices = list(indices)
        self.num_replicas, self.rank = _resolve(num_replicas, rank)
        n = len(self.indices)
        counts = [n // self.num_replicas] * self.num_replicas
        for i in range(n % self.num_replicas):
            counts[i] += 1
        self.num_samples = counts
        self.total_size = n

    def __iter__(self):
        start = sum(self.num_samples[:self.rank])
        end = sum(self.num_samples[:self.rank + 1])
        yield from self.indices[start:end]

    def __len__(self):
        return self.num_samples[self.rank]


class DistributedInfiniteSampler(Sampler):
    def __init__(self, dataset, num_replicas=None, rank=None, shuffle: bool = True,
                 seed: int = 0, window_size: float = 0.5):
        assert len(dataset) > 0
        assert 0 <= window_size <= 1
        self.dataset = dataset
        self.num_replicas, self.rank = _resolve(num_replicas, rank)
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size
        self.step = 0

    def set_step(self, step: int) -> None:
        self.step = step

    def __iter__(self):
        order = np.arange(len(self.dataset))
        rng = None
        window = 0
        if self.shuffle:
            rng = np.random.RandomState(self.seed)
            rng.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rng.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1

    def __len__(self):
        return math.ceil(len(self.dataset) / self.num_replicas)


class RandomSampler(Sampler):
    """Single-process random permutation per epoch."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        # each pass draws a fresh permutation; set_epoch overrides it
        self.epoch += 1
        yield from rng.permutation(len(self.dataset)).tolist()

    def __len__(self):
        return len(self.dataset)


class SequentialSampler(Sampler):
    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        yield from range(len(self.dataset))

    def __len__(self):
        return len(self.dataset)


class SubsetSampler(Sampler):
    def __init__(self, indices: Sequence[int]):
        self.indices = list(indices)

    def __iter__(self):
        yield from self.indices

    def __len__(self):
        return len(self.indices)


class SubsetRandomSampler(Sampler):
    def __init__(self, indices: Sequence[int], seed: int = 0):
        self.indices = np.asarray(indices)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1   # fresh permutation per pass (see RandomSampler)
        yield from self.indices[rng.permutation(len(self.indices))].tolist()

    def __len__(self):
        return len(self.indices)


def with_sampler(loader: torch.utils.data.DataLoader, sampler
                 ) -> torch.utils.data.DataLoader:
    """A loader like ``loader`` (dataset, batch size, workers, collate,
    drop_last) that draws its indices from ``sampler``."""
    return torch.utils.data.DataLoader(
        loader.dataset, batch_size=loader.batch_size, sampler=sampler,
        num_workers=loader.num_workers, collate_fn=loader.collate_fn,
        drop_last=loader.drop_last, pin_memory=loader.pin_memory)


def as_ddp_inference_loader(dataloader):
    """The loader rewrapped with a non-overlapping sequential sampler, for
    exact distributed evaluation."""
    sampler = dataloader.sampler
    if isinstance(sampler, (DistributedNonOverlapSeqSampler,
                            DistributedNonOverlapSubsetSeqSampler)):
        return dataloader
    if hasattr(sampler, 'indices'):
        new_sampler = DistributedNonOverlapSubsetSeqSampler(sampler.indices)
    else:
        new_sampler = DistributedNonOverlapSeqSampler(dataloader.dataset)
    return with_sampler(dataloader, new_sampler)
