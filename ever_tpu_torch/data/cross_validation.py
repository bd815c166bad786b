"""Deterministic k-fold cross-validation sampler pairs (counterpart of
``ever_tpu/data/cross_validation.py``, with the same index splits)."""

from __future__ import annotations

import math
from functools import reduce

import numpy as np

from ever_tpu_torch.data.distributed import (
    DistributedNonOverlapSubsetSeqSampler,
    StepDistributedRandomSubsetSampler,
    SubsetRandomSampler,
    SubsetSampler,
)

__all__ = ['CrossValSamplerGenerator', 'make_CVSamplers']


class CrossValSamplerGenerator:
    """k-fold index split into (train, val) sampler pairs::

        CV = CrossValSamplerGenerator(dataset, distributed=True, seed=2333)
        train_sampler, val_sampler = CV.k_fold(5)[0]
    """

    def __init__(self, dataset, distributed: bool = True, seed: int = 2333):
        self.num_samples = len(dataset)
        self.seed = seed
        self.distributed = distributed

    def k_fold(self, k: int = 5):
        rng = np.random.default_rng(self.seed)
        indices = rng.permutation(self.num_samples).tolist()
        total_size = int(math.ceil(len(indices) / k) * k)
        offset = k - (total_size - self.num_samples)
        indices += indices[offset:offset + total_size - len(indices)]
        if len(indices) != total_size:
            raise ValueError(f'cannot pad {self.num_samples} samples to {k} folds')

        folds = [indices[i:total_size:k] for i in range(k)]
        pairs = []
        for i in range(k):
            rest = folds.copy()
            val_indices = rest.pop(i)
            train_indices = reduce(lambda a, b: a + b, rest)
            if self.distributed:
                pairs.append((StepDistributedRandomSubsetSampler(train_indices),
                              DistributedNonOverlapSubsetSeqSampler(val_indices)))
            else:
                pairs.append((SubsetRandomSampler(train_indices), SubsetSampler(val_indices)))
        return pairs


def make_CVSamplers(dataset, i: int = 0, k: int = 5, distributed: bool = True,
                    seed: int = 2333):
    return CrossValSamplerGenerator(dataset, distributed, seed).k_fold(k)[i]
