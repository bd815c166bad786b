"""`ERDataLoader` / `ERDataset`: configurable data sources on
``torch.utils.data.DataLoader`` (counterpart of
``ever_tpu/interface/dataloader.py``).

Datasets return numpy (or tensor) samples, a tuple or a dict; the loader
batches them on the host with :func:`default_collate`, which stacks them
into tensors, and the launcher moves each batch to its device.  The JAX
package's own process-pool loader (``ever_tpu/data/loader.py``) has
PyTorch's ``DataLoader`` as its counterpart here.  ``total_batch_size`` is
the global batch, divided by the number of processes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.data

from ever_tpu_torch.core import dist
from ever_tpu_torch.core.config import AttrDict
from ever_tpu_torch.data.distributed import (
    DistributedInfiniteSampler,
    RandomSampler,
    SequentialSampler,
    StepDistributedSampler,
)
from ever_tpu_torch.interface.configurable import ConfigurableMixin

__all__ = ['ERDataLoader', 'ERDataset', 'default_collate']


def default_collate(items):
    """Stack a list of samples into a batch of tensors, recursing over dicts,
    tuples and lists (the JAX package's collate, with tensors for numpy)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate(list(group)) for group in zip(*items))
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if first is None:
        return None
    return torch.from_numpy(np.stack([np.asarray(it) for it in items]))


class ERDataLoader(torch.utils.data.DataLoader, ConfigurableMixin):
    """A DataLoader configured through its ``dataloader_params`` property:
    subclasses override :meth:`set_default_config` and
    :attr:`dataloader_params`."""

    def __init__(self, config=None):
        ConfigurableMixin.__init__(self, config)
        torch.utils.data.DataLoader.__init__(self, **self.dataloader_params)

    @property
    def dataloader_params(self) -> dict:
        return dict(dataset=[], sampler=None, batch_size=1, num_workers=0,
                    collate_fn=default_collate, drop_last=False)


class ERDataset(torch.utils.data.Dataset, ConfigurableMixin):
    """Configurable map-style dataset with ``to_dataloader()``.

    ``sampler_type`` names one of :attr:`SUPPORT_SAMPLERS`.  ``drop_last``
    None drops the ragged tail batch of the training samplers and keeps it
    for ``SequentialSampler`` (evaluation), as in the JAX package.
    """

    SUPPORT_SAMPLERS = {
        'StepDistributedSampler': StepDistributedSampler,
        'RandomSampler': RandomSampler,
        'SequentialSampler': SequentialSampler,
        'DistributedInfiniteSampler': DistributedInfiniteSampler,
    }

    def __init__(self, config=None):
        ConfigurableMixin.__init__(self, config)
        base = AttrDict(dict(
            total_batch_size=-1,
            batch_size=1,
            num_workers=0,
            prefetch_factor=2,
            persistent_workers=False,
            drop_last=None,
            sampler_type='StepDistributedSampler',
        ))
        base.update(self._config)
        self._config = base

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError

    def to_dataloader(self, batch_size=None, num_workers=None, prefetch_factor=None,
                      persistent_workers=None) -> torch.utils.data.DataLoader:
        sampler = self.SUPPORT_SAMPLERS[self.config.sampler_type](self)
        if self.config.total_batch_size > 0:
            world = dist.get_world_size()
            if self.config.total_batch_size % world != 0:
                raise ValueError(
                    f'total_batch_size ({self.config.total_batch_size}) must be '
                    f'divisible by the number of processes ({world})')
            self.config.batch_size = self.config.total_batch_size // world
        bs = batch_size or self.config.batch_size
        drop_last = self.config.drop_last
        if drop_last is None:
            drop_last = self.config.sampler_type in (
                'StepDistributedSampler', 'DistributedInfiniteSampler',
                'RandomSampler')
        if drop_last and len(sampler) < bs:
            raise ValueError(
                f'{len(sampler)} samples per process ({len(self)} total), fewer '
                f'than one batch ({bs}); every training batch would be '
                'dropped: lower batch_size or grow the dataset')
        workers = num_workers if num_workers is not None else self.config.num_workers
        extra = {}
        if workers > 0:
            extra = dict(prefetch_factor=prefetch_factor or self.config.prefetch_factor,
                         persistent_workers=(persistent_workers
                                             if persistent_workers is not None
                                             else self.config.persistent_workers))
        return torch.utils.data.DataLoader(
            self, batch_size=bs, sampler=sampler, num_workers=workers,
            collate_fn=default_collate, drop_last=drop_last, **extra)
