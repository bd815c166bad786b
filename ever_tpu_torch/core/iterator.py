"""Epoch-agnostic endless iterator over a DataLoader (counterpart of
``ever_tpu/core/iterator.py``).

``next(forward_times)`` returns a list of batches (one per microbatch),
restarting the loader when an epoch ends, fires the callbacks due at each
new epoch, tells the dataset its epoch, and reseeds the sampler with the
step (``set_seed_for_dist_sampler``).  The loader's iterator is made at the
first draw, so an epoch's order is the one its sampler gives when the
epoch's first batch is drawn, with the step the launcher set just before.

A resumed run (``set_start_step``) sees the batches an unbroken run would
have: its first draw is placed in the epoch that run would be in, with the
sampler seeded as it was when that epoch began, after the batches of that
epoch already drawn.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.dist import is_main_process, synchronize
from ever_tpu_torch.core.prefetch import prefetch_to_device
from ever_tpu_torch.interface.callback import Callback

__all__ = ['get_iterator', 'Iterator', 'PrefetchedIterator', 'run_callbacks',
           'ITERATOR_TYPE']


def run_callbacks(callbacks, current_epoch: int, is_master: bool) -> None:
    """Fire the callbacks due at ``current_epoch``."""
    if callbacks is None:
        return
    for f in callbacks:
        if not isinstance(f, Callback):
            raise TypeError('callbacks must be ever_tpu_torch Callback objects')
        if f.interval <= 0:
            # <= 0: never on an epoch boundary (before/after_train still apply)
            continue
        if (current_epoch - 1) % f.interval != 0 or current_epoch == 1:
            continue
        if not f.only_master or is_master:
            f.func()
        synchronize()


class Iterator:
    def __init__(self, data_loader):
        self._data_loader = data_loader
        self._iterator = None
        self._step = 0
        self._start_step = 0
        self._seed: Optional[int] = None
        self._look_up = {}
        self._ds_epoch = None

    def epoch(self, forward_times: int) -> int:
        # counts from the resumed step, so callbacks fire on the epochs an
        # unbroken run's would
        return (forward_times * (self._start_step + self._step)
                // max(len(self._data_loader), 1) + 1)

    def _get_one(self):
        if self._iterator is None:
            self.reset()
        try:
            return next(self._iterator)
        except StopIteration:
            self.reset()
            return next(self._iterator)

    def _resume(self, forward_times: int) -> None:
        drawn = self._start_step * forward_times
        skip = drawn % max(len(self._data_loader), 1)
        if not skip:
            return
        if self._seed is not None:
            self._reseed((drawn - skip) // forward_times)
        self.reset()
        for _ in range(skip):
            next(self._iterator)
        if self._seed is not None:
            self._reseed(self._seed)

    def next(self, forward_times: int = 1, call_backs=None,
             is_master: Optional[bool] = None) -> List:
        if is_master is None:
            is_master = is_main_process()
        self._step += 1
        # the dataset's epoch is that of the batch about to be drawn, set
        # before a resume makes the loader's iterator: its worker processes
        # take the dataset as it is when they start
        ds = getattr(self._data_loader, 'dataset', None)
        if hasattr(ds, 'set_epoch'):
            ds_ep = ((self._start_step + self._step - 1) * forward_times
                     ) // max(len(self._data_loader), 1)
            if ds_ep != self._ds_epoch:
                ds.set_epoch(ds_ep)
                self._ds_epoch = ds_ep
        if self._step == 1 and self._start_step > 0:
            self._resume(forward_times)
        ep = self.epoch(forward_times)
        if ep not in self._look_up:
            # a resumed run's first epoch is marked, not fired: saving or
            # evaluating at once would repeat what it resumed from
            if self._step > 1 or self._start_step == 0:
                run_callbacks(call_backs, ep, is_master)
            self._look_up[ep] = True
        return [self._get_one() for _ in range(forward_times)]

    def reset(self) -> None:
        self._iterator = iter(self._data_loader)

    def set_start_step(self, global_step: int) -> None:
        """The global step this run resumes from (0 for a fresh run)."""
        self._start_step = int(global_step)

    def _reseed(self, seed: int) -> None:
        sampler = getattr(self._data_loader, 'sampler', None)
        if sampler is None:
            warnings.warn('data_loader has no sampler; no shuffle reseeding.')
        elif hasattr(sampler, 'set_step'):
            sampler.set_step(seed)
        elif hasattr(sampler, 'set_epoch'):
            sampler.set_epoch(seed)

    def set_seed_for_dist_sampler(self, seed: int) -> None:
        """Reseed the sampler with the current step (its ``set_step``, else
        its ``set_epoch``)."""
        self._seed = int(seed)
        self._reseed(self._seed)


class PrefetchedIterator(Iterator):
    """An :class:`Iterator` whose batches are on ``device`` already, copied
    one batch ahead of the loop by :func:`~ever_tpu_torch.core.prefetch.
    prefetch_to_device` (``iterator_type='prefetched'``).  The loader's
    iterator is made when the normal one's would be, so the batches, and
    their order, are the normal iterator's."""

    def __init__(self, data_loader, prefetch_size: int = 2, device=None):
        super().__init__(data_loader)
        self._prefetch_size = prefetch_size
        self._device = get_device(device)

    def reset(self) -> None:
        self._iterator = prefetch_to_device(iter(self._data_loader),
                                            size=self._prefetch_size, device=self._device)


ITERATOR_TYPE = dict(normal=Iterator, prefetched=PrefetchedIterator)


def get_iterator(type_name: str):
    if type_name in ITERATOR_TYPE:
        return ITERATOR_TYPE[type_name]
    raise KeyError(f'{type_name} is not supported.')
