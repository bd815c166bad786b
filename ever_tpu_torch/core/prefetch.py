"""Copy batches to the device one step ahead (counterpart of
``ever_tpu/core/prefetch.py``).

On the GPU each batch is pinned and copied on a side stream while the card
computes the steps queued before it.  The consumer's stream waits on the
copy's event before it uses the batch, and every tensor is recorded on that
stream (``record_stream``), so the caching allocator does not hand its
memory to another tensor while the consumer's kernels may still read it.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional, Union

import torch
from torch.utils._pytree import tree_leaves

from ever_tpu_torch.core.device import get_device
from ever_tpu_torch.core.to import to_device

__all__ = ['prefetch_to_device']


def prefetch_to_device(iterator: Iterator, size: int = 2,
                       device: Optional[Union[str, torch.device]] = None) -> Iterator:
    """Yield ``iterator``'s batches on ``device`` (the GPU unless
    ``device='cpu'``), ``size`` of them copied ahead."""
    dev = get_device(device)
    if size < 1:
        raise ValueError(f'prefetch size must be >= 1, got {size}')
    return _prefetch(iterator, size, dev)


def _prefetch(iterator, size, dev):
    stream = torch.cuda.Stream(dev) if dev.type == 'cuda' else None
    queue = deque()

    def enqueue():
        try:
            batch = next(iterator)
        except StopIteration:
            return False
        if stream is None:
            queue.append((to_device(batch, dev), None))
            return True
        with torch.cuda.stream(stream):
            moved = to_device(batch, dev)
            ready = torch.cuda.Event()
            ready.record(stream)
        queue.append((moved, ready))
        return True

    for _ in range(size):
        if not enqueue():
            break
    while queue:
        batch, ready = queue.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in tree_leaves(batch):
                if isinstance(t, torch.Tensor) and t.device.type == 'cuda':
                    t.record_stream(consumer)
        yield batch
        enqueue()
