"""Invertible batch transforms, the contract of test-time augmentation
(counterpart of ``ever_tpu/interface/transform_base.py``).

Transforms act on NHWC batches ``[batch, height, width, channel]``: the
spatial axes are 1 and 2, as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ['Transform', 'MultiTransform']


class Transform:
    """Invertible transform over NHWC batches."""

    def transform(self, inputs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inv_transform(self, transformed_inputs: torch.Tensor) -> torch.Tensor:
        """Inverse transformation back to the original frame."""
        raise NotImplementedError

    @staticmethod
    def unit_test(transform: 'Transform') -> None:
        """Assert ``inv_transform(transform(x)) == x`` on a 2×128×128×32
        ramp."""
        inputs = torch.arange(128 * 128, dtype=torch.float32).reshape(
            1, 128, 128, 1).expand(2, 128, 128, 32).clone()
        out = transform.inv_transform(transform.transform(inputs))
        torch.testing.assert_close(out, inputs)


class MultiTransform(list):
    """A list of transforms applied to one input; ``inv_transform`` inverts
    each output with its own transform."""

    def __init__(self, *transforms):
        super().__init__()
        if not all(isinstance(t, Transform) for t in transforms):
            raise TypeError('MultiTransform accepts Transform instances only')
        self.extend(transforms)

    def transform(self, inputs):
        return [t.transform(inputs) for t in self]

    def inv_transform(self, transformed_inputs):
        return [t.inv_transform(ti) for ti, t in zip(transformed_inputs, self)]
