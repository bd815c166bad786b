"""Module wrappers (counterpart of ``ever_tpu/module/misc.py``)."""

from __future__ import annotations

import torch.nn as nn

__all__ = ['PadCropWrapper']


class PadCropWrapper(nn.Module):
    """Pad NHWC input to a ``size_divisor`` multiple, run the inner model,
    crop back (functional form: :func:`~ever_tpu_torch.magic.tiled.
    pad_crop_apply`).

    Its ``state_dict`` is the inner model's, with no prefix (flax's
    ``share_scope`` in the JAX package), so a trained model's weights load
    into the wrapped one unchanged.
    """

    def __init__(self, inner: nn.Module, size_divisor: int = 32):
        super().__init__()
        self.inner = inner
        self.size_divisor = size_divisor
        self._register_state_dict_hook(_drop_prefix)
        self._register_load_state_dict_pre_hook(_add_prefix)

    def forward(self, x, *args, **kwargs):
        # imported here: the magic package imports the model zoo's ops
        from ever_tpu_torch.magic.tiled import pad_crop_apply
        return pad_crop_apply(lambda t: self.inner(t, *args, **kwargs), x,
                              self.size_divisor)


def _drop_prefix(module, state_dict, prefix, local_metadata):
    inner = prefix + 'inner.'
    for key in [k for k in state_dict if k.startswith(inner)]:
        state_dict[prefix + key[len(inner):]] = state_dict.pop(key)


def _add_prefix(state_dict, prefix, local_metadata, strict, missing_keys,
                unexpected_keys, error_msgs):
    for key in [k for k in state_dict if k.startswith(prefix)
                and not k.startswith(prefix + 'inner.')]:
        state_dict[prefix + 'inner.' + key[len(prefix):]] = state_dict.pop(key)
