"""``ever.module.dinov3.utils.dtype`` in the port: a dtype from its name."""

import torch

_NAMES = {
    'float32': torch.float32, 'fp32': torch.float32,
    'float16': torch.float16, 'fp16': torch.float16,
    'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
    'float64': torch.float64, 'int8': torch.int8, 'int32': torch.int32,
    'float8_e4m3fn': torch.float8_e4m3fn, 'float8_e5m2': torch.float8_e5m2,
}


def as_torch_dtype(name):
    """The torch dtype a name (``'bf16'``, ``'torch.float32'``, ...) or a
    dtype stands for."""
    if isinstance(name, torch.dtype):
        return name
    if not isinstance(name, str):
        name = str(name)
    key = name.replace('torch.', '')
    if key in _NAMES:
        return _NAMES[key]
    dtype = getattr(torch, key, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f'not a dtype name: {name!r}')
    return dtype


# the JAX package's name for the same function
as_jax_dtype = as_torch_dtype

__all__ = ['as_torch_dtype', 'as_jax_dtype']
