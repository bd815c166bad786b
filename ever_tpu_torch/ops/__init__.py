"""The hand-written Hopper kernels and their plain versions.

``ops.attention`` stays the kernels' module here (``chip_smoke.py`` and
the tests reach its wrappers through it); the function the JAX package
re-exports under that name is ``attention_fn``.
"""

from ever_tpu_torch.ops import attention, quant  # noqa: F401
from ever_tpu_torch.ops.attention import attention as attention_fn  # noqa: F401
from ever_tpu_torch.ops.quant import QuantDense, int8_matmul, quantize_int8  # noqa: F401
