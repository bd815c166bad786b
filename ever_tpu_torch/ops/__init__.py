"""The hand-written Hopper kernels and their plain versions, as
``torch.library`` ops in the ``ever_tpu_torch`` namespace, and the int8
post-training quantization that serves on K7.

Importing it registers every op (``torch.export.load`` of an exported
program needs them).  ``ops.attention`` stays the kernels' module here
(``chip_smoke.py`` and the tests reach its wrappers through it); the
function the JAX package re-exports under that name is ``attention_fn``.
"""

from ever_tpu_torch.ops import attention, norm, pool, ptq, quant  # noqa: F401
from ever_tpu_torch.ops.attention import attention as attention_fn  # noqa: F401
from ever_tpu_torch.ops.ptq import (  # noqa: F401
    calibrate_int8,
    make_ptq_predict_fn,
    ptq_apply,
    ptq_quantize,
    quantize_convs,
)
from ever_tpu_torch.ops.quant import QuantDense, int8_matmul, quantize_int8  # noqa: F401
