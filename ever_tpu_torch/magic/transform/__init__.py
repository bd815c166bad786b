"""Invertible batch transforms and test-time augmentation.

Implementation: :mod:`ever_tpu_torch.magic._transform_impl`; the ``segm``
and ``tta`` submodules keep the JAX package's file layout.
"""

from ever_tpu_torch.magic._transform_impl import *  # noqa: F401,F403
from ever_tpu_torch.magic._transform_impl import __all__  # noqa: F401
