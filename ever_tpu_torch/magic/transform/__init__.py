"""Invertible batch transforms and test-time augmentation.

Implementation: :mod:`ever_tpu_torch.magic._transform_impl`; the ``segm``
and ``tta`` submodules keep the JAX package's file layout.

The ``tta`` submodule is imported here, before the function of that name is
bound: importing a submodule sets its name on the package, so a first
``import ever_tpu_torch.magic.transform.tta`` made later would turn
``transform.tta`` from the function into the module (the JAX package has
that trap; ``ROADMAP.md`` §C).
"""

from ever_tpu_torch.magic.transform import tta as _tta_module  # noqa: F401
from ever_tpu_torch.magic._transform_impl import *  # noqa: F401,F403,E402
from ever_tpu_torch.magic._transform_impl import __all__  # noqa: F401,E402
