"""Train and eval steps (``spmd``) and the data mesh (``mesh``); the other
parallel layouts are not ported yet (``ROADMAP.md`` A.9)."""

from ever_tpu_torch.parallel import mesh, spmd  # noqa: F401
from ever_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from ever_tpu_torch.parallel.spmd import (  # noqa: F401
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)
