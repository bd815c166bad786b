"""Train and eval steps (``spmd``), the data mesh and its placements
(``mesh``), ZeRO-1/3 (``zero``) and abstract and sharded train states
(``sharded``); tensor parallel, the pipeline, expert parallel, the spatial
layouts and the 2-D and hybrid meshes are not ported yet (``ROADMAP.md``
A.9.2, A.9.3)."""

from ever_tpu_torch.parallel import mesh, sharded, spmd, zero  # noqa: F401
from ever_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    host_to_global,
    make_mesh,
    replicated,
)
from ever_tpu_torch.parallel.sharded import (  # noqa: F401
    abstract_train_state,
    create_train_state_sharded,
    sharded_state_shardings,
)
from ever_tpu_torch.parallel.spmd import (  # noqa: F401
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)
from ever_tpu_torch.parallel.zero import zero_init, zero_shardings  # noqa: F401
