"""Train and eval steps (``spmd``), meshes of named axes and their
placements (``mesh``), ZeRO-1/3 (``zero``), abstract and sharded train
states (``sharded``), tensor parallel (``tp``), the GPipe pipeline
(``pp``), expert parallel (``ep``) and one tile split along its rows
with halo exchange (``spatial``)."""

from ever_tpu_torch.parallel import ep, mesh, pp, sharded, spatial, spmd, tp, zero  # noqa: F401
from ever_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    host_to_global,
    make_hybrid_mesh,
    make_mesh,
    replicated,
)
from ever_tpu_torch.parallel.sharded import (  # noqa: F401
    abstract_train_state,
    create_train_state_sharded,
    sharded_state_shardings,
)
from ever_tpu_torch.parallel.spatial import (  # noqa: F401
    build_halo_train_step,
    build_spatial_train_step,
    halo_exchange,
    spatial_partition_apply,
)
from ever_tpu_torch.parallel.spmd import (  # noqa: F401
    TrainState,
    build_eval_step,
    build_train_step,
    create_train_state,
)
from ever_tpu_torch.parallel.tp import apply_tp, vit_tp_shardings  # noqa: F401
from ever_tpu_torch.parallel.zero import zero_init, zero_shardings  # noqa: F401
