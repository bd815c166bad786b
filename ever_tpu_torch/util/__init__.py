from ever_tpu_torch.util import lr_search, param_util, seedlib, weight_io  # noqa: F401
from ever_tpu_torch.util.seedlib import seed_everything, seed_torch, worker_init_fn  # noqa: F401
