from ever_tpu_torch.magic.sliding_window import sliding_window  # noqa: F401
from ever_tpu_torch.magic.tiled import tiled_inference  # noqa: F401
