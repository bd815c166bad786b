from ever_tpu_torch.magic import transform  # noqa: F401
from ever_tpu_torch.magic.sliding_window import sliding_window  # noqa: F401
from ever_tpu_torch.magic import bigimage  # noqa: F401
from ever_tpu_torch.magic.tiled import pad_crop_apply, tiled_inference  # noqa: F401
from ever_tpu_torch.magic.transform import (  # noqa: F401
    HorizontalFlip,
    Identity,
    Rotate90k,
    Scale,
    TestTimeAugmentation,
    Transpose,
    VerticalFlip,
    d4_tta,
    tta,
)
