"""The segmentation transforms (``ever_tpu/magic/transform/segm.py``'s path)."""

from ever_tpu_torch.magic._transform_impl import (  # noqa: F401
    HorizontalFlip,
    Identity,
    Rotate90k,
    Scale,
    Transpose,
    VerticalFlip,
)

__all__ = ['Identity', 'Rotate90k', 'HorizontalFlip', 'VerticalFlip',
           'Transpose', 'Scale']
