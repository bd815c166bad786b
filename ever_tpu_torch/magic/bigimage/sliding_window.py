"""The path ``magic.bigimage.sliding_window`` (counterpart of
``ever_tpu/magic/bigimage/sliding_window.py``)."""

from ever_tpu_torch.magic.sliding_window import sliding_window

__all__ = ['sliding_window']
