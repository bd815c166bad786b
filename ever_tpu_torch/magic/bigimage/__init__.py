"""The path ``magic.bigimage`` (counterpart of ``ever_tpu/magic/bigimage/``,
the reference's ``ever/magic/bigimage/``): ``sliding_window``."""

from ever_tpu_torch.magic.sliding_window import sliding_window

__all__ = ['sliding_window']
