"""Optimizers and LR schedules (registered in ``OPT`` and ``LR``)."""

from ever_tpu_torch.opt import learning_rate, optimizer  # noqa: F401
