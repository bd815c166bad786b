"""Path-parity shim: ``ever.trainer.th_ddp_trainer`` (counterpart of
``ever_tpu/trainer/th_ddp_trainer.py``).  ``THDDPTrainer`` is the
data-parallel :class:`~ever_tpu_torch.trainer.trainer.SPMDTrainer`; the GAN
trainers wait for their slice (``ROADMAP.md`` A.7)."""

from ever_tpu_torch.trainer import THDDPTrainer

__all__ = ['THDDPTrainer']
