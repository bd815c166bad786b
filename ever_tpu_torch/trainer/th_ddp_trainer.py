"""Path-parity shim: ``ever.trainer.th_ddp_trainer`` (counterpart of
``ever_tpu/trainer/th_ddp_trainer.py``).  ``THDDPTrainer`` is the
data-parallel :class:`~ever_tpu_torch.trainer.trainer.SPMDTrainer`;
``THDDPGANTrainer`` and ``GANLauncher`` carry the two-optimizer GAN path
(``trainer/gan.py``)."""

from ever_tpu_torch.trainer import THDDPGANTrainer, THDDPTrainer
from ever_tpu_torch.trainer.gan import GANLauncher

__all__ = ['THDDPTrainer', 'THDDPGANTrainer', 'GANLauncher']
