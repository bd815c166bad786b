"""Test-time augmentation (``ever_tpu/magic/transform/tta.py``'s path)."""

from ever_tpu_torch.magic._transform_impl import TestTimeAugmentation, d4_tta, tta  # noqa: F401

__all__ = ['tta', 'TestTimeAugmentation', 'd4_tta']
