"""Robustness attack bank: geometric and valuemetric transforms (PyTorch)."""

from wmar_tpu_torch.augmentations.manager import AugmentationManager

__all__ = ["AugmentationManager"]
