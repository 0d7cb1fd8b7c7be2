"""Evaluation metrics for images and codes (PyTorch port of
``wmar_tpu.utils.metrics``'s image metrics)."""

from __future__ import annotations

import numpy as np
import torch


def psnr(a, b, max_val: float = 255.0) -> float:
    """PSNR between two images of one shape, values scaled to ``max_val``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(max_val**2 / mse))


def psnr_pm1(a, b) -> float:
    """PSNR for images in [-1, 1] mapped to the 0-255 convention."""
    a8 = (np.asarray(a) / 2.0 + 0.5) * 255.0
    b8 = (np.asarray(b) / 2.0 + 0.5) * 255.0
    return psnr(a8, b8)


def l0_token_mismatch(codes, orig_codes) -> torch.Tensor:
    """Fraction of mismatched tokens per row: ``[B, T] -> [B]``."""
    codes = torch.as_tensor(codes)
    orig_codes = torch.as_tensor(orig_codes, device=codes.device)
    return (codes != orig_codes).to(torch.float32).mean(dim=-1)
