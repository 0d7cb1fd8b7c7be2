"""Temporal synchronisation of audio: a watermark gated by a square wave (PyTorch).

Port of ``wmar_tpu.audio.sync``, the counterpart of the reference's
``wmar_audio/watermark/sync.py``: a per-sample watermark (AudioSeal,
:mod:`wmar_tpu_torch.audio.audioseal`) is gated by a square-wave mask of
period ``2 * frames_per_period * frame_size`` samples. Its detector's
presence signal then has that period and phase, so a speed change and a
shift can be read from it (:meth:`SyncPattern.get_speedup_and_shift`) and
undone by resampling (:meth:`SyncPattern.invert`).

Embedding and detection run on the model's device; the period search is
numpy and scipy on the host, as in JAX (~165 ``scipy.signal.correlate``
calls of a downsampled signal a row).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wmar_tpu_torch.audio.augmentations import resize_linear_time


def square_template(n_samples: int, period: int, shift: int = 0) -> np.ndarray:
    t = np.arange(n_samples)
    return (((t - shift) % period) < (period // 2)).astype(np.float64)


def cross_correlation_search(signal: np.ndarray, t_min: int, t_max: int, step: int):
    """A coarse period search in ``step``s, a fine one around the best, and
    the phase from the correlation's argmax: (period, shift, correlation)."""
    from scipy.signal import correlate

    n = len(signal)

    def peak(period):
        c = correlate(signal, square_template(n, period), mode="full")
        return np.max(np.abs(c)), c

    best_period, best_corr = None, -np.inf
    for period in range(int(t_min), int(t_max) + 1, step):
        p, _ = peak(period)
        if p > best_corr:
            best_corr, best_period = p, period
    fine_best, corr = -np.inf, None
    for period in range(max(int(t_min), best_period - step), min(int(t_max), best_period + step) + 1):
        p, c = peak(period)
        if p > fine_best:
            fine_best, best_period, corr = p, period, c
    best_shift = int(np.argmax(corr)) - (n - 1)
    return int(best_period), best_shift, corr


class SyncPattern:
    """``wm_model`` provides ``get_watermark(audio [B, T, 1]) -> delta`` and
    ``detect(audio) -> presence [B, T]`` (AudioSeal's interface)."""

    def __init__(self, wm_model, frames_per_period: int = 3, frame_size: int = 1920, sample_rate: int = 24000):
        self.wm = wm_model
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.samples_per_period = frame_size * frames_per_period

    def mask(self, n_samples: int, device=None) -> torch.Tensor:
        """The float32 gate ``[n_samples]``: 1 on the first half of each period."""
        return torch.from_numpy(square_template(n_samples, 2 * self.samples_per_period)).to(device, torch.float32)

    def get_sync_wm(self, audio: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        """``audio + alpha * delta * mask``."""
        delta = self.wm.get_watermark(audio)
        m = self.mask(audio.shape[1], audio.device)[None, :, None]
        return audio + alpha * delta * m

    def detect_signal(self, audio: torch.Tensor) -> np.ndarray:
        """The presence signal ``[B, T]`` on the host."""
        return self.wm.detect(audio).float().cpu().numpy()

    def get_speedup_and_shift(self, detection_signal: np.ndarray, downsample_factor: int = 8,
                              step: int = 10) -> Tuple[float, int]:
        ds = np.interp(np.arange(0, len(detection_signal), downsample_factor), np.arange(len(detection_signal)),
                       detection_signal)
        t_min = 0.5 * self.samples_per_period * 2 / downsample_factor
        t_max = 1.5 * self.samples_per_period * 2 / downsample_factor
        est_t, est_shift, _ = cross_correlation_search(ds, t_min, t_max, step)
        speedup = self.samples_per_period * 2 / (est_t * downsample_factor)
        shift = int(est_shift * speedup * downsample_factor) % self.frame_size
        return speedup, shift

    def invert(self, audio: torch.Tensor, speedup: float, shift: int) -> torch.Tensor:
        """Resample by ``1 / speedup`` (``jax.image.resize``'s linear weights,
        antialiased when the clip shrinks) and drop the first ``shift`` samples."""
        new_t = int(round(audio.shape[1] / speedup))
        return resize_linear_time(audio, new_t, antialias=speedup > 1)[:, shift:, :]
