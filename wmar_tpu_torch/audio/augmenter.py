"""The train-time audio augmenter of the Mimi RCC finetune (PyTorch).

Port of ``wmar_tpu.audio.augmenter``: a weighted bank of augmentations,
each configured by ``{min_*, max_*}`` ranges (defaults in :data:`_DEFAULTS`)
and expanded into ``n_levels`` branches at linearly spaced parameters;
each call draws one branch ``num_augs`` times from the categorical
distribution over :attr:`Augmenter.log_probs` and applies them in turn.
Branch labels and log-probabilities are JAX's.

The draws come from a ``torch.Generator`` (the pick on its device, then
the branch's noise), or are fed: ``picks`` (one branch index per
application) and ``noise`` (one draw per application: the Gaussian noise,
the pink noise's white noise, the crop's start), so tests can hand in
JAX's. MP3 runs on the host with a straight-through gradient, and
configuring it where ``libmp3lame`` does not load raises. With a trainer's
``mesh``, each dp rank draws the noise branches' noise at the global
batch's shape and keeps its rows, so the picks that follow on the same
generator are the one process's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wmar_tpu_torch.audio import augmentations as A

_DEFAULTS: Dict[str, Dict[str, float]] = {
    "identity": {},
    "speed": {"min_speed": 0.5, "max_speed": 1.5},
    "time_stretch": {"min_rate": 0.5, "max_rate": 1.5},
    "echo": {"min_volume": 0.1, "max_volume": 0.5, "min_duration": 0.1, "max_duration": 0.5},
    "noise_injection": {"min_noise_std": 0.0005, "max_noise_std": 0.0015},
    "pink_noise": {"min_noise_std": 0.005, "max_noise_std": 0.015},
    "lowpass_filter": {"min_cutoff_freq": 2500.0, "max_cutoff_freq": 7500.0},
    "highpass_filter": {"min_cutoff_freq": 250.0, "max_cutoff_freq": 750.0},
    "bandpass_filter": {"min_cutoff_low": 150.0, "max_cutoff_low": 450.0,
                        "min_cutoff_high": 4000.0, "max_cutoff_high": 10000.0},
    "smooth": {"min_window_frac": 0.001, "max_window_frac": 0.01},
    "boost_audio": {"min_amount": 10.0, "max_amount": 30.0},
    "duck_audio": {"min_amount": 10.0, "max_amount": 30.0},
    "up_down_resample": {"intermediate_freq": 32000.0},
    "mp3_compression": {"min_bitrate": 64.0, "max_bitrate": 320.0},
    "time_shift": {"min_shift_ms": 50.0, "max_shift_ms": 200.0},
    "temporal_crop": {"min_crop_ratio": 0.5, "max_crop_ratio": 0.9},
}


def _levels(lo: float, hi: float, n: int) -> np.ndarray:
    if n == 1 or lo == hi:
        return np.asarray([(lo + hi) / 2.0])
    return np.linspace(lo, hi, n)


@dataclasses.dataclass(frozen=True)
class AugBranch:
    """One branch: ``fn(x, generator, noise)``, ``noise`` the fed draw or None."""

    name: str
    label: str
    fn: Callable[..., torch.Tensor]


def _expand(name: str, p: Dict[str, float], sr: int, n: int, mesh=None) -> List[AugBranch]:
    """One configured augmentation -> its branches, one a parameter level."""
    if name == "identity":
        return [AugBranch(name, "identity", lambda x, g, z: x)]
    if name in ("speed", "time_stretch"):
        # time_stretch is resampled like speed, as in JAX (the reference leaves it out of its own grid)
        lo, hi = p.get("min_speed", p.get("min_rate")), p.get("max_speed", p.get("max_rate"))
        return [AugBranch(name, f"{name}_{v:.2f}", lambda x, g, z, v=float(v): A.speed(x, v))
                for v in _levels(lo, hi, n)]
    if name == "echo":
        vols = _levels(p["min_volume"], p["max_volume"], n)
        durs = _levels(p["min_duration"], p["max_duration"], n)
        return [AugBranch(name, f"echo_{d:.2f}s_{v:.2f}",
                          lambda x, g, z, d=float(d), v=float(v): A.echo(x, d * sr / x.shape[1], v))
                for d, v in zip(durs, vols)]
    if name == "noise_injection":
        return [AugBranch(name, f"noise_{v:.4f}",
                          lambda x, g, z, v=float(v): A.gaussian_noise(x, v, g, noise=z, mesh=mesh))
                for v in _levels(p["min_noise_std"], p["max_noise_std"], n)]
    if name == "pink_noise":
        return [AugBranch(name, f"pink_{v:.4f}", lambda x, g, z, v=float(v): A.pink_noise(x, v, g, white=z, mesh=mesh))
                for v in _levels(p["min_noise_std"], p["max_noise_std"], n)]
    if name == "lowpass_filter":
        return [AugBranch(name, f"lowpass_{v:.0f}", lambda x, g, z, v=float(v): A.lowpass(x, v / (sr / 2)))
                for v in _levels(p["min_cutoff_freq"], p["max_cutoff_freq"], n)]
    if name == "highpass_filter":
        return [AugBranch(name, f"highpass_{v:.0f}", lambda x, g, z, v=float(v): A.highpass(x, v / (sr / 2)))
                for v in _levels(p["min_cutoff_freq"], p["max_cutoff_freq"], n)]
    if name == "bandpass_filter":
        los = _levels(p["min_cutoff_low"], p["max_cutoff_low"], n)
        his = _levels(p["min_cutoff_high"], p["max_cutoff_high"], n)
        return [AugBranch(name, f"bandpass_{lo:.0f}_{hi:.0f}",
                          lambda x, g, z, lo=float(lo), hi=float(hi): A.bandpass(x, lo / (sr / 2), hi / (sr / 2)))
                for lo, hi in zip(los, his)]
    if name == "smooth":
        return [AugBranch(name, f"smooth_{v:.4f}", lambda x, g, z, w=max(3, int(float(v) * sr)) | 1: A.smooth(x, w))
                for v in _levels(p["min_window_frac"], p["max_window_frac"], n)]
    if name == "boost_audio":
        return [AugBranch(name, f"boost_{v:.0f}", lambda x, g, z, v=float(v): A.boost_audio(x, v))
                for v in _levels(p["min_amount"], p["max_amount"], n)]
    if name == "duck_audio":
        return [AugBranch(name, f"duck_{v:.0f}", lambda x, g, z, v=float(v): A.duck_audio(x, v))
                for v in _levels(p["min_amount"], p["max_amount"], n)]
    if name == "up_down_resample":
        f = int(p["intermediate_freq"])
        return [AugBranch(name, f"updown_{f}", lambda x, g, z: A.updown_resample(x, f, sr))]
    if name == "mp3_compression":
        if not A.mp3_available():
            raise RuntimeError("mp3_compression configured but libmp3lame is unavailable on this host")
        return [AugBranch(name, f"mp3_{int(v)}", lambda x, g, z, v=int(v): A.mp3_compression_st(x, v, sr))
                for v in _levels(p["min_bitrate"], p["max_bitrate"], n)]
    if name == "time_shift":
        return [AugBranch(name, f"shift_{v:.0f}ms",
                          lambda x, g, z, v=float(v): A.time_shift(x, (v / 1000.0 * sr) / x.shape[1]))
                for v in _levels(p["min_shift_ms"], p["max_shift_ms"], n)]
    if name == "temporal_crop":
        return [AugBranch(name, f"crop_{v:.2f}",
                          lambda x, g, z, v=float(v): A.temporal_crop(x, v, g, start=None if z is None else int(z)))
                for v in _levels(p["min_crop_ratio"], p["max_crop_ratio"], n)]
    raise ValueError(f"Augmentation {name} not found. Available: {sorted(_DEFAULTS)}")


class Augmenter:
    """Weighted random augmentation bank.

    Args:
        augs: relative weights, e.g. ``{"identity": 1, "noise_injection": 1}``.
        augs_params: per-aug overrides of the ``min_*`` / ``max_*`` defaults.
        num_augs: augmentations applied one after the other per call.
        sample_rate: the audio's sample rate.
        n_levels: parameter levels per configured augmentation.
        mesh: the trainer's rank grid (None: one process).
    """

    def __init__(self, augs: Dict[str, float], augs_params: Optional[Dict[str, Dict[str, float]]] = None,
                 num_augs: int = 1, sample_rate: int = 24000, n_levels: int = 4, mesh=None):
        augs_params = augs_params or {}
        self.sample_rate = sample_rate
        self.num_augs = num_augs
        branches: List[AugBranch] = []
        probs: List[float] = []
        for name, weight in augs.items():
            if weight <= 0:
                continue
            if name not in _DEFAULTS:
                raise ValueError(f"Augmentation {name} not found. Available: {sorted(_DEFAULTS)}")
            params = dict(_DEFAULTS[name])
            params.update(augs_params.get(name, {}))
            expanded = _expand(name, params, sample_rate, n_levels, mesh)
            branches += expanded
            probs += [float(weight) / len(expanded)] * len(expanded)
        if not branches:  # identity alone, like the reference
            branches, probs = [AugBranch("identity", "identity", lambda x, g, z: x)], [1.0]
        self.branches = branches
        self.log_probs = torch.from_numpy(np.log(np.asarray(probs) / np.sum(probs)).astype(np.float32))
        self.labels = [b.label for b in branches]

    def draw(self, generator: torch.Generator) -> int:
        """One categorical draw of a branch index, on the generator's device."""
        probs = torch.exp(self.log_probs).to(generator.device)
        return int(torch.multinomial(probs, 1, generator=generator).item())

    def __call__(self, audio: torch.Tensor, generator: Optional[torch.Generator] = None,
                 picks: Optional[Sequence[int]] = None, noise: Optional[Sequence] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, T, C]`` -> (augmented audio, the picked branch indices
        ``[num_augs]``). ``picks`` / ``noise`` feed the draws."""
        picked = []
        for i in range(self.num_augs):
            idx = int(picks[i]) if picks is not None else self.draw(generator)
            audio = self.branches[idx].fn(audio, generator, None if noise is None else noise[i])
            picked.append(idx)
        return audio, torch.tensor(picked, dtype=torch.int32)
