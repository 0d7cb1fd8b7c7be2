"""Watermark detection: re-tokenized codes -> p-value (PyTorch).

Port of ``wmar_tpu.core.detect``. The ngram dedup and greenlist counts run
on the codes' device, batched over rows. The binomial tail p-value runs on
the host with ``scipy.special.betainc``, because torch has no betainc.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import betainc

from wmar_tpu_torch.core.ngrams import extract_ngrams, first_occurrence_mask
from wmar_tpu_torch.core.spec import WatermarkSpec


def score_codes(spec: WatermarkSpec, greenlist, codes: torch.Tensor):
    """``codes [..., T]`` -> ``(n_green, n_scored)`` int64 ``[...]`` over the
    unique ngrams of each row."""
    rows, keys, targets = extract_ngrams(spec, codes)
    unique = first_occurrence_mask(rows)
    green = greenlist.green_lookup(keys, targets)
    return (green & unique).sum(dim=-1), unique.sum(dim=-1)


def pvalue_from_counts(n_green, n_scored, gamma: float) -> np.ndarray:
    """Binomial tail p-value ``P[Binom(n_scored, gamma) >= n_green]`` as
    ``betainc(k, n - k + 1, gamma)`` in float64 on the host;
    ``n_green == 0`` maps to p = 1."""
    k = np.asarray(torch.as_tensor(n_green).cpu(), np.float64)
    n = np.asarray(torch.as_tensor(n_scored).cpu(), np.float64)
    p = betainc(np.maximum(k, 1.0), 1.0 + n - k, gamma)
    return np.where(k <= 0, 1.0, p)


def detect(spec: WatermarkSpec, greenlist, codes: torch.Tensor) -> np.ndarray:
    """Batched detection: ``codes [B, T] -> p-values [B]`` (float64 numpy)."""
    n_green, n_scored = score_codes(spec, greenlist, codes)
    return pvalue_from_counts(n_green, n_scored, spec.gamma)


def green_fraction(spec: WatermarkSpec, greenlist, codes: torch.Tensor) -> torch.Tensor:
    """Fraction of unique ngrams that are green, per row (diagnostic)."""
    n_green, n_scored = score_codes(spec, greenlist, codes)
    return n_green.to(torch.float32) / n_scored.clamp_min(1)
