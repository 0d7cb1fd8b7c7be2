"""Audio token watermarking: Maryland greenlist and Gumbel (Aaronson)
sampling (PyTorch).

Port of ``wmar_tpu.audio.wm``. Both samplers are stateless hashes of a
window hash and the vocabulary, so they run on the logits' device inside
the frame loop; the hashes are the port's ``core.hashing`` (uint32 values
held in int64), bit for bit the JAX package's.

A window hash is ``fmix32(seed) XOR tok_1 ... XOR tok_n``, returned as an
int32 as in JAX; ``n = 0`` is the seed itself (the fixed hash of the audio
streams). Maryland's and plain sampling draw ``argmax(log p + g)`` with
Gumbel noise ``g`` (what ``jax.random.categorical`` computes), which the
caller passes in or which comes from a ``torch.Generator``.

Scoring: greenlist hits with first-occurrence (token, hash) dedup give a
binomial tail p-value (Maryland); summed ``-log(1 - u)`` a Gamma(n, 1) tail
(Gumbel). Both p-values are computed in float64 on the host with scipy, as
the port's ``core.detect`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.special import gammaincc

from wmar_tpu_torch.core.hashing import fmix32, hash_key_token, uniform_from_hash
from wmar_tpu_torch.core.sampling import gumbel_noise

_MASK = 0xFFFFFFFF


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def window_hash(ngrams: torch.Tensor, seed: int) -> torch.Tensor:
    """``[B, n]`` context tokens -> ``[B]`` int32 window hashes; ``n = 0``
    returns the seed itself."""
    b, n = ngrams.shape
    if n == 0:
        return torch.full((b,), seed, dtype=torch.int32, device=ngrams.device)
    acc = fmix32(torch.full((b,), seed & _MASK, dtype=torch.int64, device=ngrams.device))
    for i in range(n):
        acc = acc ^ (ngrams[:, i].to(torch.int64) & _MASK)
    return _as_int32(acc)


def _warp_probs(logits: torch.Tensor, temp: float, top_k: int, top_p: float) -> torch.Tensor:
    probs = torch.softmax(logits.to(torch.float32) / float(temp), dim=-1)
    v = probs.shape[-1]
    if top_p and top_p > 0.0:
        sort_idx = torch.argsort(-probs, dim=-1, stable=True)
        sorted_p = torch.gather(probs, -1, sort_idx)
        cum = torch.cumsum(sorted_p, dim=-1)
        keep_sorted = (cum - sorted_p) <= top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
        probs = torch.where(keep, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True)
    elif top_k and top_k > 0:
        k = min(top_k, v)
        thresh = torch.topk(probs, k, dim=-1).values[:, -1:]
        probs = torch.where(probs >= thresh, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True)
    return probs


def _categorical(probs: torch.Tensor, noise: Optional[torch.Tensor], generator) -> torch.Tensor:
    """``jax.random.categorical`` over ``log(max(probs, 1e-12))``: the argmax
    of the log-probabilities plus Gumbel noise ``[B, V]``."""
    if noise is None:
        noise = gumbel_noise(probs.shape, generator, probs.device)
    return torch.argmax(torch.log(torch.clamp_min(probs, 1e-12)) + noise.to(torch.float32), dim=-1)


def gumbel_sample(logits: torch.Tensor, window_hashes: torch.Tensor, use_sampling: bool = True,
                  temp: float = 1.0, top_k: int = 0, top_p: float = 0.0, salt: int = 0) -> torch.Tensor:
    """Aaronson sampling: ``argmax_t u(hash, t)^(1/p_t)``, distortion-free
    given the hash. ``logits [B, V]`` -> tokens ``[B]``."""
    if not use_sampling or temp <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = _warp_probs(logits, temp, top_k, top_p)
    v = probs.shape[-1]
    u = uniform_from_hash(hash_key_token(window_hashes[:, None], torch.arange(v, device=logits.device), salt))
    # argmax u^(1/p) == argmax log(u)/p; p == 0 -> -inf (never selected)
    score = torch.where(probs > 0, torch.log(torch.clamp_min(u, 1e-12)) / torch.clamp_min(probs, 1e-12),
                        -torch.inf)
    return torch.argmax(score, dim=-1)


def gumbel_score(tokens: torch.Tensor, window_hashes: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Per-token score ``-log(1 - u(hash, token))``, float32."""
    u = uniform_from_hash(hash_key_token(window_hashes, tokens, salt))
    return -torch.log1p(-torch.clamp_max(u, 1.0 - 1e-7))


def _green_threshold(gamma: float) -> int:
    return int(min(gamma * 2.0**32, 2.0**32 - 1))


def maryland_green(tokens: torch.Tensor, window_hashes: torch.Tensor, gamma: float, salt: int = 0) -> torch.Tensor:
    """Greenlist membership of individual tokens (bool, broadcast shape)."""
    return hash_key_token(window_hashes, tokens, salt) < _green_threshold(gamma)


def maryland_sample(logits: torch.Tensor, window_hashes: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    use_sampling: bool = True, temp: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                    gamma: float = 0.5, delta: float = 1.0, salt: int = 0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greenlist-biased sampling: ``delta`` added to the green logits, then
    temperature, top-k / top-p and a categorical draw with ``noise [B, V]``
    (Gumbel; drawn from ``generator`` when None)."""
    v = logits.shape[-1]
    green = maryland_green(window_hashes[:, None], torch.arange(v, device=logits.device), gamma, salt)
    logits = logits + delta * green.to(logits.dtype)
    if not use_sampling or temp <= 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(_warp_probs(logits, temp, top_k, top_p), noise, generator)


def wm_sample_token(logits: torch.Tensor, method: str, window_hashes: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None, use_sampling: bool = True, temp: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0, gamma: float = 0.5, delta: float = 1.0, salt: int = 0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dispatch on ``method``: ``gumbel``, ``maryland`` or plain sampling."""
    if method == "gumbel":
        return gumbel_sample(logits, window_hashes, use_sampling, temp, top_k, top_p, salt)
    if method == "maryland":
        return maryland_sample(logits, window_hashes, noise, use_sampling, temp, top_k, top_p, gamma, delta, salt,
                               generator)
    if not use_sampling or temp <= 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(_warp_probs(logits, temp, top_k, top_p), noise, generator)


# ---------------------------------------------------------------------------
# Stream scoring / detection
# ---------------------------------------------------------------------------


def score_stream_maryland(tokens: torch.Tensor, hashes: torch.Tensor, gamma: float, salt: int = 0):
    """Greenlist scoring of one stream ``tokens, hashes: [T]`` with
    first-occurrence (token, hash) dedup. Returns ``(n_green, n_scored)``
    as 0-d int64 tensors."""
    # the argument order of JAX's call (and of the sampler's): the token is the hash key, the window hash the token
    green = maryland_green(hashes, tokens, gamma, salt)
    pair = torch.stack([tokens.to(torch.int64), hashes.to(torch.int64)], dim=1)
    eq = (pair[:, None, :] == pair[None, :, :]).all(-1)
    t = tokens.shape[0]
    earlier = torch.ones((t, t), dtype=torch.bool, device=tokens.device).tril(-1)
    first = ~(eq & earlier).any(dim=1)
    return (green & first).sum(), first.sum()


def pvalue_maryland(n_green, n_scored, gamma: float) -> np.ndarray:
    """``P[Binom(n_scored, gamma) >= n_green]``: the port's
    ``core.detect.pvalue_from_counts`` (float64)."""
    from wmar_tpu_torch.core.detect import pvalue_from_counts

    return pvalue_from_counts(n_green, n_scored, gamma)


def pvalue_gumbel(score_sum, n) -> np.ndarray:
    """H0: the sum of ``-log(1 - u)`` over ``n`` tokens is Gamma(n, 1);
    ``p = P[Gamma(n, 1) >= s] = gammaincc(n, s)``, in float64 of the float32
    sum."""
    s = np.asarray(torch.as_tensor(score_sum).cpu(), np.float64)
    k = np.asarray(torch.as_tensor(n).cpu(), np.float64)
    return gammaincc(k, s)
