"""Vectorized integer hashing for greenlist membership (PyTorch).

Same murmur3-style mixer as ``wmar_tpu.core.hashing``: token ``t`` is green
for context key ``k`` iff ``hash(k, t) < threshold(t)``, evaluated for the
whole vocab at once.

torch's ``uint32`` has no ``>>`` on the CPU, so every value here is an int64
holding a uint32, masked with ``& 0xFFFFFFFF`` after every multiply and
shift. Multiplies are split into 16-bit halves so no int64 product ever
overflows. The same code runs on CUDA.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for ``a`` in [0, 2^32) without int64 overflow."""
    lo = a * (c & 0xFFFF)  # < 2^48
    hi = ((a * (c >> 16)) & 0xFFFF) << 16  # < 2^32
    return (lo + hi) & _MASK


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h.to(torch.int64) & _MASK
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    h = h ^ (h >> 16)
    return h


def hash_key_token(keys: torch.Tensor, tokens: torch.Tensor, salt: int) -> torch.Tensor:
    """Hash (context-key, token) pairs to uniform uint32 bits (as int64).

    ``keys`` and ``tokens`` broadcast against each other, as in
    ``wmar_tpu.core.hashing.hash_key_token``.
    """
    k = (_mul32(keys.to(torch.int64) & _MASK, _GOLDEN) + (salt & _MASK)) & _MASK
    k = fmix32(k)
    t = _mul32(tokens.to(torch.int64) & _MASK, _C1)
    return fmix32(k ^ t ^ (t >> 15))


def uniform_from_hash(bits: torch.Tensor) -> torch.Tensor:
    """uint32 hash bits (held in int64) -> float32 uniforms in [0, 1], as
    ``wmar_tpu.core.hashing.uniform_from_hash``: the bits rounded to float32
    (so the largest round to 1.0) times ``2^-32``."""
    return (bits & _MASK).to(torch.float32) * (2.0**-32)
