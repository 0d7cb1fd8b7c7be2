"""Host-side C++ ngram scorer, bound with ctypes (PyTorch port of
``wmar_tpu.native``).

``ngram_scorer.cpp`` is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/wmar_tpu_torch/native/<hash>/`` at the repository
root, keyed by a hash of the source and flags, as ``ops/build.py`` builds
the CUDA kernels. Without a compiler :func:`available` is false and the
callers take their numpy (or device) branch, which gives the same counts.

``calls`` counts the scoring calls that went through the library, so a run
can tell that the native path was taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "ngram_scorer.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "wmar_tpu_torch" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

calls = 0
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "_ngram_scorer.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if _build_failed:
        return None
    lib = library_path()
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        for cxx in ("g++", "c++", "clang++"):
            try:
                subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True)
                break
            except (OSError, subprocess.CalledProcessError):
                continue
        else:
            _build_failed = True
            return None
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(lib))


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        _lib = _build()
        if _lib is not None:
            i64, i32, u32 = ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
            p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
            p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C")
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
            _lib.score_codes_table.argtypes = [p_i32, i64, i64, i32, i32, i32, p_u32, i64, i64, i32, p_i64]
            _lib.score_codes_hash.argtypes = [p_i32, i64, i64, i32, i32, i32, p_u32, u32, i32, p_i64]
            _lib.score_codes_keymap.argtypes = [p_i32, i64, i64, i32, i32, i32, p_i64, i64, p_u32, i64, p_i64]
    return _lib


def available() -> bool:
    return get_lib() is not None


def context_keys_np(spec, codes: np.ndarray) -> np.ndarray:
    """All greenlist context keys in ``codes [B, T]`` (sums of the context
    windows, the rules of ``core/ngrams.py``), to build the rows of a lazy
    greenlist for exactly the keys of a batch."""
    from wmar_tpu_torch.core.spec import SeedStrategy

    codes = np.asarray(codes, dtype=np.int64)
    if codes.ndim == 1:
        codes = codes[None]
    h = spec.context_size
    if spec.seed_strategy == SeedStrategy.FIXED:
        return np.zeros((1,), np.int64)
    if spec.seed_strategy == SeedStrategy.SPATIAL:
        d = spec.spatial_dim
        grid = codes.reshape(codes.shape[0], d, d)
        if h == 1:
            above = np.roll(grid, 1, axis=1)
            left = np.roll(grid, 1, axis=2)
            ctx = np.where((np.arange(d) == 0)[None, None, :], above, left)
            return ctx.reshape(codes.shape[0], -1)[:, 1:].reshape(-1)
        if h == 3:
            return (grid[:, :-1, :-1] + grid[:, :-1, 1:] + grid[:, 1:, :-1]).reshape(-1)
        raise ValueError("spatial keys support h in {1, 3}")
    t = codes.shape[1]
    csum = np.concatenate([np.zeros((codes.shape[0], 1), np.int64), np.cumsum(codes, axis=1)], axis=1)
    return (csum[:, h:t] - csum[:, 0:t - h]).reshape(-1)


def _u32(x) -> np.ndarray:
    """A tensor or array of uint32 values (held as int32 or int64) as a
    contiguous uint32 array."""
    a = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return np.ascontiguousarray((a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32))


def score_codes_native(spec, greenlist, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batched ``(n_green, n_scored)`` on the host through the C++ scorer,
    the counts of ``core.detect.score_codes`` for every greenlist source.
    Raises ``RuntimeError`` without a compiler."""
    global calls
    from wmar_tpu_torch.core.greenlist import HashGreenlist, LazyTorchCompatGreenlist, TableGreenlist, pack_bool_rows
    from wmar_tpu_torch.core.spec import SeedStrategy

    lib = get_lib()
    if lib is None:
        raise RuntimeError("no C++ compiler available for the native scorer")
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    batch, t = codes.shape
    spatial = 1 if spec.seed_strategy == SeedStrategy.SPATIAL else 0
    fixed = 1 if spec.seed_strategy == SeedStrategy.FIXED else 0
    h, dim = spec.context_size, spec.spatial_dim
    out = np.zeros((batch, 2), dtype=np.int64)

    if isinstance(greenlist, LazyTorchCompatGreenlist):
        # rows for exactly the context keys of this batch (the torch-compat
        # randperm, cached in the greenlist's LRU), binary-searched by key;
        # FIXED seeding has one row for every key: the table kernel
        uniq = np.unique(context_keys_np(spec, codes))
        table = np.ascontiguousarray(pack_bool_rows(np.stack([greenlist._row(int(k)) for k in uniq])), np.uint32)
        if fixed:
            lib.score_codes_table(codes, batch, t, h, spatial, dim, table, 1, table.shape[1], 1, out)
        else:
            lib.score_codes_keymap(codes, batch, t, h, spatial, dim, np.ascontiguousarray(uniq, np.int64),
                                   len(uniq), table, table.shape[1], out)
    elif isinstance(greenlist, TableGreenlist):
        table = _u32(greenlist._table)
        lib.score_codes_table(codes, batch, t, h, spatial, dim, table, table.shape[0], table.shape[1], fixed, out)
    elif isinstance(greenlist, HashGreenlist):
        if greenlist._fixed_mask is not None:
            table = np.ascontiguousarray(pack_bool_rows(greenlist._fixed_mask.cpu().numpy()[None, :]), np.uint32)
            lib.score_codes_table(codes, batch, t, h, spatial, dim, table, 1, table.shape[1], 1, out)
        else:
            lib.score_codes_hash(codes, batch, t, h, spatial, dim, _u32(greenlist._thresholds),
                                 np.uint32(spec.salt_key & 0xFFFFFFFF), fixed, out)
    else:
        raise TypeError(type(greenlist))
    calls += 1
    return out[:, 0], out[:, 1]


def detect_native(spec, greenlist, codes: np.ndarray) -> np.ndarray:
    """Host detection: codes ``[B, T]`` -> p-values ``[B]`` (scipy's
    float64 ``betainc``)."""
    from scipy import special

    n_green, n_scored = score_codes_native(spec, greenlist, codes)
    pvals = np.ones(len(n_green))
    pos = n_green > 0
    pvals[pos] = special.betainc(n_green[pos], 1 + n_scored[pos] - n_green[pos], spec.gamma)
    return pvals
