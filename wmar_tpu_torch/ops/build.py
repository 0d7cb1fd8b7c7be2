"""Builds the hand-written CUDA kernels at first use and loads them.

Every ``*.cu`` file under ``wmar_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ``ctypes``. The library goes to ``build/wmar_tpu_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, so a fresh
checkout builds everything on its first call and an edited source never
loads a stale library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "wmar_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libwmar_tpu_torch_kernels.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns ``(library path, seconds spent compiling, nvcc's output)``.
    """
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, output


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.wmar_packed4_decode_attention
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return lib
