"""Builds the hand-written CUDA kernels at first use and loads them.

Every ``*.cu`` file under ``wmar_tpu_torch/csrc/`` is compiled by its own
``nvcc`` for ``sm_90a`` (all started together), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``. The library goes to ``build/wmar_tpu_torch/<hash>/`` at
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
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in _sources():
        obj = lib.with_name(f".{src.stem}.{os.getpid()}.o")
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    output = ""
    failed = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        output += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        output += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout + proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    log.write_text(output)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, output


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.wmar_packed_decode_attention
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    fn = lib.wmar_packed_chunked_attention
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    fn = lib.wmar_w4_matmul
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.wmar_flash_decode_attention
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    fn = lib.wmar_dma_probe
    fn.argtypes = [p, p, p, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.wmar_row_mean_probe
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = i
    return lib
