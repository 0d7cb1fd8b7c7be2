"""Audio-file dataset of the Mimi RCC finetune (the port's own copy of
``wmar_tpu.audio.dataloader``, numpy only).

Recursive discovery of ``.wav`` and ``.npy`` files with a JSON path cache,
spectral resampling to the target rate, mono summing, cropping or zero
padding to a fixed duration, and a seeded train / valid split. ``.wav`` is
read with the stdlib (PCM16 / 24 / 32); ``.npy`` holds float arrays ``[T]``
or ``[C, T]`` at ``--target_sr`` or the rate of a sidecar
``<name>.sr.txt``. Clips come out as ``[T, 1]`` float32.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import wave
from typing import List, Optional, Sequence, Tuple

import numpy as np

CACHE_DIR = ".cache/datafiles"


def get_cached_audio_files(audio_dir: str,
                           extensions: Sequence[str] = ("wav", "npy"),
                           cache_dir: Optional[str] = CACHE_DIR) -> List[str]:
    """Sorted recursive discovery, cached as JSON under ``cache_dir`` (None: no cache)."""
    cache_file = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha1(os.path.abspath(audio_dir).encode()).hexdigest()[:16]
        cache_file = os.path.join(
            cache_dir, f"{os.path.basename(audio_dir.rstrip('/'))}_{key}.json")
        if os.path.exists(cache_file):
            with open(cache_file) as f:
                return json.load(f)
    files: List[str] = []
    for ext in extensions:
        files.extend(glob.glob(os.path.join(audio_dir, f"**/*.{ext}"),
                               recursive=True))
    files = sorted(files)
    if cache_file:
        with open(cache_file, "w") as f:
            json.dump(files, f)
    return files


def _read_wav_any(path: str) -> Tuple[np.ndarray, int]:
    """[C, T] float32 + sample rate from PCM16/24/32 wav."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x - ((x >> 23) & 1) * (1 << 24)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported wav sample width {width} in {path}")
    return x.reshape(-1, nch).T, sr


def _read_npy(path: str, default_sr: int) -> Tuple[np.ndarray, int]:
    x = np.load(path).astype(np.float32)
    if x.ndim == 1:
        x = x[None]
    sr_path = path[: -len(".npy")] + ".sr.txt"
    sr = int(open(sr_path).read().strip()) if os.path.exists(sr_path) else default_sr
    return x, sr


def _fft_resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Spectral resampling along the last axis (host side, numpy)."""
    if sr_in == sr_out:
        return x
    n_in = x.shape[-1]
    n_out = int(round(n_in * sr_out / sr_in))
    spec = np.fft.rfft(x, axis=-1)
    n_bins = n_out // 2 + 1
    out_spec = np.zeros(x.shape[:-1] + (n_bins,), dtype=spec.dtype)
    keep = min(spec.shape[-1], n_bins)
    out_spec[..., :keep] = spec[..., :keep]
    return np.fft.irfft(out_spec, n=n_out, axis=-1).astype(np.float32) * (n_out / n_in)


class AudioDataset:
    """Fixed-duration mono clips from a directory."""

    def __init__(self, audio_dir: str, target_sr: int = 24000,
                 target_duration: float = 5.0,
                 extensions: Sequence[str] = ("wav", "npy"),
                 cache_dir: Optional[str] = CACHE_DIR):
        self.audio_dir = audio_dir
        self.target_sr = target_sr
        self.target_length = int(target_sr * target_duration)
        self.audio_files = get_cached_audio_files(audio_dir, extensions, cache_dir)
        if not self.audio_files:
            raise FileNotFoundError(
                f"no audio files ({'/'.join(extensions)}) under {audio_dir}")

    def __len__(self) -> int:
        return len(self.audio_files)

    def __getitem__(self, idx: int) -> np.ndarray:
        """[T, 1] float32 at target_sr, cropped/zero-padded to target_length."""
        path = self.audio_files[idx]
        if path.endswith(".npy"):
            x, sr = _read_npy(path, self.target_sr)
        else:
            x, sr = _read_wav_any(path)
        if sr != self.target_sr:
            x = _fft_resample(x, sr, self.target_sr)
        if x.shape[0] > 1:  # stereo -> sum
            x = x.sum(axis=0, keepdims=True)
        x = x[0]
        if x.shape[0] >= self.target_length:
            x = x[: self.target_length]
        else:
            x = np.pad(x, (0, self.target_length - x.shape[0]))
        return x[:, None].astype(np.float32)

    def batches(self, indices: Sequence[int], batch_size: int,
                drop_last: bool = False):
        """Yield [B, T, 1] batches over the given index order."""
        for s in range(0, len(indices), batch_size):
            chunk = list(indices[s : s + batch_size])
            if not chunk or (drop_last and len(chunk) < batch_size):
                return
            yield np.stack([self[i] for i in chunk])


def train_valid_split(n: int, num_valid: int, seed: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random split: ``(train indices, valid indices)``."""
    if num_valid >= n:
        raise ValueError(f"num_valid ({num_valid}) must be < dataset size ({n})")
    perm = np.random.default_rng(seed).permutation(n)
    return perm[num_valid:], perm[:num_valid]
