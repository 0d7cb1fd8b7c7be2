"""Audio attacks over ``[B, T, 1]`` waveforms: the audio eval grid (PyTorch).

Port of ``wmar_tpu.audio.augmentations``: speed, echo, white and pink
noise, FIR low/high/band-pass and smoothing, amplitude, up-down
resampling, time shift and temporal crop at the reference's strengths,
MP3 through the port's own ctypes bridge to ``libmp3lame``
(:mod:`wmar_tpu_torch.native.mp3`, on the host), and the Mimi, EnCodec and
DAC round trips.
Everything but MP3 runs on the waveform's device.

The stochastic attacks draw from a ``torch.Generator`` on that device, or
take their draws as arguments (``noise``, ``white``, ``start``), so tests
can feed JAX's. On a dp rank of a trainer's ``mesh``, white and pink noise
are drawn at the global batch's shape (pink normalised over it) and the
rank keeps its rows: the one process's values and generator state. ``speed`` and ``updown_resample`` compute
``jax.image.resize``'s linear (triangle) weights in float32 exactly as JAX
does, but only over the band of inputs each output reaches, so a clip of
any length resamples in ``O(T)`` memory.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wmar_tpu_torch.native import mp3 as _mp3
from wmar_tpu_torch.parallel.data import global_randn, rows_of

_EPS32 = float(np.finfo(np.float32).eps)


def gaussian_noise(audio, std: float, generator=None, noise: Optional[torch.Tensor] = None, mesh=None):
    if noise is None:
        noise = rows_of(mesh, global_randn(mesh, audio.shape, generator, device=audio.device))
    return torch.clamp(audio + noise.to(audio.device) * std, -1.0, 1.0)


def pink_noise(audio, std: float, generator=None, white: Optional[torch.Tensor] = None, mesh=None):
    """1/f-shaped noise by FFT filtering of white noise ``white [B, T, C]``
    (the global batch's on a dp rank of ``mesh``), normalised to unit std
    over the whole batch."""
    b, t, c = audio.shape
    if white is None:
        white = global_randn(mesh, (b, t, c), generator, device=audio.device)
    spec = torch.fft.rfft(white.to(audio.device, torch.float32), dim=1)
    freqs = torch.arange(spec.shape[1], dtype=torch.float32, device=audio.device)
    shape_ = 1.0 / torch.sqrt(torch.clamp_min(freqs, 1.0))
    pink = torch.fft.irfft(spec * shape_[None, :, None], n=t, dim=1)
    pink = rows_of(mesh, pink / (pink.std(correction=0) + 1e-8))
    return torch.clamp(audio + pink * std, -1.0, 1.0)


def _fir(audio, kernel: np.ndarray):
    """Edge-padded FIR (a correlation, as ``lax.conv``) along time."""
    k = torch.as_tensor(kernel, dtype=torch.float32, device=audio.device)
    pad = len(kernel) // 2
    x = F.pad(audio.transpose(1, 2), (pad, pad), mode="replicate")  # [B, C, T + 2 pad]
    c = x.shape[1]
    y = F.conv1d(x, k.reshape(1, 1, -1).expand(c, 1, -1).contiguous(), groups=c)
    return y.transpose(1, 2)


def _sinc_kernel(cutoff: float, taps: int = 65) -> np.ndarray:
    """Windowed-sinc lowpass, cutoff as a fraction of Nyquist."""
    n = np.arange(taps) - (taps - 1) / 2
    h = np.sinc(cutoff * n) * cutoff
    h *= np.hamming(taps)
    return (h / h.sum()).astype(np.float32)


def lowpass(audio, cutoff: float):
    return _fir(audio, _sinc_kernel(cutoff))


def highpass(audio, cutoff: float):
    return torch.clamp(audio - _fir(audio, _sinc_kernel(cutoff)), -1.0, 1.0)


def bandpass(audio, low_c: float, high_c: float):
    return torch.clamp(lowpass(audio, high_c) - lowpass(audio, low_c), -1.0, 1.0)


def smooth(audio, window: int):
    return _fir(audio, np.ones(window, dtype=np.float32) / window)


def echo(audio, delay_frac: float = 0.1, volume: float = 0.5):
    """A single reflection at ``delay_frac`` of the clip length."""
    t = audio.shape[1]
    d = max(1, int(delay_frac * t))
    delayed = F.pad(audio.transpose(1, 2), (d, 0)).transpose(1, 2)[:, :t]
    return torch.clamp(audio + volume * delayed, -1.0, 1.0)


def resize_linear_time(audio, n_out: int, antialias: bool) -> torch.Tensor:
    """``jax.image.resize(audio, (B, n_out, C), "linear", antialias)`` along
    axis 1 in float32: the same sample positions, triangle weights, weight
    sums and range mask, each output reading only the inputs its kernel
    reaches."""
    b, n_in, c = audio.shape
    audio = audio.to(torch.float32)
    if n_in == n_out:  # JAX skips a dim of equal size
        return audio
    dev = audio.device
    inv = 1.0 / (n_out / n_in)
    kscale = max(inv, 1.0) if antialias else 1.0
    ks32 = torch.tensor(kscale, dtype=torch.float32, device=dev)
    # (i + 0.5) * inv - 0.5 with inv in float32 and one rounding, as XLA's fused multiply-add gives it: the
    # float64 product of two 24-bit values is exact
    inv32 = float(np.float32(inv))
    sample_f = ((torch.arange(n_out, dtype=torch.float64, device=dev) + 0.5) * inv32 - 0.5).to(torch.float32)
    width = int(np.ceil(2 * kscale)) + 2
    j = torch.floor(sample_f - ks32).to(torch.int64)[:, None] + torch.arange(width, device=dev)  # [n_out, W]
    inside = (j >= 0) & (j < n_in)
    x = torch.abs(sample_f[:, None] - j.to(torch.float32)) / ks32
    w = torch.where(inside, torch.clamp_min(1.0 - torch.abs(x), 0.0), 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS32, w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((sample_f >= -0.5) & (sample_f <= n_in - 0.5))[:, None], w, 0.0)
    taps = audio[:, j.clamp(0, n_in - 1)]  # [B, n_out, W, C]
    return (taps * w[None, :, :, None]).sum(dim=2)


def speed(audio, factor: float):
    """Resample to change speed, then pad or crop back to the input length
    (the content plays at ``factor`` x speed)."""
    b, t, c = audio.shape
    new_t = max(1, int(round(t / factor)))
    resampled = resize_linear_time(audio, new_t, antialias=factor > 1)
    if new_t >= t:
        return resampled[:, :t]
    return F.pad(resampled.transpose(1, 2), (0, t - new_t)).transpose(1, 2)


def time_shift(audio, shift_frac: float):
    return torch.roll(audio, int(shift_frac * audio.shape[1]), dims=1)


def boost_audio(audio, amount_pct: float):
    return audio * (1.0 + amount_pct / 100.0)


def duck_audio(audio, amount_pct: float):
    return audio * (1.0 - amount_pct / 100.0)


def updown_resample(audio, intermediate_freq: int, sample_rate: int = 24000):
    """Resample to ``intermediate_freq`` and back (linear, antialiased on
    the way down)."""
    n = audio.shape[1]
    n_mid = int(round(n * intermediate_freq / sample_rate))
    mid = resize_linear_time(audio, n_mid, antialias=n_mid < n)
    return resize_linear_time(mid, n, antialias=n < n_mid)


def temporal_crop(audio, keep_ratio: float, generator=None, start: Optional[int] = None):
    """Keep a random contiguous ``keep_ratio`` fraction, moved to the front
    and zero-padded to the input length; ``start`` is drawn uniformly from
    ``[0, n - keep]`` unless given."""
    n = audio.shape[1]
    keep = int(n * keep_ratio)
    if start is None:
        start = int(torch.randint(0, n - keep + 1, (1,), generator=generator, device=audio.device).item())
    idx = torch.arange(n, device=audio.device)[None, :, None]
    mask = (idx >= start) & (idx < start + keep)
    return torch.roll(torch.where(mask, audio, 0.0), -start, dims=1)


class MimiCompression:
    """A Mimi encode / decode round trip as an attack (the codec slot of the
    reference's neural-codec attacks)."""

    def __init__(self, mimi):
        self.mimi = mimi

    def __call__(self, audio):
        out = self.mimi.decode(self.mimi.encode(audio))
        n = min(out.shape[-1], audio.shape[-1])
        return out[..., :n]


class MP3Compression:
    """MP3 round trip on the host at ``bitrate_kbps`` through
    :func:`wmar_tpu_torch.native.mp3.mp3_roundtrip`; the result goes back
    to the waveform's device."""

    def __init__(self, sample_rate: int = 24000):
        if not _mp3.available():
            raise RuntimeError("MP3Compression: libmp3lame not found on this host")
        self.sample_rate = sample_rate

    def __call__(self, audio, bitrate_kbps: float):
        x = audio.detach().to("cpu", torch.float32).numpy()
        chan = x.ndim == 3
        if chan:
            x = x[..., 0]
        out = np.asarray(_mp3.mp3_roundtrip(x, self.sample_rate, int(bitrate_kbps)), np.float32)
        return torch.from_numpy(out[..., None] if chan else out).to(audio.device)


def mp3_available() -> bool:
    return _mp3.available()


class _MP3StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, audio, bitrate_kbps: int, sample_rate: int):
        return MP3Compression(sample_rate)(audio, bitrate_kbps)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def mp3_compression_st(audio, bitrate_kbps: int, sample_rate: int = 24000):
    """MP3 round trip with a straight-through gradient (the reference's
    train-time ``MP3Compression(passthrough=True)``): the forward is
    :func:`wmar_tpu_torch.native.mp3.mp3_roundtrip` on the host, in float32,
    the result back on the waveform's device; the backward is the
    identity."""
    return _MP3StraightThrough.apply(audio, bitrate_kbps, sample_rate)


def get_validation_augs(sample_rate: int = 24000, frame_size: int = 1920, mimi_codec=None, encodec=None,
                        dac=None) -> List[Tuple[str, object, list]]:
    """The audio eval grid: ``(name, fn(x, param, generator), params)`` for
    every family at the reference's strengths, MP3 at 16/64/128 kbps where
    ``libmp3lame`` loads, then ``mimi-compression`` with a ``mimi_codec``,
    ``encodec-compression`` and ``dac-compression`` with an ``encodec`` /
    ``dac`` (:class:`wmar_tpu_torch.audio.codecs.CodecCompression`), one
    cell each.
    ``time-shift`` rolls the clip by 10, 20 and 40 ms: the shift over the
    clip's length ``x.shape[1]``. (JAX's grid divides by ``x.shape[-1]``,
    the channel axis of ``[B, T, 1]``, where the reference's ``[B, C, T]``
    has time, so its roll is a whole number of clip lengths and leaves the
    waveform as it is: ROADMAP queue 3, fault (g).)"""
    frame_ms = 1000 * frame_size / sample_rate  # 80 ms
    shift = lambda ms: ms / 1000 * sample_rate  # noqa: E731
    nyq = sample_rate / 2
    augs: List[Tuple[str, object, list]] = [
        ("identity", lambda x, p, g: x, [0]),
        ("speed", lambda x, p, g: speed(x, p), [0.75, 0.9, 1.0, 1.1, 1.25]),
        ("echo", lambda x, p, g: echo(x, p[0], p[1]), [(0.1, 0.2), (0.3, 0.5), (0.5, 0.7)]),
        ("noise", lambda x, p, g: gaussian_noise(x, p, g), [0.001, 0.01, 0.05]),
        ("pink-noise", lambda x, p, g: pink_noise(x, p, g), [0.01, 0.05, 0.1]),
        ("lowpass", lambda x, p, g: lowpass(x, p / nyq), [1000, 3000, 8000]),
        ("highpass", lambda x, p, g: highpass(x, p / nyq), [100, 500, 1000]),
        ("bandpass", lambda x, p, g: bandpass(x, p[0] / nyq, p[1] / nyq), [(300, 3000), (500, 5000), (1000, 8000)]),
        ("smooth", lambda x, p, g: smooth(x, max(3, int(p * sample_rate)) | 1), [0.001, 0.005, 0.01]),
        ("boost", lambda x, p, g: boost_audio(x, p), [50, 90]),
        ("duck", lambda x, p, g: duck_audio(x, p), [50, 90]),
        ("updown-resample", lambda x, p, g: updown_resample(x, int(p), sample_rate),
         [sample_rate, int(sample_rate * 1.5), sample_rate * 2]),
        ("time-shift", lambda x, p, g: time_shift(x, shift(p) / x.shape[1]),
         [frame_ms / 8, frame_ms / 4, frame_ms / 2]),
        ("temporal-crop", lambda x, p, g: temporal_crop(x, p, g), [0.5, 0.7, 0.9]),
    ]
    if _mp3.available():
        mp3 = MP3Compression(sample_rate)
        augs.append(("mp3-compression", lambda x, p, g: mp3(x, p), [16, 64, 128]))
    if mimi_codec is not None:
        augs.append(("mimi-compression", lambda x, p, g: mimi_codec(x), [0.0]))
    if encodec is not None:
        augs.append(("encodec-compression", lambda x, p, g: encodec(x), [0.0]))
    if dac is not None:
        augs.append(("dac-compression", lambda x, p, g: dac(x), [0.0]))
    return augs
