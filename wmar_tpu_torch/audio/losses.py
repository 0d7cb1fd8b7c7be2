"""The audio loss bank of the Mimi RCC finetune (PyTorch).

Port of ``wmar_tpu.audio.losses``, with its math rather than julius' or
torchaudio's:

- :class:`SISNR`: negated SI-SNR over 50%-overlapping segments;
- :func:`stft_losses` / :class:`STFTLoss` / :class:`MRSTFTLoss`: spectral
  convergence and log-magnitude L1 from framed ``rfft`` STFTs (``center``
  reflect padding, a periodic Hann window of ``win`` centred in ``n_fft``);
- :class:`MelSpectrogramL1Loss` / :class:`MultiScaleMelSpectrogramLoss` on
  an HTK mel filterbank without norm;
- :class:`TFLoudnessRatio`: a mel-spaced windowed-sinc band split as one
  grouped ``conv1d``, K-weighting applied on the FFT grid (the two biquads'
  exact transfer function, circular at the clip's ends), 0.4 s blocks;
- :func:`get_audio_loss` / :func:`get_code_loss`.

Every loss takes ``(pred, target)`` as ``[B, T, C]`` and returns a scalar.
Three are not means over the batch's rows: the spectral convergence of
``stft`` / ``mrstft`` sums over the whole batch, and ``tf_loudness``
groups its ratios by the batch size. On a dp rank of a trainer's ``mesh``,
:func:`get_audio_loss` computes those whole from the ranks' gathered
predictions and targets (:class:`OverRanks`), their value on the global
batch; the others are row means and stay on the rank's rows.
Reflect padding follows numpy's rule, so a pad longer than the clip
reflects again (the tiny CLI's 64-sample clips under a 2048-point STFT).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Framing helpers
# ---------------------------------------------------------------------------


def _frame(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """``[..., T]`` -> ``[..., 1 + (T - frame) // hop, frame]``."""
    return x.unfold(-1, frame, hop)


def _unfold_ceil(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Right zero-padding to ``ceil(T / hop)`` full frames, then framed."""
    t = x.shape[-1]
    n = max(1, math.ceil(t / hop))
    return _frame(F.pad(x, (0, (n - 1) * hop + frame - t)), frame, hop)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``np.pad(x, ..., mode="reflect")`` along the last axis, for pads of
    any length: the index folds back and forth with period ``2 (T - 1)``."""
    t = x.shape[-1]
    if t == 1:
        return x.expand(*x.shape[:-1], left + 1 + right)
    period = 2 * (t - 1)
    idx = torch.arange(-left, t + right, device=x.device).remainder(period)
    idx = torch.where(idx >= t, period - idx, idx)
    return x[..., idx]


def _hann(n: int) -> np.ndarray:
    """``torch.hann_window(n, periodic=True)`` in float32."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _centered_window(n_fft: int, win: int) -> np.ndarray:
    window = np.zeros(n_fft, np.float32)
    off = (n_fft - win) // 2
    window[off:off + win] = _hann(win)
    return window


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """``[B, T]`` -> ``|STFT|`` ``[B, frames, n_fft // 2 + 1]``, floored at
    ``sqrt(1e-7)``."""
    pad = n_fft // 2
    frames = _frame(reflect_pad(x, pad, pad), n_fft, hop)
    spec = torch.fft.rfft(frames * torch.from_numpy(_centered_window(n_fft, win)).to(x), dim=-1)
    return torch.sqrt(torch.clamp(torch.abs(spec) ** 2, min=1e-7))


def _bct(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, C]`` -> ``[B, C, T]``."""
    return x.transpose(-1, -2)


# ---------------------------------------------------------------------------
# STFT losses
# ---------------------------------------------------------------------------


def stft_losses(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) of ``[B, T, C]`` signals.
    The eps sits inside the square root: at the finetune's first step the
    trainable decoder equals the frozen one, and ``d sqrt(u) / du`` is
    infinite at ``u = 0``."""
    b, t, c = x.shape
    xm = _stft_mag(_bct(x).reshape(b * c, t), n_fft, hop, win)
    ym = _stft_mag(_bct(y).reshape(b * c, t), n_fft, hop, win)
    sc = torch.sqrt(((ym - xm) ** 2).sum() + _EPS**2) / (torch.sqrt((ym**2).sum()) + _EPS)
    mag = torch.abs(torch.log(_EPS + ym) - torch.log(_EPS + xm)).mean()
    return sc, mag


@dataclasses.dataclass(frozen=True)
class STFTLoss:
    """One resolution: ``factor_sc * sc + factor_mag * mag``."""

    n_fft: int = 1024
    hop: int = 120
    win: int = 600
    factor_sc: float = 0.1
    factor_mag: float = 0.1

    def __call__(self, x, y):
        sc, mag = stft_losses(x, y, self.n_fft, self.hop, self.win)
        return self.factor_sc * sc + self.factor_mag * mag


@dataclasses.dataclass(frozen=True)
class MRSTFTLoss:
    """Three resolutions, each term averaged over them."""

    n_ffts: Sequence[int] = (1024, 2048, 512)
    hops: Sequence[int] = (120, 240, 50)
    wins: Sequence[int] = (600, 1200, 240)
    factor_sc: float = 0.1
    factor_mag: float = 0.1

    def __call__(self, x, y):
        sc_total, mag_total = 0.0, 0.0
        for n_fft, hop, win in zip(self.n_ffts, self.hops, self.wins):
            sc, mag = stft_losses(x, y, n_fft, hop, win)
            sc_total = sc_total + sc
            mag_total = mag_total + mag
        n = len(self.n_ffts)
        return self.factor_sc * sc_total / n + self.factor_mag * mag_total / n


# ---------------------------------------------------------------------------
# SI-SNR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SISNR:
    """Negated SI-SNR over ``segment`` s windows with ``overlap`` (the whole
    clip when ``segment`` is None). Lower is better."""

    sample_rate: int = 16000
    segment: Optional[float] = 20.0
    overlap: float = 0.5

    def __call__(self, out_sig, ref_sig):
        out_sig, ref_sig = _bct(out_sig), _bct(ref_sig)
        t = ref_sig.shape[-1]
        if self.segment is None:
            frame, stride = t, t
        else:
            frame = int(self.segment * self.sample_rate)
            stride = int(frame * (1 - self.overlap))
        eps = _EPS * frame
        gt = _unfold_ceil(ref_sig, frame, stride)
        est = _unfold_ceil(out_sig, frame, stride)
        gt = gt - gt.mean(-1, keepdim=True)
        est = est - est.mean(-1, keepdim=True)
        dot = torch.einsum("bcft,bcft->bcf", gt, est)
        proj = dot[..., None] * gt / (eps + (gt**2).sum(-1, keepdim=True))
        noise = est - proj
        sisnr = 10.0 * (torch.log10(eps + (proj**2).sum(-1, keepdim=True))
                        - torch.log10(eps + (noise**2).sum(-1, keepdim=True)))
        return -sisnr[..., 0].mean()


# ---------------------------------------------------------------------------
# Mel spectrogram losses
# ---------------------------------------------------------------------------


def _mel_fbank(sr: float, n_fft: int, n_mels: int, f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """HTK-scale triangular filterbank without norm, ``[n_fft // 2 + 1,
    n_mels]`` float32."""
    f_max = f_max or sr / 2.0
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mels = np.linspace(2595.0 * np.log10(1.0 + f_min / 700.0), 2595.0 * np.log10(1.0 + f_max / 700.0), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    fb = np.zeros((len(freqs), n_mels), np.float32)
    for m in range(n_mels):
        lo, ce, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / max(ce - lo, 1e-10)
        down = (hi - freqs) / max(hi - ce, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@dataclasses.dataclass(frozen=True)
class MelSpectrogramWrapper:
    """Reflect padding of ``(n_fft - hop) // 2`` a side, zero padding to
    whole frames, a power mel spectrogram, ``log10(floor + mel)`` when
    ``log``. ``[B, T, C]`` -> ``[B, C * n_mels, frames]``."""

    n_fft: int = 1024
    hop: int = 256
    win: Optional[int] = None
    n_mels: int = 80
    sample_rate: float = 22050
    f_min: float = 0.0
    f_max: Optional[float] = None
    log: bool = True
    floor_level: float = 1e-5

    def __call__(self, x):
        win = self.win or self.n_fft
        x = _bct(x)
        b, c, t = x.shape
        p = (self.n_fft - self.hop) // 2
        x = reflect_pad(x.reshape(b * c, t), p, p)
        t2 = x.shape[-1]
        n_frames = math.ceil((t2 - self.n_fft) / self.hop) + 1
        x = F.pad(x, (0, max(0, (n_frames - 1) * self.hop + self.n_fft - t2)))
        frames = _frame(x, self.n_fft, self.hop) * torch.from_numpy(_centered_window(self.n_fft, win)).to(x)
        power = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2  # [BC, F, n_freq]
        fb = torch.from_numpy(_mel_fbank(self.sample_rate, self.n_fft, self.n_mels, self.f_min, self.f_max))
        mel = (power @ fb.to(power)).transpose(-1, -2)  # [BC, n_mels, F]
        if self.log:
            mel = torch.log10(self.floor_level + mel)
        return mel.reshape(b, c * self.n_mels, -1)


@dataclasses.dataclass(frozen=True)
class MelSpectrogramL1Loss:
    """L1 between log-mel spectrograms."""

    sample_rate: int
    n_fft: int = 1024
    hop: int = 256
    win: int = 1024
    n_mels: int = 80

    def __call__(self, x, y):
        mel = MelSpectrogramWrapper(self.n_fft, self.hop, self.win, self.n_mels, self.sample_rate)
        return torch.abs(mel(x) - mel(y)).mean()


@dataclasses.dataclass(frozen=True)
class MultiScaleMelSpectrogramLoss:
    """Over ``n_fft = 2^6 .. 2^10``: L1 on the linear mel plus ``sqrt(n_fft
    - 1)`` x MSE on the log mel (1 without ``alphas``); divided by the sum
    of the weights when ``normalized``."""

    sample_rate: int
    range_start: int = 6
    range_end: int = 11
    n_mels: int = 64
    alphas: bool = True
    normalized: bool = False

    def __call__(self, x, y):
        loss, total = 0.0, 0.0
        for i in range(self.range_start, self.range_end):
            kw = dict(n_fft=2**i, hop=int((2**i) / 4), win=2**i, n_mels=self.n_mels, sample_rate=self.sample_rate)
            alpha = math.sqrt(2**i - 1) if self.alphas else 1.0
            lin = MelSpectrogramWrapper(log=False, **kw)
            logm = MelSpectrogramWrapper(log=True, **kw)
            loss = loss + torch.abs(lin(x) - lin(y)).mean() + alpha * ((logm(x) - logm(y)) ** 2).mean()
            total += alpha + 1
        return loss / total if self.normalized else loss


# ---------------------------------------------------------------------------
# TF loudness ratio
# ---------------------------------------------------------------------------


def _biquad_freq_response(b: Sequence[float], a: Sequence[float], n_fft: int) -> np.ndarray:
    """``H(e^{jw})`` of a biquad on the ``rfft`` grid, complex64."""
    w = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    return ((b[0] + b[1] * w + b[2] * w**2) / (a[0] + a[1] * w + a[2] * w**2)).astype(np.complex64)


def _k_weighting_response(sr: int, n_fft: int) -> np.ndarray:
    """The K-weighting pre-filter: a 4 dB treble shelf at 1500 Hz (Q
    1/sqrt 2) times a 38 Hz highpass (Q 0.5), torchaudio's biquad
    coefficients."""
    gain, fc, q = 4.0, 1500.0, 1.0 / math.sqrt(2.0)
    w0 = 2 * math.pi * fc / sr
    amp = 10.0 ** (gain / 40.0)
    alpha = math.sin(w0) / (2 * q)
    cosw = math.cos(w0)
    tb = [amp * ((amp + 1) + (amp - 1) * cosw + 2 * math.sqrt(amp) * alpha),
          -2 * amp * ((amp - 1) + (amp + 1) * cosw),
          amp * ((amp + 1) + (amp - 1) * cosw - 2 * math.sqrt(amp) * alpha)]
    ta = [(amp + 1) - (amp - 1) * cosw + 2 * math.sqrt(amp) * alpha,
          2 * ((amp - 1) - (amp + 1) * cosw),
          (amp + 1) - (amp - 1) * cosw - 2 * math.sqrt(amp) * alpha]
    fc2, q2 = 38.0, 0.5
    w02 = 2 * math.pi * fc2 / sr
    alpha2 = math.sin(w02) / (2 * q2)
    cosw2 = math.cos(w02)
    hb = [(1 + cosw2) / 2, -(1 + cosw2), (1 + cosw2) / 2]
    ha = [1 + alpha2, -2 * cosw2, 1 - alpha2]
    return _biquad_freq_response(tb, ta, n_fft) * _biquad_freq_response(hb, ha, n_fft)


def _basic_loudness(wav: torch.Tensor, sr: int) -> torch.Tensor:
    """Per-block loudness ``-0.691 + 10 log10(E)`` of ``[N, 1, T]``:
    K-weighting on the FFT grid, 0.4 s blocks at 75% overlap (one block
    when the clip is shorter). Returns ``[N, blocks]``."""
    n, c, t = wav.shape
    n_fft = int(2 ** math.ceil(math.log2(max(t, 16))))
    h = torch.from_numpy(_k_weighting_response(sr, n_fft)).to(wav.device)
    spec = torch.fft.rfft(wav.reshape(n * c, t), n=n_fft, dim=-1) * h
    x = torch.fft.irfft(spec, n=n_fft, dim=-1)[..., :t].reshape(n, c, t)
    gate = int(round(0.4 * sr))
    step = int(round(gate * 0.25))
    if t < gate:
        energy = torch.mean(x**2, dim=-1, keepdim=True)
    else:
        energy = _frame(x**2, gate, step).mean(-1)  # [N, C, blocks]
    return -0.691 + 10.0 * torch.log10(energy.sum(dim=1) + _EPS)


def _split_bands_kernels(sr: int, n_bands: int, zeros: float = 8.0) -> np.ndarray:
    """Mel-spaced band split as FIR kernels ``[n_bands, taps]``: Hann-
    windowed sinc lowpasses at mel-spaced cutoffs, band 0 the first, band i
    the difference of neighbours, the last the delta minus the top one."""
    mels = np.linspace(1127.0 * np.log(1.0), 1127.0 * np.log(1.0 + (sr / 2) / 700.0), n_bands + 1)
    cutoffs = (700.0 * (np.exp(mels / 1127.0) - 1.0))[1:-1] / sr
    half = int(math.ceil(zeros / (2 * min(cutoffs)) / 2))
    taps = 2 * half + 1
    tgrid = np.arange(taps) - half

    def lp(cut):
        k = 2 * cut * np.sinc(2 * cut * tgrid)
        k *= np.hanning(taps)
        return k / k.sum()

    lows = [lp(c) for c in cutoffs]
    delta = np.zeros(taps)
    delta[half] = 1.0
    bands = [lows[0]] + [lows[i] - lows[i - 1] for i in range(1, len(lows))] + [delta - lows[-1]]
    return np.stack(bands).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TFLoudnessRatio:
    """Loudness of ``pred - ref`` against ``ref`` per (band, 0.5 s frame),
    softmax-weighted over the bands and frames of each clip. Mono."""

    sample_rate: int = 24000
    segment: float = 0.5
    overlap: float = 0.5
    n_bands: int = 16
    temperature: float = 1.0

    def __call__(self, out_sig, ref_sig):
        out_sig, ref_sig = _bct(out_sig), _bct(ref_sig)
        b, c, t = ref_sig.shape
        kern = torch.from_numpy(_split_bands_kernels(self.sample_rate, self.n_bands))[:, None, :].to(ref_sig)
        pad = kern.shape[-1] // 2

        def split(sig):  # [B, 1, T] -> [B * bands, 1, T]
            return F.conv1d(sig, kern, padding=pad).reshape(b * self.n_bands, 1, t)

        frame = int(self.segment * self.sample_rate)
        stride = int(frame * (1 - self.overlap))
        gt = _unfold_ceil(split(ref_sig)[:, 0], frame, stride).reshape(-1, 1, frame)
        est = _unfold_ceil(split(out_sig)[:, 0], frame, stride).reshape(-1, 1, frame)
        l_ratio = (_basic_loudness(est - gt, self.sample_rate) - _basic_loudness(gt, self.sample_rate)).reshape(-1, b)
        w = torch.softmax(l_ratio / self.temperature, dim=0)
        return (w * l_ratio).mean()


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------


def _mse(x, y):
    return ((x - y) ** 2).mean()


def _l1(x, y):
    return torch.abs(x - y).mean()


# the losses that are not means over the batch's rows
BATCH_LOSSES = ("stft", "mrstft", "tf_loudness")


@dataclasses.dataclass(frozen=True)
class OverRanks:
    """``loss`` of the ranks' gathered ``(pred, target)``: the global batch's
    value on every dp rank. The gather's backward hands this rank's rows dp
    times their gradient, which the gradients' mean over the ranks divides
    back."""

    loss: Callable
    mesh: Any

    def __call__(self, x, y):
        from wmar_tpu_torch.parallel import gather_rows

        return self.loss(gather_rows(x, self.mesh), gather_rows(y, self.mesh))


def get_audio_loss(loss_type: str, sample_rate: int = 24000, mesh=None):
    """``mse``, ``l1``, ``sisnr``, ``multi_mel``, ``stft``, ``mrstft`` or
    ``tf_loudness``; on a dp rank of ``mesh``, those of :data:`BATCH_LOSSES`
    over the global batch."""
    from wmar_tpu_torch.parallel import dp_size

    losses = {"mse": lambda: _mse, "l1": lambda: _l1, "sisnr": lambda: SISNR(sample_rate=sample_rate),
              "multi_mel": lambda: MultiScaleMelSpectrogramLoss(sample_rate=sample_rate), "stft": STFTLoss,
              "mrstft": MRSTFTLoss, "tf_loudness": lambda: TFLoudnessRatio(sample_rate=sample_rate)}
    if loss_type not in losses:
        raise ValueError(f"Unknown audio loss type: {loss_type}")
    loss = losses[loss_type]()
    return OverRanks(loss, mesh) if loss_type in BATCH_LOSSES and dp_size(mesh) > 1 else loss


def get_code_loss(loss_type: str):
    """``mse`` or ``l1``."""
    if loss_type == "mse":
        return _mse
    if loss_type == "l1":
        return _l1
    raise ValueError(f"Unknown code loss type: {loss_type}")
