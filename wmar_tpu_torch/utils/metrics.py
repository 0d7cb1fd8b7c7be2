"""Evaluation metrics for images, codes and audio (PyTorch port of
``wmar_tpu.utils.metrics``). The audio metrics (STOI, PESQ, SI-SNR, SNR)
run on the host in float64 numpy, as the JAX package's do."""

from __future__ import annotations

import numpy as np
import torch


def psnr(a, b, max_val: float = 255.0) -> float:
    """PSNR between two images of one shape, values scaled to ``max_val``."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(max_val**2 / mse))


def psnr_pm1(a, b) -> float:
    """PSNR for images in [-1, 1] mapped to the 0-255 convention."""
    a8 = (np.asarray(a) / 2.0 + 0.5) * 255.0
    b8 = (np.asarray(b) / 2.0 + 0.5) * 255.0
    return psnr(a8, b8)


def l0_token_mismatch(codes, orig_codes) -> torch.Tensor:
    """Fraction of mismatched tokens per row: ``[B, T] -> [B]``."""
    codes = torch.as_tensor(codes)
    orig_codes = torch.as_tensor(orig_codes, device=codes.device)
    return (codes != orig_codes).to(torch.float32).mean(dim=-1)


# ---------------------------------------------------------------------------
# Audio metrics (port of the JAX package's; host numpy in float64)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A waveform (tensor on any device, or array) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _fft_resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Bandlimited resampling via rFFT spectrum truncation/zero-padding."""
    n_out = int(round(len(x) * sr_out / sr_in))
    spec = np.fft.rfft(x)
    n_bins = n_out // 2 + 1
    out_spec = np.zeros(n_bins, dtype=spec.dtype)
    m = min(n_bins, len(spec))
    out_spec[:m] = spec[:m]
    return np.fft.irfft(out_spec, n=n_out) * (n_out / len(x))


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix (Taal et al. 2010 STOI)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    flo = cf * 2 ** (-1.0 / 6)
    fhi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - flo[i]) ** 2))
        hi = int(np.argmin((f - fhi[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def stoi(est, ref, fs: int = 24000) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2010), the
    reference's ``wmar_audio/evals/metrics.py`` STOI, from the published
    algorithm (10 kHz, 15 third-octave bands from 150 Hz, 384 ms
    segments, -15 dB SDR clip). Host numpy."""
    x = _host(ref).reshape(-1)
    y = _host(est).reshape(-1)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    fs_target = 10000
    if fs != fs_target:
        x = _fft_resample(x, fs, fs_target)
        y = _fft_resample(y, fs, fs_target)

    n_frame, hop, nfft = 256, 128, 512
    # remove silent frames (energy > max - 40 dB)
    win = np.hanning(n_frame + 2)[1:-1]
    frames = range(0, len(x) - n_frame, hop)
    energies = np.array(
        [20 * np.log10(np.linalg.norm(win * x[i : i + n_frame]) + 1e-12) for i in frames]
    )
    if len(energies) == 0:
        return 0.0
    mask = energies > energies.max() - 40.0
    xs, ys = [], []
    for keep, i in zip(mask, frames):
        if keep:
            xs.append(x[i : i + n_frame])
            ys.append(y[i : i + n_frame])
    if len(xs) < 30:
        return 0.0
    X = np.fft.rfft(np.asarray(xs) * win, nfft, axis=1)
    Y = np.fft.rfft(np.asarray(ys) * win, nfft, axis=1)
    obm = _thirdoct(fs_target, nfft, 15, 150.0)
    Xb = np.sqrt(obm @ (np.abs(X.T) ** 2))  # [bands, frames]
    Yb = np.sqrt(obm @ (np.abs(Y.T) ** 2))

    N = 30  # 384 ms segments
    beta = 10 ** (-15.0 / 20.0)
    d_sum, count = 0.0, 0
    for m in range(N, Xb.shape[1] + 1):
        Xseg = Xb[:, m - N : m]
        Yseg = Yb[:, m - N : m]
        alpha = np.linalg.norm(Xseg, axis=1, keepdims=True) / (
            np.linalg.norm(Yseg, axis=1, keepdims=True) + 1e-12
        )
        Yprime = np.minimum(Yseg * alpha, Xseg * (1 + beta))
        xn = Xseg - Xseg.mean(axis=1, keepdims=True)
        yn = Yprime - Yprime.mean(axis=1, keepdims=True)
        corr = (xn * yn).sum(axis=1) / (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-12
        )
        d_sum += corr.mean()
        count += 1
    return float(d_sum / max(count, 1))


def pesq_metric(est, ref, fs: int = 24000):
    """PESQ via the optional ``pesq`` package; None where the package
    is absent, rather than an approximation of an ITU standard."""
    try:
        from pesq import pesq as _pesq  # type: ignore
    except ImportError:
        return None
    x = _fft_resample(_host(ref).reshape(-1), fs, 16000)
    y = _fft_resample(_host(est).reshape(-1), fs, 16000)
    return float(_pesq(16000, x, y, "wb"))


def sisnr(est, ref) -> float:
    """Scale-invariant SNR in dB (the reference's audio quality metric,
    ``wmar_audio/evals/metrics.py``). Inputs [T] or [B, T, 1]."""
    est = _host(est).reshape(-1)
    ref = _host(ref).reshape(-1)
    ref = ref - ref.mean()
    est = est - est.mean()
    s = (est @ ref) / (ref @ ref + 1e-12) * ref
    noise = est - s
    return float(10 * np.log10((s @ s + 1e-12) / (noise @ noise + 1e-12)))


def snr(est, ref) -> float:
    """Plain SNR in dB (``wmar_audio/evals/metrics.py`` calculate_snr).
    Inputs [T] or [B, T, 1]."""
    est = _host(est).reshape(-1)
    ref = _host(ref).reshape(-1)
    noise = est - ref
    return float(10 * np.log10((ref @ ref + 1e-12) / (noise @ noise + 1e-12)))
