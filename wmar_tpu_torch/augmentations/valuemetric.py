"""Valuemetric attacks on NHWC float images in [0, 1] (PyTorch).

Port of ``wmar_tpu.augmentations.valuemetric``: colour, median, noise,
brightness, blur and JPEG. Every function runs on the images' own device
but one: JPEG comes in two kinds.

* :func:`jpeg_diff`, a differentiable JPEG on the device (YCbCr, 4:2:0
  chroma subsampling, 8x8 DCT, quality-scaled quantization with a
  straight-through round);
* :func:`jpeg_pil`, PIL's encoder and decoder on the host, for runs that
  must match the reference's codec exactly. It copies the images to the
  host and back to their device.

Padding is by index (``_pad``), with numpy's ``reflect`` and ``edge``
rules, so a pad wider than the image reflects again as ``jnp.pad`` does.
The attacks that RCC finetuning and SyncSeal training go through clip
with :func:`clip01`, whose gradient at a bound is JAX's.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F

from wmar_tpu_torch.augmentations.geometric import resize_linear

_LUMA = (0.2989, 0.587, 0.114)  # torchvision rgb_to_grayscale weights


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position, numpy's ``reflect`` (period
    ``2 (n - 1)``) or ``edge``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _pad(imgs: torch.Tensor, pad_h, pad_w, mode: str) -> torch.Tensor:
    """Pad the H and W axes of NHWC images by ``(before, after)`` pairs."""
    h, w = imgs.shape[1:3]
    iy = _pad_index(h, *pad_h, mode, imgs.device)
    ix = _pad_index(w, *pad_w, mode, imgs.device)
    return imgs[:, iy[:, None], ix[None, :], :]


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: ``torch.clamp``'s values, and half the
    gradient at a value exactly on a bound, as JAX's clip (a clamp passes
    all of it; a brightness factor of 1.0 leaves saturated pixels there)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _luma(imgs: torch.Tensor) -> torch.Tensor:
    return (imgs * torch.tensor(_LUMA, dtype=imgs.dtype, device=imgs.device)).sum(-1, keepdim=True)


def grayscale(imgs: torch.Tensor) -> torch.Tensor:
    """3-channel luminance (torchvision ``Grayscale(num_output_channels=3)``)."""
    return _luma(imgs).repeat(1, 1, 1, 3)


def contrast(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    """torchvision ``adjust_contrast``: blend with the per-image grey mean."""
    mean = _luma(imgs).mean(dim=(1, 2, 3), keepdim=True)
    return clip01(mean + factor * (imgs - mean))


def saturation(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    """torchvision ``adjust_saturation``: blend with grayscale."""
    return clip01(grayscale(imgs) + factor * (imgs - grayscale(imgs)))


def hue(imgs: torch.Tensor, shift: float) -> torch.Tensor:
    """Hue rotation by ``shift`` in [-0.5, 0.5] turns (HSV round trip)."""
    r, g, b = imgs[..., 0], imgs[..., 1], imgs[..., 2]
    maxc = imgs.amax(dim=-1)
    minc = imgs.amin(dim=-1)
    v = maxc
    cr = maxc - minc
    s = cr / torch.clamp(maxc, min=1e-8)
    safe_cr = torch.clamp(cr, min=1e-8)
    rc = (maxc - r) / safe_cr
    gc = (maxc - g) / safe_cr
    bc = (maxc - b) / safe_cr
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(cr < 1e-8, torch.zeros_like(h), h)
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # the value of sector i, as jnp.select over i == 0 .. 5
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=-1)


def median_filter(imgs: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """k x k median filter with reflect padding, odd ``k`` (the middle of the
    sorted window, as ``jnp.median``)."""
    k = int(kernel_size)
    if k % 2 == 0:
        raise ValueError(f"median_filter takes an odd kernel size, got {k}")
    pad = k // 2
    x = _pad(imgs, (pad, pad), (pad, pad), "reflect")
    h, w = imgs.shape[1:3]
    patches = torch.stack([x[:, i: i + h, j: j + w, :] for i in range(k) for j in range(k)], dim=-1)
    # the middle of a stable sort: jnp.median's element at ties (and deterministic on the card)
    return patches.sort(dim=-1, stable=True).values[..., k * k // 2]


def gaussian_noise(imgs: torch.Tensor, std: float, generator: torch.Generator = None,
                   noise: torch.Tensor = None) -> torch.Tensor:
    """Add ``std`` times standard normal noise: ``noise`` where it is fed
    (a test feeds JAX's draws), else drawn from ``generator`` on the
    images' device."""
    if noise is None:
        noise = torch.randn(imgs.shape, generator=generator, dtype=imgs.dtype, device=imgs.device)
    return clip01(imgs + noise.to(imgs.device, imgs.dtype) * std)


def brightness(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    return clip01(imgs * factor)


def _gaussian_kernel1d(kernel_size: int, device=None) -> torch.Tensor:
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8  # torchvision's default sigma
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(imgs: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Separable depthwise blur with reflect padding, vertical then
    horizontal (torchvision's kernel)."""
    if kernel_size <= 0:
        return imgs
    if kernel_size % 2 == 0:
        kernel_size += 1
    k = _gaussian_kernel1d(kernel_size, imgs.device).to(imgs.dtype)
    pad = kernel_size // 2
    c = imgs.shape[-1]
    x = _pad(imgs, (pad, pad), (pad, pad), "reflect").permute(0, 3, 1, 2)
    x = F.conv2d(x, k.reshape(1, 1, kernel_size, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, k.reshape(1, 1, 1, kernel_size).repeat(c, 1, 1, 1), groups=c)
    return clip01(x.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# the standard Annex K quantization tables
_Q_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_Q_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _quality_tables(quality: int, device=None):
    """(luma, chroma) quantization tables of ``quality`` as float32 tensors."""
    quality = max(1, min(int(quality), 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    luma = np.clip(np.floor((_Q_LUMA * scale + 50) / 100), 1, 255)
    chroma = np.clip(np.floor((_Q_CHROMA * scale + 50) / 100), 1, 255)
    return (torch.as_tensor(luma, dtype=torch.float32, device=device),
            torch.as_tensor(chroma, dtype=torch.float32, device=device))


def _dct_matrix(device=None) -> torch.Tensor:
    """The orthonormal 8-point DCT-II matrix ``M``: ``X_dct = M x M^T``."""
    n = 8
    k = np.arange(n)
    m = np.sqrt(2.0 / n) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / (2 * n))
    m[0] *= 1.0 / np.sqrt(2.0)
    return torch.as_tensor(m.astype(np.float32), device=device)


def _blockify(x: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(-1, 8, 8)


def _unblockify(x: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _st_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round: the gradient of the identity."""
    return x + (torch.round(x) - x).detach()


def _jpeg_channel(chan: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One channel ``[B, H, W]`` centred at 0 (value - 128) through DCT,
    quantization and the inverse DCT."""
    b, h, w = chan.shape
    m = _dct_matrix(chan.device)
    blocks = _blockify(chan)
    coef = torch.einsum("ij,bjk,lk->bil", m, blocks, m)
    deq = _st_round(coef / table) * table
    rec = torch.einsum("ji,bjk,kl->bil", m, deq, m)
    return _unblockify(rec, b, h, w)


def jpeg_diff(imgs: torch.Tensor, quality: int, subsample: bool = True) -> torch.Tensor:
    """Differentiable JPEG round trip of NHWC [0, 1] images.

    Any size: images are edge-padded to block multiples and cropped back.
    Chroma subsampling is skipped for images under 16 px.
    """
    h0, w0 = imgs.shape[1:3]
    subsample = subsample and h0 >= 16 and w0 >= 16
    mult = 16 if subsample else 8
    pad_h, pad_w = (-h0) % mult, (-w0) % mult
    if pad_h or pad_w:
        imgs = _pad(imgs, (0, pad_h), (0, pad_w), "edge")
    luma_t, chroma_t = _quality_tables(quality, imgs.device)
    x = imgs * 255.0
    r, g, b_ = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b_
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b_ + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b_ + 128.0

    y = _jpeg_channel(y - 128.0, luma_t) + 128.0
    if subsample:
        _, h, w = cb.shape
        half = (h // 2, w // 2)
        cb_d = resize_linear(cb[..., None], half)[..., 0]
        cr_d = resize_linear(cr[..., None], half)[..., 0]
        cb_d = _jpeg_channel(cb_d - 128.0, chroma_t) + 128.0
        cr_d = _jpeg_channel(cr_d - 128.0, chroma_t) + 128.0
        cb = resize_linear(cb_d[..., None], (h, w))[..., 0]
        cr = resize_linear(cr_d[..., None], (h, w))[..., 0]
    else:
        cb = _jpeg_channel(cb - 128.0, chroma_t) + 128.0
        cr = _jpeg_channel(cr - 128.0, chroma_t) + 128.0

    cb, cr = cb - 128.0, cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b_ = y + 1.772 * cb
    out = torch.stack([r, g, b_], dim=-1) / 255.0
    return clip01(out[:, :h0, :w0, :])


def jpeg_pil(imgs: torch.Tensor, quality: int) -> torch.Tensor:
    """PIL's JPEG round trip of NHWC [0, 1] float images, exactly the
    reference's codec. The one host step of the grid: the images go to the
    host and come back to their device."""
    from PIL import Image

    host = imgs.detach().float().cpu().numpy()
    out = np.empty_like(host)
    for i in range(host.shape[0]):
        arr = np.clip(host[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=int(quality))
        buf.seek(0)
        out[i] = np.asarray(Image.open(buf), dtype=np.float32) / 255.0
    return torch.from_numpy(out).to(device=imgs.device, dtype=imgs.dtype)
