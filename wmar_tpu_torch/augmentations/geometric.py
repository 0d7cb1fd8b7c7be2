"""Geometric attacks on NHWC float images in [0, 1] (PyTorch).

Port of ``wmar_tpu.augmentations.geometric``: identity, horizontal flip,
lossless multiples of 90 degrees, rotation and the upper-left crops. Every
function runs on the images' own device.

* ``rotate(angle)`` splits into a lossless multiple-of-90 base rotation
  (floor division, so -20 becomes a base of -90 plus a residual of 70) and a
  residual rotation about the centre without expansion: an inverse map
  rounded half to even, a gather and a zero fill.
* the crops keep the upper-left ``factor`` of each side, then either resize
  back (bilinear, antialiased) or zero-pad back.

``resize_linear`` and ``resize_cubic`` are ``jax.image.resize``'s
"linear" and "bicubic".
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def identity(imgs: torch.Tensor) -> torch.Tensor:
    return imgs


def hflip(imgs: torch.Tensor) -> torch.Tensor:
    return torch.flip(imgs, dims=(2,))


def rot90_multiple(imgs: torch.Tensor, k: int) -> torch.Tensor:
    """Lossless rotation by ``k`` * 90 degrees counter-clockwise (numpy's
    direction, as ``jnp.rot90``)."""
    return torch.rot90(imgs, k % 4, dims=(1, 2))


def _rotate_residual(imgs: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Rotate by ``angle_deg`` counter-clockwise about the image centre, no
    expansion, nearest neighbour, zero fill."""
    if angle_deg == 0:
        return imgs
    _, h, w, _ = imgs.shape
    theta = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32, device=imgs.device))
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=imgs.device),
                            torch.arange(w, dtype=torch.float32, device=imgs.device), indexing="ij")
    # inverse map: the output pixel takes the source pixel rotated by -theta
    y0, x0 = yy - cy, xx - cx
    src_y = cos * y0 + sin * x0 + cy
    src_x = -sin * y0 + cos * x0 + cx
    iy = torch.round(src_y).to(torch.int64)
    ix = torch.round(src_x).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = imgs[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1), :]
    return torch.where(valid[None, :, :, None], out, torch.zeros((), dtype=imgs.dtype, device=imgs.device))


def rotate(imgs: torch.Tensor, angle: float) -> torch.Tensor:
    """The reference's rotation: a lossless base of a multiple of 90 degrees
    plus the residual."""
    base = int(angle // 90 * 90)
    residual = float(angle) - base
    if base:
        imgs = rot90_multiple(imgs, base // 90)
    return _rotate_residual(imgs, residual)


def upper_left_crop(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    """Keep the upper-left ``factor`` of each side."""
    h, w = imgs.shape[1:3]
    return imgs[:, : int(factor * h), : int(factor * w), :]


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(n_in: int, n_out: int, kernel=_triangle, device=None) -> torch.Tensor:
    """``[n_out, n_in]`` weights of ``jax.image.resize`` along one axis
    (``_compute_weight_mat``): half-pixel centres, the kernel widened by the
    scale when it shrinks (antialiasing), each row normalized over the taps
    inside the image (so an edge repeats its pixel, as an upsampling
    ``F.interpolate`` clamps)."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    w = kernel((sample[:, None] - torch.arange(n_in, dtype=torch.float32, device=device)[None, :]).abs() / kscale)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=256)
def _cached_weights(n_in: int, n_out: int, kernel, device, dtype) -> torch.Tensor:
    with torch.inference_mode(False):  # a plain tensor, which a later backward may save
        return resize_weights(n_in, n_out, kernel, device).to(dtype)


def _resize(imgs: torch.Tensor, size, kernel) -> torch.Tensor:
    """Separable resize of the two spatial axes of NHWC images by weight
    matrices (built once per shape and device): two products, whose backward
    is deterministic on the card."""
    wh = _cached_weights(imgs.shape[1], size[0], kernel, imgs.device, imgs.dtype)
    ww = _cached_weights(imgs.shape[2], size[1], kernel, imgs.device, imgs.dtype)
    return torch.einsum("yh,bhwc->bywc", wh, torch.einsum("xw,bhwc->bhxc", ww, imgs))


def resize_linear(imgs: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., method="linear")`` (antialiased when
    shrinking) of NHWC images to ``size = (H, W)``: ``F.interpolate``, or,
    under ``torch.use_deterministic_algorithms``, the weight matrices
    (``F.interpolate``'s backward adds atomically on the card)."""
    if torch.are_deterministic_algorithms_enabled():
        return _resize(imgs, size, _triangle)
    x = F.interpolate(imgs.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


def _up_axis(x: torch.Tensor, factor: int, dim: int) -> torch.Tensor:
    """Bilinear upsampling by an integer ``factor`` along ``dim``: output
    ``factor * i + r`` samples ``i + (r + 0.5) / factor - 0.5``, two taps of
    the neighbours with the edges repeated (slices, so the backward adds no
    atomics)."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    phases = []
    for r in range(factor):
        d = (r + 0.5) / factor - 0.5
        phases.append(-d * prev + (1 + d) * x if d < 0 else (1 - d) * x + d * nxt if d > 0 else x)
    return torch.stack(phases, dim + 1).flatten(dim, dim + 1)


def bilinear_up_nchw(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``nn.Upsample(scale_factor=factor, mode="bilinear",
    align_corners=False)`` of NCHW maps (upsampling: no antialiasing, the
    edges repeated); under ``torch.use_deterministic_algorithms`` by slices,
    whose backward is deterministic on the card."""
    if torch.are_deterministic_algorithms_enabled():
        return _up_axis(_up_axis(x, factor, 2), factor, 3)
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def resize_cubic(imgs: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., method="bicubic")`` of NHWC images to
    ``size = (H, W)``: Keys' a = -0.5 kernel, no edge clamping (the taps
    that fall outside are dropped and the rest renormalized), unlike
    ``F.interpolate``'s bicubic."""
    return _resize(imgs.float(), size, _keys_cubic)


def upper_left_crop_resize_back(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    if factor >= 1.0:
        return imgs
    return resize_linear(upper_left_crop(imgs, factor), imgs.shape[1:3])


def upper_left_crop_pad_back(imgs: torch.Tensor, factor: float) -> torch.Tensor:
    if factor >= 1.0:
        return imgs
    h, w = imgs.shape[1:3]
    cropped = upper_left_crop(imgs, factor)
    return F.pad(cropped, (0, 0, 0, w - cropped.shape[2], 0, h - cropped.shape[1]))
