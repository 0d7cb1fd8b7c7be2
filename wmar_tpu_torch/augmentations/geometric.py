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
"""

from __future__ import annotations

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


def resize_linear(imgs: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., method="linear")`` (antialiased when
    shrinking) of NHWC images to ``size = (H, W)``."""
    x = imgs.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


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
