"""Homography estimation and perspective warping (PyTorch port of
``wmar_tpu.sync.homography``): SyncSeal's unwarp path.

The 4-point homography is solved as a batched 8x8 linear system in float32
and the image is resampled with an explicit 4-tap bilinear gather: taps
outside the image read ``fill``, the projective divide is by ``w + 1e-8``,
as in JAX (``grid_sample`` would round the border taps otherwise).

Convention: points are (x, y) in pixels, corner order TL, TR, BL, BR.
"""

from __future__ import annotations

import torch


def solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """H mapping src -> dst. ``src, dst: [B, 4, 2]`` -> ``[B, 3, 3]``: the
    DLT system ``A h = b`` for h = (h11..h32), h33 = 1."""
    src, dst = src.float(), dst.float()
    x, y = src[..., 0], src[..., 1]  # [B, 4]
    u, v = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)  # [B, 4, 8]
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    a = torch.stack([rows_u, rows_v], dim=2).reshape(-1, 8, 8)  # rows interleaved u0 v0 u1 v1 ...
    b = torch.stack([u, v], dim=2).reshape(-1, 8)
    h = torch.linalg.solve(a, b)
    return torch.cat([h, torch.ones_like(h[:, :1])], dim=1).reshape(-1, 3, 3)


def warp_perspective(imgs: torch.Tensor, h_matrix: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Bilinear perspective warp of ``imgs [B, H, W, C]``; ``h_matrix [B, 3,
    3]`` maps OUTPUT pixel coordinates to SOURCE ones (inverse warp)."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1).reshape(-1, 3)  # [HW, 3]
    src = grid @ h_matrix.float().transpose(1, 2)  # [B, HW, 3]
    sx = src[..., 0] / (src[..., 2] + 1e-8)
    sy = src[..., 1] / (src[..., 2] + 1e-8)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = imgs.reshape(b, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B, HW]
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], vals, torch.full_like(vals, fill))

    out = (gather(y0i, x0i) * (1 - fx) * (1 - fy) + gather(y0i, x0i + 1) * fx * (1 - fy)
           + gather(y0i + 1, x0i) * (1 - fx) * fy + gather(y0i + 1, x0i + 1) * fx * fy)
    return out.reshape(b, h, w, c)


def unwarp_from_corners(imgs: torch.Tensor, pred_corners: torch.Tensor) -> torch.Tensor:
    """Undo a geometric attack given where the original TL/TR/BL/BR corners
    ended up (``pred_corners [B, 4, 2]``, normalized (x, y) in [0, 1]): warp
    them back to the image corners (the reference's ``SyncModelJIT.unwarp``)."""
    b, h, w, _ = imgs.shape
    scale = torch.tensor([w - 1.0, h - 1.0], device=imgs.device)
    canon = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]],
                         device=imgs.device).expand(b, 4, 2)
    # inverse warp: each output (canonical) pixel samples the attacked image
    return warp_perspective(imgs, solve_homography(canon, pred_corners.float() * scale))
