"""N-gram extraction over token streams and token grids (PyTorch).

Port of ``wmar_tpu.core.ngrams``: static-shaped gathers in the reference's
iteration order, and dedup as an ``[N, N]`` comparison matrix. Every
function takes any leading batch dimensions: ``codes [..., T]``, where the
JAX functions take ``[T]`` and are vmapped.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wmar_tpu_torch.core.spec import SeedStrategy, WatermarkSpec

Ngrams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def linear_ngrams(codes: torch.Tensor, h: int) -> Ngrams:
    """Sliding (h+1)-grams: ``codes [..., T]`` -> ``(rows [..., N, h+1], keys
    [..., N], targets [..., N])`` with ``N = T - h``; ``keys`` is the context
    sum (the greenlist key)."""
    t = codes.shape[-1]
    n = t - h
    if n < 1:
        raise ValueError(f"Need at least {h + 1} tokens, got {t}")
    rows = codes.unfold(-1, h + 1, 1)  # [B, N, h+1]
    keys = rows[..., :h].to(torch.int64).sum(dim=-1)
    return rows, keys, rows[..., h]


def spatial_ngrams(codes: torch.Tensor, h: int, dim: int) -> Ngrams:
    """Spatial (h+1)-grams over a row-major ``dim x dim`` token grid.

    h=1: every cell but (0,0), context = left neighbour, or the cell above
    in column 0 (N = dim^2 - 1). h=3: every 2x2 block, context (top-left,
    top-right, bottom-left), target bottom-right (N = (dim-1)^2).
    """
    lead = codes.shape[:-1]
    grid = codes.reshape(*lead, dim, dim)
    if h == 1:
        above = torch.roll(grid, 1, dims=-2)
        left = torch.roll(grid, 1, dims=-1)
        j_is_zero = torch.arange(dim, device=codes.device) == 0
        ctx = torch.where(j_is_zero, above, left).reshape(*lead, -1)[..., 1:]
        tgt = grid.reshape(*lead, -1)[..., 1:]
        rows = torch.stack([ctx, tgt], dim=-1)
        return rows, ctx.to(torch.int64), tgt
    if h == 3:
        tl = grid[..., :-1, :-1].reshape(*lead, -1)
        tr = grid[..., :-1, 1:].reshape(*lead, -1)
        bl = grid[..., 1:, :-1].reshape(*lead, -1)
        br = grid[..., 1:, 1:].reshape(*lead, -1)
        rows = torch.stack([tl, tr, bl, br], dim=-1)
        keys = (tl.to(torch.int64) + tr + bl)
        return rows, keys, br
    raise ValueError("spatial n-grams support h in {1, 3} (2x1 and 2x2 blocks)")


def extract_ngrams(spec: WatermarkSpec, codes: torch.Tensor) -> Ngrams:
    """Dispatch on the seed strategy. FIXED scores every token with key 0."""
    if spec.seed_strategy == SeedStrategy.SPATIAL:
        return spatial_ngrams(codes, spec.context_size, spec.spatial_dim)
    if spec.seed_strategy == SeedStrategy.LINEAR:
        return linear_ngrams(codes, spec.context_size)
    h = spec.context_size
    if h == 0:
        return codes[..., None], torch.zeros_like(codes, dtype=torch.int64), codes
    rows, _, targets = linear_ngrams(codes, h)
    return rows, torch.zeros_like(targets, dtype=torch.int64), targets


def first_occurrence_mask(rows: torch.Tensor) -> torch.Tensor:
    """``rows [..., N, w]`` -> ``mask [..., N]``, True iff row ``i`` is the
    first occurrence of its value (the reference's ``Counter`` dedup)."""
    eq = (rows[..., :, None, :] == rows[..., None, :, :]).all(dim=-1)  # [..., N, N]
    n = rows.shape[-2]
    earlier = torch.ones((n, n), dtype=torch.bool, device=rows.device).tril(diagonal=-1)
    return ~(eq & earlier).any(dim=-1)
