"""Sampler primitives: watermark logit bias, top-k/top-p warps, CFG (PyTorch).

Port of ``wmar_tpu.core.sampling``. Step indices and lengths may be 0-d
device tensors, so the decode loop never waits on the host: every index
here goes through ``index_select`` on a 1-element index tensor, never
through a Python int read back from the device.

A categorical draw is ``argmax(logits + gumbel)``, as in
``jax.random.categorical``. The noise is either passed in (the tests feed
JAX's own Gumbel noise) or drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from wmar_tpu_torch.core.spec import SeedStrategy, WatermarkSpec

NEG_INF = float(-1e10)

IntLike = Union[int, torch.Tensor]


def _as_index(x: IntLike, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(torch.int64)
    return torch.full((1,), int(x), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Watermark bias (sampler side)
# ---------------------------------------------------------------------------


def context_keys_at_step(spec: WatermarkSpec, buffer: torch.Tensor, length: IntLike, image_pos: IntLike):
    """Greenlist key and validity for the token about to be sampled.

    ``buffer`` is the int ``[B, L]`` past-token buffer, ``length`` the number
    of valid tokens in it and ``image_pos`` the index of the image token
    being generated. Returns ``(keys [B] int64, valid 0-d bool tensor)``.
    """
    h = spec.context_size
    dev = buffer.device
    b = buffer.shape[0]
    if spec.seed_strategy == SeedStrategy.FIXED:
        return torch.zeros((b,), dtype=torch.int64, device=dev), torch.ones((), dtype=torch.bool, device=dev)

    length = _as_index(length, dev)
    if spec.seed_strategy == SeedStrategy.LINEAR:
        valid = (length >= h).reshape(())
        idx = torch.clamp(length - h, min=0) + torch.arange(h, device=dev)
        ctx = buffer.index_select(1, idx)  # [B, h]
        return ctx.to(torch.int64).sum(dim=1), valid

    image_pos = _as_index(image_pos, dev)
    dim = spec.spatial_dim
    if h == 1:
        valid = (image_pos >= 1).reshape(())
        off = torch.where(image_pos % dim == 0, dim, 1)
        idx = torch.clamp(length - off, min=0)
        return buffer.index_select(1, idx)[:, 0].to(torch.int64), valid
    if h == 3:
        valid = (image_pos >= dim + 1).reshape(())
        idx = torch.cat([length - (dim + 1), length - dim, length - 1]).clamp(min=0)
        return buffer.index_select(1, idx).to(torch.int64).sum(dim=1), valid
    raise ValueError("spatial seeding supports h in {1, 3}")


def apply_watermark_bias(spec: WatermarkSpec, greenlist, logits: torch.Tensor, keys: torch.Tensor, valid) -> torch.Tensor:
    """``logits[b, t] += delta`` where token t is green for ``keys[b]``;
    ``valid`` gates the whole step (underfull context window)."""
    v = spec.vocab_size
    if logits.shape[-1] != v:
        raise ValueError(f"logits width {logits.shape[-1]} != vocab {v}")
    mask = greenlist.green_mask(keys).to(logits.dtype)  # [B, V]
    delta = torch.where(valid, spec.delta, 0.0).to(logits.dtype)
    return logits + delta * mask


# ---------------------------------------------------------------------------
# Warping + sampling
# ---------------------------------------------------------------------------


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def warp_and_sample(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    greedy: bool = False,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Temperature -> top-k -> top-p -> categorical draw. ``[B, V] -> [B]``.

    ``noise [B, k]`` is the Gumbel noise of the draw over the ``k`` kept
    logits (``k = min(top_k, V)``, or ``V``); without it the noise comes from
    ``generator``. Ties keep the order ``lax.top_k`` gives them.
    """
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    if temperature != 1.0:
        logits = logits / temperature

    k = min(top_k, v) if top_k else v
    if greedy and (top_p is None or top_p >= 1.0):
        return torch.argmax(logits, dim=-1)

    # lax.top_k orders floats totally (+0 above -0): sort their bits, mapped
    # to ints of the same order, stably, so equal logits keep index order
    bits = logits.view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(order, dim=-1, descending=True, stable=True).indices[:, :k]
    vals = torch.gather(logits, 1, idx)
    if top_p is not None and top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # HF semantics: drop tokens once the mass *before* them exceeds top_p
        keep = (cum - probs) <= top_p
        vals = torch.where(keep, vals, NEG_INF)

    if greedy:
        choice = torch.argmax(vals, dim=-1)
    else:
        if noise is None:
            noise = gumbel_noise(vals.shape, generator, vals.device)
        choice = torch.argmax(noise.to(torch.float32) + vals, dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Classifier-free guidance
# ---------------------------------------------------------------------------


def cfg_combine(cond_logits: torch.Tensor, uncond_logits: torch.Tensor, scale) -> torch.Tensor:
    """Standard 2-branch CFG: ``uncond + (cond - uncond) * scale``."""
    return uncond_logits + (cond_logits - uncond_logits) * scale


def rar_cfg_scale(step: torch.Tensor, seq_len: int, guidance_scale: float, guidance_scale_pow: float) -> torch.Tensor:
    """RAR's cosine-annealed guidance schedule:
    ``1 + (g - 1) * (1 - cos(pi * (step/seq_len)^pow)) / 2``."""
    frac = (step.to(torch.float32) / seq_len) ** guidance_scale_pow
    scale_step = (1.0 - torch.cos(frac * math.pi)) * 0.5
    return (guidance_scale - 1.0) * scale_step + 1.0


def instruct_cfg_combine(full_logits, image_cond_logits, uncond_logits, guidance_text: float, guidance_image: float):
    """Chameleon's 3-branch instruct CFG."""
    return (
        uncond_logits
        + guidance_image * (image_cond_logits - uncond_logits)
        + guidance_text * (full_logits - image_cond_logits)
    )
