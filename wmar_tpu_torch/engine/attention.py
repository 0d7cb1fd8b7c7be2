"""Attention for prefill and decode (PyTorch).

Port of ``wmar_tpu.engine.attention``. Decode attends the new query tokens
against the padded cache with a length mask (masked slots get -1e30, as in
the JAX package). Single-token steps on a ``Packed4QuantKVCache`` go to the
hand-written CUDA kernel (:mod:`wmar_tpu_torch.ops.flash_decode`); every
other case runs the plain torch path on the dequantized ``cache.layer()``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(-1e30)


def _promoted(*xs: torch.Tensor):
    """Cast to one dtype by JAX's promotion rule (torch's einsum refuses mixed dtypes)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def cached_decode_attention(q, cache, layer: int, valid_len, start=None, key_mask=None):
    """Decode attention against ``cache``, dispatching on the cache type."""
    from wmar_tpu_torch.engine.kvcache import Packed4QuantKVCache

    if isinstance(cache, Packed4QuantKVCache) and q.shape[2] == 1 and q.shape[1] == cache.n_heads:
        from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention

        return packed4_decode_attention(q, cache.kv, cache.scale, layer, valid_len,
                                        start=start, key_mask=key_mask)
    k_all, v_all = cache.layer(layer)
    return decode_attention(q, k_all, v_all, valid_len, start=start, key_mask=key_mask)


def prefill_attention(q, k, v, causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Full self-attention over the prompt. ``q, k, v: [B, H, T, D]``."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    q, k = _promoted(q, k)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        t = q.shape[2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, valid_len, scale: Optional[float] = None,
                     start=None, key_mask=None) -> torch.Tensor:
    """Decode attention of ``q [B, H, t, D]`` against ``[B, H, T_max, D]``
    caches whose first ``valid_len`` slots (the new tokens included) hold
    data. With ``t > 1`` (a burst through the cache) query ``i`` sits at
    slot ``valid_len - t + i`` and is causal within the burst. ``start [B]``
    masks left padding; ``key_mask [B, T_max]`` masks slots per row.
    Returns ``[B, H, t, D]`` in the cache's dtype, as the JAX path does.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    qc, kc = _promoted(q, k_cache)
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kc).to(torch.float32) * scale
    t_max = k_cache.shape[2]
    b, t = q.shape[0], q.shape[2]
    ar = torch.arange(t_max, device=q.device)
    valid_len = torch.as_tensor(valid_len, device=q.device).reshape(())
    if t > 1:
        qpos = valid_len - t + torch.arange(t, device=q.device)  # [t]
        pos_ok = (ar[None, :] <= qpos[:, None]).expand(b, t, t_max)
    else:
        pos_ok = (ar < valid_len).expand(b, 1, t_max)
    if start is not None:
        pos_ok = pos_ok & (ar[None, None, :] >= start[:, None, None])
    if key_mask is not None:
        pos_ok = pos_ok & key_mask[:, None, :]
    s = torch.where(pos_ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
