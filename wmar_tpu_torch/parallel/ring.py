"""Ring-attention sequence-parallel prefill over the ``sp`` axis (PyTorch).

Port of ``wmar_tpu.parallel.ring``. The reference prefills the whole prompt
on every worker (``deps/chameleon/inference/generation.py``). Here the
prompt's sequence is cut over the ``sp`` ranks: each rank keeps its query
block and the key/value blocks go round the ring, ``sp`` hops, while an
online softmax in float32 gathers the output (Liu et al., "Ring Attention
with Blockwise Transformers"). JAX's body is plain ``jnp`` inside
``shard_map``, with no Pallas kernel; the port's is plain PyTorch with one
:func:`~wmar_tpu_torch.parallel.mesh.ring_exchange` a hop.

Masking is JAX's, that of :func:`wmar_tpu_torch.engine.attention.
decode_attention`'s multi-token burst at write position 0: causal on the
absolute key index, the per-row ``start`` (left padding of right-aligned
ragged prompts) and the per-position ``key_mask`` (Chameleon's CFG rows
over one token history). A query with no valid key gives 0. The blocks'
rows and heads are whatever the rank holds (a dp rank's rows, a tp rank's
heads): the attention is per row and per head, so those axes need no
collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from wmar_tpu_torch.parallel.mesh import Mesh, ring_exchange

NEG_INF = -1e30


def sequence_block(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 1, sp_axis: str = "sp") -> torch.Tensor:
    """This rank's block of ``x``'s sequence axis ``dim``; raises where the
    length does not split over the ``sp`` ranks, as JAX does."""
    n, i = (mesh.size_of(sp_axis), mesh.axis_index(sp_axis)) if mesh is not None else (1, 0)
    t = x.shape[dim]
    if t % n:
        raise ValueError(f"seq len {t} not divisible by sp={n}")
    return x.narrow(dim, i * (t // n), t // n)


def ring_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Optional[Mesh], *,
                           sp_axis: str = "sp", start: Optional[torch.Tensor] = None,
                           key_mask: Optional[torch.Tensor] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Causal prefill attention of this rank's block of the sequence.

    ``q, k, v [B, H, T/sp, D]``: the rank's block (positions ``[i T/sp,
    (i + 1) T/sp)`` of rank ``i`` of ``sp_axis``); ``start [B]``: the first
    valid key index of each row; ``key_mask [B, T]``: the validity of every
    key of the whole sequence (every rank holds it: it is the prompt's).
    Returns the rank's ``[B, H, T/sp, D]`` outputs in ``q``'s dtype. The
    scores are taken in ``q``'s dtype and gathered in float32, as in JAX.
    """
    b, h, tl, d = q.shape
    n, me = (mesh.size_of(sp_axis), mesh.axis_index(sp_axis)) if mesh is not None else (1, 0)
    if key_mask is not None and key_mask.shape[1] != n * tl:
        raise ValueError(f"key_mask of {key_mask.shape[1]} keys for {n} blocks of {tl}")
    scale = scale if scale is not None else d**-0.5
    dev = q.device
    qidx = me * tl + torch.arange(tl, device=dev)
    start = start if start is not None else torch.zeros((b,), dtype=torch.int64, device=dev)
    o = torch.zeros((b, h, tl, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for hop in range(n):
        src = (me - hop) % n  # the rank whose key block this rank holds at this hop
        kidx = src * tl + torch.arange(tl, device=dev)
        ok = (kidx[None, None, :] <= qidx[None, :, None]) & (kidx[None, None, :] >= start[:, None, None])
        if key_mask is not None:
            ok = ok & key_mask[:, kidx][:, None, :]
        okb = ok[:, None]  # [B, 1, Tq, Tk]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kv[0]).to(torch.float32) * scale
        s = torch.where(okb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # times the mask, so that a query with no valid key keeps l = 0 and o = 0
        p = torch.exp(s - m_new[..., None]) * okb
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p.to(kv.dtype), kv[1]).to(torch.float32)
        m = m_new
        if hop + 1 < n:
            kv = ring_exchange(kv, mesh, sp_axis)
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
