"""Llama-style transformer, the Chameleon/Anole-7B backbone (PyTorch).

Port of ``wmar_tpu.models.llama``: RMSNorm pre-norm blocks, rotary
embeddings on adjacent pairs, SwiGLU FFN, optional per-head qk-LayerNorm
(the Chameleon setting), GQA-capable, with a preallocated KV cache and
per-row start offsets for right-aligned ragged prompts.

Parameters stay the JAX package's tree: a dict ``{"tok_embeddings",
"blocks": [...], "norm", "output"}`` of tensors with matrices ``[n_in,
n_out]``, where a weight-only-int8 matrix is a ``{"q", "s"}`` dict
(:func:`quantize_llama_params_int8`). :func:`wmar_tpu_torch.bridge.load_llama`
turns a JAX tree into one.

Single-token decode on the packed caches goes to the hand-written CUDA
kernels through :func:`wmar_tpu_torch.engine.attention.cached_decode_attention`
(the chunked ones at Chameleon's ~1043 slots, with the per-row ``start``);
on a float or int8 cache of 2048 slots or more it goes to the flash-decode
kernels (:func:`wmar_tpu_torch.ops.flash_decode.flash_decode_attention` and
``..._q8``), as in JAX: that is the interleaved path, whose three CFG rows
share one long cache behind a per-row ``key_mask``. ``USE_FLASH_DECODE``
forces that route on or off.

Tensor parallelism is Megatron's, as JAX's ``llama_tp_specs`` shards it:
:func:`llama_tp_specs` gives the specs, ``parallel.apply_specs`` cuts a
rank's shard, and :func:`llama_forward` with ``mesh`` runs that shard with
the collectives the reference issues (``deps/chameleon/inference/
transformer.py:159,220``): wq/wk/wv/w1/w3 column-parallel (this rank's
heads and hidden units), wo and w2 row-parallel with an all-reduce after
each, the embedding vocab-parallel (ids outside this rank's rows masked,
then an all-reduce) and the vocab head column-parallel, its logits
all-gathered, so the sampler sees the whole vocabulary. The qk-norms are
per head over ``head_dim`` and replicate. Grouped-int4 weights keep their
bytes: ``w2`` splits its within-group byte axis as JAX's spec does, so
``w1`` and ``w3`` take the strided hidden units whose rows those bytes
hold, and ``wo`` splits its group axis, whole heads (see
:func:`llama_tp_specs`); kernel #8 then runs on the rank's slices.

:func:`llama_prefill_sp` is the sequence-parallel prefill (ring attention
over ``sp``, :mod:`wmar_tpu_torch.parallel.ring`);
:mod:`wmar_tpu_torch.parallel.pipeline` holds the pipeline-parallel one.

Chameleon-7B config: dim 4096, 32 layers/heads, ffn 11008, qk_normalization,
vocab 65536.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wmar_tpu_torch.engine.attention import cached_decode_attention, decode_attention
from wmar_tpu_torch.engine.kvcache import Packed4QuantKVCache, PackedQuantKVCache, QuantKVCache
from wmar_tpu_torch.ops import wquant
from wmar_tpu_torch.ops.flash_decode import flash_decode_attention, flash_decode_attention_q8
from wmar_tpu_torch.parallel.mesh import P, all_gather, all_reduce
from wmar_tpu_torch.parallel.ring import ring_prefill_attention, sequence_block

# The flash-decode kernels for single-token steps over a float or int8
# cache. None = auto: the kernels when the cache has >= 2048 slots, the
# plain attention below; True / False force (tests and bench tooling set
# the module flag directly).
USE_FLASH_DECODE = None
FLASH_DECODE_MIN_CACHE = 2048


def _flash_enabled(cache_len: int) -> bool:
    if USE_FLASH_DECODE is not None:
        return USE_FLASH_DECODE
    return cache_len >= FLASH_DECODE_MIN_CACHE


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None
    vocab_size: int = 65536
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    qk_normalization: bool = True
    layer_scale: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)


CHAMELEON_7B = LlamaConfig()


@torch.no_grad()
def init_llama_params(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random weights from ``generator`` by the JAX init's rules: matrices
    ``N(0, 1/n_in)``, embeddings ``N(0, 0.02^2)``, unit norms, qk-norm
    scales 1 and biases 0, LayerScale 1e-4."""

    def mat(n_in, n_out, std=None):
        w = torch.randn((n_in, n_out), generator=generator, device=device, dtype=torch.float32)
        return (w * (std if std is not None else n_in**-0.5)).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    d, hd = cfg.dim, cfg.head_dim
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {
            "attention_norm": full(d, 1.0),
            "ffn_norm": full(d, 1.0),
            "wq": mat(d, cfg.n_heads * hd),
            "wk": mat(d, cfg.kv_heads * hd),
            "wv": mat(d, cfg.kv_heads * hd),
            "wo": mat(cfg.n_heads * hd, d),
            "w1": mat(d, cfg.ffn_hidden),
            "w3": mat(d, cfg.ffn_hidden),
            "w2": mat(cfg.ffn_hidden, d),
        }
        if cfg.qk_normalization:
            blk["q_norm"] = {"scale": full(hd, 1.0), "bias": full(hd, 0.0)}
            blk["k_norm"] = {"scale": full(hd, 1.0), "bias": full(hd, 0.0)}
        if cfg.layer_scale:
            blk["ls1"] = full(d, 1e-4)
            blk["ls2"] = full(d, 1e-4)
        blocks.append(blk)
    return {
        "tok_embeddings": mat(cfg.vocab_size, d, std=0.02),
        "blocks": blocks,
        "norm": full(d, 1.0),
        "output": mat(d, cfg.vocab_size),
    }


def _rms(x, scale, eps):
    var = (x.to(torch.float32) ** 2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _ln(x, p, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def rope_angles(positions: torch.Tensor, d: int, theta: float):
    """``(cos, sin)`` of shape ``[B, t, 1, d/2]`` for ``positions [B, t]``."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    xr = x.reshape(b, t, h, d // 2, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(b, t, h, d).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Llama rotary embedding on adjacent pairs ``(x[2i], x[2i+1])``.
    ``x [B, t, H, D]``, ``positions [B, t]`` (per row, so left padding
    shifts correctly)."""
    return _rotate(x, *rope_angles(positions, x.shape[-1], theta))


def block_attn_inputs(blk, cfg: LlamaConfig, x: torch.Tensor, positions: torch.Tensor, rope=None):
    """Pre-attention half of one block: norms, qkv projections, rope, GQA
    head repeat. ``x [B, t, dim]`` -> ``q, k, v [B, H, t, D]``. ``rope``:
    the ``(cos, sin)`` of :func:`rope_angles`, shared by a forward's layers."""
    b, t = x.shape[:2]
    h = _rms(x, blk["attention_norm"], cfg.norm_eps)
    # head counts from the projections: a tensor-parallel rank holds its share
    q = wquant.matmul(h, blk["wq"]).reshape(b, t, -1, cfg.head_dim)
    k = wquant.matmul(h, blk["wk"]).reshape(b, t, -1, cfg.head_dim)
    v = wquant.matmul(h, blk["wv"]).reshape(b, t, -1, cfg.head_dim)
    n_rep = q.shape[2] // k.shape[2]
    if cfg.qk_normalization:
        q = _ln(q, blk["q_norm"], cfg.norm_eps)
        k = _ln(k, blk["k_norm"], cfg.norm_eps)
    cos, sin = rope if rope is not None else rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = _rotate(q, cos, sin)
    k = _rotate(k, cos, sin)
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def block_finish(blk, cfg: LlamaConfig, x: torch.Tensor, attn: torch.Tensor, mesh=None) -> torch.Tensor:
    """Post-attention half of one block: output projection, residuals,
    SwiGLU FFN, optional LayerScale. ``attn [B, H, t, D]`` -> new ``x``.
    With a tensor-parallel ``mesh`` the two row-parallel products are summed
    over the tp ranks before their residual."""
    b, t = x.shape[:2]
    attn = attn.transpose(1, 2).reshape(b, t, -1)
    attn_out = all_reduce(wquant.matmul(attn, blk["wo"]), mesh)
    x = x + (blk["ls1"] * attn_out if cfg.layer_scale else attn_out)
    h2 = _rms(x, blk["ffn_norm"], cfg.norm_eps)
    ffn_out = wquant.matmul(F.silu(wquant.matmul(h2, blk["w1"])) * wquant.matmul(h2, blk["w3"]), blk["w2"])
    ffn_out = all_reduce(ffn_out, mesh)
    return x + (blk["ls2"] * ffn_out if cfg.layer_scale else ffn_out)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """``table[tokens]``; on a tensor-parallel rank ``table`` holds its rows
    of the vocabulary: ids outside them give zeros, and the sum over the tp
    ranks (one rank contributes each row) is the lookup."""
    if mesh is None or mesh.tp == 1:
        return table[tokens]
    n = table.shape[0]
    local = tokens - mesh.axis_index("tp") * n
    mine = (local >= 0) & (local < n)
    x = torch.where(mine[..., None], table[local.clamp(0, n - 1)], torch.zeros((), dtype=table.dtype,
                                                                              device=table.device))
    return all_reduce(x, mesh)


def _cache_attention(q, cache, li, valid_len, start, key_mask):
    if isinstance(cache, (PackedQuantKVCache, Packed4QuantKVCache)):
        return cached_decode_attention(q, cache, li, valid_len, start=start, key_mask=key_mask)
    if q.shape[2] == 1 and _flash_enabled(cache.max_len):
        if isinstance(cache, QuantKVCache):
            return flash_decode_attention_q8(q, cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li],
                                             valid_len, start=start, key_mask=key_mask)
        return flash_decode_attention(q, cache.k[li], cache.v[li], valid_len, start=start, key_mask=key_mask)
    k_all, v_all = cache.layer(li)
    return decode_attention(q, k_all, v_all, valid_len, start=start, key_mask=key_mask)


def llama_forward(
    params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    cache,
    write_pos,
    positions: torch.Tensor,
    start: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, object]:
    """Forward ``tokens [B, t]`` written into the cache at ``write_pos`` (an
    int or a 0-d device tensor).

    ``positions [B, t]``: rope positions (prompt-relative, pads excluded).
    ``start [B]``: first valid cache index per row (left-pad masking).
    ``key_mask [B, T_max]``: optional per-slot validity. The cache is
    updated in place. Returns ``(logits [B, t, vocab] float32, cache)``.
    With a tensor-parallel ``mesh`` (``parallel.Mesh``), ``params`` are
    this rank's shard (:func:`llama_tp_specs`) and ``cache`` holds this
    rank's heads; every tp rank calls this with the same tokens and gets
    the whole vocabulary's logits.
    """
    t = tokens.shape[1]
    x = embed_tokens(params["tok_embeddings"], tokens, mesh)
    valid_len = write_pos + t
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.to(torch.int32)  # one cast per forward, read by every layer's kernel
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = block_attn_inputs(blk, cfg, x, positions, rope)
        cache = cache.write(li, write_pos, k, v)
        attn = _cache_attention(q.contiguous(), cache, li, valid_len, start, key_mask)
        x = block_finish(blk, cfg, x, attn, mesh)
    x = _rms(x, params["norm"], cfg.norm_eps)
    return all_gather(wquant.matmul(x, params["output"]).to(torch.float32), mesh), cache


def llama_prefill_sp(params, cfg: LlamaConfig, tokens: torch.Tensor, cache, positions: torch.Tensor, mesh, *,
                     sp_axis: str = "sp", start: Optional[torch.Tensor] = None,
                     key_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, object]:
    """Sequence-parallel prefill: :func:`llama_forward` at write position 0
    with ring attention over ``sp_axis`` of ``mesh``, JAX's
    ``llama_prefill_sp``.

    Every rank of the ``sp`` line calls this with the whole ``tokens,
    positions [B, T]`` (``T`` a multiple of the ``sp`` size: pad the
    prompt, and mask the pads by ``start`` / ``key_mask``). The
    position-wise layers run on this rank's ``T/sp`` positions and the
    attention goes round the ring; before each layer's cache write the
    ranks' K/V blocks are all-gathered over ``sp``, so that every rank
    writes, and quantizes, the whole block a one-rank prefill writes. The
    logits ``[B, T, vocab]`` float32 are gathered too: every rank holds all
    of them, and the decode after the prefill runs on every rank. Under
    ``tp`` the ranks hold their Megatron shard, as in
    :func:`llama_forward`."""
    t = tokens.shape[1]
    km = key_mask[:, :t] if key_mask is not None else None
    tokens_l = sequence_block(tokens, mesh, 1, sp_axis)
    positions_l = sequence_block(positions, mesh, 1, sp_axis)
    x = embed_tokens(params["tok_embeddings"], tokens_l, mesh)
    rope = rope_angles(positions_l, cfg.head_dim, cfg.rope_theta)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = block_attn_inputs(blk, cfg, x, positions_l, rope)
        kv = all_gather(torch.stack([k, v]), mesh, sp_axis, dim=3)  # [2, B, H, T, D]
        cache = cache.write(li, 0, kv[0], kv[1])
        attn = ring_prefill_attention(q.contiguous(), k, v, mesh, sp_axis=sp_axis, start=start, key_mask=km)
        x = block_finish(blk, cfg, x, attn, mesh)
    x = _rms(x, params["norm"], cfg.norm_eps)
    logits = all_gather(wquant.matmul(x, params["output"]).to(torch.float32), mesh)
    return all_gather(logits, mesh, sp_axis, dim=1), cache


WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


@torch.no_grad()
def quantize_llama_params_int8(params, compute_dtype=None, bits: int = 8) -> dict:
    """Weight-only int8 for every block linear and the vocab head: each
    matrix becomes ``{"q": int8, "s": bf16 [n_out]}``, bit-identical to the
    JAX function's; ``bits=4`` makes grouped-int4 ``{"q4", "s4"}`` matrices
    (kernel #8) instead. ``tok_embeddings`` stays float (a gather, not a
    matmul). With ``compute_dtype`` the float leaves are cast to it."""
    out = dict(params)
    out["blocks"] = [
        {k: (wquant.quantize_matrix(v, bits=bits) if k in WEIGHT_KEYS else v) for k, v in blk.items()}
        for blk in params["blocks"]
    ]
    out["output"] = wquant.quantize_matrix(params["output"], bits=bits)
    if compute_dtype is not None:
        out["tok_embeddings"] = params["tok_embeddings"].to(compute_dtype)
        out["norm"] = params["norm"].to(compute_dtype)
        out["blocks"] = wquant.cast_float_leaves(out["blocks"], compute_dtype)
    return out


def int4_row_split(gc: int, group: int, tp: int) -> Tuple[int, int]:
    """How a row-parallel grouped-int4 matrix of ``gc`` groups of ``group``
    rows splits over ``tp`` ranks: ``(a, b)``, ``a`` ways along the group
    axis and ``b`` along the within-group byte axis, ``a * b = tp``. ``b``
    is the largest factor of ``tp`` that leaves a rank groups of 128, 64 or
    32 rows (kernel #8's sizes: ``group / b``) and ``a`` a divisor of
    ``gc``: JAX's byte-axis split (``b = tp``) at tp 2 and 4 over groups
    of 128; at tp 8, 2 ways by groups and 4 by bytes (groups of 32 a rank).
    Raises ``ValueError`` where no factor does."""
    for b in sorted((f for f in range(1, tp + 1) if tp % f == 0), reverse=True):
        if group % (2 * b) == 0 and group // b in wquant.GROUPS and gc % (tp // b) == 0:
            return tp // b, b
    raise ValueError(f"a grouped-int4 matrix of {gc} groups of {group} rows has no split over tp={tp} that leaves "
                     f"each rank whole groups of {wquant.GROUPS}")


def int4_hidden_units(gc: int, group: int, tp: int, rank: int) -> torch.Tensor:
    """The input rows of a row-parallel grouped-int4 matrix (``gc`` groups
    of ``group``) that tp rank ``rank`` holds under :func:`int4_row_split`,
    in the order of its slice: for each of its groups, the low-nibble rows
    of its bytes, then their high-nibble rows (``i`` and ``i + group/2``).
    The column-parallel product before it must give these units, in this
    order."""
    a, b = int4_row_split(gc, group, tp)
    ra, rb = divmod(rank, b)
    half, per = group // 2, group // (2 * b)
    groups = torch.arange(ra * (gc // a), (ra + 1) * (gc // a))
    j = rb * per + torch.arange(per)
    return (groups[:, None, None] * group + torch.tensor([0, half])[None, :, None] + j[None, None, :]).reshape(-1)


def int4_row_specs(gc: int, group: int) -> dict:
    """The specs of a row-parallel grouped-int4 leaf of ``gc`` groups of
    ``group`` rows: a rank keeps its groups and, of each, its bytes
    (:func:`int4_row_split`); the scales go with the groups."""

    def cut(mesh, w):
        a, b = int4_row_split(gc, group, mesh.tp)
        ra, rb = divmod(mesh.axis_index("tp"), b)
        w = w[ra * (gc // a):(ra + 1) * (gc // a)]
        per = group // (2 * b)
        return w[:, rb * per:(rb + 1) * per] if w.dim() == 3 else w

    return {"q4": cut, "s4": cut}


def _units_spec(gc: int, group: int):
    """The spec of a column-parallel leaf (any form: its last dim is the
    output) that feeds a row-parallel grouped-int4 matrix of ``gc`` groups
    of ``group``: the rank's strided hidden units (:func:`int4_hidden_units`)."""

    def take(mesh, w):
        return w.index_select(-1, int4_hidden_units(gc, group, mesh.tp, mesh.axis_index("tp")).to(w.device))

    return take


def llama_tp_specs(params: dict) -> dict:
    """Megatron specs of a llama tree, JAX's ``llama_tp_specs``:
    column-parallel wq/wk/wv/w1/w3 and vocab head, row-parallel wo/w2, the
    embedding's rows sharded. A weight-only-int8 ``{"q", "s"}`` leaf shards
    ``q`` as the matrix and ``s`` with the output dim (replicated where the
    input dim is sharded).

    A grouped-int4 ``{"q4": [gc, G/2, N], "s4": [gc, N]}`` leaf keeps its
    bytes. Column-parallel: a slice of ``N``. Row-parallel ``w2``: JAX's
    split of the within-group byte axis (mixed with the group axis where a
    rank's group would be under 32 rows: :func:`int4_row_split`), so the
    rank's input rows are strided, and ``w1`` and ``w3`` (in whatever form)
    take those hidden units in that order (:func:`int4_hidden_units`).
    Row-parallel ``wo``: its input rows are the rank's heads, which a byte
    split would cut, so it splits the group axis (the same sum as JAX's
    split, in another order). A shape where the split does not line up
    raises ``ValueError`` naming it when the shard is cut."""

    def mat_spec(w, spec: P):
        if isinstance(w, dict):
            in_axis, out_axis = spec[0], spec[1]
            if "q4" in w:  # grouped int4: [gc, G/2, n_out] + [gc, n_out]
                return {"q4": P(in_axis, None, out_axis), "s4": P(in_axis, out_axis)}
            return {"q": spec, "s": P(out_axis)}
        return spec

    def block_spec(blk):
        spec = {
            "attention_norm": P(),
            "ffn_norm": P(),
            "wq": P(None, "tp"),
            "wk": P(None, "tp"),
            "wv": P(None, "tp"),
            "wo": P("tp", None),
            "w1": P(None, "tp"),
            "w3": P(None, "tp"),
            "w2": P("tp", None),
        }
        spec = {k: (mat_spec(blk[k], v) if k in WEIGHT_KEYS else v) for k, v in spec.items()}
        w2 = blk["w2"]
        if isinstance(w2, dict) and "q4" in w2:
            gc, half, _ = w2["q4"].shape
            spec["w2"] = int4_row_specs(gc, 2 * half)
            units = _units_spec(gc, 2 * half)
            for k in ("w1", "w3"):
                spec[k] = {f: units for f in blk[k]} if isinstance(blk[k], dict) else units
        if "q_norm" in blk:
            spec["q_norm"] = {"scale": P(), "bias": P()}
            spec["k_norm"] = {"scale": P(), "bias": P()}
        if "ls1" in blk:
            spec["ls1"] = P()
            spec["ls2"] = P()
        return spec

    return {
        "tok_embeddings": P("tp", None),
        "blocks": [block_spec(b) for b in params["blocks"]],
        "norm": P(),
        "output": mat_spec(params["output"], P(None, "tp")),
    }
