"""GPipe pipeline-parallel Llama prefill over the ``pp`` axis (PyTorch).

Port of ``wmar_tpu.parallel.pipeline``. The reference never pipelines (its
Chameleon runs every layer on every worker,
``deps/chameleon/inference/transformer.py``). Here the ``pp`` ranks are
stages: stage ``s`` runs layers ``[s L/pp, (s + 1) L/pp)`` on ``M``
microbatches of the prompt's rows, and the hidden state goes on to the next
stage, the GPipe schedule of ``M + pp - 1`` ticks (a bubble of ``(pp - 1) /
(M + pp - 1)``). JAX's stage body is plain ``jnp`` in a ``lax.scan`` inside
``shard_map``, with no Pallas kernel; the port's is plain PyTorch, one
:func:`~wmar_tpu_torch.parallel.mesh.ring_exchange` a tick.

The stage body is :func:`wmar_tpu_torch.models.llama.block_attn_inputs` /
``block_finish``, the math of ``llama_forward``, with dense causal prefill
attention per microbatch (``engine.attention.decode_attention``'s burst,
with the per-row ``start`` and ``key_mask``). Every rank holds the whole
model, as every device does in JAX (the decode after the prefill runs on
every rank); a stage runs only its layers. Under ``tp`` a stage is a tp
group that runs the Megatron layers on its shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wmar_tpu_torch.parallel.mesh import Mesh, all_gather, broadcast, ring_exchange


def stack_blocks(blocks):
    """The per-layer trees stacked into one with a leading ``[L]`` axis,
    JAX's layout of the layers that ``llama_prefill_pp`` shards over
    ``pp`` (the port's stages index the list of layers instead)."""

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    return stack(*blocks)


def llama_prefill_pp(params, cfg, tokens: torch.Tensor, cache, positions: torch.Tensor, mesh: Mesh, *,
                     pp_axis: str = "pp", microbatches: Optional[int] = None, start: Optional[torch.Tensor] = None,
                     key_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, object]:
    """Pipeline-parallel prefill at write position 0, JAX's
    ``llama_prefill_pp``: every rank of the ``pp`` line calls this with the
    whole ``tokens, positions [B, t]``; ``B`` must divide by
    ``microbatches`` (default: the most, at most the stage count, that
    divide ``B``). ``start [B]`` masks left padding, ``key_mask [B,
    T_max]`` slots.

    At the end the last stage's hidden states go to every stage (JAX's
    ``psum`` over stages that hold zeros, here a broadcast), and each
    stage's layers' K/V to every other, so every rank writes the whole
    cache. Returns ``(logits [B, t, vocab] float32, cache)``, on every rank
    the same as :func:`~wmar_tpu_torch.models.llama.llama_forward`'s on the
    valid positions."""
    from wmar_tpu_torch.engine.attention import decode_attention
    from wmar_tpu_torch.models.llama import _rms, block_attn_inputs, block_finish, embed_tokens, rope_angles
    from wmar_tpu_torch.ops import wquant

    n_stages = mesh.size_of(pp_axis)
    if cfg.n_layers % n_stages != 0:
        raise ValueError(f"{cfg.n_layers} layers not divisible by pp={n_stages}")
    b, t = tokens.shape
    m = microbatches or max(d for d in range(1, min(n_stages, b) + 1) if b % d == 0)
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches={m}")
    mb, stage, per = b // m, mesh.axis_index(pp_axis), cfg.n_layers // n_stages
    blocks = params["blocks"][stage * per:(stage + 1) * per]
    dev = tokens.device
    start = start if start is not None else torch.zeros((b,), dtype=torch.int32, device=dev)
    km = key_mask[:, :t] if key_mask is not None else torch.ones((b, t), dtype=torch.bool, device=dev)
    rows = [slice(i * mb, (i + 1) * mb) for i in range(m)]

    x = embed_tokens(params["tok_embeddings"], tokens, mesh)  # [B, t, d]; stage 0 reads it, the rest its shape
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    outs = torch.zeros_like(x)
    kv = [[None] * m for _ in blocks]  # [layer][microbatch] -> [2, mb, H, t, D]
    buf = torch.zeros_like(x[rows[0]])
    for tick in range(m + n_stages - 1):
        idx = tick - stage  # the microbatch this stage works on at this tick
        y = torch.zeros_like(buf)
        if 0 <= idx < m:
            r = rows[idx]
            y = x[r] if stage == 0 else buf
            for j, blk in enumerate(blocks):
                q, k, v = block_attn_inputs(blk, cfg, y, positions[r], (rope[0][r], rope[1][r]))
                attn = decode_attention(q, k, v, t, start=start[r], key_mask=km[r])
                y = block_finish(blk, cfg, y, attn, mesh)
                kv[j][idx] = torch.stack([k, v])
            if stage == n_stages - 1:
                outs[r] = y
        buf = ring_exchange(y, mesh, pp_axis)
    outs = broadcast(outs, mesh, pp_axis, n_stages - 1)
    mine = torch.stack([torch.cat(layer, dim=1) for layer in kv])  # [L/pp, 2, B, H, t, D]
    every = all_gather(mine, mesh, pp_axis, dim=0)  # [L, 2, B, H, t, D], stage order = layer order
    for li in range(cfg.n_layers):
        cache = cache.write(li, 0, every[li, 0], every[li, 1])
    y = _rms(outs, params["norm"], cfg.norm_eps)
    return all_gather(wquant.matmul(y, params["output"]).to(torch.float32), mesh), cache
