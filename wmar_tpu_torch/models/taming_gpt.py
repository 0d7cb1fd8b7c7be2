"""Taming's class-conditional image GPT (minGPT), PyTorch.

Port of ``wmar_tpu.models.taming_gpt``: learned positional embeddings,
pre-LN blocks (eps 1e-5), an exact-erf GELU MLP and an untied head without
bias. The module's buffers carry the JAX parameter tree's names and
layouts (``w [n_in, n_out]``), so ``state_dict`` keys are the tree's paths
joined by dots and :func:`wmar_tpu_torch.bridge.load_gpt` loads JAX weights
1:1, float, int8 or int4.

Every linear and the head go through :mod:`wmar_tpu_torch.ops.wquant`:
with int4 weights (``quantize_gpt_params_int8(bits=4)``) each is one launch
of the w4a16 kernel #8. Single-token steps over the packed caches take the
decode-attention kernels #1 and #2.

The published ImageNet cin_transformer: vocab 16384 (class ids alias the
first 1000 codes), block_size 512, 48 layers, 16 heads, width 1664
(GPT-1.4B).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.engine.attention import cached_decode_attention, prefill_attention
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.models.rar import LayerNorm
from wmar_tpu_torch.ops import wquant
from wmar_tpu_torch.ops.wquant import Linear


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    block_size: int
    n_layer: int
    n_head: int
    n_embd: int

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


TAMING_GPT_1_4B = GPTConfig(vocab_size=16384, block_size=512, n_layer=48, n_head=16, n_embd=1664)


class QuantMatrix(nn.Module):
    """A quantized bare matrix (``{"q","s"}`` or ``{"q4","s4"}``) whose
    buffers are the JAX dict's leaves."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, t in leaves.items():
            self.register_buffer(name, t)

    def params(self) -> dict:
        return dict(self.named_buffers(recurse=False))


class Attention(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.q = Linear(d, d, dtype, device)
        self.k = Linear(d, d, dtype, device)
        self.v = Linear(d, d, dtype, device)
        self.proj = Linear(d, d, dtype, device)


class Mlp(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.fc = Linear(d, 4 * d, dtype, device)
        self.proj = Linear(4 * d, d, dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.n_embd, dtype=dtype, device=device, eps=1e-5)
        self.ln2 = LayerNorm(cfg.n_embd, dtype=dtype, device=device, eps=1e-5)
        self.attn = Attention(cfg.n_embd, dtype, device)
        self.mlp = Mlp(cfg.n_embd, dtype, device)

    def forward(self, x, cache, layer: int, start_pos, valid_len):
        """``x [B, t, C]``; with a cache, writes K/V at ``start_pos`` and
        attends the cache's first ``valid_len`` slots, else causal."""
        cfg = self.cfg
        h = self.ln1(x)
        q, k, v = (_split_heads(lin(h), cfg.n_head) for lin in (self.attn.q, self.attn.k, self.attn.v))
        if cache is not None:
            cache = cache.write(layer, start_pos, k, v)
            attn = cached_decode_attention(q.contiguous(), cache, layer, valid_len)
        else:
            attn = prefill_attention(q, k, v, causal=True)
        x = x + self.attn.proj(_merge_heads(attn))
        h2 = F.gelu(self.mlp.fc(self.ln2(x)), approximate="none")
        return x + self.mlp.proj(h2), cache


class GPT(nn.Module):
    """The cin_transformer's weights and forward pass."""

    def __init__(self, cfg: GPTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        buf = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        self.register_buffer("tok_emb", buf(cfg.vocab_size, cfg.n_embd))
        self.register_buffer("pos_emb", buf(cfg.block_size, cfg.n_embd))
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg.n_layer)])
        self.ln_f = LayerNorm(cfg.n_embd, dtype=dtype, device=device, eps=1e-5)
        self.register_buffer("head", buf(cfg.n_embd, cfg.vocab_size))  # untied, no bias

    def head_weight(self):
        """The head as :func:`wquant.matmul` takes it: a tensor or a dict."""
        return self.head.params() if isinstance(self.head, QuantMatrix) else self.head

    def set_head(self, leaves: dict) -> None:
        """Swap the float head for a quantized one (``{"q","s"}`` or ``{"q4","s4"}``)."""
        self._buffers.pop("head", None)
        self.head = QuantMatrix(leaves)


def _split_heads(x, n_head):
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def gpt_forward(model: GPT, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                start_pos=0) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Forward ``tokens [B, t]`` at absolute position ``start_pos`` (an int
    or a 0-d device tensor).

    With a cache: writes the new K/V at ``start_pos`` (in place) and attends
    the cache's first ``start_pos + t`` slots, both the prefill and the
    1-token decode path. Without a cache: plain causal attention.

    Returns ``(logits [B, t, vocab], cache)``.
    """
    t = tokens.shape[1]
    pos = start_pos + torch.arange(t, device=tokens.device)
    x = model.tok_emb[tokens] + model.pos_emb[pos]
    valid_len = start_pos + t
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.to(torch.int32)  # one cast per forward, read by every layer's kernel
    for li, blk in enumerate(model.blocks):
        x, cache = blk(x, cache, li, start_pos, valid_len)
    return wquant.matmul(model.ln_f(x), model.head_weight()), cache


def make_step_fn(model: GPT, cond_len: int):
    """Decode-step adapter for :func:`wmar_tpu_torch.engine.decode.decode_tokens`.

    ``step`` is the image-token index of the logits to produce; the freshly
    sampled token ``prev`` sits at absolute position ``cond_len + step - 1``.
    """

    def step_fn(cache, prev: torch.Tensor, step: torch.Tensor):
        pos = cond_len + step - 1
        logits, cache = gpt_forward(model, prev[:, None], cache, pos)
        return logits[:, -1], cache

    return step_fn


def prefill(model: GPT, cond_tokens: torch.Tensor, max_len: int, dtype=torch.float32):
    """Run the conditioning prefix; returns first-step logits and the cache."""
    cfg = model.cfg
    b = cond_tokens.shape[0]
    cache = KVCache.zeros(cfg.n_layer, b, cfg.n_head, max_len, cfg.head_dim, dtype, device=model.tok_emb.device)
    logits, cache = gpt_forward(model, cond_tokens, cache, 0)
    return logits[:, -1], cache


@torch.no_grad()
def init_gpt(cfg: GPTConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> GPT:
    """Random weights from ``generator`` by the reference's rules: normal
    with std 0.02 for embeddings, linears and the head; zero biases and
    positional embeddings; unit LayerNorm scales, zero LayerNorm biases."""
    model = GPT(cfg, dtype=torch.float32, device=device)
    for name, t in model.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            t.fill_(1.0)
        elif leaf in ("b", "bias") or name == "pos_emb":
            t.zero_()
        else:
            t.normal_(0.0, 0.02, generator=generator)
    return model.to(dtype)


@torch.no_grad()
def quantize_gpt_params_int8(model: GPT, compute_dtype=None, bits: int = 8) -> GPT:
    """Weight-only int8 (``bits=8``) or grouped int4 (``bits=4``, int8 where
    no group divides a matrix's input dim) for every block linear and the
    untied head, in place, bit-identical to the JAX function's leaves.
    Embeddings and norms stay floating point; with ``compute_dtype`` they,
    the biases and the blocks' other float buffers are cast to it."""
    for blk in model.blocks:
        for lin in (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.proj, blk.mlp.fc, blk.mlp.proj):
            lin.quantize(bits, compute_dtype)
    model.set_head(wquant.quantize_matrix(model.head, bits=bits))
    if compute_dtype is not None:
        model.tok_emb = model.tok_emb.to(compute_dtype)
        model.pos_emb = model.pos_emb.to(compute_dtype)
        for mod in (model.blocks, model.ln_f):
            for name, t in list(mod.named_buffers()):
                if t.is_floating_point():
                    mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
                    setattr(mod.get_submodule(mod_name), leaf, t.to(compute_dtype))
    return model
