"""RAR: randomized-order autoregressive image generator (PyTorch).

Port of ``wmar_tpu.models.rar``: a decoder-only ViT with adaLN conditioning,
qk-norm attention, target-aware positional embeddings and in-batch CFG, in
raster order. The modules' buffers carry the JAX parameter tree's names and
layouts (``w [n_in, n_out]``), so ``state_dict`` keys are the tree's paths
joined by dots and :mod:`wmar_tpu_torch.bridge` loads JAX weights 1:1.

Token space: [0, K-1] image codes | K mask | [K+1, K+nclass] classes |
K+nclass+1 the class-drop ("none") token. Sizes B/L/XL/XXL are 768x24 /
1024x24 / 1280x32 / 1408x40 with 16 heads (head dims 48, 64, 80, 88).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.core.sampling import cfg_combine, rar_cfg_scale
from wmar_tpu_torch.engine.attention import cached_decode_attention
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.ops import wquant
from wmar_tpu_torch.ops.wquant import Linear


@dataclasses.dataclass(frozen=True)
class RARConfig:
    embed_dim: int = 768
    depth: int = 24
    num_heads: int = 16
    intermediate_size: int = 3072
    image_seq_len: int = 256
    codebook_size: int = 1024
    num_classes: int = 1000

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def input_vocab(self) -> int:
        return self.codebook_size + 1 + self.num_classes + 1

    @property
    def none_condition_id(self) -> int:
        return self.num_classes + self.codebook_size + 1

    @property
    def max_positions(self) -> int:
        return self.image_seq_len + 2  # cls + condition + image tokens


def rar_config(size: str, **kw) -> RARConfig:
    dims = {
        "rar_b": (768, 24, 3072),
        "rar_l": (1024, 24, 4096),
        "rar_xl": (1280, 32, 5120),
        "rar_xxl": (1408, 40, 6144),
    }[size]
    return RARConfig(embed_dim=dims[0], depth=dims[1], intermediate_size=dims[2], **kw)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-6, with the JAX formula; buffers
    ``scale`` and ``bias`` unless ``affine`` is False."""

    def __init__(self, dim: int, affine: bool = True, dtype=torch.float32, device=None, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.affine = affine
        if affine:
            self.register_buffer("scale", torch.ones((dim,), dtype=dtype, device=device))
            self.register_buffer("bias", torch.zeros((dim,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + self.eps)
        if self.affine:
            x = x * self.scale + self.bias
        return x


def _modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


class Attention(nn.Module):
    def __init__(self, cfg: RARConfig, dtype, device):
        super().__init__()
        d = cfg.embed_dim
        self.qkv = Linear(d, 3 * d, dtype, device)
        self.q_norm = LayerNorm(cfg.head_dim, dtype=dtype, device=device)
        self.k_norm = LayerNorm(cfg.head_dim, dtype=dtype, device=device)
        self.proj = Linear(d, d, dtype, device)


class Mlp(nn.Module):
    def __init__(self, cfg: RARConfig, dtype, device):
        super().__init__()
        self.fc1 = Linear(cfg.embed_dim, cfg.intermediate_size, dtype, device)
        self.fc2 = Linear(cfg.intermediate_size, cfg.embed_dim, dtype, device)


class Block(nn.Module):
    """One adaLN block."""

    def __init__(self, cfg: RARConfig, dtype, device):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.norm1 = LayerNorm(d, dtype=dtype, device=device)
        self.norm2 = LayerNorm(d, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = Mlp(cfg, dtype, device)
        self.adaln = Linear(d, 6 * d, dtype, device)

    def forward(self, x, c, cache, layer: int, pos, valid_len):
        """``x [B, t, D]`` with condition ``c``; writes K/V at ``pos``."""
        cfg = self.cfg
        mods = self.adaln(F.silu(c))
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = torch.chunk(mods, 6, dim=-1)

        h = _modulate(self.norm1(x), sh_msa, sc_msa)
        b, t, d = h.shape
        qkv = self.attn.qkv(h).reshape(b, t, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = self.attn.q_norm(q).transpose(1, 2)
        k = self.attn.k_norm(k).transpose(1, 2)
        v = v.transpose(1, 2)
        cache = cache.write(layer, pos, k, v)
        attn = cached_decode_attention(q.contiguous(), cache, layer, valid_len)
        attn = attn.transpose(1, 2).reshape(b, t, d)
        x = x + g_msa * self.attn.proj(attn)

        h2 = _modulate(self.norm2(x), sh_mlp, sc_mlp)
        h2 = F.gelu(self.mlp.fc1(h2), approximate="none")
        x = x + g_mlp * self.mlp.fc2(h2)
        return x, cache


class RAR(nn.Module):
    """The RAR generator's weights and cached forward pass."""

    def __init__(self, cfg: RARConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        buf = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        self.register_buffer("cls_token", buf(1, 1, d))
        self.register_buffer("embeddings", buf(cfg.input_vocab, d))
        self.register_buffer("pos_embed", buf(cfg.image_seq_len + 1024, d))
        self.register_buffer("target_aware_pos_embed", buf(cfg.image_seq_len + 1024, d))
        self.register_buffer("timesteps_embeddings", buf(cfg.image_seq_len + 100, d))
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg.depth)])
        self.final_adaln = Linear(d, 2 * d, dtype, device)
        self.final_norm = LayerNorm(d, affine=False)
        self.lm_head = Linear(d, cfg.codebook_size, dtype, device)

    def forward_cached(self, x, c, cache, pos) -> Tuple[torch.Tensor, KVCache]:
        """Forward embedded inputs ``x [B, t, D]`` at slot ``pos`` (int or
        0-d device tensor). Returns the last position's logits ``[B,
        codebook]`` and the cache."""
        valid_len = pos + x.shape[1]
        if isinstance(valid_len, torch.Tensor):
            valid_len = valid_len.to(torch.int32)  # one cast per step, read by every layer's kernel
        for li, blk in enumerate(self.blocks):
            x, cache = blk(x, c, cache, li, pos, valid_len)
        x_last, c_last = x[:, -1:], c[:, -1:]
        shift, scale = torch.chunk(self.final_adaln(F.silu(c_last)), 2, dim=-1)
        h = _modulate(self.final_norm(x_last), shift, scale)
        return self.lm_head(h)[:, 0], cache

    def embed_inputs(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token + positional + target-aware embeddings. Position ``i >= 1``
        also carries ``target_aware_pos_embed[i + 1]``, the embedding of the
        slot it predicts; position 0 (cls) carries none."""
        cfg = self.cfg
        emb = self.embeddings[tokens] + self.pos_embed[positions]
        ta = self.target_aware_pos_embed[positions + 1]
        gate = ((positions >= 1) & (positions <= cfg.image_seq_len))[..., None]
        return emb + torch.where(gate, ta, 0.0)


def rar_forward_cached(model: RAR, x, c, cache, pos):
    """Function form of :meth:`RAR.forward_cached`."""
    return model.forward_cached(x, c, cache, pos)


def _embed_inputs(model: RAR, tokens, positions):
    """Function form of :meth:`RAR.embed_inputs`."""
    return model.embed_inputs(tokens, positions)


@torch.no_grad()
def init_rar(cfg: RARConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> RAR:
    """Random weights from ``generator``: truncated normal (std 0.02, cut at
    two std), zero biases, unit norms, and adaLN-zero like the JAX init."""
    model = RAR(cfg, dtype=torch.float32, device=device)
    for name, t in model.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        zero = leaf == "b" or name == "cls_token" or ".adaln." in f".{name}" or name.startswith("final_adaln.")
        if leaf == "scale":
            t.fill_(1.0)
        elif leaf == "bias" or zero:
            t.zero_()
        else:
            nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
    return model.to(dtype)


@torch.no_grad()
def quantize_rar_params_int8(model: RAR, compute_dtype=None, bits: int = 8) -> RAR:
    """Weight-only int8 for every decode-path linear, in place.

    Embeddings and norms stay floating point; with ``compute_dtype`` they,
    the biases and the blocks' other float buffers are cast to it, as in the
    JAX function of the same name."""
    if bits != 8:
        wquant.quantize_linear({}, bits=bits)  # raises for the unported int4
    for blk in model.blocks:
        for lin in (blk.adaln, blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            lin.quantize_int8(compute_dtype)
    model.final_adaln.quantize_int8(compute_dtype)
    model.lm_head.quantize_int8(compute_dtype)
    if compute_dtype is not None:
        for key in ("cls_token", "embeddings", "pos_embed", "target_aware_pos_embed", "timesteps_embeddings"):
            setattr(model, key, getattr(model, key).to(compute_dtype))
        for name, t in list(model.blocks.named_buffers()):
            if t.is_floating_point():
                mod_name, leaf = name.rsplit(".", 1)
                setattr(model.blocks.get_submodule(mod_name), leaf, t.to(compute_dtype))
    return model


class RARSampler:
    """Per-batch sampling adapter (prefill + engine ``step_fn``) with CFG."""

    def __init__(
        self,
        model: RAR,
        class_ids: torch.Tensor,
        guidance_scale: float = 4.0,
        guidance_scale_pow: float = 0.0,
        cache_dtype=torch.float32,
    ):
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.embeddings.device
        self.guidance_scale = float(guidance_scale)
        self.guidance_scale_pow = float(guidance_scale_pow)
        self.cache_dtype = cache_dtype
        cond = class_ids.to(device=self.device, dtype=torch.int64) + cfg.codebook_size + 1
        if self.use_cfg:
            cond = torch.cat([cond, torch.full_like(cond, cfg.none_condition_id)])
        self.cond_ids = cond  # [B or 2B]
        self.cond_emb = model.embeddings[cond]  # [B or 2B, D]

    @property
    def use_cfg(self) -> bool:
        return self.guidance_scale != 0

    def _cond_stream(self, positions: torch.Tensor) -> torch.Tensor:
        """adaLN condition: class embedding + per-position timestep embedding."""
        return self.cond_emb[:, None, :] + self.model.timesteps_embeddings[positions]

    def _combine(self, logits, step):
        if not self.use_cfg:
            return logits
        b = logits.shape[0] // 2
        scale = rar_cfg_scale(step, self.cfg.image_seq_len, self.guidance_scale, self.guidance_scale_pow)
        return cfg_combine(logits[:b], logits[b:], scale)

    def prefill(self, max_len: Optional[int] = None):
        """Process the [cls, condition] prefix; returns (step-0 logits, cache)."""
        cfg, model, dev = self.cfg, self.model, self.device
        bb = self.cond_ids.shape[0]
        max_len = max_len or cfg.max_positions
        cache = KVCache.zeros(cfg.depth, bb, cfg.num_heads, max_len, cfg.head_dim, self.cache_dtype, device=dev)
        ones = torch.ones((1, 1), dtype=torch.int64, device=dev)
        cond_x = model.embed_inputs(self.cond_ids[:, None], ones)
        cls = (model.cls_token + model.pos_embed[0]).expand(bb, 1, cfg.embed_dim)
        x = torch.cat([cls, cond_x], dim=1)
        c = self._cond_stream(torch.arange(2, device=dev)[None, :])
        logits, cache = model.forward_cached(x, c, cache, 0)
        return self._combine(logits, torch.zeros((), dtype=torch.int64, device=dev)), cache

    def step_fn(self, cache, prev: torch.Tensor, step: torch.Tensor):
        """Engine adapter: feed the sampled token, get the logits of ``step``."""
        tokens = torch.cat([prev, prev]) if self.use_cfg else prev
        pos = step + 1  # image token s-1 sits at slot s+1
        positions = pos.reshape(1, 1).expand(tokens.shape[0], 1)
        x = self.model.embed_inputs(tokens[:, None], positions)
        c = self._cond_stream(positions)
        logits, cache = self.model.forward_cached(x, c, cache, pos)
        return self._combine(logits, step), cache
