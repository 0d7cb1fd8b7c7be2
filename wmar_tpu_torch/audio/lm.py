"""Moshi-style audio LM: temporal transformer + depformer, watermark-fused
(PyTorch).

Port of ``wmar_tpu.audio.lm``. One temporal transformer runs over frames
whose input is the summed embeddings of the text stream and the ``n_q``
input audio streams (each with its delay); a small depformer then predicts
the ``dep_q`` codebooks of the frame one after the other. The watermark
replaces the samplers: the text stream hashes an n-gram window of its own
input history, the audio streams use the fixed seed hash.

Parameters stay the JAX package's tree (a dict of tensors, matrices
``[n_in, n_out]``, a weight-only-int8 matrix a ``{"q", "s"}`` dict), so
:func:`wmar_tpu_torch.bridge.load_moshi` and :func:`convert_moshi_lm` both
produce it. JAX's ``lax.scan`` over frames is a Python loop over a
preallocated cache here; the temporal cache has ``n_frames + max_delay + 1``
slots, and on a packed cache (``"packed"``, ``"packed4"``) every layer of
every frame reads it through the hand-written CUDA kernels #2 / #1
(:func:`wmar_tpu_torch.engine.attention.cached_decode_attention`), from
1024 slots on the chunked #3 / #4. The depformer's short float cache and
Moshi's float caches take the plain attention, as in JAX.

Sampling noise: Maryland and plain sampling draw Gumbel noise per (frame,
stream) from a ``torch.Generator`` seeded by ``seed``, or take it from a
``noise(t, stream, shape)`` callable (tests feed JAX's draws through it).
Gumbel (Aaronson) sampling needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wmar_tpu_torch.audio import wm as audio_wm
from wmar_tpu_torch.core.sampling import gumbel_noise
from wmar_tpu_torch.engine.attention import cached_decode_attention, decode_attention
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.models.llama import WEIGHT_KEYS, LlamaConfig, _rms, _rotate, rope_angles
from wmar_tpu_torch.ops import wquant

Noise = Callable[[int, int, Tuple[int, int]], torch.Tensor]
_mm = wquant.matmul  # a bare matrix or a weight-only-int8 {"q", "s"} dict


def gating_hidden(dim: int, dim_feedforward: int) -> int:
    """Moshi's ActivationGating hidden rule: 21d/8 when ff == 4d, else 2*ff/3."""
    if dim_feedforward == 4 * dim:
        return (21 * dim) // 8
    return (2 * dim_feedforward) // 3


@dataclasses.dataclass(frozen=True)
class MoshiConfig:
    n_audio_streams: int = 8  # dep_q: output (watermarkable) audio streams
    audio_vocab: int = 2048
    text_vocab: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    dep_dim: int = 256
    dep_layers: int = 2
    dep_heads: int = 4
    delays: Sequence[int] = (0, 1, 1, 1, 1, 1, 1, 1)  # per input audio stream
    n_q: Optional[int] = None  # input audio streams (16 for Moshi); None = dep_q
    hidden_scale: float = 4.0  # ffn = hidden_scale * dim, gated via gating_hidden
    depformer_multi_linear: bool = False  # one dep_in projection per codebook
    depformer_weights_per_step: bool = False  # per-codebook depformer weights
    depformer_pos_emb: str = "rope"  # real Moshi: "none"

    @property
    def num_inputs(self) -> int:
        return self.n_q if self.n_q is not None else self.n_audio_streams

    @property
    def ungenerated(self) -> int:
        return self.audio_vocab  # sentinel id for not-yet-available tokens

    @property
    def text_ungenerated(self) -> int:
        return self.text_vocab

    def temporal_cfg(self) -> LlamaConfig:
        return LlamaConfig(dim=self.dim, n_layers=self.n_layers, n_heads=self.n_heads, vocab_size=8,
                           multiple_of=16, qk_normalization=False, ffn_dim_multiplier=None)

    @property
    def ffn_hidden(self) -> int:
        return gating_hidden(self.dim, int(self.hidden_scale * self.dim))

    @property
    def dep_ffn_hidden(self) -> int:
        return gating_hidden(self.dep_dim, int(self.hidden_scale * self.dep_dim))

    def dep_cfg(self) -> LlamaConfig:
        return LlamaConfig(dim=self.dep_dim, n_layers=self.dep_layers, n_heads=self.dep_heads, vocab_size=8,
                           multiple_of=16, qk_normalization=False)

    def full_delays(self) -> Tuple[int, ...]:
        """The delay of the text stream (0) and of each input audio stream."""
        return (0,) + tuple(self.delays[s % len(self.delays)] for s in range(self.num_inputs))

    def total_steps(self, n_frames: int) -> int:
        """Frames the loop runs for ``n_frames`` emitted ones: ``n_frames +
        max_delay``, each a temporal forward of every layer."""
        return n_frames + max(self.full_delays())


#: kyutai/moshiko-pytorch-bf16 geometry (``moshi/models/loaders.py:81-111``)
MOSHI_V01 = MoshiConfig(
    n_audio_streams=8, audio_vocab=2048, text_vocab=32000,
    dim=4096, n_layers=32, n_heads=32,
    dep_dim=1024, dep_layers=6, dep_heads=16,
    delays=(0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1),
    n_q=16, hidden_scale=4.125,
    depformer_multi_linear=True, depformer_weights_per_step=True,
    depformer_pos_emb="none",
)


@dataclasses.dataclass(frozen=True)
class WMConfig:
    """Which streams are watermarked and how (0 = text, 1..K = audio)."""

    method: str = "maryland"  # maryland | gumbel | none
    streams: Sequence[int] = tuple(range(9))
    ngram: int = 1  # text-stream context size
    delta: float = 4.0
    gamma: float = 0.25
    seed: int = 0
    temp: float = 0.8
    top_k: int = 250
    greedy: bool = False  # argmax on the streams without a watermark (parity tests)


@torch.no_grad()
def init_moshi_params(cfg: MoshiConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """Random weights by the JAX init's rules: matrices ``N(0, 1/n_in)``,
    embeddings ``N(0, 0.02^2)``, unit norms, Moshi's gated FFN widths, and
    with ``depformer_weights_per_step`` codebook ``i``'s depformer matrices
    the base times ``1 + 0.01 i``. Each matrix is drawn in float32 on
    ``device`` and cast to ``dtype`` before the next one is drawn."""

    def mat(n_in, n_out, std=None):
        w = torch.randn((n_in, n_out), generator=generator, device=device, dtype=torch.float32)
        return (w * (std if std is not None else n_in**-0.5)).to(dtype)

    def llama(lcfg: LlamaConfig, hidden: int) -> dict:
        d = lcfg.dim
        ones = lambda: torch.ones((d,), dtype=dtype, device=device)  # noqa: E731
        blocks = [{"attention_norm": ones(), "ffn_norm": ones(), "wq": mat(d, d), "wk": mat(d, d), "wv": mat(d, d),
                   "wo": mat(d, d), "w1": mat(d, hidden), "w3": mat(d, hidden), "w2": mat(hidden, d)}
                  for _ in range(lcfg.n_layers)]
        return {"tok_embeddings": mat(lcfg.vocab_size, d, std=0.02), "blocks": blocks, "norm": ones(),
                "output": mat(d, lcfg.vocab_size)}

    temporal = llama(cfg.temporal_cfg(), cfg.ffn_hidden)
    dep = llama(cfg.dep_cfg(), cfg.dep_ffn_hidden)
    if cfg.depformer_weights_per_step:
        for blk in dep["blocks"]:
            for name in WEIGHT_KEYS:
                base = blk[name]
                blk[name] = torch.stack([base * (1.0 + 0.01 * i) for i in range(cfg.n_audio_streams)])
    num_in = cfg.n_audio_streams if cfg.depformer_multi_linear else 1
    card1 = cfg.audio_vocab + 1
    return {
        "temporal": temporal,
        "dep": dep,
        "text_emb": mat(cfg.text_vocab + 1, cfg.dim, std=0.02),
        "audio_emb": mat(cfg.num_inputs * card1, cfg.dim, std=0.02),
        "text_head": mat(cfg.dim, cfg.text_vocab, std=0.02),
        "dep_in": torch.stack([mat(cfg.dim, cfg.dep_dim) for _ in range(num_in)]),
        "dep_tok_emb": mat(cfg.n_audio_streams * card1 + cfg.text_vocab + 1, cfg.dep_dim, std=0.02),
        "dep_heads": mat(cfg.n_audio_streams * cfg.dep_dim, cfg.audio_vocab, std=0.02).reshape(
            cfg.n_audio_streams, cfg.dep_dim, cfg.audio_vocab),
    }


@torch.no_grad()
def quantize_moshi_params_int8(params, compute_dtype=None, bits: int = 8) -> dict:
    """Weight-only int8 for the temporal backbone and the text head (each
    matrix ``{"q": int8, "s": bf16 [n_out]}``, bit-identical to the JAX
    function's); the depformer stays in floating point. With
    ``compute_dtype`` every float leaf is cast to it."""
    out = dict(params)
    t = dict(params["temporal"])
    t["blocks"] = [{k: (wquant.quantize_matrix(v, bits=bits) if k in WEIGHT_KEYS else v) for k, v in blk.items()}
                   for blk in t["blocks"]]
    out["temporal"] = t
    out["text_head"] = wquant.quantize_matrix(params["text_head"], bits=bits)
    if compute_dtype is not None:
        out = wquant.cast_float_leaves(out, compute_dtype)
    return out


def _temporal_step(params, cfg: MoshiConfig, x_emb: torch.Tensor, cache, pos: int, valid_len) -> torch.Tensor:
    """One frame ``x_emb [B, dim]`` (summed embeddings) through the temporal
    backbone, written into ``cache`` at slot ``pos``; ``valid_len`` is
    ``pos + 1`` (a device int32 tensor of one element, read by every layer's
    kernel). Returns the normed hidden state ``[B, dim]``."""
    tcfg = cfg.temporal_cfg()
    b = x_emb.shape[0]
    x = x_emb[:, None, :]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(positions, tcfg.head_dim, tcfg.rope_theta)
    for li, blk in enumerate(params["blocks"]):
        h = _rms(x, blk["attention_norm"], tcfg.norm_eps)
        q = _mm(h, blk["wq"]).reshape(b, 1, tcfg.n_heads, tcfg.head_dim)
        k = _mm(h, blk["wk"]).reshape(b, 1, tcfg.kv_heads, tcfg.head_dim)
        v = _mm(h, blk["wv"]).reshape(b, 1, tcfg.kv_heads, tcfg.head_dim)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))
        cache.write(li, pos, k, v)
        attn = cached_decode_attention(q.contiguous(), cache, li, valid_len)
        attn_out = _mm(attn.transpose(1, 2).reshape(b, 1, tcfg.dim), blk["wo"])
        x = x + (blk["ls1"] * attn_out if "ls1" in blk else attn_out)
        h2 = _rms(x, blk["ffn_norm"], tcfg.norm_eps)
        ffn_out = _mm(F.silu(_mm(h2, blk["w1"])) * _mm(h2, blk["w3"]), blk["w2"])
        x = x + (blk["ls2"] * ffn_out if "ls2" in blk else ffn_out)
    return _rms(x, params["norm"], tcfg.norm_eps)[:, 0]


def _dep_step(params, dcfg: LlamaConfig, x_emb: torch.Tensor, cache, pos: int, step: int = 0,
              per_step: bool = False, use_rope: bool = True) -> torch.Tensor:
    """One depformer position; ``per_step`` selects codebook ``step``'s
    slice of the stacked ``[K, ...]`` weights."""
    b = x_emb.shape[0]
    x = x_emb[:, None, :]
    if use_rope:
        cos, sin = rope_angles(torch.full((b, 1), pos, dtype=torch.int32, device=x.device), dcfg.head_dim,
                               dcfg.rope_theta)

    def W(blk, name):
        return blk[name][step] if per_step else blk[name]

    for li, blk in enumerate(params["blocks"]):
        h = _rms(x, blk["attention_norm"], dcfg.norm_eps)
        q = _mm(h, W(blk, "wq")).reshape(b, 1, dcfg.n_heads, dcfg.head_dim)
        k = _mm(h, W(blk, "wk")).reshape(b, 1, dcfg.kv_heads, dcfg.head_dim)
        v = _mm(h, W(blk, "wv")).reshape(b, 1, dcfg.kv_heads, dcfg.head_dim)
        if use_rope:
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))
        cache.write(li, pos, k, v)
        k_all, v_all = cache.layer(li)
        attn = decode_attention(q, k_all, v_all, pos + 1)
        attn_out = _mm(attn.transpose(1, 2).reshape(b, 1, dcfg.dim), W(blk, "wo"))
        x = x + (blk["ls1"] * attn_out if "ls1" in blk else attn_out)
        h2 = _rms(x, blk["ffn_norm"], dcfg.norm_eps)
        ffn_out = _mm(F.silu(_mm(h2, W(blk, "w1"))) * _mm(h2, W(blk, "w3")), W(blk, "w2"))
        x = x + (blk["ls2"] * ffn_out if "ls2" in blk else ffn_out)
    return _rms(x, params["norm"], dcfg.norm_eps)[:, 0]


class MoshiGen:
    """Streaming generation with the fused watermark (``LMGen.step``
    semantics). ``cache_dtype``: torch.float32 / torch.bfloat16 /
    torch.int8 / ``"packed"`` / ``"packed4"`` for the temporal cache."""

    def __init__(self, params, cfg: MoshiConfig, wm_cfg: Optional[WMConfig] = None, cache_dtype=torch.float32):
        self.params = params
        self.cfg = cfg
        self.wm = wm_cfg
        self.cache_dtype = cache_dtype
        self.device = params["text_emb"].device

    def _sample_stream(self, logits, stream_idx: int, ctx_tokens, draw) -> torch.Tensor:
        """The sampler of one stream (0 = text); ``ctx_tokens`` is the
        ``[B, ngram]`` text context window, ``draw()`` the stream's noise."""
        wm = self.wm
        use_wm = wm is not None and wm.method != "none" and stream_idx in wm.streams
        greedy = bool(wm.greedy) if wm is not None else False
        if not use_wm:
            sampling = not greedy
            return audio_wm.wm_sample_token(logits, "none", noise=draw() if sampling else None, use_sampling=sampling,
                                            temp=wm.temp if wm else 0.8, top_k=wm.top_k if wm else 250)
        if stream_idx == 0 and wm.ngram > 0:
            hashes = audio_wm.window_hash(ctx_tokens, wm.seed)
        else:
            hashes = audio_wm.window_hash(torch.zeros((logits.shape[0], 0), dtype=torch.int64,
                                                      device=logits.device), wm.seed)
        return audio_wm.wm_sample_token(logits, wm.method, window_hashes=hashes,
                                        noise=draw() if wm.method == "maryland" else None,
                                        temp=wm.temp, top_k=wm.top_k, gamma=wm.gamma, delta=wm.delta)

    def generate(self, n_frames: int, seed: int = 0, batch: int = 1, prompt_codes: Optional[torch.Tensor] = None,
                 text_prompt: Optional[torch.Tensor] = None, noise: Optional[Noise] = None):
        """Generate ``n_frames``; returns (text ``[B, T]``, audio ``[B, K, T]``),
        int64 on the model's device. ``prompt_codes [B, K, Tp]`` teacher-forces
        the first frames' audio, ``text_prompt [B, Tt]`` the text stream."""
        return self.generate_with_inputs(n_frames, seed, batch, prompt_codes, text_prompt, noise=noise)

    @torch.no_grad()
    def generate_with_inputs(self, n_frames: int, seed: int = 0, batch: int = 1,
                             prompt_codes: Optional[torch.Tensor] = None, text_prompt: Optional[torch.Tensor] = None,
                             other_codes: Optional[torch.Tensor] = None, condition_sum: Optional[torch.Tensor] = None,
                             noise: Optional[Noise] = None):
        """Like :meth:`generate`, plus ``other_codes [B, n_q - dep_q, T]``,
        the user's input audio streams fed per frame (zeros when omitted),
        and ``condition_sum [B, 1, D]`` (or ``[B, D]``), added to the
        temporal input every frame.

        A ring of ``max_delay + 2`` slots holds the model input of each
        stream per frame. The generated frame is written at slot ``t + 1``;
        delayed streams are seeded with the initial token while ``t <=
        delay``; the emitted frame gathers stream ``k`` at ``t + 1 -
        max_delay + delay_k``, so the output is time-aligned with a
        ``max_delay`` latency."""
        cfg, p, dev = self.cfg, self.params, self.device
        dep_q, n_in = cfg.n_audio_streams, cfg.num_inputs
        tcfg, dcfg = cfg.temporal_cfg(), cfg.dep_cfg()
        full_delays = cfg.full_delays()
        max_delay = max(full_delays)
        ct = max_delay + 2
        total_steps = cfg.total_steps(n_frames)
        card1 = cfg.audio_vocab + 1
        generator = torch.Generator(device=dev).manual_seed(int(seed)) if noise is None else None

        def drawer(t, s, shape):
            if noise is not None:
                return lambda: noise(t, s, shape).to(dev)
            return lambda: gumbel_noise(shape, generator, dev)

        t_cache = KVCache.zeros(tcfg.n_layers, batch, tcfg.n_heads, total_steps + 1, tcfg.head_dim,
                                self.cache_dtype, device=dev)
        ring = torch.zeros((batch, 1 + n_in, ct), dtype=torch.int64, device=dev)
        initial = [cfg.text_vocab] + [cfg.audio_vocab] * n_in
        streams = torch.arange(1 + dep_q, device=dev)
        ngram = self.wm.ngram if self.wm else 0
        per_step = cfg.depformer_weights_per_step
        use_rope = cfg.depformer_pos_emb == "rope"
        n_dep_in = p["dep_in"].shape[0]
        cond = None if condition_sum is None else condition_sum.reshape(batch, -1)
        texts, audios = [], []
        for t in range(total_steps):
            # 1. the user's input streams at their delayed slots
            for qo in range(n_in - dep_q):
                k = 1 + dep_q + qo
                if other_codes is not None and t < other_codes.shape[-1]:
                    ring[:, k, (t + full_delays[k]) % ct] = other_codes[:, qo, t].to(dev)
                else:
                    ring[:, k, (t + full_delays[k]) % ct] = 0
            # 2. initial tokens while t <= delay
            pos = t % ct
            for k, d in enumerate(full_delays):
                if t <= d:
                    ring[:, k, pos] = initial[k]
            inp = ring[:, :, pos]
            # 3. the temporal transformer on the summed embeddings
            x = p["text_emb"][inp[:, 0]]
            for s in range(n_in):
                x = x + p["audio_emb"][s * card1 + inp[:, 1 + s]]
            if cond is not None:
                x = x + cond.to(x.dtype)
            lens = torch.full((1,), t + 1, dtype=torch.int32, device=dev)
            h = _temporal_step(p["temporal"], cfg, x, t_cache, t, lens)
            # 4. text: the context is the last ngram input text tokens in the ring
            text_logits = _mm(h, p["text_head"])
            if ngram > 0:
                ctx = ring[:, 0, [(pos + 1 - ngram + i) % ct for i in range(ngram)]]
            else:
                ctx = torch.zeros((batch, 0), dtype=torch.int64, device=dev)
            text_tok = self._sample_stream(text_logits, 0, ctx, drawer(t, 0, tuple(text_logits.shape)))
            if text_prompt is not None and t < text_prompt.shape[-1]:
                text_tok = text_prompt[:, t].to(dev)
            text_tok = text_tok.to(torch.int64)
            # 5. depformer: dep_q codebooks one after the other
            dep_cache = KVCache.zeros(dcfg.n_layers, batch, dcfg.n_heads, dep_q + 1, dcfg.head_dim, device=dev)
            prev_tok_emb = p["dep_tok_emb"][dep_q * card1 + text_tok]
            frame_tokens = []
            for s in range(dep_q):
                dep_in = prev_tok_emb + _mm(h, p["dep_in"][min(s, n_dep_in - 1)])
                hd = _dep_step(p["dep"], dcfg, dep_in, dep_cache, s, step=s, per_step=per_step, use_rope=use_rope)
                logits = _mm(hd, p["dep_heads"][s])
                tok = self._sample_stream(logits, s + 1, ctx, drawer(t, s + 1, tuple(logits.shape)))
                frame_tokens.append(tok.to(torch.int64))
                prev_tok_emb = p["dep_tok_emb"][s * card1 + tok]
            frame_audio = torch.stack(frame_tokens, dim=1)  # [B, dep_q]
            if prompt_codes is not None and t < prompt_codes.shape[-1]:
                frame_audio = prompt_codes[:, :, t].to(dev, torch.int64)
            # 6. the generated frame at slot t + 1
            wpos = (t + 1) % ct
            ring[:, 0, wpos] = text_tok
            ring[:, 1:1 + dep_q, wpos] = frame_audio
            # 7. aligned emission: stream k at t + 1 - max_delay + delay_k
            if t >= max_delay:
                em = torch.tensor([(t + 1 - max_delay + d) % ct for d in full_delays[:1 + dep_q]], device=dev)
                out = ring[:, streams, em]  # [B, 1 + dep_q]
                texts.append(out[:, 0])
                audios.append(out[:, 1:])
        return torch.stack(texts, dim=1), torch.stack(audios, dim=2)  # [B, T], [B, K, T]


# ---------------------------------------------------------------------------
# Checkpoint conversion (the reference's Moshi LMModel state dict)
# ---------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _moshi_norm(sd, prefix: str) -> torch.Tensor:
    """LayerNorm ``.weight [d]`` or RMSNorm ``.alpha [1, 1, d]`` -> an rms scale."""
    if prefix + ".alpha" in sd:
        return _t(sd[prefix + ".alpha"]).reshape(-1)
    return _t(sd[prefix + ".weight"])


def convert_moshi_transformer(sd, cfg: LlamaConfig, prefix: str = "transformer.") -> list:
    """Moshi ``StreamingTransformer`` layers -> llama-style blocks: the fused
    ``in_proj_weight [3d, d]`` -> wq/wk/wv, the gating ``linear_in [2h, d]``
    -> w1 (first h rows) and w3, ``linear_out`` -> w2, norm1/norm2 ->
    attention_norm/ffn_norm, LayerScale -> ls1/ls2."""
    d = cfg.dim
    blocks = []
    for i in range(cfg.n_layers):
        p = f"{prefix}layers.{i}."
        in_proj = _t(sd[p + "self_attn.in_proj_weight"])
        lin_in = _t(sd[p + "gating.linear_in.weight"])
        h = lin_in.shape[0] // 2
        blk = {
            "attention_norm": _moshi_norm(sd, p + "norm1"),
            "ffn_norm": _moshi_norm(sd, p + "norm2"),
            "wq": in_proj[:d].T.contiguous(),
            "wk": in_proj[d:2 * d].T.contiguous(),
            "wv": in_proj[2 * d:].T.contiguous(),
            "wo": _t(sd[p + "self_attn.out_proj.weight"]).T.contiguous(),
            "w1": lin_in[:h].T.contiguous(),
            "w3": lin_in[h:].T.contiguous(),
            "w2": _t(sd[p + "gating.linear_out.weight"]).T.contiguous(),
        }
        if p + "layer_scale_1.scale" in sd:
            blk["ls1"] = _t(sd[p + "layer_scale_1.scale"])
            blk["ls2"] = _t(sd[p + "layer_scale_2.scale"])
        blocks.append(blk)
    return blocks


def convert_moshi_depformer(sd, dep_layers: int, dep_dim: int, dep_q: int, prefix: str = "depformer.") -> list:
    """Depformer layers with weights_per_step multi-linear weights: the
    per-step fused ``in_proj_weight [dep_q*3*d, d]`` (step-major), ``out_proj
    [dep_q*d, d]`` and the ``gating.{s}`` list, stacked on a leading K axis."""
    blocks = []
    for i in range(dep_layers):
        p = f"{prefix}layers.{i}."
        in_proj = _t(sd[p + "self_attn.in_proj_weight"]).reshape(dep_q, 3 * dep_dim, -1)
        out_proj = _t(sd[p + "self_attn.out_proj.weight"]).reshape(dep_q, dep_dim, -1)
        w1s, w3s, w2s = [], [], []
        for s in range(dep_q):
            lin_in = _t(sd[f"{p}gating.{s}.linear_in.weight"])
            h = lin_in.shape[0] // 2
            w1s.append(lin_in[:h].T)
            w3s.append(lin_in[h:].T)
            w2s.append(_t(sd[f"{p}gating.{s}.linear_out.weight"]).T)
        blocks.append({
            "attention_norm": _moshi_norm(sd, p + "norm1"),
            "ffn_norm": _moshi_norm(sd, p + "norm2"),
            "wq": in_proj[:, :dep_dim].transpose(1, 2).contiguous(),
            "wk": in_proj[:, dep_dim:2 * dep_dim].transpose(1, 2).contiguous(),
            "wv": in_proj[:, 2 * dep_dim:].transpose(1, 2).contiguous(),
            "wo": out_proj.transpose(1, 2).contiguous(),
            "w1": torch.stack(w1s).contiguous(),
            "w3": torch.stack(w3s).contiguous(),
            "w2": torch.stack(w2s).contiguous(),
        })
    return blocks


def convert_moshi_lm(sd, cfg: MoshiConfig) -> dict:
    """A Moshi ``LMModel`` state dict (tensors or numpy arrays, e.g. from
    :func:`wmar_tpu_torch.utils.convert.read_safetensors`) -> the parameter
    tree of :class:`MoshiGen`, equal to ``wmar_tpu.utils.convert.
    convert_moshi_lm``'s: text_emb, the ``emb.{k}`` input audio embeddings,
    the temporal layers, out_norm and text_linear, the per-codebook
    ``depformer_in.{k}``, ``depformer_text_emb`` / ``depformer_emb.{k}``, the
    weights_per_step depformer layers and the ``linears.{k}`` heads."""
    card, text_card = cfg.audio_vocab, cfg.text_vocab
    dep_q = cfg.n_audio_streams
    tvocab = cfg.temporal_cfg().vocab_size
    temporal = {
        "blocks": convert_moshi_transformer(sd, cfg.temporal_cfg(), "transformer."),
        "norm": _moshi_norm(sd, "out_norm"),
        # unused by the audio path, kept for the llama layout
        "tok_embeddings": torch.zeros((tvocab, cfg.dim)),
        "output": torch.zeros((cfg.dim, tvocab)),
    }
    n_in = 1
    while f"depformer_in.{n_in}.weight" in sd:
        n_in += 1
    dep_in = torch.stack([_t(sd[f"depformer_in.{k}.weight"]).T for k in range(n_in)])
    audio_emb = torch.cat([_t(sd[f"emb.{k}.weight"]) for k in range(cfg.num_inputs)], dim=0)
    dep_tok = torch.zeros((dep_q * (card + 1) + text_card + 1, cfg.dep_dim))
    for k in range(dep_q - 1):
        dep_tok[k * (card + 1):(k + 1) * (card + 1)] = _t(sd[f"depformer_emb.{k}.weight"])
    dep_tok[dep_q * (card + 1):] = _t(sd["depformer_text_emb.weight"])
    if "depformer.norm.alpha" in sd or "depformer.norm.weight" in sd:
        dep_norm = _moshi_norm(sd, "depformer.norm")
    else:
        dep_norm = torch.ones((cfg.dep_dim,))
    dep = {
        "blocks": convert_moshi_depformer(sd, cfg.dep_layers, cfg.dep_dim, dep_q),
        "norm": dep_norm,
        "tok_embeddings": torch.zeros((cfg.dep_cfg().vocab_size, cfg.dep_dim)),
        "output": torch.zeros((cfg.dep_dim, cfg.dep_cfg().vocab_size)),
    }
    return {
        "temporal": temporal,
        "dep": dep,
        "text_emb": _t(sd["text_emb.weight"]),
        "audio_emb": audio_emb,
        "text_head": _t(sd["text_linear.weight"]).T.contiguous(),
        "dep_in": dep_in.contiguous(),
        "dep_tok_emb": dep_tok,
        "dep_heads": torch.stack([_t(sd[f"linears.{k}.weight"]).T for k in range(dep_q)]).contiguous(),
    }
