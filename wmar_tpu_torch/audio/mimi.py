"""Mimi neural audio codec: SEANet + transformer bottleneck + split RVQ
(PyTorch).

Port of ``wmar_tpu.audio.mimi``, module for module and with the same
padding arithmetic: convs are causal (left padding ``(k - 1) * dilation -
(stride - 1)``), a transposed conv keeps the first ``stride * T`` outputs,
so ``T`` samples encode to ``T // hop`` frames and ``F`` frames decode to
``F * hop`` samples. Audio is ``[B, T, 1]`` and codes ``[B, n_q, frames]``
at the interface, as in JAX; inside, the convs run channels-first.

Module and parameter names follow the Flax tree (``encoder.block_0_0.
conv1.conv``, ``enc_transformer.in_proj_0``, ``rvq_first.codebooks``, ...);
:func:`wmar_tpu_torch.bridge.load_mimi` copies a JAX (or
:func:`convert_mimi`) tree in, turning each kernel into torch's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.models.llama import apply_rope


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    channels: int = 1
    dimension: int = 512
    n_filters: int = 64
    ratios: Sequence[int] = (8, 6, 5, 4)  # 24kHz -> 25Hz
    n_residual_layers: int = 1
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_base: int = 2
    n_q: int = 8
    n_q_semantic: int = 1
    cardinality: int = 2048
    codebook_dim: int = 256
    transformer_layers: int = 2
    transformer_heads: int = 8
    transformer_ff: Optional[int] = None  # default 4*dimension (real Mimi: 2048)
    transformer_context: int = 250  # causal attention window
    layer_scale: float = 0.01
    downsample: int = 2  # 25Hz -> 12.5Hz

    @property
    def hop_length(self) -> int:
        h = self.downsample
        for r in self.ratios:
            h *= r
        return h


MIMI_V0_1 = MimiConfig(transformer_layers=8)


class CausalConv1d(nn.Module):
    """Left-padded conv over ``[B, C, T]``; the torch conv is ``.conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.pad = max((kernel - 1) * dilation - (stride - 1), 0)
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, dilation=dilation, bias=use_bias)

    def forward(self, x):
        return self.conv(F.pad(x, (self.pad, 0)))


class CausalConvTranspose1d(nn.Module):
    """torch ``ConvTranspose1d(k, s)`` with the causal right trim: the first
    ``stride * T`` outputs. ``weight`` is torch's ``[in, out / groups, k]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros((in_ch, out_ch // groups, kernel)))
        self.bias = nn.Parameter(torch.zeros((out_ch,))) if use_bias else None

    def forward(self, x):
        y = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride, groups=self.groups)
        return y[:, :, :x.shape[-1] * self.stride]


class SEANetResnetBlock(nn.Module):
    def __init__(self, dim: int, kernel: int, dilation: int):
        super().__init__()
        self.conv1 = CausalConv1d(dim, dim // 2, kernel, dilation=dilation)
        self.conv2 = CausalConv1d(dim // 2, dim, 1)

    def forward(self, x):
        return x + self.conv2(F.elu(self.conv1(F.elu(x))))


class BottleneckTransformer(nn.Module):
    """Mimi's bottleneck transformer over ``[B, T, D]``: causal rope attention
    within a ``context`` window, a fused in_proj, LayerScale residuals,
    LayerNorm and a linear1 -> exact GELU -> linear2 FFN, no biases."""

    def __init__(self, d: int, layers: int, heads: int, ff: Optional[int] = None, context: int = 250,
                 layer_scale: float = 0.01):
        super().__init__()
        self.layers, self.heads, self.context = layers, heads, context
        ff = ff or 4 * d
        for li in range(layers):
            setattr(self, f"norm1_{li}", nn.LayerNorm(d, eps=1e-5))
            setattr(self, f"in_proj_{li}", nn.Linear(d, 3 * d, bias=False))
            setattr(self, f"out_proj_{li}", nn.Linear(d, d, bias=False))
            setattr(self, f"ls1_{li}", nn.Parameter(torch.full((d,), layer_scale)))
            setattr(self, f"norm2_{li}", nn.LayerNorm(d, eps=1e-5))
            setattr(self, f"linear1_{li}", nn.Linear(d, ff, bias=False))
            setattr(self, f"linear2_{li}", nn.Linear(ff, d, bias=False))
            setattr(self, f"ls2_{li}", nn.Parameter(torch.full((d,), layer_scale)))

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        ar = torch.arange(t, device=x.device)
        delta = ar[:, None] - ar[None, :]
        mask = (delta >= 0) & (delta < self.context)  # causal + window
        for li in range(self.layers):
            h = getattr(self, f"norm1_{li}")(x)
            qkv = getattr(self, f"in_proj_{li}")(h).reshape(b, t, 3, self.heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, t, H, hd]
            q = apply_rope(q, positions, 10000.0)
            k = apply_rope(k, positions, 10000.0)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * hd**-0.5
            s = torch.where(mask[None, None], s, -1e30)
            a = torch.softmax(s, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, t, d)
            x = x + getattr(self, f"ls1_{li}") * getattr(self, f"out_proj_{li}")(out)
            h = getattr(self, f"norm2_{li}")(x)
            h = getattr(self, f"linear2_{li}")(F.gelu(getattr(self, f"linear1_{li}")(h)))
            x = x + getattr(self, f"ls2_{li}") * h
        return x


class SEANetEncoder(nn.Module):
    """``[B, channels, T]`` -> ``[B, dimension, T / prod(ratios)]``."""

    def __init__(self, cfg: MimiConfig):
        super().__init__()
        self.cfg = cfg
        mult = 1
        self.conv_in = CausalConv1d(cfg.channels, cfg.n_filters, cfg.kernel_size)
        for bi, ratio in enumerate(reversed(cfg.ratios)):
            for ri in range(cfg.n_residual_layers):
                setattr(self, f"block_{bi}_{ri}", SEANetResnetBlock(mult * cfg.n_filters, cfg.residual_kernel_size,
                                                                    cfg.dilation_base**ri))
            setattr(self, f"down_{bi}", CausalConv1d(mult * cfg.n_filters, mult * cfg.n_filters * 2, 2 * ratio,
                                                     stride=ratio))
            mult *= 2
        self.conv_out = CausalConv1d(mult * cfg.n_filters, cfg.dimension, cfg.last_kernel_size)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for bi in range(len(cfg.ratios)):
            for ri in range(cfg.n_residual_layers):
                h = getattr(self, f"block_{bi}_{ri}")(h)
            h = getattr(self, f"down_{bi}")(F.elu(h))
        return self.conv_out(F.elu(h))


class SEANetDecoder(nn.Module):
    """``[B, dimension, frames]`` -> ``[B, channels, frames * prod(ratios)]``."""

    def __init__(self, cfg: MimiConfig):
        super().__init__()
        self.cfg = cfg
        mult = 2 ** len(cfg.ratios)
        self.conv_in = CausalConv1d(cfg.dimension, mult * cfg.n_filters, cfg.kernel_size)
        for bi, ratio in enumerate(cfg.ratios):
            setattr(self, f"up_{bi}", CausalConvTranspose1d(mult * cfg.n_filters, mult * cfg.n_filters // 2,
                                                            2 * ratio, stride=ratio))
            for ri in range(cfg.n_residual_layers):
                setattr(self, f"block_{bi}_{ri}", SEANetResnetBlock(mult * cfg.n_filters // 2,
                                                                    cfg.residual_kernel_size, cfg.dilation_base**ri))
            mult //= 2
        self.conv_out = CausalConv1d(cfg.n_filters, cfg.channels, cfg.last_kernel_size)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z)
        for bi in range(len(cfg.ratios)):
            h = getattr(self, f"up_{bi}")(F.elu(h))
            for ri in range(cfg.n_residual_layers):
                h = getattr(self, f"block_{bi}_{ri}")(h)
        return self.conv_out(F.elu(h))


class RVQ(nn.Module):
    """Residual vector quantizer with input/output projections."""

    def __init__(self, n_q: int, cardinality: int, dim: int, codebook_dim: int):
        super().__init__()
        self.n_q = n_q
        self.input_proj = nn.Linear(dim, codebook_dim, bias=False)
        self.output_proj = nn.Linear(codebook_dim, dim, bias=False)
        self.codebooks = nn.Parameter(torch.zeros((n_q, cardinality, codebook_dim)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, dim]`` -> codes ``[B, n_q, T]`` (int64): each level the
        nearest code of the residual, ``argmin |e|^2 - 2 r.e`` in float32."""
        residual = self.input_proj(x).to(torch.float32)
        codes = []
        for q in range(self.n_q):
            emb = self.codebooks[q].to(torch.float32)
            d = (emb**2).sum(-1) - 2.0 * residual @ emb.T
            idx = torch.argmin(d, dim=-1)
            codes.append(idx)
            residual = residual - emb[idx]
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, n_q, T]`` -> ``[B, T, dim]``."""
        y = 0.0
        for q in range(codes.shape[1]):
            y = y + self.codebooks[q][codes[:, q]]
        return self.output_proj(y)


class Mimi(nn.Module):
    """The codec: audio ``[B, T, 1]`` in [-1, 1] <-> codes ``[B, n_q, frames]``."""

    def __init__(self, cfg: MimiConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg)
        self.decoder = SEANetDecoder(cfg)
        kw = dict(ff=cfg.transformer_ff, context=cfg.transformer_context, layer_scale=cfg.layer_scale)
        self.enc_transformer = BottleneckTransformer(cfg.dimension, cfg.transformer_layers, cfg.transformer_heads,
                                                     **kw)
        self.dec_transformer = BottleneckTransformer(cfg.dimension, cfg.transformer_layers, cfg.transformer_heads,
                                                     **kw)
        self.rvq_first = RVQ(cfg.n_q_semantic, cfg.cardinality, cfg.dimension, cfg.codebook_dim)
        self.rvq_rest = RVQ(cfg.n_q - cfg.n_q_semantic, cfg.cardinality, cfg.dimension, cfg.codebook_dim)
        if cfg.downsample > 1:
            ds = cfg.downsample
            self.downsample_conv = CausalConv1d(cfg.dimension, cfg.dimension, 2 * ds, stride=ds, use_bias=False)
            # channel-wise, the reference's upsample_channel_wise_bug
            self.upsample_conv = CausalConvTranspose1d(cfg.dimension, cfg.dimension, 2 * ds, stride=ds,
                                                       groups=cfg.dimension, use_bias=False)

    def _to_latent(self, audio: torch.Tensor) -> torch.Tensor:
        z = self.encoder(audio.transpose(1, 2))  # [B, D, T']
        z = self.enc_transformer(z.transpose(1, 2)).transpose(1, 2)
        if self.cfg.downsample > 1:
            z = self.downsample_conv(z)
        return z.transpose(1, 2)  # [B, frames, D]

    def _from_latent(self, z: torch.Tensor) -> torch.Tensor:
        z = z.transpose(1, 2)
        if self.cfg.downsample > 1:
            z = self.upsample_conv(z)
        z = self.dec_transformer(z.transpose(1, 2)).transpose(1, 2)
        return self.decoder(z).transpose(1, 2)  # [B, T, channels]

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        z = self._to_latent(audio)
        return torch.cat([self.rvq_first.encode(z), self.rvq_rest.encode(z)], dim=1)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        nq_sem = self.cfg.n_q_semantic
        z = self.rvq_first.decode(codes[:, :nq_sem]) + self.rvq_rest.decode(codes[:, nq_sem:])
        return self._from_latent(z)


def init_mimi(cfg: MimiConfig, generator: torch.Generator, device=None) -> Mimi:
    """Random float32 weights by the Flax init's rules: conv and dense kernels
    LeCun-normal (``N(0, 1/fan_in)``; flax truncates its draw, these are
    plain normal draws), biases 0, LayerNorm 1 and 0, LayerScale at
    ``cfg.layer_scale``, codebooks ``N(0, 0.02^2)``."""
    device = torch.device("cpu") if device is None else device
    with torch.device("meta"):
        model = Mimi(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "codebooks":
                prm.copy_(torch.randn(prm.shape, generator=generator, device=device) * 0.02)
            elif leaf.startswith(("ls1_", "ls2_")):
                prm.fill_(cfg.layer_scale)
            elif leaf == "bias":
                prm.zero_()
            elif prm.dim() == 1:  # LayerNorm scale
                prm.fill_(1.0)
            else:
                if prm.dim() == 2:  # Linear [out, in]
                    fan_in = prm.shape[1]
                else:
                    parent = model.get_submodule(name.rsplit(".", 1)[0])
                    if isinstance(parent, CausalConvTranspose1d):  # [in, out / g, k]: flax's (k, in / g, out)
                        fan_in = prm.shape[2] * prm.shape[0] // parent.groups
                    else:  # Conv1d [out, in, k]
                        fan_in = prm.shape[1] * prm.shape[2]
                prm.copy_(torch.randn(prm.shape, generator=generator, device=device) * fan_in**-0.5)
    return model


# ---------------------------------------------------------------------------
# Checkpoint conversion (kyutai tokenizer-*.safetensors layout)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy() if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


def convert_mimi(sd, cfg: MimiConfig) -> dict:
    """A released Mimi state dict (tensors or numpy) -> the Flax variables
    ``{"params": ...}`` of ``wmar_tpu.audio.mimi.convert_mimi`` (numpy leaves
    in the Flax layouts, transposed-conv kernels flipped), which
    :func:`wmar_tpu_torch.bridge.load_mimi` loads.

    Layout: ``encoder.model.{i}.conv.conv`` sequential SEANet (ELU slots
    unnumbered), ``{encoder,decoder}_transformer.transformer.layers.{i}.*``,
    ``quantizer.rvq_{first,rest}`` with 1x1 projections and EMA codebooks
    (``embedding_sum / cluster_usage``), and the learned conv resampling
    (``downsample.conv.conv`` / ``upsample.convtr.convtr``)."""

    def arr(name):
        return _np(sd[name])

    def cv(p):
        out = {"kernel": np.ascontiguousarray(arr(p + ".weight").transpose(2, 1, 0))}  # [O, I, K] -> [K, I, O]
        if p + ".bias" in sd:
            out["bias"] = arr(p + ".bias")
        return out

    def cvt(p, channel_wise=False):
        w = arr(p + ".weight")  # [I, O/g, K]
        k = w.transpose(2, 1, 0)[::-1] if channel_wise else w.transpose(2, 0, 1)[::-1]
        out = {"kernel": np.ascontiguousarray(k)}
        if p + ".bias" in sd:
            out["bias"] = arr(p + ".bias")
        return out

    def resblock(bp):
        return {"conv1": {"conv": cv(f"{bp}.1.conv.conv")}, "conv2": {"conv": cv(f"{bp}.3.conv.conv")}}

    def seanet_enc(prefix):
        out = {"conv_in": {"conv": cv(f"{prefix}.model.0.conv.conv")}}
        idx = 1
        for bi in range(len(cfg.ratios)):
            for ri in range(cfg.n_residual_layers):
                out[f"block_{bi}_{ri}"] = resblock(f"{prefix}.model.{idx}.block")
                idx += 1
            idx += 1  # ELU
            out[f"down_{bi}"] = {"conv": cv(f"{prefix}.model.{idx}.conv.conv")}
            idx += 1
        idx += 1  # ELU
        out["conv_out"] = {"conv": cv(f"{prefix}.model.{idx}.conv.conv")}
        return out

    def seanet_dec(prefix):
        out = {"conv_in": {"conv": cv(f"{prefix}.model.0.conv.conv")}}
        idx = 1
        for bi in range(len(cfg.ratios)):
            idx += 1  # ELU
            out[f"up_{bi}"] = cvt(f"{prefix}.model.{idx}.convtr.convtr")
            idx += 1
            for ri in range(cfg.n_residual_layers):
                out[f"block_{bi}_{ri}"] = resblock(f"{prefix}.model.{idx}.block")
                idx += 1
        idx += 1  # ELU
        out["conv_out"] = {"conv": cv(f"{prefix}.model.{idx}.conv.conv")}
        return out

    def transformer(prefix):
        out = {}
        for i in range(cfg.transformer_layers):
            p = f"{prefix}.transformer.layers.{i}"
            out[f"norm1_{i}"] = {"scale": arr(p + ".norm1.weight"), "bias": arr(p + ".norm1.bias")}
            out[f"norm2_{i}"] = {"scale": arr(p + ".norm2.weight"), "bias": arr(p + ".norm2.bias")}
            for name, key in (("in_proj", ".self_attn.in_proj_weight"), ("out_proj", ".self_attn.out_proj.weight"),
                              ("linear1", ".linear1.weight"), ("linear2", ".linear2.weight")):
                out[f"{name}_{i}"] = {"kernel": np.ascontiguousarray(arr(p + key).T)}
            out[f"ls1_{i}"] = arr(p + ".layer_scale_1.scale")
            out[f"ls2_{i}"] = arr(p + ".layer_scale_2.scale")
        return out

    def rvq(prefix, n_q):
        def emb(q):
            base = f"{prefix}.vq.layers.{q}._codebook"
            if base + ".embedding_sum" in sd:
                s, u = arr(base + ".embedding_sum"), arr(base + ".cluster_usage")
            else:  # older naming
                s, u = arr(base + ".embed_sum"), arr(base + ".cluster_size")
            return s / np.maximum(u, 1e-5)[:, None]

        return {
            "input_proj": {"kernel": np.ascontiguousarray(arr(f"{prefix}.input_proj.weight")[:, :, 0].T)},
            "output_proj": {"kernel": np.ascontiguousarray(arr(f"{prefix}.output_proj.weight")[:, :, 0].T)},
            "codebooks": np.stack([emb(q) for q in range(n_q)]),
        }

    params = {
        "encoder": seanet_enc("encoder"),
        "decoder": seanet_dec("decoder"),
        "enc_transformer": transformer("encoder_transformer"),
        "dec_transformer": transformer("decoder_transformer"),
        "rvq_first": rvq("quantizer.rvq_first", cfg.n_q_semantic),
        "rvq_rest": rvq("quantizer.rvq_rest", cfg.n_q - cfg.n_q_semantic),
    }
    if cfg.downsample > 1:
        params["downsample_conv"] = {"conv": cv("downsample.conv.conv.conv")}
        params["upsample_conv"] = cvt("upsample.convtr.convtr.convtr", channel_wise=True)
    return {"params": params}
