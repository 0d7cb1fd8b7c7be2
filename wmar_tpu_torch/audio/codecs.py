"""EnCodec and DAC, the audio grid's codec attacks (PyTorch).

Port of ``wmar_tpu.audio.codecs``: the round trips of EnCodec 24 kHz (HF
``facebook/encodec_24khz`` and the encodec package: a causal SEANet with
reflect padding, 1x1 shortcuts, a two-layer LSTM with a skip, residual VQ
by argmin) and of descript's DAC 24 kHz (a non-causal snake SEANet and a
projected, L2-normalised residual VQ), with the same padding arithmetic.
Audio is ``[B, T, 1]`` at the interface, codes ``[B, n_q, frames]``; the
convolutions run channels-first inside (cuDNN on the card).

The SEANet here (:class:`SEANetEncoder`, :class:`SEANetDecoder`) also
serves AudioSeal (:mod:`wmar_tpu_torch.audio.audioseal`), built
non-causal with zero padding. Module names follow the JAX package's
parameter trees (``encoder.down.0.res.0.conv1``, ``decoder.up.1.up``,
``quantizer.0.in_proj``), so :func:`wmar_tpu_torch.bridge.load_encodec`
/ :func:`~wmar_tpu_torch.bridge.load_dac` copy a tree of the converters
below (the JAX package's, copied) into a module.

Published layouts: :func:`convert_encodec` reads HF's
(``encoder.layers.{i}.conv``) and the encodec package's
(``encoder.model.{i}.conv.conv``), :func:`convert_dac` descript's; both
compose weight norm in numpy, from ``weight_g`` / ``weight_v`` or
``parametrizations.weight.original0/1``. The writers
:func:`encodec_state_dict` and :func:`dac_state_dict` turn a module back
into those layouts, so a random module can be written as a published file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    n_residual_layers: int = 1
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    lstm_layers: int = 2
    # the reference's attack runs at the default bandwidth, 1.5 kbps: 2 quantizers
    n_q: int = 2
    bins: int = 1024
    pad_mode: str = "reflect"  # HF EncodecConfig.pad_mode for encodec_24khz

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))


ENCODEC_24K = EncodecConfig()


@dataclasses.dataclass(frozen=True)
class DACConfig:
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    latent_dim: int = 1024  # encoder_dim * 2**len(rates)
    n_codebooks: int = 32
    codebook_size: int = 1024
    codebook_dim: int = 8
    n_q: int = 8

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))


DAC_24K = DACConfig()


# ---------------------------------------------------------------------------
# SEANet (EnCodec causal / reflect; AudioSeal non-causal / zeros)
# ---------------------------------------------------------------------------


def pad1d(x, left: int, right: int, mode: str = "zero"):
    """HF ``EncodecConv1d._pad1d`` over ``[B, C, T]``: reflect padding with
    the small-input guard (zero-extend on the right before reflecting when
    ``T <= max(left, right)``, then drop that extension)."""
    if mode != "reflect":
        return F.pad(x, (left, right))
    t = x.shape[-1]
    extra = max(left, right) - t + 1 if t <= max(left, right) else 0
    if extra > 0:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra > 0 else y


class SConv1d(nn.Conv1d):
    """A SEANet conv over ``[B, C, T]`` with audiocraft's padding: the pad a
    stride leaves (``(k - 1) * dilation + 1 - stride``) plus the extra right
    pad that completes the last frame. Causal (EnCodec): the whole pad on
    the left, in ``pad_mode``; non-causal (AudioSeal): zeros, ``total //
    2`` on the right and the rest on the left."""

    def __init__(self, i: int, o: int, k: int, stride: int = 1, dilation: int = 1, causal: bool = True,
                 pad_mode: str = "reflect"):
        super().__init__(i, o, k, stride=stride, dilation=dilation)
        self.causal, self.pad_mode = causal, pad_mode

    def forward(self, x):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        keff = (k - 1) * d + 1
        total = keff - s
        t = x.shape[-1]
        n_frames = -(-(t - keff + total) // s)
        extra = n_frames * s + keff - total - t
        if self.causal:
            x = pad1d(x, max(total, 0), max(extra, 0), self.pad_mode)
        else:
            right = total // 2
            x = F.pad(x, (max(total - right, 0), max(right + extra, 0)))
        return super().forward(x)


class SConvTranspose1d(nn.ConvTranspose1d):
    """``ConvTranspose1d(k, stride)`` trimmed to ``T * stride`` outputs:
    causal keeps the first ones, non-causal drops ``(k - s) - (k - s) // 2``
    on the left and ``(k - s) // 2`` on the right."""

    def __init__(self, i: int, o: int, k: int, stride: int, causal: bool = True):
        super().__init__(i, o, k, stride=stride)
        self.causal = causal

    def forward(self, x):
        y = super().forward(x)
        total = self.kernel_size[0] - self.stride[0]
        left = 0 if self.causal else total - total // 2
        return y[..., left: left + x.shape[-1] * self.stride[0]]


class ResBlock(nn.Module):
    """ELU, conv k (dilated), ELU, conv 1, plus a 1x1 shortcut conv."""

    def __init__(self, dim: int, kernel: int, dilation: int, **conv):
        super().__init__()
        self.conv1 = SConv1d(dim, dim // 2, kernel, dilation=dilation, **conv)
        self.conv2 = SConv1d(dim // 2, dim, 1, **conv)
        self.shortcut = SConv1d(dim, dim, 1, **conv)

    def forward(self, x):
        return self.shortcut(x) + self.conv2(F.elu(self.conv1(F.elu(x))))


def _skip_lstm(lstm: nn.LSTM, x):
    """The SLSTM / ``EncodecLSTM`` over ``[B, C, T]``: the LSTM plus its input."""
    h = x.transpose(1, 2)
    return (lstm(h)[0] + h).transpose(1, 2)


class _Stage(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class SEANetEncoder(nn.Module):
    """``[B, channels, T]`` -> ``[B, dimension, T / hop]``. ``cfg`` is an
    :class:`EncodecConfig` or an AudioSeal config (the same fields)."""

    def __init__(self, cfg, causal: bool = True, pad_mode: str = "reflect"):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        f = cfg.n_filters
        self.conv_in = SConv1d(cfg.channels, f, cfg.kernel_size, **conv)
        self.down = nn.ModuleList()
        mult = 1
        for ratio in reversed(cfg.ratios):
            res = nn.ModuleList(ResBlock(mult * f, cfg.residual_kernel_size, cfg.dilation_base ** j, **conv)
                                for j in range(cfg.n_residual_layers))
            self.down.append(_Stage(res=res, down=SConv1d(mult * f, 2 * mult * f, 2 * ratio, stride=ratio, **conv)))
            mult *= 2
        self.lstm = nn.LSTM(mult * f, mult * f, cfg.lstm_layers, batch_first=True)
        self.conv_out = SConv1d(mult * f, cfg.dimension, cfg.last_kernel_size, **conv)

    def forward(self, x):
        h = self.conv_in(x)
        for stage in self.down:
            for block in stage.res:
                h = block(h)
            h = stage.down(F.elu(h))
        return self.conv_out(F.elu(_skip_lstm(self.lstm, h)))


class SEANetDecoder(nn.Module):
    """``[B, dimension, frames]`` -> ``[B, channels, frames * hop]``."""

    def __init__(self, cfg, causal: bool = True, pad_mode: str = "reflect"):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        f = cfg.n_filters
        mult = 2 ** len(cfg.ratios)
        self.conv_in = SConv1d(cfg.dimension, mult * f, cfg.kernel_size, **conv)
        self.lstm = nn.LSTM(mult * f, mult * f, cfg.lstm_layers, batch_first=True)
        self.up = nn.ModuleList()
        for ratio in cfg.ratios:
            res = nn.ModuleList(ResBlock(mult * f // 2, cfg.residual_kernel_size, cfg.dilation_base ** j, **conv)
                                for j in range(cfg.n_residual_layers))
            self.up.append(_Stage(up=SConvTranspose1d(mult * f, mult * f // 2, 2 * ratio, ratio, causal=causal),
                                  res=res))
            mult //= 2
        self.conv_out = SConv1d(f, cfg.channels, cfg.last_kernel_size, **conv)

    def forward(self, z):
        h = _skip_lstm(self.lstm, self.conv_in(z))
        for stage in self.up:
            h = stage.up(F.elu(h))
            for block in stage.res:
                h = block(h)
        return self.conv_out(F.elu(h))


# ---------------------------------------------------------------------------
# EnCodec
# ---------------------------------------------------------------------------


def rvq_encode(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Residual VQ by argmin: codebooks ``[n_q, bins, D]``, z ``[B, T, D]``
    -> codes ``[B, n_q, T]``."""
    codes = []
    residual = z
    for cb in codebooks:
        d = (cb ** 2).sum(-1)[None, None, :] - 2.0 * torch.einsum("btd,kd->btk", residual, cb)
        idx = d.argmin(-1)
        residual = residual - cb[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def rvq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, n_q, T]`` -> ``[B, T, D]``."""
    out = codebooks[0][codes[:, 0]]
    for q in range(1, codebooks.shape[0]):
        out = out + codebooks[q][codes[:, q]]
    return out


class Encodec(nn.Module):
    """EnCodec's round trip at ``cfg``'s first ``n_q`` codebooks."""

    def __init__(self, cfg: EncodecConfig = ENCODEC_24K):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg, causal=True, pad_mode=cfg.pad_mode)
        self.decoder = SEANetDecoder(cfg, causal=True, pad_mode=cfg.pad_mode)
        self.codebooks = nn.Parameter(torch.zeros((cfg.n_q, cfg.bins, cfg.dimension)))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """``[B, T, 1]`` -> codes ``[B, n_q, T / hop]``."""
        z = self.encoder(audio.transpose(1, 2)).transpose(1, 2)
        return rvq_encode(self.codebooks, z)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, n_q, frames]`` -> ``[B, frames * hop, 1]``."""
        return self.decoder(rvq_decode(self.codebooks, codes).transpose(1, 2)).transpose(1, 2)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(audio))


# ---------------------------------------------------------------------------
# DAC
# ---------------------------------------------------------------------------


class Snake(nn.Module):
    """Snake1d: ``x + sin^2(alpha x) / (alpha + 1e-9)``; ``alpha`` is kept as
    the JAX tree's ``[1, 1, C]``, applied over ``[B, C, T]``."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones((1, 1, c)))

    def forward(self, x):
        a = self.alpha.reshape(1, -1, 1)
        return x + torch.sin(a * x) ** 2 / (a + 1e-9)


class DACResUnit(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.snake1 = Snake(dim)
        self.conv1 = nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation)
        self.snake2 = Snake(dim)
        self.conv2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class DACEncoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        d = cfg.encoder_dim
        self.conv_in = nn.Conv1d(1, d, 7, padding=3)
        self.blocks = nn.ModuleList()
        for s in cfg.encoder_rates:
            self.blocks.append(_Stage(res=nn.ModuleList(DACResUnit(d, dil) for dil in (1, 3, 9)), snake=Snake(d),
                                      down=nn.Conv1d(d, 2 * d, 2 * s, stride=s, padding=-(-s // 2))))
            d *= 2
        self.snake_out = Snake(d)
        self.conv_out = nn.Conv1d(d, cfg.latent_dim, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.blocks:
            for unit in blk.res:
                h = unit(h)
            h = blk.down(blk.snake(h))
        return self.conv_out(self.snake_out(h))


class DACDecoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        d = cfg.decoder_dim
        self.conv_in = nn.Conv1d(cfg.latent_dim, d, 7, padding=3)
        self.blocks = nn.ModuleList()
        for s in cfg.decoder_rates:
            # WNConvTranspose1d(k = 2s, stride s, padding ceil(s / 2))
            self.blocks.append(_Stage(snake=Snake(d), up=nn.ConvTranspose1d(d, d // 2, 2 * s, stride=s,
                                                                            padding=-(-s // 2)),
                                      res=nn.ModuleList(DACResUnit(d // 2, dil) for dil in (1, 3, 9))))
            d //= 2
        self.snake_out = Snake(d)
        self.conv_out = nn.Conv1d(d, 1, 7, padding=3)

    def forward(self, z):
        h = self.conv_in(z)
        for blk in self.blocks:
            h = blk.up(blk.snake(h))
            for unit in blk.res:
                h = unit(h)
        return torch.tanh(self.conv_out(self.snake_out(h)))


class DACQuantizer(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.in_proj = nn.Conv1d(cfg.latent_dim, cfg.codebook_dim, 1)
        self.out_proj = nn.Conv1d(cfg.codebook_dim, cfg.latent_dim, 1)
        self.codebook = nn.Parameter(torch.zeros((cfg.codebook_size, cfg.codebook_dim)))


def _l2n(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-9)


class DAC(nn.Module):
    """DAC's round trip over its first ``n_q`` projected codebooks."""

    def __init__(self, cfg: DACConfig = DAC_24K):
        super().__init__()
        self.cfg = cfg
        self.encoder = DACEncoder(cfg)
        self.decoder = DACDecoder(cfg)
        self.quantizer = nn.ModuleList(DACQuantizer(cfg) for _ in range(cfg.n_q))

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """``[B, T, 1]`` -> codes ``[B, n_q, T / hop]``: each codebook's
        argmin of the L2-normalised projection, the residual minus its
        projected-back code."""
        residual = self.encoder(audio.transpose(1, 2))
        codes = []
        for vq in self.quantizer:
            zp_n = _l2n(vq.in_proj(residual).transpose(1, 2))
            cb_n = _l2n(vq.codebook)
            d = (cb_n ** 2).sum(-1)[None, None] - 2 * torch.einsum("btd,kd->btk", zp_n, cb_n)
            idx = d.argmin(-1)
            residual = residual - vq.out_proj(vq.codebook[idx].transpose(1, 2))
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, n_q, frames]`` -> ``[B, frames * hop, 1]``."""
        z_hat = 0.0
        for q, vq in enumerate(self.quantizer):
            z_hat = z_hat + vq.out_proj(vq.codebook[codes[:, q]].transpose(1, 2))
        return self.decoder(z_hat).transpose(1, 2)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(audio))


# ---------------------------------------------------------------------------
# Conversion: published state dicts <-> the JAX package's trees
# ---------------------------------------------------------------------------


def _composed(sd, p) -> np.ndarray:
    """A conv's torch-layout weight with weight norm composed: ``g * v /
    ||v||``, the norm over all but dim 0 (the output channels of a conv, the
    input channels of a transposed conv)."""
    for g_key, v_key in ((".weight_g", ".weight_v"),
                         (".parametrizations.weight.original0", ".parametrizations.weight.original1")):
        if p + g_key in sd:
            g = np.asarray(sd[p + g_key])
            v = np.asarray(sd[p + v_key])
            return g * v / np.maximum(np.linalg.norm(v.reshape(v.shape[0], -1), axis=1)[:, None, None], 1e-12)
    return np.asarray(sd[p + ".weight"])


def _wn_conv(sd, p) -> dict:
    """torch conv1d ``[O, I, K]`` (weight-normed or not) -> ``{"kernel" [K, I, O], "bias"}``."""
    out = {"kernel": np.ascontiguousarray(_composed(sd, p).transpose(2, 1, 0))}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _wn_convtr(sd, p) -> dict:
    """ConvTranspose1d ``[I, O, K]`` -> flipped ``[K, I, O]`` (the lhs-dilated
    conv's kernel, as the JAX package stores it)."""
    out = {"kernel": np.ascontiguousarray(_composed(sd, p).transpose(2, 0, 1)[::-1])}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _lstm_params(sd, prefix, layers) -> List[dict]:
    out = []
    for k in range(layers):
        w_ih = np.asarray(sd[f"{prefix}.weight_ih_l{k}"]).T
        w_hh = np.asarray(sd[f"{prefix}.weight_hh_l{k}"]).T
        b = np.asarray(sd[f"{prefix}.bias_ih_l{k}"]) + np.asarray(sd[f"{prefix}.bias_hh_l{k}"])
        out.append({"w_ih": np.ascontiguousarray(w_ih), "w_hh": np.ascontiguousarray(w_hh), "b": b})
    return out


def _snake(sd, p) -> dict:
    return {"alpha": np.asarray(sd[p + ".alpha"]).reshape(1, 1, -1)}


_READERS = {"conv": _wn_conv, "convtr": _wn_convtr, "snake": _snake}


def seanet_pairs(cfg, enc: Optional[str], dec: Optional[str], hf: bool = False) -> List[tuple]:
    """``(tree path, state-dict prefix, kind)`` of every SEANet layer: the
    encoder's under the tree root ``encoder`` and the Sequential ``enc``,
    the decoder's under ``decoder`` and ``dec`` (None leaves one out).
    Kinds: ``conv``, ``convtr`` and ``lstm`` (with the layer count). The
    Sequential indexing is the same in HF's layout (``{seq}.{i}.conv``)
    and audiocraft's (``{seq}.{i}.conv.conv``, ``.convtr.convtr``): ELUs
    take an index and hold nothing."""
    conv_sfx, convtr_sfx = (".conv", ".conv") if hf else (".conv.conv", ".convtr.convtr")
    pairs = []

    def res(path, prefix):
        pairs.extend([((*path, "conv1"), f"{prefix}.block.1{conv_sfx}", "conv"),
                      ((*path, "conv2"), f"{prefix}.block.3{conv_sfx}", "conv"),
                      ((*path, "shortcut"), f"{prefix}.shortcut{conv_sfx}", "conv")])

    if enc is not None:
        pairs.append((("encoder", "conv_in"), f"{enc}.0{conv_sfx}", "conv"))
        idx = 1
        for bi in range(len(cfg.ratios)):
            for ri in range(cfg.n_residual_layers):
                res(("encoder", "down", bi, "res", ri), f"{enc}.{idx}")
                idx += 1
            idx += 1  # ELU
            pairs.append((("encoder", "down", bi, "down"), f"{enc}.{idx}{conv_sfx}", "conv"))
            idx += 1
        pairs.append((("encoder", "lstm"), f"{enc}.{idx}.lstm", ("lstm", cfg.lstm_layers)))
        idx += 2  # LSTM + ELU
        pairs.append((("encoder", "conv_out"), f"{enc}.{idx}{conv_sfx}", "conv"))
    if dec is not None:
        pairs.append((("decoder", "conv_in"), f"{dec}.0{conv_sfx}", "conv"))
        pairs.append((("decoder", "lstm"), f"{dec}.1.lstm", ("lstm", cfg.lstm_layers)))
        idx = 2
        for bi in range(len(cfg.ratios)):
            idx += 1  # ELU
            pairs.append((("decoder", "up", bi, "up"), f"{dec}.{idx}{convtr_sfx}", "convtr"))
            idx += 1
            for ri in range(cfg.n_residual_layers):
                res(("decoder", "up", bi, "res", ri), f"{dec}.{idx}")
                idx += 1
        idx += 1  # ELU
        pairs.append((("decoder", "conv_out"), f"{dec}.{idx}{conv_sfx}", "conv"))
    return pairs


def dac_pairs(cfg: DACConfig) -> List[tuple]:
    """descript DAC's layers as ``(tree path, state-dict prefix, kind)``
    (``dac/model/dac.py`` Encoder / Decoder, ``nn/quantize.py``)."""
    pairs = []

    def resunit(path, p):
        pairs.extend([((*path, "snake1"), p + ".block.0", "snake"), ((*path, "conv1"), p + ".block.1", "conv"),
                      ((*path, "snake2"), p + ".block.2", "snake"), ((*path, "conv2"), p + ".block.3", "conv")])

    pairs.append((("encoder", "conv_in"), "encoder.block.0", "conv"))
    for bi in range(len(cfg.encoder_rates)):
        p = f"encoder.block.{bi + 1}.block"
        for j in range(3):
            resunit(("encoder", "blocks", bi, "res", j), f"{p}.{j}")
        pairs += [(("encoder", "blocks", bi, "snake"), f"{p}.3", "snake"),
                  (("encoder", "blocks", bi, "down"), f"{p}.4", "conv")]
    n = len(cfg.encoder_rates) + 1
    pairs += [(("encoder", "snake_out"), f"encoder.block.{n}", "snake"),
              (("encoder", "conv_out"), f"encoder.block.{n + 1}", "conv"),
              (("decoder", "conv_in"), "decoder.model.0", "conv")]
    for bi in range(len(cfg.decoder_rates)):
        p = f"decoder.model.{bi + 1}.block"
        pairs += [(("decoder", "blocks", bi, "snake"), f"{p}.0", "snake"),
                  (("decoder", "blocks", bi, "up"), f"{p}.1", "convtr")]
        for j in range(3):
            resunit(("decoder", "blocks", bi, "res", j), f"{p}.{j + 2}")
    n = len(cfg.decoder_rates) + 1
    pairs += [(("decoder", "snake_out"), f"decoder.model.{n}", "snake"),
              (("decoder", "conv_out"), f"decoder.model.{n + 1}", "conv")]
    for q in range(cfg.n_q):
        p = f"quantizer.quantizers.{q}"
        pairs += [(("quantizer", q, "in_proj"), p + ".in_proj", "conv"),
                  (("quantizer", q, "out_proj"), p + ".out_proj", "conv"),
                  (("quantizer", q, "codebook"), p + ".codebook.weight", "weight")]
    return pairs


def _read(sd, prefix, kind):
    if isinstance(kind, tuple):
        return _lstm_params(sd, prefix, kind[1])
    if kind == "weight":
        return np.asarray(sd[prefix])
    return _READERS[kind](sd, prefix)


def _tree(sd, pairs) -> dict:
    """The JAX package's tree (dicts, and lists where a path part is an int)."""
    tree: dict = {}
    for path, prefix, kind in pairs:
        node = tree
        for part, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= part:
                    node.append([] if isinstance(nxt, int) else {})
                node = node[part]
            else:
                node = node.setdefault(part, [] if isinstance(nxt, int) else {})
        node[path[-1]] = _read(sd, prefix, kind)
    return tree


def convert_encodec(sd, cfg: EncodecConfig = ENCODEC_24K) -> dict:
    """An EnCodec state dict -> the tree ``{"encoder", "decoder",
    "codebooks" [n_q, bins, D]}`` (the JAX package's ``convert_encodec``).
    The layout is detected: HF transformers (``encoder.layers.{i}.conv``,
    ``quantizer.layers.{q}.codebook.embed``) or the encodec package
    (``encoder.model.{i}.conv.conv``, ``quantizer.vq.layers.{q}._codebook.embed``).
    ``cfg.n_q`` takes the first codebooks (the bandwidth tier)."""
    hf = any(k.startswith(("encoder.layers.", "decoder.layers.")) for k in sd)
    seq = "layers" if hf else "model"
    tree = _tree(sd, seanet_pairs(cfg, f"encoder.{seq}", f"decoder.{seq}", hf=hf))
    cb_key = "quantizer.layers.{q}.codebook.embed" if hf else "quantizer.vq.layers.{q}._codebook.embed"
    tree["codebooks"] = np.stack([np.asarray(sd[cb_key.format(q=q)]) for q in range(cfg.n_q)])
    return tree


def convert_dac(sd, cfg: DACConfig = DAC_24K) -> dict:
    """A descript-audio-codec state dict -> the tree ``{"encoder", "decoder",
    "quantizer"}`` (the JAX package's ``convert_dac``). The strides come from
    ``cfg``, so a strided conv whose kernel is not ``2 * stride`` wide (a file
    of other rates) raises rather than run at another hop."""
    for path, prefix, kind in dac_pairs(cfg):
        if path[-1] in ("down", "up"):
            rates = cfg.encoder_rates if path[0] == "encoder" else cfg.decoder_rates
            width = _composed(sd, prefix).shape[-1]
            if width != 2 * rates[path[2]]:
                raise ValueError(f"{prefix}: kernel width {width}, but the config's stride {rates[path[2]]} needs "
                                 f"{2 * rates[path[2]]}: the file's rates are not {tuple(rates)}")
    return _tree(sd, dac_pairs(cfg))


def _weight_out(sd, prefix, w: torch.Tensor, weight_norm: Optional[str]) -> None:
    if weight_norm is None:
        sd[prefix + ".weight"] = w
        return
    g = torch.linalg.vector_norm(w.reshape(w.shape[0], -1), dim=1).reshape(-1, 1, 1)
    names = {"weight_norm": (".weight_g", ".weight_v"),
             "parametrizations": (".parametrizations.weight.original0", ".parametrizations.weight.original1")}
    sd[prefix + names[weight_norm][0]], sd[prefix + names[weight_norm][1]] = g, w.clone()


def _state_dict(model: nn.Module, pairs, weight_norm: Optional[str]) -> Dict[str, torch.Tensor]:
    """The published state dict of ``model``, whose submodules sit at the
    pairs' tree paths: torch's own weight layouts, weight norm as ``g =
    ||w||``, ``v = w`` in the ``weight_norm`` naming (None: plain weights),
    the LSTM's biases as they are."""
    sd: Dict[str, torch.Tensor] = {}
    for path, prefix, kind in pairs:
        mod_path = ".".join(str(p) for p in path)
        if kind == "weight":
            mod_name, name = mod_path.rsplit(".", 1)
            sd[prefix] = getattr(model.get_submodule(mod_name), name).detach().clone()
            continue
        mod = model.get_submodule(mod_path)
        if isinstance(kind, tuple):
            for k, v in mod.state_dict().items():
                sd[f"{prefix}.{k}"] = v.detach().clone()
        elif kind == "snake":
            sd[prefix + ".alpha"] = mod.alpha.detach().reshape(1, -1, 1).clone()
        else:
            _weight_out(sd, prefix, mod.weight.detach(), weight_norm)
            if mod.bias is not None:
                sd[prefix + ".bias"] = mod.bias.detach().clone()
    return sd


def encodec_state_dict(model: Encodec, layout: str = "hf",
                       weight_norm: Optional[str] = "weight_norm") -> Dict[str, torch.Tensor]:
    """``model`` as a published EnCodec state dict: ``layout`` "hf"
    (``facebook/encodec_24khz``) or "encodec" (the encodec package), with
    its ``n_q`` codebooks; the inverse of :func:`convert_encodec`."""
    hf = layout == "hf"
    seq = "layers" if hf else "model"
    sd = _state_dict(model, seanet_pairs(model.cfg, f"encoder.{seq}", f"decoder.{seq}", hf=hf), weight_norm)
    cb_key = "quantizer.layers.{q}.codebook.embed" if hf else "quantizer.vq.layers.{q}._codebook.embed"
    for q in range(model.cfg.n_q):
        sd[cb_key.format(q=q)] = model.codebooks[q].detach().clone()
    return sd


def dac_state_dict(model: DAC, weight_norm: Optional[str] = "weight_norm") -> Dict[str, torch.Tensor]:
    """``model`` as a descript DAC state dict (the inverse of :func:`convert_dac`)."""
    return _state_dict(model, dac_pairs(model.cfg), weight_norm)


@torch.no_grad()
def _init_codec_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place from ``generator`` (no global RNG): convs and
    LSTMs uniform within ``1 / sqrt(fan_in)`` (torch's default bounds),
    snake ``alpha`` 1 + 0.1 N(0, 1), codebooks and embeddings N(0, 1)."""
    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator, device=t.device) * 2 - 1) * bound)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)):
            fan_in = mod.in_channels // mod.groups * mod.kernel_size[0]
            for t in (mod.weight, mod.bias):
                if t is not None:
                    uniform_(t, fan_in ** -0.5)
        elif isinstance(mod, nn.LSTM):
            for t in mod.parameters():
                uniform_(t, mod.hidden_size ** -0.5)
        elif isinstance(mod, Snake):
            mod.alpha.copy_(1 + 0.1 * torch.randn(mod.alpha.shape, generator=generator, device=mod.alpha.device))
    for name, p in model.named_parameters():
        if name.split(".")[-1] in ("codebooks", "codebook", "msg_embed"):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
    return model


def random_codec(build, generator: torch.Generator, device="cpu") -> nn.Module:
    """``build()`` on the meta device, then random weights on ``device``
    from ``generator`` (:func:`_init_codec_`): nothing drawn from the global
    RNG, no CPU copy of a full-width model."""
    with torch.device("meta"):
        model = build()
    return _init_codec_(model.to_empty(device=device), generator).eval()


# ---------------------------------------------------------------------------
# The attack
# ---------------------------------------------------------------------------


class CodecCompression:
    """A codec round trip as an attack (the reference's EncodecCompression
    / DacCompression): zero-pad ``[B, T, 1]`` to the hop, run, crop back.
    Needs weights: a random codec is noise injection, not compression."""

    def __init__(self, model: nn.Module):
        self.model, self.cfg = model.eval(), model.cfg

    @torch.no_grad()
    def __call__(self, audio, param=None, generator=None):
        hop, t = self.cfg.hop_length, audio.shape[1]
        x = F.pad(audio.to(torch.float32).transpose(1, 2), (0, -(-t // hop) * hop - t)).transpose(1, 2)
        return self.model(x)[:, :t]

    @staticmethod
    def from_checkpoint(kind: str, path: str, cfg=None, device="cpu") -> "CodecCompression":
        """From a published ``.pth`` / ``.safetensors`` (HF or encodec-package
        EnCodec, descript DAC) at ``cfg`` (default the 24 kHz geometries)."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.augmentations.neural import read_state_dict

        sd = read_state_dict(path)
        if kind == "encodec":
            cfg = cfg or ENCODEC_24K
            return CodecCompression(bridge.load_encodec(convert_encodec(sd, cfg), cfg, device))
        if kind == "dac":
            cfg = cfg or DAC_24K
            return CodecCompression(bridge.load_dac(convert_dac(sd, cfg), cfg, device))
        raise ValueError(kind)
