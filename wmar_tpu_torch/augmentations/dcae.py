"""DC-AE (Deep Compression Autoencoder, EfficientViT) in PyTorch.

Port of ``wmar_tpu.augmentations.dcae``: ``diffusers``' ``AutoencoderDC``
as the reference's ``DeepCompressionAE`` runs it
(``wmar/augmentations/neuralcompression.py:206-214``,
``mit-han-lab/dc-ae-f64c128-in-1.0-diffusers``): images rescaled to
[-1, 1], encoded without a posterior draw, decoded and rescaled back; the
nominal bpp is 1 (128 channels x 32 bits / 64^2 pixels).

Blocks (diffusers naming, NCHW here):

- ``ResBlock``: conv3x3 -> silu -> conv3x3 (no bias) -> norm -> + residual
- ``GLUMBConv``: 1x1 expand (x2) -> silu -> depthwise 3x3 -> gate
  (x * silu(g)) -> 1x1 project (no bias) -> RMS norm -> + residual
- ``SanaMultiscaleLinearAttention``: ReLU linear attention (the value
  padded with a row of ones as the normalizer) over the concatenated [qkv,
  multiscale-conv(qkv)] branches; the quadratic form when the token count
  is at most the head dim
- ``DCDownBlock2d``: a strided conv or conv + pixel_unshuffle, plus a
  pixel-unshuffle + channel-group-average shortcut
- ``DCUpBlock2d``: nearest interpolate + conv or conv + pixel_shuffle, plus
  a channel repeat_interleave + pixel_shuffle shortcut
- the encoder's ``out_shortcut`` (a channel-group average onto the latent)
  and the decoder's ``in_shortcut`` (the latent repeated onto the trunk)

:func:`convert_dcae` reads the whole stage geometry off a state dict (the
JAX package's shape-driven converter, copied); :class:`DCAEConfig` holds
it, and ``wmar_tpu_torch.bridge.load_dcae`` builds a :class:`DCAE` from a
config and a parameter tree. Norms hold ``mean`` / ``var`` only when the
tree has them (BatchNorm); otherwise they are RMS norms.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS_NORM = 1e-5
_EPS_ATTN = 1e-15


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
    kind: str  # "res" | "evit" | "down" | "up" | "conv"
    out_channels: int = 0  # down/up: target channels (for the shortcut math)
    mode: str = ""  # down: "conv"|"pixel_unshuffle"; up: "interpolate"|"pixel_shuffle"
    shortcut: bool = True
    multiscales: Tuple[int, ...] = ()  # evit: multiscale kernel sizes


@dataclasses.dataclass(frozen=True)
class DCAEConfig:
    encoder_ops: Tuple[Tuple[OpSpec, ...], ...]  # ops per encoder stage
    decoder_ops: Tuple[Tuple[OpSpec, ...], ...]  # ops per decoder stage (as stored)
    enc_stem: OpSpec  # "conv" or "down" (a 0-layer first stage: a downsampling stem)
    dec_head: OpSpec  # "conv" or "up"
    latent_channels: int
    attention_head_dim: int = 32
    in_channels: int = 3
    nominal_bpp: float = 1.0
    # decoder stage execution order (deep trunk first): the converter tells a
    # checkpoint storing up_blocks shallow-first (config order) from one storing
    # them deep-first by the one staged block list without an upsampler
    decoder_exec: Tuple[int, ...] = ()
    deepest_channels: int = 0  # trunk width at the latent (the decoder conv_in's output)

    def exec_order(self) -> Tuple[int, ...]:
        if self.decoder_exec:
            return self.decoder_exec
        return tuple(range(len(self.decoder_ops) - 1, -1, -1))

    @staticmethod
    def from_diffusers(block_types, channels, layers, multiscales, latent_channels, attention_head_dim=32,
                       downsample_block_type="conv", upsample_block_type="interpolate", in_channels=3,
                       nominal_bpp=1.0) -> "DCAEConfig":
        """From the diffusers AutoencoderDC config fields (one set for both
        sides)."""
        n = len(channels)
        enc_stages: List[Tuple[OpSpec, ...]] = []
        dec_stages: List[Tuple[OpSpec, ...]] = []
        for i in range(n):
            blk = OpSpec("res" if block_types[i] == "ResBlock" else "evit", channels[i],
                         multiscales=tuple(multiscales[i]))
            enc_ops = [dataclasses.replace(blk) for _ in range(layers[i])]
            if i < n - 1 and layers[i] > 0:
                enc_ops.append(OpSpec("down", channels[i + 1], downsample_block_type))
            enc_stages.append(tuple(enc_ops))
            dec_ops: List[OpSpec] = []
            if i < n - 1 and layers[i] > 0:
                dec_ops.append(OpSpec("up", channels[i], upsample_block_type))
            dec_ops += [dataclasses.replace(blk) for _ in range(layers[i])]
            dec_stages.append(tuple(dec_ops))
        if layers[0] > 0:
            enc_stem = OpSpec("conv", channels[0])
            dec_head = OpSpec("conv", in_channels)
        else:
            enc_stem = OpSpec("down", channels[0], downsample_block_type, shortcut=False)
            dec_head = OpSpec("up", in_channels, upsample_block_type, shortcut=False)
            # stage 0 chains to stage 1 through a shortcutted downsample / upsample
            enc_stages[0] = (OpSpec("down", channels[1], downsample_block_type),)
            dec_stages[0] = (OpSpec("up", channels[0], upsample_block_type),)
        return DCAEConfig(tuple(enc_stages), tuple(dec_stages), enc_stem, dec_head, latent_channels,
                          attention_head_dim, in_channels, nominal_bpp, decoder_exec=tuple(range(n - 1, -1, -1)),
                          deepest_channels=channels[-1])

    @staticmethod
    def tiny(deep_stem: bool = False) -> "DCAEConfig":
        """The JAX package's random DC-AE slot (and its tests' geometry)."""
        layers = [0, 1, 1] if deep_stem else [1, 1, 1]
        return DCAEConfig.from_diffusers(["ResBlock", "ResBlock", "EfficientViTBlock"], [8, 16, 16], layers,
                                         [(), (), (5,)], latent_channels=4, attention_head_dim=4)


def f64c128_config() -> DCAEConfig:
    """The stage geometry of ``mit-han-lab/dc-ae-f64c128-in-1.0-diffusers``:
    widths 128 ... 1024, ResBlock x3 then EfficientViT x3 (multiscale 5),
    layers [0, 2, 2, 3, 3, 3] (a deep stem), pixel-unshuffle down,
    interpolate up, a 128-channel latent (``tools/validate_converters.py``'s
    target ``dcae_f64c128``)."""
    return DCAEConfig.from_diffusers(
        ["ResBlock"] * 3 + ["EfficientViTBlock"] * 3, [128, 256, 512, 512, 1024, 1024], [0, 2, 2, 3, 3, 3],
        [(), (), (), (5,), (5,), (5,)], latent_channels=128, attention_head_dim=32,
        downsample_block_type="pixel_unshuffle", upsample_block_type="interpolate")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _conv(cin: int, cout: int, k: int = 3, bias: bool = True, groups: int = 1, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, groups=groups, bias=bias)


class Norm(nn.Module):
    """Over the channel axis: an RMS norm (eps 1e-5, float32 statistics,
    affine, a bias where the tree has one), or, unless ``rms_only``, a
    BatchNorm in eval mode where ``mean`` / ``var`` were loaded (the JAX
    package's ``_norm``; GLUMBConv and the decoder's ``norm_out`` take the
    RMS norm whatever the tree holds)."""

    OPTIONAL = ("bias", "mean", "var")  # leaves a tree may lack

    def __init__(self, c: int, rms_only: bool = False):
        super().__init__()
        self.rms_only = rms_only
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("mean", None)
        self.register_buffer("var", None)

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if self.mean is not None and not self.rms_only:
            y = (x - self.mean.view(shape)) * torch.rsqrt(self.var.view(shape) + _EPS_NORM)
        else:
            xf = x.float()
            y = (xf * torch.rsqrt(xf.square().mean(dim=1, keepdim=True) + _EPS_NORM)).to(x.dtype)
        y = y * self.scale.view(shape)
        return y + self.bias.view(shape) if self.bias is not None else y


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.conv2, self.norm = _conv(c, c), _conv(c, c, bias=False), Norm(c)

    def forward(self, x):
        return x + self.norm(self.conv2(F.silu(self.conv1(x))))


class GLUMBConv(nn.Module):
    def __init__(self, c: int, expand: int = 4):
        super().__init__()
        hid = c * expand
        self.conv_inverted = _conv(c, 2 * hid, 1)
        self.conv_depth = _conv(2 * hid, 2 * hid, 3, groups=2 * hid)
        self.conv_point = _conv(hid, c, 1, bias=False)
        self.norm = Norm(c, rms_only=True)

    def forward(self, x):
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = h.chunk(2, dim=1)
        return self.norm(self.conv_point(h * F.silu(gate))) + x


class MultiscaleProjection(nn.Module):
    def __init__(self, inner: int, heads: int, k: int):
        super().__init__()
        self.proj_in = _conv(3 * inner, 3 * inner, k, bias=False, groups=3 * inner)
        self.proj_out = _conv(3 * inner, 3 * inner, 1, bias=False, groups=3 * heads)

    def forward(self, x):
        return self.proj_out(self.proj_in(x))


class SanaMultiscaleLinearAttention(nn.Module):
    """SanaMultiscaleLinearAttention + its residual (diffusers'
    ``SanaMultiscaleAttnProcessor2_0``)."""

    def __init__(self, c: int, head_dim: int, multiscales: Tuple[int, ...]):
        super().__init__()
        heads = c // head_dim
        inner = heads * head_dim
        self.head_dim = head_dim
        self.to_q, self.to_k, self.to_v = (nn.Linear(c, inner, bias=False) for _ in range(3))
        self.multiscale = nn.ModuleList([MultiscaleProjection(inner, heads, k) for k in multiscales])
        self.to_out = nn.Linear(inner * (1 + len(multiscales)), c, bias=False)
        self.norm_out = Norm(c)

    def forward(self, x):
        b, _, hh, ww = x.shape
        h = x.movedim(1, -1)
        qkv = torch.cat([self.to_q(h), self.to_k(h), self.to_v(h)], dim=-1).movedim(-1, 1)
        h = torch.cat([qkv] + [ms(qkv) for ms in self.multiscale], dim=1)
        n = hh * ww
        h = h.reshape(b, -1, 3 * self.head_dim, n)  # [B, heads, 3d, N]
        q, k, v = h.chunk(3, dim=2)
        q, k = F.relu(q), F.relu(k)
        if n > self.head_dim:  # linear attention, in float32 as the reference
            q, k, v = q.float(), k.float(), v.float()
            v1 = F.pad(v, (0, 0, 0, 1), value=1.0)
            out = (v1 @ k.transpose(-1, -2)) @ q  # [B, heads, d + 1, N]
            out = out[:, :, :-1] / (out[:, :, -1:] + _EPS_ATTN)
        else:  # quadratic attention
            scores = (k.transpose(-1, -2) @ q).float()  # [B, heads, N, N]
            scores = scores / (scores.sum(dim=2, keepdim=True) + _EPS_ATTN)
            out = v.float() @ scores
        out = out.to(x.dtype).reshape(b, -1, hh, ww)
        out = self.to_out(out.movedim(1, -1)).movedim(-1, 1)
        return self.norm_out(out) + x


class EfficientViTBlock(nn.Module):
    def __init__(self, c: int, head_dim: int, multiscales: Tuple[int, ...]):
        super().__init__()
        self.attn = SanaMultiscaleLinearAttention(c, head_dim, multiscales)
        self.conv_out = GLUMBConv(c)

    def forward(self, x):
        return self.conv_out(self.attn(x))


def _group_average(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    return x.unflatten(1, (out_channels, -1)).mean(dim=2)


class DCDown(nn.Module):
    def __init__(self, cin: int, spec: OpSpec):
        super().__init__()
        self.spec = spec
        unshuffle = spec.mode == "pixel_unshuffle"
        self.conv = _conv(cin, spec.out_channels // 4 if unshuffle else spec.out_channels,
                          stride=1 if unshuffle else 2)

    def forward(self, x):
        y = self.conv(x)
        if self.spec.mode == "pixel_unshuffle":
            y = F.pixel_unshuffle(y, 2)
        if self.spec.shortcut:
            y = y + _group_average(F.pixel_unshuffle(x, 2), self.spec.out_channels)
        return y


class DCUp(nn.Module):
    def __init__(self, cin: int, spec: OpSpec):
        super().__init__()
        self.spec = spec
        self.conv = _conv(cin, spec.out_channels if spec.mode == "interpolate" else spec.out_channels * 4)

    def forward(self, x):
        if self.spec.mode == "interpolate":
            return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        y = F.pixel_shuffle(self.conv(x), 2)
        if self.spec.shortcut:
            y = y + F.pixel_shuffle(x.repeat_interleave(self.spec.out_channels * 4 // x.shape[1], dim=1), 2)
        return y


def _make_op(spec: OpSpec, cin: int, head_dim: int) -> Tuple[nn.Module, int]:
    if spec.kind == "res":
        return ResBlock(spec.out_channels), spec.out_channels
    if spec.kind == "evit":
        return EfficientViTBlock(spec.out_channels, head_dim, spec.multiscales), spec.out_channels
    if spec.kind == "down":
        return DCDown(cin, spec), spec.out_channels
    if spec.kind == "up":
        return DCUp(cin, spec), spec.out_channels
    raise ValueError(spec.kind)


class DCAE(nn.Module):
    """``AutoencoderDC``'s encoder and decoder from a :class:`DCAEConfig`;
    attribute names follow the JAX package's parameter tree (``encoder.
    {conv_in, down_blocks, conv_out}``, ``decoder.{conv_in, up_blocks,
    norm_out, conv_out}``)."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.attention_head_dim
        self.encoder, self.decoder = nn.Module(), nn.Module()
        if cfg.enc_stem.kind == "down":
            self.encoder.conv_in, ch = DCDown(cfg.in_channels, cfg.enc_stem), cfg.enc_stem.out_channels
        else:
            self.encoder.conv_in, ch = _conv(cfg.in_channels, cfg.enc_stem.out_channels), cfg.enc_stem.out_channels
        stages = []
        for stage in cfg.encoder_ops:
            ops = []
            for spec in stage:
                op, ch = _make_op(spec, ch, hd)
                ops.append(op)
            stages.append(nn.ModuleList(ops))
        self.encoder.down_blocks = nn.ModuleList(stages)
        self.encoder.conv_out = _conv(ch, cfg.latent_channels)
        self.decoder.conv_in = _conv(cfg.latent_channels, cfg.deepest_channels)
        ch = cfg.deepest_channels
        up: List[List[nn.Module]] = [[] for _ in cfg.decoder_ops]
        for i in cfg.exec_order():  # stored in config order, built deep -> shallow
            for spec in cfg.decoder_ops[i]:
                op, ch = _make_op(spec, ch, hd)
                up[i].append(op)
        self.decoder.up_blocks = nn.ModuleList(nn.ModuleList(ops) for ops in up)
        self.decoder.norm_out = Norm(ch, rms_only=True)
        if cfg.dec_head.kind == "conv":
            self.decoder.conv_out = _conv(ch, cfg.in_channels)
        else:
            self.decoder.conv_out = DCUp(ch, cfg.dec_head)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x in [-1, 1] NCHW -> the latent ``[B, latent, H/f, W/f]``."""
        enc = self.encoder
        h = enc.conv_in(x)
        for stage in enc.down_blocks:
            for op in stage:
                h = op(h)
        return enc.conv_out(h) + _group_average(h, self.cfg.latent_channels)  # out_shortcut

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        h = dec.conv_in(z) + z.repeat_interleave(self.cfg.deepest_channels // self.cfg.latent_channels, dim=1)
        for i in self.cfg.exec_order():  # deep -> shallow
            for op in dec.up_blocks[i]:
                h = op(h)
        return dec.conv_out(F.relu(dec.norm_out(h)))

    def roundtrip(self, x01: torch.Tensor) -> torch.Tensor:
        """[0, 1] -> [0, 1]: DeepCompressionAE rescales to [-1, 1] around
        the codec (``neuralcompression.py:131-140,158-163``)."""
        return (self.decode(self.encode(2.0 * x01 - 1.0)) + 1.0) / 2.0


# ---------------------------------------------------------------------------
# conversion from a diffusers AutoencoderDC state dict (shape-driven, numpy)
# ---------------------------------------------------------------------------


def _cv(sd, p):
    out = {"kernel": np.ascontiguousarray(np.transpose(np.asarray(sd[p + ".weight"]), (2, 3, 1, 0)))}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _nm(sd, p):
    out = {"scale": np.asarray(sd[p + ".weight"])}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    if p + ".running_mean" in sd:
        out["mean"] = np.asarray(sd[p + ".running_mean"])
        out["var"] = np.asarray(sd[p + ".running_var"])
    return out


def _block_type_at(sd, prefix):
    if prefix + ".attn.to_q.weight" in sd:
        return "evit"
    if prefix + ".conv1.weight" in sd:
        return "res"
    if prefix + ".conv.weight" in sd:
        return "downup"
    raise KeyError(f"unrecognized block at {prefix}")


def _convert_block(sd, prefix, kind):
    if kind == "res":
        return {"conv1": _cv(sd, prefix + ".conv1"), "conv2": _cv(sd, prefix + ".conv2"),
                "norm": _nm(sd, prefix + ".norm")}
    ms, i = [], 0
    while f"{prefix}.attn.to_qkv_multiscale.{i}.proj_in.weight" in sd:
        ms.append({"proj_in": _cv(sd, f"{prefix}.attn.to_qkv_multiscale.{i}.proj_in"),
                   "proj_out": _cv(sd, f"{prefix}.attn.to_qkv_multiscale.{i}.proj_out")})
        i += 1

    def lin(p):
        return np.ascontiguousarray(np.asarray(sd[p + ".weight"]).T)

    return {
        "attn": {"to_q": lin(prefix + ".attn.to_q"), "to_k": lin(prefix + ".attn.to_k"),
                 "to_v": lin(prefix + ".attn.to_v"), "multiscale": ms, "to_out": lin(prefix + ".attn.to_out"),
                 "norm_out": _nm(sd, prefix + ".attn.norm_out")},
        "conv_out": {"conv_inverted": _cv(sd, prefix + ".conv_out.conv_inverted"),
                     "conv_depth": _cv(sd, prefix + ".conv_out.conv_depth"),
                     "conv_point": _cv(sd, prefix + ".conv_out.conv_point"),
                     "norm": _nm(sd, prefix + ".conv_out.norm")},
    }


def _seq_indices(sd, stage_prefix):
    idx = set()
    for key in sd:
        if key.startswith(stage_prefix + "."):
            idx.add(int(key[len(stage_prefix) + 1:].split(".")[0]))
    return sorted(idx)


def convert_dcae(sd, attention_head_dim: int = 32, in_channels: int = 3,
                 nominal_bpp: float = 1.0) -> Tuple[dict, DCAEConfig]:
    """A diffusers AutoencoderDC state dict -> (parameter tree, DCAEConfig).

    Shape-driven: the stage structure, block types, multiscale kernels and
    down/up-sample modes are read off the checkpoint (conv channel chaining
    tells a strided conv from pixel-(un)shuffle and interpolate from
    pixel-shuffle, since strides are not stored in weights).
    """
    sd = {k: np.asarray(v) for k, v in sd.items()}
    latent = int(sd["decoder.conv_in.weight"].shape[1])

    def side(tree):
        n_stages = 1 + max(int(k[len(tree) + 1:].split(".")[0]) for k in sd if k.startswith(tree + "."))
        specs: List[List[OpSpec]] = []
        blocks: List[List[dict]] = []
        for i in range(n_stages):
            specs.append([])
            blocks.append([])
            for j in _seq_indices(sd, f"{tree}.{i}"):
                prefix = f"{tree}.{i}.{j}"
                kind = _block_type_at(sd, prefix)
                if kind == "downup":
                    specs[-1].append(OpSpec("downup"))  # resolved below
                    blocks[-1].append({"conv": _cv(sd, prefix + ".conv")})
                else:
                    w = sd[prefix + (".conv1.weight" if kind == "res" else ".attn.to_q.weight")]
                    ch = int(w.shape[0] if kind == "res" else w.shape[1])
                    blk = _convert_block(sd, prefix, kind)
                    ms: Tuple[int, ...] = ()
                    if kind == "evit":
                        ms = tuple(m["proj_in"]["kernel"].shape[0] for m in blk["attn"]["multiscale"])
                    specs[-1].append(OpSpec(kind, ch, multiscales=ms))
                    blocks[-1].append(blk)
        return specs, blocks

    enc_specs, enc_blocks = side("encoder.down_blocks")
    dec_specs, dec_blocks = side("decoder.up_blocks")

    def next_block_in_channels(specs, blocks, i, j):
        """Input channels of the first res/evit block after (i, j)."""
        for ii in range(i, len(specs)):
            for jj in range(j + 1 if ii == i else 0, len(specs[ii])):
                s = specs[ii][jj]
                if s.kind == "res":
                    return int(blocks[ii][jj]["conv1"]["kernel"].shape[2])
                if s.kind == "evit":
                    return int(blocks[ii][jj]["attn"]["to_q"].shape[0])
        return None

    # encoder downsample modes, by channel chaining
    for i, stage in enumerate(enc_specs):
        for j, s in enumerate(stage):
            if s.kind != "downup":
                continue
            out = int(enc_blocks[i][j]["conv"]["kernel"].shape[3])
            nxt = next_block_in_channels(enc_specs, enc_blocks, i, j)
            if nxt is None:
                nxt = int(sd["encoder.conv_out.weight"].shape[1])
            mode = "pixel_unshuffle" if out * 4 == nxt else "conv"
            stage[j] = OpSpec("down", out * 4 if mode == "pixel_unshuffle" else out, mode)

    # decoder upsample modes: each stage's Sequential starts with its upsampler
    for i in range(len(dec_specs)):
        for j, s in enumerate(dec_specs[i]):
            if s.kind != "downup":
                continue
            cout = int(dec_blocks[i][j]["conv"]["kernel"].shape[3])
            target = None
            for jj in range(j + 1, len(dec_specs[i])):
                if dec_specs[i][jj].kind in ("res", "evit"):
                    target = dec_specs[i][jj].out_channels
                    break
            if target is None:
                target = int(sd["decoder.norm_out.weight"].shape[0])
            mode = "pixel_shuffle" if cout == target * 4 else "interpolate"
            dec_specs[i][j] = OpSpec("up", target, mode)

    # stems and heads
    if "encoder.conv_in.conv.weight" in sd:
        out = int(sd["encoder.conv_in.conv.weight"].shape[0])
        if enc_specs[0] and enc_specs[0][0].kind == "down":
            nxt = int(enc_blocks[0][0]["conv"]["kernel"].shape[2])  # stage 0 holds only a downsampler
        else:
            nxt = next_block_in_channels(enc_specs, enc_blocks, 0, -1)
        if nxt is None:
            nxt = int(sd["encoder.conv_out.weight"].shape[1])
        mode = "pixel_unshuffle" if out * 4 == nxt else "conv"
        enc_stem = OpSpec("down", out * 4 if mode == "pixel_unshuffle" else out, mode, shortcut=False)
        enc_conv_in = {"conv": _cv(sd, "encoder.conv_in.conv")}
    else:
        enc_stem = OpSpec("conv", int(sd["encoder.conv_in.weight"].shape[0]))
        enc_conv_in = _cv(sd, "encoder.conv_in")
    if "decoder.conv_out.conv.weight" in sd:
        w = sd["decoder.conv_out.conv.weight"]
        mode = "pixel_shuffle" if int(w.shape[0]) == in_channels * 4 else "interpolate"
        dec_head = OpSpec("up", in_channels, mode, shortcut=False)
        dec_conv_out = {"conv": _cv(sd, "decoder.conv_out.conv")}
    else:
        dec_head = OpSpec("conv", in_channels)
        dec_conv_out = _cv(sd, "decoder.conv_out")

    # decoder storage order: among the stages with blocks exactly one has no
    # leading upsampler, the deepest; stored first means deep-first storage
    n_dec = len(dec_specs)
    staged = [i for i, s in enumerate(dec_specs) if any(op.kind in ("res", "evit") for op in s)]
    no_up = [i for i in staged if not any(op.kind == "up" for op in dec_specs[i])]
    if len(no_up) == 1 and no_up[0] == min(staged) and no_up[0] != max(staged):
        decoder_exec = tuple(range(n_dec))
    else:
        decoder_exec = tuple(range(n_dec - 1, -1, -1))

    cfg = DCAEConfig(tuple(tuple(s) for s in enc_specs), tuple(tuple(s) for s in dec_specs), enc_stem, dec_head,
                     latent, attention_head_dim, in_channels, nominal_bpp, decoder_exec=decoder_exec,
                     deepest_channels=int(sd["decoder.conv_in.weight"].shape[0]))
    params = {
        "encoder": {"conv_in": enc_conv_in, "down_blocks": enc_blocks, "conv_out": _cv(sd, "encoder.conv_out")},
        "decoder": {"conv_in": _cv(sd, "decoder.conv_in"), "up_blocks": dec_blocks,
                    "norm_out": _nm(sd, "decoder.norm_out"), "conv_out": dec_conv_out},
    }
    return params, cfg


# ---------------------------------------------------------------------------
# random init (the JAX package's numpy draws)
# ---------------------------------------------------------------------------


def init_dcae_params(seed: int, cfg: DCAEConfig) -> dict:
    """Random parameters of ``cfg`` in :func:`convert_dcae`'s layout, the
    JAX package's draws in its order (the same seed gives the same tree)."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, k=3, bias=True, groups=1):
        std = 1.0 / np.sqrt(cin // groups * k * k)
        p = {"kernel": rng.uniform(-std, std, (k, k, cin // groups, cout)).astype(np.float32)}
        if bias:
            p["bias"] = rng.uniform(-std, std, (cout,)).astype(np.float32)
        return p

    def norm(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def lin(ci, co):
        return (rng.uniform(-1, 1, (ci, co)) / np.sqrt(ci)).astype(np.float32)

    def make_op(spec: OpSpec, cin: int) -> Tuple[dict, int]:
        if spec.kind == "res":
            c = spec.out_channels
            return {"conv1": conv(c, c), "conv2": conv(c, c, bias=False), "norm": norm(c)}, c
        if spec.kind == "evit":
            c = spec.out_channels
            heads = c // cfg.attention_head_dim
            inner = heads * cfg.attention_head_dim
            ms = [{"proj_in": conv(3 * inner, 3 * inner, ksz, bias=False, groups=3 * inner),
                   "proj_out": conv(3 * inner, 3 * inner, 1, bias=False, groups=3 * heads)}
                  for ksz in spec.multiscales]
            hid = c * 4
            return {
                "attn": {"to_q": lin(c, inner), "to_k": lin(c, inner), "to_v": lin(c, inner), "multiscale": ms,
                         "to_out": lin(inner * (1 + len(ms)), c), "norm_out": norm(c)},
                "conv_out": {"conv_inverted": conv(c, 2 * hid, 1), "conv_depth": conv(2 * hid, 2 * hid, 3, groups=2 * hid),
                             "conv_point": conv(hid, c, 1, bias=False), "norm": norm(c)},
            }, c
        if spec.kind == "down":
            out = spec.out_channels
            return {"conv": conv(cin, out // 4 if spec.mode == "pixel_unshuffle" else out)}, out
        if spec.kind == "up":
            out = spec.out_channels
            return {"conv": conv(cin, out if spec.mode == "interpolate" else out * 4)}, out
        raise ValueError(spec.kind)

    if cfg.enc_stem.kind == "down":
        stem, ch = make_op(cfg.enc_stem, cfg.in_channels)
    else:
        stem, ch = conv(cfg.in_channels, cfg.enc_stem.out_channels), cfg.enc_stem.out_channels
    down_blocks = []
    for stage in cfg.encoder_ops:
        ops = []
        for spec in stage:
            p, ch = make_op(spec, ch)
            ops.append(p)
        down_blocks.append(ops)
    encoder = {"conv_in": stem, "down_blocks": down_blocks, "conv_out": conv(ch, cfg.latent_channels)}
    dec_conv_in = conv(cfg.latent_channels, cfg.deepest_channels)
    ch = cfg.deepest_channels
    up_blocks: List[List[dict]] = [[] for _ in cfg.decoder_ops]
    for i in cfg.exec_order():  # stored in config order, built deep -> shallow
        for spec in cfg.decoder_ops[i]:
            p, ch = make_op(spec, ch)
            up_blocks[i].append(p)
    if cfg.dec_head.kind == "conv":
        dec_out = conv(ch, cfg.in_channels)
    else:
        dec_out = {"conv": conv(ch, cfg.in_channels if cfg.dec_head.mode == "interpolate" else cfg.in_channels * 4)}
    decoder = {"conv_in": dec_conv_in, "up_blocks": up_blocks, "norm_out": norm(ch), "conv_out": dec_out}
    return {"encoder": encoder, "decoder": decoder}
