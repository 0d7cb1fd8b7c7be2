"""SyncSeal's released backbones (PyTorch port of
``wmar_tpu.sync.syncseal_models``), with the released checkpoint's
parameter names, so ``load_state_dict(strict=True)`` reads its
``embedder.unet.*`` and ``extractor.{convnext,head}.*`` keys directly:

* the UNet embedder on the Y (luma) channel (``unet_small2_yuv``):
  ResnetBlocks (conv-GN-GELU twice + a 1x1 residual conv), strided down
  convs (16 -> 32 -> 64 -> 128), 8 bottleneck blocks, up blocks with a
  bilinear x2, a reflect-padded conv, a channels-first LayerNorm and GELU,
  skips scaled by 2^-0.5, a 1x1 head with tanh
  (``syncseal/modules/unet.py:140-236``, ``modules/common.py:13-110``);
* the ConvNeXtV2 extractor (depths 3/3/9/3, dims 96/192/384/768, GRN
  blocks) and its ``Head``: a spatial mean, then a Linear to 1 + 8 (the
  detection logit and the 8 corner coordinates in [-1, 1])
  (``syncseal/modules/convnext.py``, ``modules/head.py``);
* the training discriminator, a PatchGAN with biased convolutions and
  GroupNorm(4) (ndf 32, 3 layers) for the hinge-GAN term of
  ``losses/sync_loss.py:43-172``, and ``hinge_d_loss``.

Images enter NHWC, as in JAX; the convolutions run NCHW. GELU is the exact
one, GroupNorm's eps 1e-5, the LayerNorms' 1e-6, as the reference's. The
quantizable UNet (``unet_small2_yuv_quantizable``: ReLU and batch norm)
normalizes with the statistics of the batch it is given, in training and at
inference alike, as JAX's does. ``init_*_params`` draw JAX's numpy trees
from the same seeds, so ``bridge`` turns them into the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.augmentations.geometric import bilinear_up_nchw

RGB2YUV_M = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14713, -0.28886, 0.436],
     [0.615, -0.51499, -0.10001]], np.float32
)


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """NHWC RGB -> YUV."""
    return x @ torch.as_tensor(RGB2YUV_M, device=x.device, dtype=x.dtype).T


class ChannelsFirstLN(nn.Module):
    """LayerNorm over the channels of an NCHW tensor (eps 1e-6)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class BilinearUp(nn.Module):
    """``nn.Upsample(scale_factor, "bilinear", align_corners=False)``
    (``geometric.bilinear_up_nchw``: a deterministic backward on the card
    under ``torch.use_deterministic_algorithms``)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return bilinear_up_nchw(x, self.factor)


class ReflectPad1(nn.Module):
    """``nn.ReflectionPad2d(1)``; under ``torch.use_deterministic_algorithms``
    by slices, whose backward is deterministic on the card."""

    def forward(self, x):
        if not torch.are_deterministic_algorithms_enabled():
            return F.pad(x, (1, 1, 1, 1), mode="reflect")
        x = torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)
        return torch.cat([x[..., 1:2], x, x[..., -2:-1]], dim=3)


class UpBlock(nn.Module):
    """``common.py`` Upsample: bilinear x``factor`` (half-pixel centres),
    reflect pad 1, conv3 without bias, channels-first LN, exact GELU."""

    def __init__(self, c_in: int, c_out: int, factor: int = 2):
        super().__init__()
        self.upsample_block = nn.Sequential(
            BilinearUp(factor),
            ReflectPad1(),
            nn.Conv2d(c_in, c_out, 3, bias=False),
            ChannelsFirstLN(c_out),
            nn.GELU(),
        )

    def forward(self, x):
        return self.upsample_block(x)


# ---------------------------------------------------------------------------
# UNet embedder (unet_small2 family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 1
    out_channels: int = 1
    z_channels: int = 16
    num_blocks: int = 8
    z_channels_mults: Tuple[int, ...] = (1, 2, 4, 8)
    norm_groups: int = 8
    last_tanh: bool = True
    # the quantizable training variant (embedder.yaml's
    # unet_small2_yuv_quantizable) swaps gelu -> relu and group -> batch norm
    activation: str = "gelu"
    normalization: str = "group"


UNET_SMALL2_YUV = UNetConfig()
UNET_SMALL2_YUV_QUANTIZABLE = UNetConfig(activation="relu", normalization="batch")


def _unet_norm(cfg: UNetConfig, c: int) -> nn.Module:
    """GroupNorm, or batch norm over the batch it is given (no running
    statistics: JAX's ``_bn`` in training and at inference)."""
    if cfg.normalization == "batch":
        return nn.BatchNorm2d(c, track_running_stats=False)
    return nn.GroupNorm(cfg.norm_groups, c)


def _unet_act(cfg: UNetConfig) -> nn.Module:
    return nn.ReLU() if cfg.activation == "relu" else nn.GELU()


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: UNetConfig):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(c_in, c_out, 3, padding=1, bias=False), _unet_norm(cfg, c_out), _unet_act(cfg),
            nn.Conv2d(c_out, c_out, 3, padding=1, bias=False), _unet_norm(cfg, c_out), _unet_act(cfg),
        )
        self.res_conv = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x):
        return self.double_conv(x) + self.res_conv(x)


class _Down(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: UNetConfig):
        super().__init__()
        self.down = nn.Conv2d(c_in, c_out, 3, stride=2, padding=1)
        self.conv = ResnetBlock(c_out, c_out, cfg)


class _Up(nn.Module):
    def __init__(self, c_in: int, c_out: int, cfg: UNetConfig):
        super().__init__()
        self.up = UpBlock(c_in, c_out)
        self.conv = ResnetBlock(c_out, c_out, cfg)


class _Bottleneck(nn.Module):
    def __init__(self, c: int, n: int, cfg: UNetConfig):
        super().__init__()
        self.model = nn.Sequential(*[ResnetBlock(c, c, cfg) for _ in range(n)])


class UNet(nn.Module):
    """NHWC ``[B, H, W, in]`` in [-1, 1] -> delta ``[B, H, W, out]``."""

    def __init__(self, cfg: UNetConfig = UNET_SMALL2_YUV):
        super().__init__()
        self.cfg = cfg
        z = [cfg.z_channels * m for m in cfg.z_channels_mults]
        self.inc = ResnetBlock(cfg.in_channels, z[0], cfg)
        self.downs = nn.ModuleList([_Down(z[i], z[i + 1], cfg) for i in range(len(z) - 1)])
        self.bottleneck = _Bottleneck(z[-1], cfg.num_blocks, cfg)
        self.ups = nn.ModuleList([_Up(2 * z[i + 1], z[i], cfg) for i in reversed(range(len(z) - 1))])
        self.outc = nn.Conv2d(z[0], cfg.out_channels, 1)

    def forward(self, x):
        hiddens = [self.inc(x.permute(0, 3, 1, 2))]
        for d in self.downs:
            hiddens.append(d.conv(d.down(hiddens[-1])))
        h = self.bottleneck.model(hiddens[-1])
        for u in self.ups:
            h = u.conv(u.up(torch.cat([h, hiddens.pop() * 2.0**-0.5], dim=1)))
        out = self.outc(h)
        return (torch.tanh(out) if self.cfg.last_tanh else out).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# ConvNeXtV2 extractor + Head
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    out_dim: int = 8  # corner coords; the head outputs 1 + out_dim


CONVNEXT_TINY = ConvNeXtConfig()


class GRN(nn.Module):
    """Global response normalization over (H, W) per channel, NHWC."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        gx = torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        h = self.dwconv(x).permute(0, 2, 3, 1)
        h = self.pwconv2(self.grn(F.gelu(self.pwconv1(self.norm(h)))))
        return x + h.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        d = cfg.dims
        self.downsample_layers = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(3, d[0], 4, stride=4), ChannelsFirstLN(d[0]))]
            + [nn.Sequential(ChannelsFirstLN(d[i]), nn.Conv2d(d[i], d[i + 1], 2, stride=2))
               for i in range(len(d) - 1)])
        self.stages = nn.ModuleList(
            [nn.Sequential(*[ConvNeXtBlock(d[i]) for _ in range(n)]) for i, n in enumerate(cfg.depths)])


class _Head(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = nn.Linear(dim, out)


class ConvNeXtExtractor(nn.Module):
    """NHWC in [-1, 1] -> ``[B, 1 + out_dim]`` (detection logit, corners);
    parameters ``convnext.*`` and ``head.linear.*``."""

    def __init__(self, cfg: ConvNeXtConfig = CONVNEXT_TINY):
        super().__init__()
        self.cfg = cfg
        self.convnext = ConvNeXt(cfg)
        self.head = _Head(cfg.dims[-1], 1 + cfg.out_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for down, stage in zip(self.convnext.downsample_layers, self.convnext.stages):
            x = stage(down(x))
        return self.head.linear(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# NLayerDiscriminator (PatchGAN with GroupNorm(4))
# ---------------------------------------------------------------------------


class SyncSealDiscriminator(nn.Module):
    """The reference's training discriminator: conv(s2) + leaky ReLU, then
    ``n_layers`` x [conv + GroupNorm(4) + leaky ReLU] (stride 2, the last
    stride 1), and a 1-channel conv(s1); every conv 4x4, padding 1, with a
    bias. ``main.*`` carries the reference's names. NHWC in, NHWC patch
    logits out."""

    def __init__(self, in_ch: int = 3, ndf: int = 32, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(in_ch, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2**n, 8)
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride=2 if n < n_layers else 1, padding=1),
                       nn.GroupNorm(4, ndf * nf), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _res_block_tree(sd, p: str) -> dict:
    from wmar_tpu_torch.utils.convert import _conv, _ln

    return {"conv1": _conv(sd, p + ".double_conv.0"), "norm1": _ln(sd, p + ".double_conv.1"),
            "conv2": _conv(sd, p + ".double_conv.3"), "norm2": _ln(sd, p + ".double_conv.4"),
            "res": _conv(sd, p + ".res_conv")}


def convert_unet(sd, cfg: UNetConfig = UNET_SMALL2_YUV, prefix: str = "") -> dict:
    """A ``unet.*`` (or ``embedder.unet.*``) state dict -> the JAX package's
    ``unet_forward`` tree (``wmar_tpu.sync.syncseal_models.convert_unet``)."""
    from wmar_tpu_torch.utils.convert import _conv, _ln

    p, nlev = prefix, len(cfg.z_channels_mults)
    return {
        "inc": _res_block_tree(sd, p + "inc"),
        "downs": [{"down": _conv(sd, f"{p}downs.{i}.down"), "conv": _res_block_tree(sd, f"{p}downs.{i}.conv")}
                  for i in range(nlev - 1)],
        "bottleneck": [_res_block_tree(sd, f"{p}bottleneck.model.{j}") for j in range(cfg.num_blocks)],
        "ups": [{"up": {"conv": _conv(sd, f"{p}ups.{i}.up.upsample_block.2"),
                        "ln": _ln(sd, f"{p}ups.{i}.up.upsample_block.3")},
                 "conv": _res_block_tree(sd, f"{p}ups.{i}.conv")} for i in range(nlev - 1)],
        "outc": _conv(sd, p + "outc"),
    }


def convert_convnext(sd, cfg: ConvNeXtConfig = CONVNEXT_TINY, prefix: str = "convnext.",
                     head_prefix: str = "head.") -> dict:
    """A ConvNeXt extractor state dict -> the JAX package's tree
    (``wmar_tpu.sync.syncseal_models.convert_convnext``): Linear layers as
    ``{"w", "b"}``, GRN's gamma and beta as ``[1, 1, 1, C]``."""
    from wmar_tpu_torch.utils.convert import _conv, _lin, _ln, _t

    downsample = []
    for i in range(len(cfg.depths)):
        dp = f"{prefix}downsample_layers.{i}."
        conv, norm = ("0", "1") if i == 0 else ("1", "0")
        downsample.append({"conv": _conv(sd, dp + conv), "norm": _ln(sd, dp + norm)})
    stages = [[{"dwconv": _conv(sd, f"{prefix}stages.{i}.{j}.dwconv"), "norm": _ln(sd, f"{prefix}stages.{i}.{j}.norm"),
                "pwconv1": _lin(sd, f"{prefix}stages.{i}.{j}.pwconv1"),
                "grn": {"gamma": _t(sd[f"{prefix}stages.{i}.{j}.grn.gamma"]).reshape(1, 1, 1, -1),
                        "beta": _t(sd[f"{prefix}stages.{i}.{j}.grn.beta"]).reshape(1, 1, 1, -1)},
                "pwconv2": _lin(sd, f"{prefix}stages.{i}.{j}.pwconv2")} for j in range(depth)]
              for i, depth in enumerate(cfg.depths)]
    return {"downsample": downsample, "stages": stages, "head": _lin(sd, head_prefix + "linear")}


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def discriminator_conv_indices(n_layers: int = 3) -> Tuple[int, ...]:
    """The ``main.<i>`` index of each conv, in the order of JAX's list."""
    return (0, *(2 + 3 * n for n in range(n_layers)), 2 + 3 * n_layers)


def convert_discriminator(sd, n_layers: int = 3, prefix: str = "main.") -> dict:
    """A reference discriminator state dict (``main.*`` under ``prefix``)
    as :class:`SyncSealDiscriminator`'s; every conv and norm must be there."""
    out = {}
    for i, idx in enumerate(discriminator_conv_indices(n_layers)):
        names = [f"{idx}.weight", f"{idx}.bias"]
        if 0 < i <= n_layers:
            names += [f"{idx + 1}.weight", f"{idx + 1}.bias"]
        for name in names:
            out[f"main.{name}"] = torch.as_tensor(sd[prefix + name])
    return out


# ---------------------------------------------------------------------------
# Random init: JAX's numpy trees, drawn in JAX's order from the same seeds
# ---------------------------------------------------------------------------


def _rngc(rng, k, i, o, bias=True):
    p = {"kernel": rng.normal(0, (2.0 / (i * k * k)) ** 0.5, (k, k, i, o)).astype(np.float32)}
    if bias:
        p["bias"] = np.zeros((o,), np.float32)
    return p


def _rngnb(c):
    return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}


def _rngl(rng, i, o):
    return {"w": rng.normal(0, i**-0.5, (i, o)).astype(np.float32), "b": np.zeros((o,), np.float32)}


def _rng_res(rng, i, o):
    return {"conv1": _rngc(rng, 3, i, o, bias=False), "norm1": _rngnb(o),
            "conv2": _rngc(rng, 3, o, o, bias=False), "norm2": _rngnb(o), "res": _rngc(rng, 1, i, o)}


def init_unet_params(seed: int, cfg: UNetConfig = UNET_SMALL2_YUV) -> dict:
    """JAX's ``init_unet_params`` tree (numpy), for ``bridge``."""
    rng = np.random.default_rng(seed)
    z = [cfg.z_channels * m for m in cfg.z_channels_mults]
    downs = [{"down": _rngc(rng, 3, z[i], z[i + 1]), "conv": _rng_res(rng, z[i + 1], z[i + 1])}
             for i in range(len(z) - 1)]
    ups = [{"up": {"conv": _rngc(rng, 3, 2 * z[i + 1], z[i], bias=False), "ln": _rngnb(z[i])},
            "conv": _rng_res(rng, z[i], z[i])} for i in reversed(range(len(z) - 1))]
    return {"inc": _rng_res(rng, cfg.in_channels, z[0]), "downs": downs,
            "bottleneck": [_rng_res(rng, z[-1], z[-1]) for _ in range(cfg.num_blocks)],
            "ups": ups, "outc": _rngc(rng, 1, z[0], cfg.out_channels)}


def init_convnext_params(seed: int, cfg: ConvNeXtConfig = CONVNEXT_TINY) -> dict:
    """JAX's ``init_convnext_params`` tree (numpy), for ``bridge``."""
    rng = np.random.default_rng(seed)
    dims = cfg.dims
    downsample = [{"conv": _rngc(rng, 4, 3, dims[0]), "norm": _rngnb(dims[0])}]
    for i in range(len(dims) - 1):
        downsample.append({"norm": _rngnb(dims[i]), "conv": _rngc(rng, 2, dims[i], dims[i + 1])})
    stages = []
    for i, depth in enumerate(cfg.depths):
        d = dims[i]
        stages.append([{"dwconv": {"kernel": rng.normal(0, 0.02, (7, 7, 1, d)).astype(np.float32),
                                   "bias": np.zeros((d,), np.float32)},
                        "norm": _rngnb(d), "pwconv1": _rngl(rng, d, 4 * d),
                        "grn": {"gamma": np.zeros((1, 1, 1, 4 * d), np.float32),
                                "beta": np.zeros((1, 1, 1, 4 * d), np.float32)},
                        "pwconv2": _rngl(rng, 4 * d, d)} for _ in range(depth)])
    return {"downsample": downsample, "stages": stages, "head": _rngl(rng, dims[-1], 1 + cfg.out_dim)}


def init_discriminator_params(seed: int, in_ch: int = 3, ndf: int = 32, n_layers: int = 3) -> List[dict]:
    """JAX's ``init_discriminator_params`` list (numpy), for ``bridge``."""
    rng = np.random.default_rng(seed)
    params = [{"conv": _rngc(rng, 4, in_ch, ndf)}]
    nf = 1
    for n in range(1, n_layers):
        nf_prev, nf = nf, min(2**n, 8)
        params.append({"conv": _rngc(rng, 4, ndf * nf_prev, ndf * nf), "norm": _rngnb(ndf * nf)})
    nf_prev, nf = nf, min(2**n_layers, 8)
    params.append({"conv": _rngc(rng, 4, ndf * nf_prev, ndf * nf), "norm": _rngnb(ndf * nf)})
    params.append({"conv": _rngc(rng, 4, ndf * nf, 1)})
    return params


def init_discriminator(seed: int = 0, n_layers: int = 3, device=None) -> SyncSealDiscriminator:
    """A discriminator with JAX's ``init_discriminator_params(seed)`` weights."""
    from wmar_tpu_torch import bridge

    disc = SyncSealDiscriminator(n_layers=n_layers)
    disc.load_state_dict(bridge.discriminator_state_dict(init_discriminator_params(seed, n_layers=n_layers)))
    return disc.to(device)
