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
  (``syncseal/modules/convnext.py``, ``modules/head.py``).

Images enter NHWC, as in JAX; the convolutions run NCHW. GELU is the exact
one, GroupNorm's eps 1e-5, the LayerNorms' 1e-6, as the reference's. The
discriminator belongs to training and is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


class UpBlock(nn.Module):
    """``common.py`` Upsample: bilinear x``factor`` (half-pixel centres),
    reflect pad 1, conv3 without bias, channels-first LN, exact GELU."""

    def __init__(self, c_in: int, c_out: int, factor: int = 2):
        super().__init__()
        self.upsample_block = nn.Sequential(
            nn.Upsample(scale_factor=factor, mode="bilinear", align_corners=False),
            nn.ReflectionPad2d(1),
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


UNET_SMALL2_YUV = UNetConfig()


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(c_in, c_out, 3, padding=1, bias=False), nn.GroupNorm(groups, c_out), nn.GELU(),
            nn.Conv2d(c_out, c_out, 3, padding=1, bias=False), nn.GroupNorm(groups, c_out), nn.GELU(),
        )
        self.res_conv = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x):
        return self.double_conv(x) + self.res_conv(x)


class _Down(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.down = nn.Conv2d(c_in, c_out, 3, stride=2, padding=1)
        self.conv = ResnetBlock(c_out, c_out, groups)


class _Up(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.up = UpBlock(c_in, c_out)
        self.conv = ResnetBlock(c_out, c_out, groups)


class _Bottleneck(nn.Module):
    def __init__(self, c: int, n: int, groups: int):
        super().__init__()
        self.model = nn.Sequential(*[ResnetBlock(c, c, groups) for _ in range(n)])


class UNet(nn.Module):
    """NHWC ``[B, H, W, in]`` in [-1, 1] -> delta ``[B, H, W, out]``."""

    def __init__(self, cfg: UNetConfig = UNET_SMALL2_YUV):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_groups
        z = [cfg.z_channels * m for m in cfg.z_channels_mults]
        self.inc = ResnetBlock(cfg.in_channels, z[0], g)
        self.downs = nn.ModuleList([_Down(z[i], z[i + 1], g) for i in range(len(z) - 1)])
        self.bottleneck = _Bottleneck(z[-1], cfg.num_blocks, g)
        self.ups = nn.ModuleList([_Up(2 * z[i + 1], z[i], g) for i in reversed(range(len(z) - 1))])
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
