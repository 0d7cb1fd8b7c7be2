"""MaskGit-VQGAN tokenizer, RAR's image tokenizer (PyTorch).

Port of ``wmar_tpu.models.maskgit_vqgan``: an attention-free VQGAN with
avg-pool downsampling and nearest-neighbour upsampling, codebook 1024 x 256,
images in [0, 1] inside. The public methods keep the JAX package's layout:
images NHWC in [-1, 1], codes ``[B, tokens]`` in raster order. Inside, the
convolutions run NCHW. Submodules carry the Flax module names, so the
bridge maps ``kernel`` (HWIO) to ``weight`` (OIHW) and GroupNorm ``scale``
to ``weight`` name for name.

As in the JAX package, a ResnetBlock that changes width applies its 1x1
``nin_shortcut`` to the block *output* (a quirk of the released weights).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MaskGitVQConfig:
    resolution: int = 256
    num_channels: int = 3
    hidden_channels: int = 128
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    n_embed: int = 1024
    embed_dim: int = 256
    dropout: float = 0.0

    def __post_init__(self):
        if self.z_channels != self.embed_dim:
            raise ValueError("z_channels must equal embed_dim (MaskGit has no quant_conv)")

    @property
    def num_resolutions(self) -> int:
        return len(self.channel_mult)

    @property
    def codes_per_side(self) -> int:
        return self.resolution // 2 ** (self.num_resolutions - 1)


MASKGIT_IMAGENET_F16 = MaskGitVQConfig()


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


def _conv(c_in: int, c_out: int, k: int, bias: bool) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=bias)  # Flax SAME at stride 1


class MGResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.GroupNorm_0 = _norm(in_ch)
        self.conv1 = _conv(in_ch, out_ch, 3, bias=False)
        self.GroupNorm_1 = _norm(out_ch)
        self.conv2 = _conv(out_ch, out_ch, 3, bias=False)
        self.nin_shortcut = _conv(out_ch, out_ch, 1, bias=False) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        h = self.conv2(F.silu(self.GroupNorm_1(h)))
        res = self.nin_shortcut(h) if self.nin_shortcut is not None else x
        return h + res


class MGEncoder(nn.Module):
    def __init__(self, cfg: MaskGitVQConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = _conv(cfg.num_channels, cfg.hidden_channels, 3, bias=False)
        ch = cfg.hidden_channels
        for i_level, mult in enumerate(cfg.channel_mult):
            for i_block in range(cfg.num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}", MGResnetBlock(ch, cfg.hidden_channels * mult))
                ch = cfg.hidden_channels * mult
        for i_block in range(cfg.num_res_blocks):
            self.add_module(f"mid_block_{i_block}", MGResnetBlock(ch, ch))
        self.GroupNorm_0 = _norm(ch)
        self.conv_out = _conv(ch, cfg.z_channels, 1, bias=True)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        for i_level in range(cfg.num_resolutions):
            for i_block in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
            if i_level != cfg.num_resolutions - 1:
                h = F.avg_pool2d(h, 2)
        for i_block in range(cfg.num_res_blocks):
            h = getattr(self, f"mid_block_{i_block}")(h)
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


class MGDecoder(nn.Module):
    def __init__(self, cfg: MaskGitVQConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.hidden_channels * cfg.channel_mult[-1]
        self.conv_in = _conv(cfg.z_channels, ch, 3, bias=True)
        for i_block in range(cfg.num_res_blocks):
            self.add_module(f"mid_block_{i_block}", MGResnetBlock(ch, ch))
        for i_level in reversed(range(cfg.num_resolutions)):
            out_ch = cfg.hidden_channels * cfg.channel_mult[i_level]
            for i_block in range(cfg.num_res_blocks):
                self.add_module(f"up_{i_level}_block_{i_block}", MGResnetBlock(ch, out_ch))
                ch = out_ch
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample_conv", _conv(ch, ch, 3, bias=True))
        self.GroupNorm_0 = _norm(ch)
        self.conv_out = _conv(ch, cfg.num_channels, 3, bias=True)

    def forward(self, z):
        cfg = self.cfg
        h = self.conv_in(z)
        for i_block in range(cfg.num_res_blocks):
            h = getattr(self, f"mid_block_{i_block}")(h)
        for i_level in reversed(range(cfg.num_resolutions)):
            for i_block in range(cfg.num_res_blocks):
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
            if i_level != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i_level}_upsample_conv")(h)
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


class MaskGitVQGAN(nn.Module):
    """Tokenizer with the ARMM boundary's conventions: NHWC images in [-1, 1]."""

    def __init__(self, cfg: MaskGitVQConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = MGEncoder(cfg)
        self.decoder = MGDecoder(cfg)
        self.embedding = nn.Parameter(torch.zeros((cfg.n_embed, cfg.embed_dim)))

    def nearest(self, z: torch.Tensor) -> torch.Tensor:
        """Codebook index of each ``z [..., C]`` vector, by the JAX formula
        ``|e|^2 - 2 z.e`` in float32 (ties and rounding as there)."""
        flat = z.reshape(-1, self.cfg.embed_dim).to(torch.float32)
        emb = self.embedding.to(torch.float32)
        d = (emb**2).sum(-1)[None, :] - 2.0 * flat @ emb.T
        return torch.argmin(d, dim=-1).reshape(z.shape[:-1])

    def encode_codes(self, images: torch.Tensor) -> torch.Tensor:
        """images NHWC in [-1, 1] -> codes ``[B, tokens]``."""
        x = ((images + 1.0) / 2.0).permute(0, 3, 1, 2).to(self.embedding.dtype)
        z = self.encoder(x).permute(0, 2, 3, 1)  # NHWC, as nearest's raster order expects
        return self.nearest(z).reshape(images.shape[0], -1)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, tokens]`` -> images NHWC in [-1, 1]."""
        side = self.cfg.codes_per_side
        z_q = self.embedding[codes.reshape(codes.shape[0], side, side)]  # NHWC
        rec = self.decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.clamp(rec, 0.0, 1.0) * 2.0 - 1.0


@torch.no_grad()
def init_maskgit(cfg: MaskGitVQConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> MaskGitVQGAN:
    """Random weights from ``generator``: LeCun-normal convolutions (Flax's
    default), unit GroupNorms, zero biases and a uniform codebook in
    ``+-1/n_embed``, as the JAX init draws them."""
    model = MaskGitVQGAN(cfg).to(device)
    for name, p in model.named_parameters():
        if name == "embedding":
            p.uniform_(-1.0 / cfg.n_embed, 1.0 / cfg.n_embed, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            nn.init.trunc_normal_(p, std=1.0, a=-2.0, b=2.0, generator=generator)
            p.mul_((1.0 / fan_in) ** 0.5 / 0.87962566103423978)
    return model.to(dtype)
