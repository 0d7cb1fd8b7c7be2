"""Taming-style VQGAN tokenizer, Chameleon's image tokenizer (PyTorch).

Port of ``wmar_tpu.models.vqgan``: ResNet blocks with GroupNorm and swish,
single-head attention at selected resolutions and always in the middle,
stride-2 downsampling with asymmetric (0, 1) padding, nearest-neighbour
upsampling, a nearest-codebook quantizer. The public methods keep the JAX
package's layout: images NHWC in [-1, 1], codes ``[B, h*w]`` in raster
order; inside, the convolutions run NCHW. Submodules carry the Flax module
names, so the bridge maps ``kernel`` (HWIO) to ``weight`` (OIHW) and
GroupNorm ``scale`` to ``weight`` name for name. ``encode_latent`` and
``decode_latent`` (each optionally through a substitute encoder or decoder)
serve RCC finetuning (``wmar_tpu_torch.finetune``). The straight-through
``VectorQuantizer.forward`` is JAX's training-time quantizer with its
codebook and commitment losses, for a training forward pass; the RCC loop
itself quantizes with ``nearest``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    resolution: int = 256
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16,)
    z_channels: int = 256
    n_embed: int = 16384
    embed_dim: int = 256
    dropout: float = 0.0
    double_z: bool = False
    norm_groups: int = 32
    tanh_out: bool = False

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)

    @property
    def codes_per_side(self) -> int:
        return self.resolution // self.downsample_factor


TAMING_IMAGENET_F16 = VQGANConfig()
CHAMELEON_F16 = VQGANConfig(resolution=512, n_embed=8192, attn_resolutions=())


def _norm(ch: int, groups: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, ch, eps=1e-6)


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, padding=k // 2)  # Flax SAME at stride 1, with bias


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.GroupNorm_0 = _norm(in_ch, groups)
        self.conv1 = _conv(in_ch, out_ch, 3)
        self.GroupNorm_1 = _norm(out_ch, groups)
        self.conv2 = _conv(out_ch, out_ch, 3)
        self.nin_shortcut = _conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.GroupNorm_0(x)))
        h = self.conv2(F.silu(self.GroupNorm_1(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over the spatial grid (1x1 convs)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.GroupNorm_0 = _norm(ch, groups)
        self.q = _conv(ch, ch, 1)
        self.k = _conv(ch, ch, 1)
        self.v = _conv(ch, ch, 1)
        self.proj_out = _conv(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        hn = self.GroupNorm_0(x)
        q, k, v = (conv(hn).reshape(b, c, hh * ww).transpose(1, 2) for conv in (self.q, self.k, self.v))
        attn = torch.softmax((q @ k.transpose(1, 2)).to(torch.float32) * c**-0.5, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Taming's stride-2 conv with asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv(ch, ch, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_groups
        self.conv_in = _conv(cfg.in_channels, cfg.ch, 3)
        ch, res = cfg.ch, cfg.resolution
        for i_level, mult in enumerate(cfg.ch_mult):
            for i_block in range(cfg.num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}", ResnetBlock(ch, cfg.ch * mult, g))
                ch = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    self.add_module(f"down_{i_level}_attn_{i_block}", AttnBlock(ch, g))
            if i_level != cfg.num_resolutions - 1:
                self.add_module(f"down_{i_level}_downsample", Downsample(ch))
                res //= 2
        self.mid_block_1 = ResnetBlock(ch, ch, g)
        self.mid_attn_1 = AttnBlock(ch, g)
        self.mid_block_2 = ResnetBlock(ch, ch, g)
        self.GroupNorm_0 = _norm(ch, g)
        self.conv_out = _conv(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels, 3)

    def forward(self, x):
        cfg = self.cfg
        h = self.conv_in(x)
        res = cfg.resolution
        for i_level in range(cfg.num_resolutions):
            for i_block in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
                if res in cfg.attn_resolutions:
                    h = getattr(self, f"down_{i_level}_attn_{i_block}")(h)
            if i_level != cfg.num_resolutions - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h)
                res //= 2
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_groups
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.z_channels, ch, 3)
        self.mid_block_1 = ResnetBlock(ch, ch, g)
        self.mid_attn_1 = AttnBlock(ch, g)
        self.mid_block_2 = ResnetBlock(ch, ch, g)
        res = cfg.codes_per_side
        for i_level in reversed(range(cfg.num_resolutions)):
            out_ch = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}", ResnetBlock(ch, out_ch, g))
                ch = out_ch
                if res in cfg.attn_resolutions:
                    self.add_module(f"up_{i_level}_attn_{i_block}", AttnBlock(ch, g))
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample", Upsample(ch))
                res *= 2
        self.GroupNorm_0 = _norm(ch, g)
        self.conv_out = _conv(ch, cfg.out_channels, 3)

    def forward(self, z):
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        res = cfg.codes_per_side
        for i_level in reversed(range(cfg.num_resolutions)):
            for i_block in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
                if res in cfg.attn_resolutions:
                    h = getattr(self, f"up_{i_level}_attn_{i_block}")(h)
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h)
                res *= 2
        h = self.conv_out(F.silu(self.GroupNorm_0(h)))
        return torch.tanh(h) if cfg.tanh_out else h


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook (VectorQuantizer2 semantics)."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.embed_dim = embed_dim
        self.beta = beta
        self.embedding = nn.Parameter(torch.zeros((n_embed, embed_dim)))

    def nearest(self, z: torch.Tensor) -> torch.Tensor:
        """Codebook index of each ``z [..., embed_dim]`` vector, by the JAX
        formula ``|e|^2 - 2 z.e`` in float32 (ties and rounding as there)."""
        flat = z.reshape(-1, self.embed_dim).to(torch.float32)
        emb = self.embedding.to(torch.float32)
        d = (emb**2).sum(-1)[None, :] - 2.0 * flat @ emb.T
        return torch.argmin(d, dim=-1).reshape(z.shape[:-1])

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding[indices]

    def forward(self, z: torch.Tensor):
        """Straight-through quantization of ``z [..., embed_dim]``: returns
        ``(z_q, indices, (codebook loss, beta * commitment loss))``, where
        ``z_q`` has ``z``'s values' gradient (``z + (z_q - z).detach()``)."""
        idx = self.nearest(z)
        z_q = self.lookup(idx)
        codebook_loss = torch.mean((z.detach() - z_q) ** 2)
        commit_loss = torch.mean((z - z_q.detach()) ** 2)
        return z + (z_q - z).detach(), idx, (codebook_loss, self.beta * commit_loss)


class TamingVQGAN(nn.Module):
    """Encoder, decoder and codebook with NHWC images in [-1, 1] at the
    public boundary."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)
        self.quant_conv = _conv(2 * cfg.z_channels if cfg.double_z else cfg.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, 1)

    def encode_latent(self, images: torch.Tensor, encoder: Optional[nn.Module] = None) -> torch.Tensor:
        """images NHWC in [-1, 1] -> pre-quantization latents NHWC ``[B, h, w, e]``,
        through ``encoder`` in place of the model's own where given (RCC's trainable clone)."""
        x = images.permute(0, 3, 1, 2).to(self.quantize.embedding.dtype)
        return self.quant_conv((self.encoder if encoder is None else encoder)(x)).permute(0, 2, 3, 1)

    def encode_codes(self, images: torch.Tensor) -> torch.Tensor:
        """images NHWC in [-1, 1] -> token grid ``[B, h*w]`` (row-major)."""
        return self.quantize.nearest(self.encode_latent(images)).reshape(images.shape[0], -1)

    def decode_latent(self, z_q: torch.Tensor, decoder: Optional[Callable] = None) -> torch.Tensor:
        """Latents NHWC ``[B, h, w, e]`` -> images NHWC (unclamped), through
        ``decoder`` in place of the model's own where given."""
        h = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        return (self.decoder if decoder is None else decoder)(h).permute(0, 2, 3, 1)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes ``[B, h*w]`` -> images NHWC (unclamped)."""
        side = self.cfg.codes_per_side
        return self.decode_latent(self.quantize.lookup(codes.reshape(codes.shape[0], side, side)))


@torch.no_grad()
def init_taming_vqgan(cfg: VQGANConfig, generator: torch.Generator, dtype=torch.float32, device=None) -> TamingVQGAN:
    """Random weights from ``generator`` by Flax's default rules: LeCun-normal
    convolutions, zero biases, unit GroupNorms, a uniform codebook in
    ``+-1/n_embed``."""
    model = TamingVQGAN(cfg).to(device)
    for name, p in model.named_parameters():
        if name == "quantize.embedding":
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
