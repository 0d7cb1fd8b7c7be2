"""WAM (Watermark Anything) as the released ``wam_mit.pth`` lays it out
(PyTorch port of ``wmar_tpu.sync.wam_exact``).

* embedder ``vae_small``: the taming-style VAE encoder (ch 32, mult
  (1, 1, 1, 2), 2 res blocks, z 4, no attention but the middle one), the
  binary+concat message processor (32 bits, hidden 64) and the VAE decoder
  (z 68, tanh out), built from ``models/vqgan.py``'s ``Encoder`` and
  ``Decoder``  [``modules/vae.py``, ``modules/msg_processor.py``];
* extractor ``sam_base``: the SAM/ViTDet image encoder (768 wide, 12
  layers, 12 heads, window 8, global attention at blocks 2/5/8/11,
  decomposed relative positions, a LayerNorm neck) and the bilinear pixel
  decoder (x4, x2, x2) to per-pixel 1 + 32 logits  [``modules/vit.py``,
  ``modules/pixel_decoder.py``];
* the ``jnd_1_3_blue`` attenuation with scaling_w 2.0, scaling_i 1.0
  [``modules/jnd.py``], and ImageNet normalization around all of it.

The detector's parameters carry ``wam_mit.pth``'s names
(``detector.image_encoder.*``, ``detector.pixel_decoder.*``) and so does the
message table; the VAE keeps ``models/vqgan.py``'s names, and
:func:`from_wam_state_dict` renames the file's taming keys to them. The
attention is a plain softmax(QK^T + rel)V, as JAX writes it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.models.vqgan import Decoder, Encoder, VQGANConfig
from wmar_tpu_torch.sync.syncseal_models import ChannelsFirstLN, UpBlock

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)

WAM_ENC_CFG = VQGANConfig(
    resolution=256, ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=2,
    attn_resolutions=(), z_channels=4, n_embed=1, embed_dim=4, double_z=False,
)
WAM_DEC_CFG = VQGANConfig(
    resolution=256, ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=2,
    attn_resolutions=(), z_channels=68, n_embed=1, embed_dim=68, out_channels=3,
)


@dataclasses.dataclass(frozen=True)
class SAMViTConfig:
    img_size: int = 256
    patch_size: int = 16
    embed_dim: int = 768
    out_chans: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 8
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


SAM_BASE = SAMViTConfig()
NBITS = 32
SCALING_W = 2.0
SCALING_I = 1.0


# ---------------------------------------------------------------------------
# SAM/ViTDet encoder
# ---------------------------------------------------------------------------


def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class SAMAttention(nn.Module):
    """Multi-head attention with decomposed relative positions; the tables
    are sized to the grid the block sees (the window, or the whole grid),
    so no interpolation branch is needed."""

    def __init__(self, dim: int, num_heads: int, size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        ar_h = torch.arange(h, device=x.device)
        ar_w = torch.arange(w, device=x.device)
        rh = self.rel_pos_h[ar_h[:, None] - ar_h[None, :] + (h - 1)]  # [h, h, hd]
        rw = self.rel_pos_w[ar_w[:, None] - ar_w[None, :] + (w - 1)]
        r_q = q.reshape(b * nh, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = attn.reshape(-1, h, w, h, w) + rel_h[..., None] + rel_w[:, :, :, None, :]
        attn = torch.softmax(attn.reshape(-1, h * w, h * w), dim=-1)
        out = (attn @ v).reshape(b, nh, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class SAMBlock(nn.Module):
    def __init__(self, cfg: SAMViTConfig, window_size: int):
        super().__init__()
        d = cfg.embed_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = SAMAttention(d, cfg.num_heads, window_size or cfg.grid)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _MLP(d, int(d * cfg.mlp_ratio))

    def forward(self, x):
        hn = self.norm1(x)
        if self.window_size:
            hw = (x.shape[1], x.shape[2])
            hn, pad_hw = _window_partition(hn, self.window_size)
            hn = _window_unpartition(self.attn(hn), self.window_size, pad_hw, hw)
        else:
            hn = self.attn(hn)
        x = x + hn
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class ImageEncoderViT(nn.Module):
    """NHWC images (ImageNet-normalized) -> features ``[B, out_chans, g, g]``."""

    def __init__(self, cfg: SAMViTConfig = SAM_BASE):
        super().__init__()
        self.cfg = cfg
        d, oc = cfg.embed_dim, cfg.out_chans
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, d))
        self.blocks = nn.ModuleList([
            SAMBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size) for i in range(cfg.depth)])
        self.neck = nn.Sequential(nn.Conv2d(d, oc, 1, bias=False), ChannelsFirstLN(oc),
                                  nn.Conv2d(oc, oc, 3, padding=1, bias=False), ChannelsFirstLN(oc))

    def forward(self, x):
        h = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        return self.neck(h.permute(0, 3, 1, 2))


class PixelDecoder(nn.Module):
    """Bilinear upscaling stages (x4, x2, x2 for WAM) and a 1x1 head ->
    ``[B, out_channels, H, W]``."""

    def __init__(self, embed_dim: int, out_channels: int, upscale_stages=(4, 2, 2)):
        super().__init__()
        ups, ch = [], embed_dim
        for f in upscale_stages:
            ups.append(UpBlock(ch, ch // f, f))
            ch //= f
        self.output_upscaling = nn.Sequential(*ups)
        self.last_layer = nn.Conv2d(ch, out_channels, 1)

    def forward(self, x):
        return self.last_layer(self.output_upscaling(x))


# ---------------------------------------------------------------------------
# Message processor and JND
# ---------------------------------------------------------------------------


def msg_concat(emb_table: torch.Tensor, latents: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """binary+concat (``msg_processor.py:96-118``) on NCHW latents: rows
    ``2k + bit_k`` of the table summed, tiled over the grid, concatenated
    on the channels."""
    k = msgs.shape[-1]
    idx = 2 * torch.arange(k, device=msgs.device)[None, :] + msgs.to(torch.int64)
    aux = emb_table[idx].sum(dim=1)  # [B, d]
    b, _, h, w = latents.shape
    return torch.cat([latents, aux[:, :, None, None].expand(b, aux.shape[-1], h, w)], dim=1)


_SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
_SOBEL_Y = [[1, 2, 1], [0, 0, 0], [-1, -2, -1]]
_LUM = [[1, 1, 1, 1, 1], [1, 2, 2, 2, 1], [1, 2, 0, 2, 1], [1, 2, 2, 2, 1], [1, 1, 1, 1, 1]]


def _fixed_conv(x1: torch.Tensor, kernel) -> torch.Tensor:
    """Zero-padded 'same' cross-correlation of NHWC ``[B, H, W, 1]``."""
    k = torch.tensor(kernel, dtype=x1.dtype, device=x1.device)[None, None]
    return F.conv2d(x1.permute(0, 3, 1, 2), k, padding=k.shape[-1] // 2).permute(0, 2, 3, 1)


def jnd_heatmaps(imgs01: torch.Tensor, blue: bool = True, clc: float = 0.3) -> torch.Tensor:
    """``jnd_1_3(_blue)``: the luminance and contrast masking heatmap of
    NHWC images in [0, 1] (``jnd.py:69-110``)."""
    x = 255.0 * imgs01
    lum = (x * torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)).sum(-1, keepdim=True)
    la = _fixed_conv(lum, _LUM) / 32.0
    la_low = 17.0 * (1.0 - torch.sqrt(torch.clamp(la / 127.0, min=0.0) + 1e-5))
    la_high = 3.0 / 128.0 * (la - 127.0) + 3.0
    la = torch.where(la <= 127.0, la_low, la_high)
    gx = _fixed_conv(lum, _SOBEL_X)
    gy = _fixed_conv(lum, _SOBEL_Y)
    cm = torch.sqrt(gx**2 + gy**2)
    cm = 0.117 * (16.0 * cm**2.4 / (cm**2 + 26.0**2))
    hmap = torch.clamp(la + cm - clc * torch.minimum(la, cm), min=0.0).expand(*la.shape[:3], 3)
    if blue:
        hmap = hmap * torch.tensor([0.5, 0.5, 1.0], dtype=x.dtype, device=x.device)
    return hmap / 255.0


# ---------------------------------------------------------------------------
# The WAM model
# ---------------------------------------------------------------------------


class _MsgProcessor(nn.Module):
    def __init__(self, nbits: int, hidden: int):
        super().__init__()
        self.msg_embeddings = nn.Embedding(2 * nbits, hidden)


class _Embedder(nn.Module):
    def __init__(self, enc_cfg, dec_cfg, nbits):
        super().__init__()
        self.encoder = Encoder(enc_cfg)
        self.msg_processor = _MsgProcessor(nbits, 2 * nbits)
        self.decoder = Decoder(dec_cfg)


class _Detector(nn.Module):
    def __init__(self, vit_cfg, nbits, upscale_stages):
        super().__init__()
        self.image_encoder = ImageEncoderViT(vit_cfg)
        self.pixel_decoder = PixelDecoder(vit_cfg.out_chans, 1 + nbits, upscale_stages)


def _norm(x01: torch.Tensor) -> torch.Tensor:
    return (x01 - x01.new_tensor(IMAGE_MEAN)) / x01.new_tensor(IMAGE_STD)


def _unnorm(xn: torch.Tensor) -> torch.Tensor:
    return xn * xn.new_tensor(IMAGE_STD) + xn.new_tensor(IMAGE_MEAN)


class WamExact(nn.Module):
    """``Wam.embed`` / ``Wam.detect``, the embedder that ``wam_logic.WamSync``
    takes:

      embed(img01 [B, H, W, 3], msg [B, 32]) -> watermarked img01
      detect(img01 [B, H, W, 3]) -> [B, 33, H, W] logits (mask + 32 bits)
    """

    def __init__(self, vit_cfg: SAMViTConfig = SAM_BASE, enc_cfg: VQGANConfig = WAM_ENC_CFG,
                 dec_cfg: VQGANConfig = WAM_DEC_CFG, nbits: int = NBITS, upscale_stages=(4, 2, 2),
                 device=None):
        super().__init__()
        self.vit_cfg, self.enc_cfg, self.dec_cfg, self.nbits = vit_cfg, enc_cfg, dec_cfg, nbits
        self.upscale_stages = tuple(upscale_stages)
        with torch.device(device or "cpu"):
            self.embedder = _Embedder(enc_cfg, dec_cfg, nbits)
            self.detector = _Detector(vit_cfg, nbits, self.upscale_stages)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.detector.image_encoder.pos_embed.device

    @torch.no_grad()
    def embed(self, img01: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        x = _norm(img01)
        latents = self.embedder.encoder(x.permute(0, 3, 1, 2))
        latents = msg_concat(self.embedder.msg_processor.msg_embeddings.weight, latents, msgs)
        delta = torch.tanh(self.embedder.decoder(latents)).permute(0, 2, 3, 1)
        imgs_w = SCALING_I * x + SCALING_W * delta
        # the attenuation runs in [0, 1] space
        i01, w01 = _unnorm(x), _unnorm(imgs_w)
        return torch.clamp(i01 + jnd_heatmaps(i01, blue=True) * (w01 - i01), 0.0, 1.0)

    @torch.no_grad()
    def detect(self, img01: torch.Tensor) -> torch.Tensor:
        return self.detector.pixel_decoder(self.detector.image_encoder(_norm(img01)))

    @staticmethod
    def load(path: str, device=None, **cfg) -> "WamExact":
        """``wam_mit.pth`` (or a file in its layout) on ``device``."""
        from wmar_tpu_torch.utils.convert import load_torch_state_dict

        model = WamExact(device="meta", **cfg)
        model.load_state_dict(from_wam_state_dict(load_torch_state_dict(path), model), strict=True, assign=True)
        return model.to(device).eval()


# the taming VAE's names in wam_mit.pth against models/vqgan.py's
_TAMING_RENAMES = (
    (re.compile(r"^(down|up)_(\d+)_block_(\d+)\.GroupNorm_0\."), r"\1.\2.block.\3.norm1."),
    (re.compile(r"^(down|up)_(\d+)_block_(\d+)\.GroupNorm_1\."), r"\1.\2.block.\3.norm2."),
    (re.compile(r"^(down|up)_(\d+)_block_(\d+)\."), r"\1.\2.block.\3."),
    (re.compile(r"^(down|up)_(\d+)_attn_(\d+)\.GroupNorm_0\."), r"\1.\2.attn.\3.norm."),
    (re.compile(r"^(down|up)_(\d+)_attn_(\d+)\."), r"\1.\2.attn.\3."),
    (re.compile(r"^down_(\d+)_downsample\."), r"down.\1.downsample."),
    (re.compile(r"^up_(\d+)_upsample\."), r"up.\1.upsample."),
    (re.compile(r"^mid_(block_\d)\.GroupNorm_0\."), r"mid.\1.norm1."),
    (re.compile(r"^mid_(block_\d)\.GroupNorm_1\."), r"mid.\1.norm2."),
    (re.compile(r"^mid_(block_\d)\."), r"mid.\1."),
    (re.compile(r"^mid_attn_1\.GroupNorm_0\."), r"mid.attn_1.norm."),
    (re.compile(r"^mid_attn_1\."), r"mid.attn_1."),
    (re.compile(r"^GroupNorm_0\."), r"norm_out."),
)


def taming_name(key: str) -> str:
    """A ``models/vqgan.py`` Encoder/Decoder key as the taming checkpoint
    names it (``down_0_block_1.GroupNorm_0.weight`` ->
    ``down.0.block.1.norm1.weight``)."""
    for pat, rep in _TAMING_RENAMES:
        new, n = pat.subn(rep, key)
        if n:
            return new
    return key


def _wam_key(key: str) -> str:
    """A ``WamExact`` state-dict key as ``wam_mit.pth`` names it."""
    for part in ("embedder.encoder.", "embedder.decoder."):
        if key.startswith(part):
            return part + taming_name(key[len(part):])
    return key


def from_wam_state_dict(sd: Dict[str, torch.Tensor], model: WamExact) -> Dict[str, torch.Tensor]:
    """The tensors of a ``wam_mit.pth``-layout state dict under ``model``'s
    keys. Keys the port does not hold (the augmenter's, the attenuation's
    fixed kernels) are left out."""
    missing = [_wam_key(k) for k in model.state_dict() if _wam_key(k) not in sd]
    if missing:
        raise KeyError(f"the WAM state dict lacks {missing[:5]}")
    return {k: torch.as_tensor(sd[_wam_key(k)]) for k in model.state_dict()}


def to_wam_state_dict(model: WamExact) -> Dict[str, torch.Tensor]:
    """``model``'s tensors under ``wam_mit.pth``'s keys (the inverse of
    :func:`from_wam_state_dict`)."""
    return {_wam_key(k): t for k, t in model.state_dict().items()}


def convert_vit(sd, vit_cfg: SAMViTConfig, prefix: str) -> dict:
    """A ViTDet ``ImageEncoderViT`` state dict -> the JAX package's
    ``sam_encoder`` tree (``wmar_tpu.sync.wam_exact.convert_vit``; WAM's
    detector and SyncSeal's ``SegmentationExtractor`` share it)."""
    from wmar_tpu_torch.utils.convert import _conv, _hwio, _ln, _t

    def lin(p):  # a Linear, its bias only where the state dict has one
        out = {"w": _t(sd[p + ".weight"]).T.contiguous()}
        if p + ".bias" in sd:
            out["b"] = _t(sd[p + ".bias"])
        return out

    blocks = []
    for i in range(vit_cfg.depth):
        p = f"{prefix}blocks.{i}."
        blocks.append({
            "norm1": _ln(sd, p + "norm1"),
            "norm2": _ln(sd, p + "norm2"),
            "attn": {"qkv": lin(p + "attn.qkv"), "proj": lin(p + "attn.proj"),
                     "rel_pos_h": _t(sd[p + "attn.rel_pos_h"]), "rel_pos_w": _t(sd[p + "attn.rel_pos_w"])},
            "mlp_lin1": lin(p + "mlp.lin1"),
            "mlp_lin2": lin(p + "mlp.lin2"),
        })
    return {
        "patch_embed": {"kernel": _hwio(sd[prefix + "patch_embed.proj.weight"]),
                        "bias": _t(sd[prefix + "patch_embed.proj.bias"])},
        "pos_embed": _t(sd[prefix + "pos_embed"]),
        "blocks": blocks,
        "neck0": _conv(sd, prefix + "neck.0"),
        "neck1": _ln(sd, prefix + "neck.1"),
        "neck2": _conv(sd, prefix + "neck.2"),
        "neck3": _ln(sd, prefix + "neck.3"),
    }


def convert_pixel_decoder(sd, upscale_stages, prefix: str) -> list:
    """A ``PixelDecoder`` state dict -> the JAX ``pixel_decoder`` list (each
    upscaling stage with its ``factor``, then the last conv)."""
    from wmar_tpu_torch.utils.convert import _conv, _ln

    pd = []
    for si, factor in enumerate(upscale_stages):
        p = f"{prefix}output_upscaling.{si}.upsample_block."
        pd.append({"factor": factor, "conv": _conv(sd, p + "2"), "ln": _ln(sd, p + "3")})
    pd.append(_conv(sd, prefix + "last_layer"))
    return pd


def convert_wam(sd, vit_cfg: SAMViTConfig = SAM_BASE, upscale_stages=(4, 2, 2), enc_cfg: VQGANConfig = WAM_ENC_CFG,
                dec_cfg: VQGANConfig = WAM_DEC_CFG) -> dict:
    """``wam_mit.pth`` -> the JAX package's WamExact tree (``wmar_tpu.sync.
    wam_exact.convert_wam``): the embedder's VAE through the Taming
    converters, the detector through :func:`convert_vit` and
    :func:`convert_pixel_decoder`. The fixed attenuation kernels and the
    training-only augmenter are not read."""
    from wmar_tpu_torch.utils.convert import _convert_taming_decoder, _convert_taming_encoder, _t

    return {
        "vae_encoder": _convert_taming_encoder(sd, enc_cfg, "embedder.encoder."),
        "msg_embeddings": _t(sd["embedder.msg_processor.msg_embeddings.weight"]),
        "vae_decoder": _convert_taming_decoder(sd, dec_cfg, "embedder.decoder."),
        "vit": convert_vit(sd, vit_cfg, "detector.image_encoder."),
        "pixel_decoder": convert_pixel_decoder(sd, upscale_stages, "detector.pixel_decoder."),
    }


def init_wam(seed: int, device=None, **cfg) -> WamExact:
    """A WAM with random weights from ``seed`` (drawn on the CPU, so a seed
    gives the same weights on every device): convolutions and linears
    He-normal, the message table standard normal, the relative-position
    tables and positions 0.02-normal, norms at one and zero."""
    gen = torch.Generator().manual_seed(seed)
    model = WamExact(**cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("msg_embeddings.weight"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif "rel_pos" in name or "pos_embed" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model.to(device).eval()
