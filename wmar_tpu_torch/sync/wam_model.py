"""A WAM-style pixel watermark trainable from scratch: a small VAE-like
embedder and a ViT extractor (PyTorch port of ``wmar_tpu.sync.wam_model``).

The Flax design of ``deps/watermark_anything`` (``models/wam.py``,
``models/embedder.py``, ``models/extractor.py``): the embedder encodes the
image, adds a projection of the 32-bit message to the latent and decodes an
additive delta, attenuated by the Laplacian JND; the extractor predicts a
presence mask and the 32 bits per pixel. It is the trainable backbone behind
``wam_logic.WamSync`` (quadrant synchronization), trained by
:func:`make_train_step`; ``wam_exact`` holds the released ``wam_mit.pth``.

Flax's defaults are kept, so a JAX tree loads name for name through
``bridge.syncseal_model_state_dict``: SAME padding (a stride-2 conv pads an
even side by (0, 1)), the tanh GELU, LayerNorm eps 1e-6, nearest x2
upsampling.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.augmentations.valuemetric import clip01
from wmar_tpu_torch.sync.syncseal import FlaxMHA, _gelu, _init_like_flax, jnd_heatmap


@dataclasses.dataclass(frozen=True)
class WAMConfig:
    nbits: int = 32
    hidden: int = 64
    latent: int = 128
    scaling_w: float = 2.0
    image_size: int = 256


class SameConv(nn.Conv2d):
    """A 3x3 conv with Flax's SAME padding at its stride."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__(c_in, c_out, 3, stride=stride)

    def forward(self, x):
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad's order: W, then H
            out = -(-n // self.stride[0])
            total = max((out - 1) * self.stride[0] + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class WamEmbedder(nn.Module):
    """``(img01 [B, H, W, 3], msg [B, nbits] in {0, 1}) -> delta [B, H, W, 3]``."""

    def __init__(self, cfg: WAMConfig):
        super().__init__()
        c = cfg
        self.down1 = SameConv(3, c.hidden, 2)
        self.down2 = SameConv(c.hidden, 2 * c.hidden, 2)
        self.down3 = SameConv(2 * c.hidden, c.latent, 2)
        self.msg_proj = nn.Linear(c.nbits, c.latent)
        self.mid = SameConv(c.latent, c.latent)
        self.up1 = SameConv(c.latent, 2 * c.hidden)
        self.up2 = SameConv(2 * c.hidden, c.hidden)
        self.up3 = SameConv(c.hidden, c.hidden)
        self.out = SameConv(c.hidden, 3)

    def forward(self, img01, msg_bits):
        x = (img01 * 2.0 - 1.0).permute(0, 3, 1, 2)
        h1 = _gelu(self.down1(x))
        h2 = _gelu(self.down2(h1))
        z = _gelu(self.down3(h2))
        z = z + self.msg_proj(msg_bits.float() * 2.0 - 1.0)[:, :, None, None]  # the message in the latent
        z = _gelu(self.mid(z))
        h = _gelu(self.up1(_up(z))) + h2
        h = _gelu(self.up2(_up(h))) + h1
        h = _gelu(self.up3(_up(h)))
        return self.out(h).permute(0, 2, 3, 1)


class WamExtractor(nn.Module):
    """``img01 [B, H, W, 3] -> logits [B, 1 + nbits, H, W]``: a conv stem to
    1/4, a ViT over the grid, a nearest x2 decoder twice and a conv head."""

    def __init__(self, cfg: WAMConfig, vit_depth: int = 4, vit_heads: int = 4):
        super().__init__()
        c, d = cfg, cfg.latent
        self.depth = vit_depth
        self.stem1 = SameConv(3, c.hidden, 2)
        self.stem2 = SameConv(c.hidden, d, 2)
        self.pos = nn.Parameter(torch.zeros(1, (c.image_size // 4) ** 2, d))
        for li in range(vit_depth):
            self.add_module(f"ln1_{li}", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"attn_{li}", FlaxMHA(d, vit_heads))
            self.add_module(f"ln2_{li}", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"fc1_{li}", nn.Linear(d, 2 * d))
            self.add_module(f"fc2_{li}", nn.Linear(2 * d, d))
        self.dec0 = SameConv(d, c.hidden)
        self.dec1 = SameConv(c.hidden, c.hidden)
        self.head = SameConv(c.hidden, 1 + c.nbits)

    def forward(self, img01):
        x = (img01 * 2.0 - 1.0).permute(0, 3, 1, 2)
        h = _gelu(self.stem2(_gelu(self.stem1(x))))
        b, d, gh, gw = h.shape
        seq = h.flatten(2).transpose(1, 2) + self.pos
        for li in range(self.depth):
            seq = seq + getattr(self, f"attn_{li}")(getattr(self, f"ln1_{li}")(seq))
            hn = getattr(self, f"ln2_{li}")(seq)
            seq = seq + getattr(self, f"fc2_{li}")(_gelu(getattr(self, f"fc1_{li}")(hn)))
        h = seq.transpose(1, 2).reshape(b, d, gh, gw)
        h = _gelu(self.dec1(_up(_gelu(self.dec0(_up(h))))))
        return self.head(h)


class WamPixelModel(nn.Module):
    """``Wam.embed`` / ``Wam.detect`` (``wam.py:147,194``) over the two
    modules, pluggable into ``WamSync``."""

    def __init__(self, cfg: WAMConfig = WAMConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        with torch.device(device or "cpu"):
            self.embedder = WamEmbedder(cfg)
            self.extractor = WamExtractor(cfg)

    @staticmethod
    def init(seed: int = 0, cfg: WAMConfig = WAMConfig(), device=None) -> "WamPixelModel":
        """Random weights from ``seed`` (on the CPU) with Flax's initial
        values: the delta conv normal(1e-2) (a zero delta stalls joint
        training), the extractor's head zero (BCE-neutral logits)."""
        model = WamPixelModel(cfg)
        gen = torch.Generator().manual_seed(seed)
        _init_like_flax(model, gen, zero=("extractor.head.weight",))
        with torch.no_grad():
            model.embedder.out.weight.copy_(torch.randn(model.embedder.out.weight.shape, generator=gen) * 1e-2)
        return model.to(device)

    def embed(self, img01: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        delta = self.embedder(img01, msg)
        return torch.clamp(img01 + self.cfg.scaling_w * jnd_heatmap(img01) * delta, 0.0, 1.0)

    def detect(self, img01: torch.Tensor) -> torch.Tensor:
        return self.extractor(img01)


def make_train_step(model: WamPixelModel, optimizer: torch.optim.Optimizer):
    """From-scratch WAM training, the core of the reference's objective:
    embed a random message, keep it left of a random vertical cut, add 0.01
    noise, then BCE on the mask and on the bits inside it, plus 0.1 x the
    delta's energy. ``train_step(imgs01, generator=None, msg=None, cut=None,
    noise=None)`` returns the metrics; ``msg`` ``[B, nbits]``, ``cut``
    ``[B]`` (in [W/4, 3W/4)) and ``noise`` ``[B, H, W, 3]`` feed the draws."""
    cfg = model.cfg

    def train_step(imgs01, generator=None, msg=None, cut=None, noise=None):
        b, h, w, _ = imgs01.shape
        dev = imgs01.device
        if msg is None:
            msg = (torch.rand(b, cfg.nbits, generator=generator) < 0.5).float()
        if cut is None:
            cut = torch.randint(w // 4, 3 * w // 4, (b,), generator=generator)
        if noise is None:
            noise = torch.randn(imgs01.shape, generator=generator)
        msg, cut, noise = msg.to(dev).float(), torch.as_tensor(cut).to(dev), noise.to(dev)
        delta = model.embedder(imgs01, msg)
        wm = clip01(imgs01 + cfg.scaling_w * jnd_heatmap(imgs01) * delta)
        mask = (torch.arange(w, device=dev)[None, None, :, None] < cut.reshape(b, 1, 1, 1)).float()
        mask = mask.expand(b, h, w, 1)
        mixed = clip01(wm * mask + imgs01 * (1 - mask) + noise * 0.01)
        logits = model.extractor(mixed)
        mask_t = mask[..., 0][:, None]
        mask_loss = F.binary_cross_entropy_with_logits(logits[:, 0:1], mask_t)
        bits_t = msg[:, :, None, None].expand(-1, -1, h, w)
        bce = F.binary_cross_entropy_with_logits(logits[:, 1:], bits_t, reduction="none")
        bit_loss = (bce * mask_t).sum() / (mask_t.sum() * cfg.nbits + 1e-6)
        loss = mask_loss + bit_loss + 0.1 * (delta**2).mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "mask_loss": mask_loss.detach(), "bit_loss": bit_loss.detach()}

    return train_step
