"""SyncSeal's model-zoo variants beyond the shipped pair (PyTorch port of
``wmar_tpu.sync.syncseal_zoo``).

The reference registers more architectures than its released config uses
(``syncseal/syncseal/models/embedder.py:24-110``, ``extractor.py:44-110``):

* ``vae*`` embedder: a taming-style VAE encoder -> decoder with
  GroupNorm(16) (``syncseal/modules/vae.py:24``), input ``* 2 - 1``; built
  on ``models/vqgan.py``'s ``Encoder``/``Decoder`` (``norm_groups`` 16);
* ``sam*`` extractor: the ViTDet ``ImageEncoderViT`` and ``PixelDecoder``
  of ``sync/wam_exact.py`` (the reference's files are watermark_anything's);
  the images go in as they are (``extractor.py:84-96`` has no ``* 2 - 1``),
  a per-pixel ``[B, H, W, 1 + nparams]`` map comes out.

Each comes with its converter from the reference's state dict and a numpy
init: the extractor's draws JAX's ``init_seg_extractor_params`` tree from
the same seed; the VAE's is He-normal from numpy (JAX's draws from its own
PRNG, so its weights cross through ``bridge`` instead).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from wmar_tpu_torch.models.vqgan import Decoder, Encoder, VQGANConfig
from wmar_tpu_torch.sync.wam_exact import ImageEncoderViT, PixelDecoder, SAMViTConfig, taming_name

# ---------------------------------------------------------------------------
# VAE embedder (embedder.py:38-67)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEEmbedderConfig:
    encoder: VQGANConfig
    decoder: VQGANConfig
    yuv: bool = False  # 'yuv' in the registry name (embedder.py:108)


def _vqgan_cfg_from_yaml(entry: dict, is_encoder: bool) -> VQGANConfig:
    """The reference's ``VAEEncoder(**cfg.encoder)`` / ``VAEDecoder(**cfg.
    decoder)`` kwargs as a ``VQGANConfig``, GroupNorm(16) as syncseal's vae.py."""
    return VQGANConfig(
        resolution=int(entry.get("resolution", 256)),
        in_channels=int(entry.get("in_channels", 3)),
        out_channels=1 if entry.get("bw") else int(entry.get("out_ch", 3)),
        ch=int(entry.get("ch", 64)),
        ch_mult=tuple(entry.get("ch_mult", (1, 2, 4, 8))),
        num_res_blocks=int(entry.get("num_res_blocks", 2)),
        attn_resolutions=tuple(entry.get("attn_resolutions", ())),
        z_channels=int(entry.get("z_channels", 4)),
        double_z=bool(entry.get("double_z", False)) if is_encoder else False,
        tanh_out=bool(entry.get("tanh_out", False)) and not is_encoder,
        norm_groups=16,
        dropout=float(entry.get("dropout", 0.0)),
    )


def vae_embedder_config(cfg_yaml: dict, name: str = "vae") -> VAEEmbedderConfig:
    """From an embedder.yaml entry with ``encoder:`` / ``decoder:`` maps
    (embedder.py:99-104)."""
    return VAEEmbedderConfig(encoder=_vqgan_cfg_from_yaml(cfg_yaml.get("encoder", {}), True),
                             decoder=_vqgan_cfg_from_yaml(cfg_yaml.get("decoder", {}), False),
                             yuv="yuv" in name)


class VAEEmbedder(nn.Module):
    """[0, 1] NHWC -> the watermark delta, NHWC (``VAEEmbedder.forward``:
    ``* 2 - 1``, encode, decode). Parameters carry ``models/vqgan.py``'s
    (Flax) names under ``encoder.`` / ``decoder.``."""

    def __init__(self, cfg: VAEEmbedderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.encoder)
        self.decoder = Decoder(cfg.decoder)

    def forward(self, imgs01):
        x = (imgs01 * 2.0 - 1.0).permute(0, 3, 1, 2)
        return self.decoder(self.encoder(x)).permute(0, 2, 3, 1)


def convert_vae_embedder(sd, cfg: VAEEmbedderConfig, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's VAEEmbedder state dict (taming names under
    ``encoder.`` / ``decoder.``) as :class:`VAEEmbedder`'s."""
    with torch.device("meta"):
        keys = VAEEmbedder(cfg).state_dict().keys()
    out = {}
    for k in keys:
        part, rest = k.split(".", 1)
        src = f"{prefix}{part}.{taming_name(rest)}"
        if src not in sd:
            raise KeyError(f"the VAE embedder state dict lacks {src}")
        out[k] = torch.as_tensor(sd[src])
    return out


def init_vae_embedder(seed: int, cfg: VAEEmbedderConfig, device=None) -> VAEEmbedder:
    """Random weights from numpy seed ``seed``: convolutions He-normal,
    biases zero, norms one."""
    rng = np.random.default_rng(seed)
    model = VAEEmbedder(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.copy_(torch.from_numpy(rng.normal(0, (2.0 / p[0].numel()) ** 0.5, tuple(p.shape))
                                         .astype(np.float32)))
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    return model.to(device)


# ---------------------------------------------------------------------------
# SAM segmentation extractor (extractor.py:70-96)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegExtractorConfig:
    vit: SAMViTConfig
    upscale_stages: Tuple[int, ...] = (4, 2, 2)
    nparams: int = 8  # output channels = 1 + nparams (PixelDecoder nbits)


def seg_extractor_config(cfg_yaml: dict, img_size: int = 256) -> SegExtractorConfig:
    """From an extractor.yaml entry with ``encoder:`` / ``pixel_decoder:``
    maps; ``img_size`` forced as the reference does (``extractor.py:104-107``)."""
    enc = dict(cfg_yaml.get("encoder", {}))
    pd = dict(cfg_yaml.get("pixel_decoder", {}))
    vit = SAMViTConfig(
        img_size=img_size,
        patch_size=int(enc.get("patch_size", 16)),
        embed_dim=int(enc.get("embed_dim", 768)),
        out_chans=int(enc.get("out_chans", enc.get("embed_dim", 768))),
        depth=int(enc.get("depth", 12)),
        num_heads=int(enc.get("num_heads", 12)),
        mlp_ratio=float(enc.get("mlp_ratio", 4.0)),
        window_size=int(enc.get("window_size", 8)),
        global_attn_indexes=tuple(enc.get("global_attn_indexes", (2, 5, 8, 11))),
    )
    return SegExtractorConfig(vit=vit, upscale_stages=tuple(pd.get("upscale_stages", (4, 2, 2))),
                              nparams=int(pd.get("nbits", 8)))


# sam_tiny: the reference's train_sync.py:77 default extractor name, ViT-tiny geometry
SAM_TINY = SegExtractorConfig(vit=SAMViTConfig(embed_dim=192, out_chans=192, depth=12, num_heads=3))


class SegExtractor(nn.Module):
    """NHWC images (no ``* 2 - 1``) -> ``[B, H, W, 1 + nparams]``; parameters
    ``image_encoder.*`` and ``pixel_decoder.*``, the reference's names."""

    def __init__(self, cfg: SegExtractorConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg.vit)
        self.pixel_decoder = PixelDecoder(cfg.vit.out_chans, 1 + cfg.nparams, cfg.upscale_stages)

    def forward(self, imgs):
        return self.pixel_decoder(self.image_encoder(imgs)).permute(0, 2, 3, 1)


def convert_seg_extractor(sd, cfg: SegExtractorConfig, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's SegmentationExtractor state dict (``image_encoder.*``
    / ``pixel_decoder.*`` under ``prefix``) as :class:`SegExtractor`'s."""
    with torch.device("meta"):
        keys = SegExtractor(cfg).state_dict().keys()
    missing = [prefix + k for k in keys if prefix + k not in sd]
    if missing:
        raise KeyError(f"the seg extractor state dict lacks {missing[:5]}")
    return {k: torch.as_tensor(sd[prefix + k]) for k in keys}


def init_vit_params(rng: np.random.Generator, vit_cfg: SAMViTConfig) -> dict:
    """JAX's ``wam_exact.init_vit_params`` tree (numpy), JAX's draws."""

    def lin(i, o):
        return {"w": rng.normal(0, i**-0.5, (i, o)).astype(np.float32), "b": np.zeros((o,), np.float32)}

    def ln(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}

    d, hd = vit_cfg.embed_dim, vit_cfg.embed_dim // vit_cfg.num_heads
    blocks = []
    for i in range(vit_cfg.depth):
        size = vit_cfg.grid if i in vit_cfg.global_attn_indexes else vit_cfg.window_size
        blocks.append({"norm1": ln(d), "norm2": ln(d),
                       "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d),
                                "rel_pos_h": np.zeros((2 * size - 1, hd), np.float32),
                                "rel_pos_w": np.zeros((2 * size - 1, hd), np.float32)},
                       "mlp_lin1": lin(d, int(d * vit_cfg.mlp_ratio)),
                       "mlp_lin2": lin(int(d * vit_cfg.mlp_ratio), d)})
    oc = vit_cfg.out_chans
    return {
        "patch_embed": {"kernel": rng.normal(0, 0.02, (vit_cfg.patch_size, vit_cfg.patch_size, 3, d))
                        .astype(np.float32), "bias": np.zeros((d,), np.float32)},
        "pos_embed": np.zeros((1, vit_cfg.grid, vit_cfg.grid, d), np.float32),
        "blocks": blocks,
        "neck0": {"kernel": rng.normal(0, d**-0.5, (1, 1, d, oc)).astype(np.float32)},
        "neck1": ln(oc),
        "neck2": {"kernel": rng.normal(0, (oc * 9) ** -0.5, (3, 3, oc, oc)).astype(np.float32)},
        "neck3": ln(oc),
    }


def init_pixel_decoder_params(rng: np.random.Generator, out_chans: int, upscale_stages,
                              out_channels: int) -> List[dict]:
    """JAX's ``wam_exact.init_pixel_decoder_params`` list (numpy)."""
    pd, ch = [], out_chans
    for factor in upscale_stages:
        out_ch = ch // factor
        pd.append({"factor": factor,
                   "conv": {"kernel": rng.normal(0, (2.0 / (ch * 9)) ** 0.5, (3, 3, ch, out_ch)).astype(np.float32)},
                   "ln": {"scale": np.ones((out_ch,), np.float32), "bias": np.zeros((out_ch,), np.float32)}})
        ch = out_ch
    pd.append({"kernel": rng.normal(0, (2.0 / ch) ** 0.5, (1, 1, ch, out_channels)).astype(np.float32),
               "bias": np.zeros((out_channels,), np.float32)})
    return pd


def init_seg_extractor_params(seed: int, cfg: SegExtractorConfig) -> dict:
    """JAX's ``init_seg_extractor_params(seed, cfg)`` tree (numpy)."""
    rng = np.random.default_rng(seed)
    return {"vit": init_vit_params(rng, cfg.vit),
            "pixel_decoder": init_pixel_decoder_params(rng, cfg.vit.out_chans, cfg.upscale_stages, 1 + cfg.nparams)}


def init_seg_extractor(seed: int, cfg: SegExtractorConfig, device=None) -> SegExtractor:
    """A :class:`SegExtractor` with JAX's ``init_seg_extractor_params(seed)`` weights."""
    from wmar_tpu_torch import bridge

    model = SegExtractor(cfg)
    model.load_state_dict(bridge.seg_extractor_state_dict(init_seg_extractor_params(seed, cfg), cfg))
    return model.to(device)
