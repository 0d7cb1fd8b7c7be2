"""The diffusers AutoencoderKL codecs (SD-VAE ft-ema, SDXL fp16, FLUX) in PyTorch.

Port of ``wmar_tpu.augmentations.diffusers_vae``: ``diffusers``'
``AutoencoderKL`` as the reference's ``DiffusersCompression`` runs it
(``wmar/augmentations/neuralcompression.py:119-225``): encode, sample the
diagonal Gaussian posterior, decode, and report the model's fixed nominal
bpp (the reference's 2 / 1 / 1 / 2 for sd / sdxl / dc-ae / flux). Modules
run NCHW; :class:`DiffusersCompression` takes NHWC images in [0, 1].

The posterior's noise comes from the caller's ``torch.Generator`` (the
attack cell's, ``eval/pipeline.py:cell_seed``), as the reference draws
fresh noise on every call. The JAX package's attack manager drops the
cell's key, so there every call draws from ``PRNGKey(0)`` (ROADMAP queue
3, fault (h)).

State-dict layout converted (diffusers naming):
``encoder.down_blocks.{i}.resnets.{j}.{norm1,conv1,norm2,conv2,conv_shortcut}``,
``...downsamplers.0.conv``, ``encoder.mid_block.{resnets.{0,1},attentions.0.
{group_norm,to_q,to_k,to_v,to_out.0}}``, ``encoder.conv_norm_out/conv_out``,
``quant_conv`` / ``post_quant_conv`` (absent for FLUX), and the mirrored
``decoder.up_blocks...`` tree. The DC-AE (``diffusers-deep-compression``)
lives in :mod:`wmar_tpu_torch.augmentations.dcae` and is built from here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from wmar_tpu_torch.augmentations import geometric as G


@dataclasses.dataclass(frozen=True)
class KLVAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    use_quant_conv: bool = True
    nominal_bpp: float = 2.0

    @staticmethod
    def for_name(name: str) -> "KLVAEConfig":
        if "flux" in name:
            # black-forest-labs/FLUX.1-schnell's vae: f8, 16 latent channels, no quant convs
            return KLVAEConfig(latent_channels=16, use_quant_conv=False, nominal_bpp=2.0)
        if "fp16" in name or "sdxl" in name:
            return KLVAEConfig(nominal_bpp=1.0)  # madebyollin/sdxl-vae-fp16-fix
        return KLVAEConfig(nominal_bpp=2.0)  # stabilityai/sd-vae-ft-ema


def _group_norm(groups: int, c: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, c, eps=1e-6)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1, self.conv1 = _group_norm(groups, cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _group_norm(groups, cout), nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class Attention(nn.Module):
    """The mid block's single-head self-attention, with a residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = _group_norm(groups, c)
        self.to_q, self.to_k, self.to_v, self.to_out = (nn.Linear(c, c) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(q @ k.transpose(1, 2) / c**0.5, dim=-1)
        out = self.to_out(attn @ v)
        return out.transpose(1, 2).reshape(b, c, hh, ww) + x


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c, groups), ResnetBlock2D(c, c, groups)])
        self.attn = Attention(c, groups)

    def forward(self, x):
        return self.resnets[1](self.attn(self.resnets[0](x)))


class _Stage(nn.Module):
    """One encoder level (resnets, then a stride-2 conv after a (0, 1, 0, 1)
    pad) or decoder level (resnets, then a nearest 2x upsample and a conv)."""

    def __init__(self, cin: int, cout: int, n_resnets: int, groups: int, resample: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, groups) for j in range(n_resnets)])
        if resample == "down":
            self.downsample = nn.Conv2d(cout, cout, 3, stride=2)
        elif resample == "up":
            self.upsample = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if hasattr(self, "downsample"):
            h = self.downsample(F.pad(h, (0, 1, 0, 1)))
        if hasattr(self, "upsample"):
            h = self.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class AutoencoderKL(nn.Module):
    """``AutoencoderKL``'s encoder and decoder; attribute names follow the
    JAX package's parameter tree (``conv_in``, ``down_blocks``, ...,
    ``conv_out_dec``), which ``wmar_tpu_torch.bridge.load_kl_vae`` loads."""

    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        self.cfg = cfg
        ch, g, z, n = cfg.block_out_channels, cfg.norm_num_groups, cfg.latent_channels, len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, "down" if i != n - 1 else None)
            for i, c in enumerate(ch)])
        self.mid_block = MidBlock(ch[-1], g)
        self.conv_norm_out = _group_norm(g, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * z, 3, padding=1)
        rev = list(reversed(ch))
        self.conv_in_dec = nn.Conv2d(z, ch[-1], 3, padding=1)
        self.mid_block_dec = MidBlock(ch[-1], g)
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g, "up" if i != n - 1 else None)
            for i, c in enumerate(rev)])
        self.conv_norm_out_dec = _group_norm(g, ch[0])
        self.conv_out_dec = nn.Conv2d(ch[0], 3, 3, padding=1)
        if cfg.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
            self.post_quant_conv = nn.Conv2d(z, z, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x NCHW -> moments ``[B, 2 * latent, H/f, W/f]``."""
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        moments = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(moments) if self.cfg.use_quant_conv else moments

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        h = self.mid_block_dec(self.conv_in_dec(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out_dec(F.silu(self.conv_norm_out_dec(h)))


def sample_posterior(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw of the diagonal Gaussian ``moments = [mean, logvar]`` (NCHW):
    ``mean + std * noise``, the noise drawn from ``generator`` unless given
    (a test feeds the JAX package's draws)."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + std * noise


def kl_vae_roundtrip(model: AutoencoderKL, x01: torch.Tensor, generator=None, noise=None) -> torch.Tensor:
    """[0, 1] NCHW in and out, as ``DiffusersCompression.forward`` runs the
    AutoencoderKL (raw [0, 1] images; only DC-AE rescales)."""
    return model.decode(sample_posterior(model.encode(x01), generator, noise))


# ---------------------------------------------------------------------------
# conversion + random init (numpy, the JAX package's layout and draws)
# ---------------------------------------------------------------------------


def _cv(sd, p):
    return {"kernel": np.ascontiguousarray(np.transpose(sd[p + ".weight"], (2, 3, 1, 0))),
            "bias": np.asarray(sd[p + ".bias"])}


def _gn(sd, p):
    return {"scale": np.asarray(sd[p + ".weight"]), "bias": np.asarray(sd[p + ".bias"])}


def _lin(sd, p):
    return {"w": np.ascontiguousarray(sd[p + ".weight"].T), "b": np.asarray(sd[p + ".bias"])}


def _res(sd, p):
    out = {"norm1": _gn(sd, p + ".norm1"), "conv1": _cv(sd, p + ".conv1"),
           "norm2": _gn(sd, p + ".norm2"), "conv2": _cv(sd, p + ".conv2")}
    if p + ".conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _cv(sd, p + ".conv_shortcut")
    return out


def _mid(sd, p):
    return {
        "resnets": [_res(sd, p + ".resnets.0"), _res(sd, p + ".resnets.1")],
        "attn": {"group_norm": _gn(sd, p + ".attentions.0.group_norm"), "to_q": _lin(sd, p + ".attentions.0.to_q"),
                 "to_k": _lin(sd, p + ".attentions.0.to_k"), "to_v": _lin(sd, p + ".attentions.0.to_v"),
                 "to_out": _lin(sd, p + ".attentions.0.to_out.0")},
    }


def convert_kl_vae(sd, cfg: KLVAEConfig) -> dict:
    """A diffusers AutoencoderKL state dict (numpy) -> the parameter tree."""
    nlev = len(cfg.block_out_channels)
    down = []
    for i in range(nlev):
        blk = {"resnets": [_res(sd, f"encoder.down_blocks.{i}.resnets.{j}") for j in range(cfg.layers_per_block)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _cv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
        down.append(blk)
    up = []
    for i in range(nlev):
        blk = {"resnets": [_res(sd, f"decoder.up_blocks.{i}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _cv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        up.append(blk)
    params = {
        "conv_in": _cv(sd, "encoder.conv_in"), "down_blocks": down, "mid_block": _mid(sd, "encoder.mid_block"),
        "conv_norm_out": _gn(sd, "encoder.conv_norm_out"), "conv_out": _cv(sd, "encoder.conv_out"),
        "conv_in_dec": _cv(sd, "decoder.conv_in"), "mid_block_dec": _mid(sd, "decoder.mid_block"), "up_blocks": up,
        "conv_norm_out_dec": _gn(sd, "decoder.conv_norm_out"), "conv_out_dec": _cv(sd, "decoder.conv_out"),
    }
    if cfg.use_quant_conv:
        params["quant_conv"] = _cv(sd, "quant_conv")
        params["post_quant_conv"] = _cv(sd, "post_quant_conv")
    return params


def init_kl_vae_params(seed: int, cfg: KLVAEConfig) -> dict:
    """Random parameters in :func:`convert_kl_vae`'s layout, the JAX
    package's numpy draws in its order (the same seed gives the same tree)."""
    rng = np.random.default_rng(seed)

    def cv(i, o, k=3):
        fan = i * k * k
        return {"kernel": rng.normal(0, (2.0 / fan) ** 0.5, (k, k, i, o)).astype(np.float32),
                "bias": np.zeros((o,), np.float32)}

    def gn(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}

    def lin(i, o):
        return {"w": rng.normal(0, i**-0.5, (i, o)).astype(np.float32), "b": np.zeros((o,), np.float32)}

    def res(i, o):
        out = {"norm1": gn(i), "conv1": cv(i, o), "norm2": gn(o), "conv2": cv(o, o)}
        if i != o:
            out["conv_shortcut"] = cv(i, o, 1)
        return out

    def mid(c):
        return {"resnets": [res(c, c), res(c, c)],
                "attn": {"group_norm": gn(c), "to_q": lin(c, c), "to_k": lin(c, c), "to_v": lin(c, c),
                         "to_out": lin(c, c)}}

    ch = cfg.block_out_channels
    down, prev = [], ch[0]
    for i, c in enumerate(ch):
        blk = {"resnets": [res(prev if j == 0 else c, c) for j in range(cfg.layers_per_block)]}
        if i != len(ch) - 1:
            blk["downsample"] = cv(c, c)
        down.append(blk)
        prev = c
    rev = list(reversed(ch))
    up, prev = [], rev[0]
    for i, c in enumerate(rev):
        blk = {"resnets": [res(prev if j == 0 else c, c) for j in range(cfg.layers_per_block + 1)]}
        if i != len(ch) - 1:
            blk["upsample"] = cv(c, c)
        up.append(blk)
        prev = c
    z = cfg.latent_channels
    params = {
        "conv_in": cv(3, ch[0]), "down_blocks": down, "mid_block": mid(ch[-1]), "conv_norm_out": gn(ch[-1]),
        "conv_out": cv(ch[-1], 2 * z), "conv_in_dec": cv(z, ch[-1]), "mid_block_dec": mid(ch[-1]),
        "up_blocks": up, "conv_norm_out_dec": gn(ch[0]), "conv_out_dec": cv(ch[0], 3),
    }
    if cfg.use_quant_conv:
        params["quant_conv"] = cv(2 * z, 2 * z, 1)
        params["post_quant_conv"] = cv(z, z, 1)
    return params


# ---------------------------------------------------------------------------
# the attack
# ---------------------------------------------------------------------------


class DiffusersCompression:
    """The reference's DiffusersCompression as an attack: NHWC images in
    [0, 1] are resized to a multiple of 16 (rounding up), round-tripped
    through the VAE (KL: with a posterior draw from ``generator``; DC-AE:
    deterministic), resized back and clamped to [0, 1]; the bpp is the
    model's nominal value (``neuralcompression.py:185-225``)."""

    def __init__(self, name: str, cfg, model: nn.Module, random_weights: bool = False):
        self.name = name
        self.cfg = cfg
        self.model = model.eval()
        self.random_weights = random_weights
        self.bpp = cfg.nominal_bpp

    @torch.inference_mode()
    def __call__(self, imgs01: torch.Tensor, generator: Optional[torch.Generator] = None,
                 return_bpp: bool = False):
        b, h, w, c = imgs01.shape
        h16, w16 = -(-h // 16) * 16, -(-w // 16) * 16
        x = imgs01.float()
        if (h16, w16) != (h, w):
            x = G.resize_linear(x, (h16, w16))
        x = x.permute(0, 3, 1, 2)
        if isinstance(self.cfg, KLVAEConfig):
            rec = kl_vae_roundtrip(self.model, x, generator)
        else:  # DCAEConfig: deterministic
            rec = self.model.roundtrip(x)
        rec = rec.permute(0, 2, 3, 1)
        if rec.shape != imgs01.shape:
            rec = G.resize_linear(rec, (h, w))
        rec = torch.clamp(rec, 0.0, 1.0)
        return (rec, torch.tensor(self.bpp, dtype=torch.float32)) if return_bpp else rec

    def __repr__(self):
        tag = " (RANDOM WEIGHTS)" if self.random_weights else ""
        return f"DiffusersCompression({self.name}{tag})"

    @staticmethod
    def from_name(name: str, weights_dir: Optional[str] = None, allow_random: bool = False,
                  device="cpu") -> "DiffusersCompression":
        """Build a diffusers codec by the reference's name, on ``device``.
        Weights: ``{name}.safetensors`` / ``.bin`` / ``.pth`` in
        ``weights_dir``; without them this raises ``RandomWeightsError``
        unless ``allow_random``."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.augmentations.neural import RandomWeightsError, layout_errors, read_state_dict

        if "deep-compression" in name or "dc-ae" in name:
            return _dcae_from_name(name, weights_dir, allow_random, device)
        cfg = KLVAEConfig.for_name(name)
        path = _weights_file(name, weights_dir)
        if path is not None:
            with layout_errors(path):
                model = bridge.load_kl_vae(cfg, convert_kl_vae(read_state_dict(path), cfg), device)
            return DiffusersCompression(name, cfg, model)
        if not allow_random:
            raise RandomWeightsError(f"no weights for diffusers codec '{name}' in {weights_dir!r}; "
                                     "pass allow_random=True to acknowledge a destructive slot.")
        print(f"WARNING: {name} running with RANDOM weights.")
        return DiffusersCompression(name, cfg, bridge.load_kl_vae(cfg, init_kl_vae_params(0, cfg), device),
                                    random_weights=True)


def _weights_file(name: str, weights_dir: Optional[str]) -> Optional[str]:
    for ext in (".safetensors", ".bin", ".pth"):
        path = os.path.join(weights_dir, name + ext) if weights_dir else None
        if path and os.path.exists(path):
            return path
    return None


def _dcae_from_name(name: str, weights_dir: Optional[str], allow_random: bool, device) -> DiffusersCompression:
    """The reference's DeepCompressionAE slot
    (``mit-han-lab/dc-ae-f64c128-in-1.0-diffusers``, nominal bpp 1), from a
    raw diffusers state dict through the shape-driven ``convert_dcae``.
    Without weights (and with ``allow_random``) it is the JAX package's
    random slot: ``DCAEConfig.tiny(deep_stem=True)``'s geometry, not the
    published one (ROADMAP queue 3)."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.augmentations.dcae import DCAEConfig, convert_dcae, init_dcae_params
    from wmar_tpu_torch.augmentations.neural import RandomWeightsError, layout_errors, read_state_dict

    path = _weights_file(name, weights_dir)
    if path is not None:
        with layout_errors(path):
            params, cfg = convert_dcae(read_state_dict(path))
            model = bridge.load_dcae(cfg, params, device)
        return DiffusersCompression(name, cfg, model)
    if not allow_random:
        raise RandomWeightsError(f"no weights for diffusers codec '{name}' in {weights_dir!r}; "
                                 "pass allow_random=True to acknowledge a destructive slot.")
    cfg = DCAEConfig.tiny(deep_stem=True)
    print(f"WARNING: {name} running with RANDOM weights.")
    return DiffusersCompression(name, cfg, bridge.load_dcae(cfg, init_dcae_params(0, cfg), device),
                                random_weights=True)
