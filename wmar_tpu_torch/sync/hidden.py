"""The HiDDeN baseline watermarker (PyTorch port of ``wmar_tpu.sync.hidden``).

The reference ships ``hidden`` as two TorchScript blobs
(``checkpoints/hidden_{encoder,decoder}_48b.pt``) wrapped by
``BaselineHiddenEmbedder``/``BaselineHiddenExtractor``
(``syncseal/syncseal/evals/baselines.py:16-76``): ImageNet-normalized
inputs, messages in {-1, +1}, the encoder's output multiplied by the channel
stds, a zero column before the decoder's bits.

The architecture is the public one (HiDDeN, Zhu et al. 2018, as in
stable_signature's ``hidden/models.py``): Conv-BN-GELU stacks; the encoder
tiles the message over the grid, concatenates ``[msgs, features, image]``
and maps back to 3 channels (tanh); the decoder pools a deeper stack to
``num_bits`` and applies one linear layer. The modules carry the blobs'
parameter names, so ``torch.jit.load(...).state_dict()`` loads into them;
a blob of another layout fails on its key set. BatchNorm runs on its running
statistics (inference). Images are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class HiddenConfig:
    num_bits: int = 48
    channels: int = 64
    enc_blocks: int = 4  # conv_bns depth (stable_signature default)
    dec_blocks: int = 8  # decoder stack depth
    redundancy: int = 1
    last_tanh: bool = True
    activation: str = "gelu"  # stable_signature's ConvBNRelu uses GELU


class ConvBN(nn.Module):
    """Conv3x3 (pad 1) -> BatchNorm (running statistics) -> activation;
    ``layers.0`` / ``layers.1`` as the blobs name them."""

    def __init__(self, c_in: int, c_out: int, activation: str = "gelu"):
        super().__init__()
        self.layers = nn.Sequential(nn.Conv2d(c_in, c_out, 3, padding=1), nn.BatchNorm2d(c_out))
        self.activation = activation

    def forward(self, x):
        y = self.layers(x)
        return F.gelu(y) if self.activation == "gelu" else F.relu(y)


class HiddenEncoder(nn.Module):
    """ImageNet-normalized NHWC images + {-1, +1} messages -> the
    watermarked (still normalized) images (``HiddenEncoder.forward``)."""

    def __init__(self, cfg: HiddenConfig):
        super().__init__()
        self.cfg = cfg
        self.last_tanh = cfg.last_tanh
        c = cfg.channels
        self.conv_bns = nn.Sequential(*[ConvBN(3 if i == 0 else c, c, cfg.activation) for i in range(cfg.enc_blocks)])
        self.after_concat_layer = ConvBN(c + 3 + cfg.num_bits, c, cfg.activation)
        self.final_layer = nn.Conv2d(c, 3, 1)

    def forward(self, imgs_norm, msgs_pm1):
        x = imgs_norm.permute(0, 3, 1, 2)
        h = self.conv_bns(x)
        b, _, hh, ww = h.shape
        msgs = msgs_pm1.to(h.dtype)[:, :, None, None].expand(b, msgs_pm1.shape[-1], hh, ww)
        out = self.final_layer(self.after_concat_layer(torch.cat([msgs, h, x], dim=1)))
        out = torch.tanh(out) if self.last_tanh else out
        return out.permute(0, 2, 3, 1)


class HiddenDecoder(nn.Module):
    """Normalized NHWC images -> ``[B, num_bits]`` soft bits."""

    def __init__(self, cfg: HiddenConfig):
        super().__init__()
        self.cfg = cfg
        self.num_bits, self.redundancy = cfg.num_bits, cfg.redundancy
        c, kr = cfg.channels, cfg.num_bits * cfg.redundancy
        self.layers = nn.Sequential(*[ConvBN(3 if i == 0 else c, c, cfg.activation) for i in range(cfg.dec_blocks - 1)],
                                    ConvBN(c, kr, cfg.activation))
        self.linear = nn.Linear(kr, kr)

    def forward(self, imgs_norm):
        h = self.layers(imgs_norm.permute(0, 3, 1, 2)).mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
        out = self.linear(h)
        if self.redundancy > 1:
            out = out.reshape(out.shape[0], self.num_bits, self.redundancy).sum(-1)
        return out


def _count(sd, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def _strict(module: nn.Module, sd, what: str) -> nn.Module:
    """Load ``sd`` into ``module``: every key of the module must be there
    (BatchNorm's ``num_batches_tracked`` is optional); extra keys raise."""
    own = module.state_dict()
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    extra = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd) if not k.endswith("num_batches_tracked"))
    if extra or missing:
        raise KeyError(f"{what}: the state dict does not follow the public stable_signature layout "
                       f"(missing {missing[:5]}, unexpected {extra[:5]})")
    module.load_state_dict({**own, **sd})
    return module.eval()


def hidden_encoder_from_state_dict(sd) -> Tuple[HiddenEncoder, HiddenConfig]:
    """An encoder blob's state dict -> (module, config); shapes give the
    channels, blocks and bits."""
    n = _count(sd, "conv_bns.{}.layers.0.weight")
    if n == 0:
        raise KeyError("hidden encoder: no conv_bns.*.layers.0.weight keys: the blob does not follow the public "
                       "stable_signature HiddenEncoder layout")
    channels = int(sd["conv_bns.0.layers.0.weight"].shape[0])
    num_bits = int(sd["after_concat_layer.layers.0.weight"].shape[1]) - channels - 3
    cfg = HiddenConfig(num_bits=num_bits, channels=channels, enc_blocks=n)
    return _strict(HiddenEncoder(cfg), sd, "hidden encoder"), cfg


def hidden_decoder_from_state_dict(sd) -> Tuple[HiddenDecoder, HiddenConfig]:
    """A decoder blob's state dict -> (module, config); the released 48-bit
    model has redundancy 1, so ``num_bits`` is the linear's width."""
    n = _count(sd, "layers.{}.layers.0.weight")
    if n == 0:
        raise KeyError("hidden decoder: no layers.*.layers.0.weight keys: the blob does not follow the public "
                       "stable_signature HiddenDecoder layout")
    cfg = HiddenConfig(num_bits=int(sd["linear.weight"].shape[0]), channels=int(sd["layers.0.layers.0.weight"].shape[0]),
                       dec_blocks=n, redundancy=1)
    return _strict(HiddenDecoder(cfg), sd, "hidden decoder"), cfg


def load_hidden_torchscript(encoder_path: str, decoder_path: str, device=None):
    """``torch.jit.load`` both blobs and read their state dicts:
    (encoder, decoder, encoder config, decoder config)."""
    enc, enc_cfg = hidden_encoder_from_state_dict(torch.jit.load(encoder_path, map_location="cpu").state_dict())
    dec, dec_cfg = hidden_decoder_from_state_dict(torch.jit.load(decoder_path, map_location="cpu").state_dict())
    return enc.to(device), dec.to(device), enc_cfg, dec_cfg


def init_hidden_params(seed: int, cfg: HiddenConfig) -> tuple:
    """JAX's ``init_hidden_params`` trees (numpy, JAX's draws): (encoder, decoder)."""
    rng = np.random.default_rng(seed)

    def conv_bn(cin, cout, k=3):
        return {"conv": {"kernel": rng.normal(0, (2.0 / (cin * k * k)) ** 0.5, (k, k, cin, cout)).astype(np.float32),
                         "bias": np.zeros((cout,), np.float32)},
                "bn": {"gamma": np.ones((cout,), np.float32), "beta": np.zeros((cout,), np.float32),
                       "mean": np.zeros((cout,), np.float32), "var": np.ones((cout,), np.float32)}}

    c, k = cfg.channels, cfg.num_bits
    enc = {"conv_bns": [conv_bn(3 if i == 0 else c, c) for i in range(cfg.enc_blocks)],
           "after_concat": conv_bn(c + 3 + k, c),
           "final": {"kernel": rng.normal(0, (2.0 / c) ** 0.5, (1, 1, c, 3)).astype(np.float32),
                     "bias": np.zeros((3,), np.float32)}}
    kr = k * cfg.redundancy
    dec_blocks: List[dict] = [conv_bn(3 if i == 0 else c, c) for i in range(cfg.dec_blocks - 1)]
    dec_blocks.append(conv_bn(c, kr))
    dec = {"layers": dec_blocks,
           "linear": {"w": rng.normal(0, kr**-0.5, (kr, kr)).astype(np.float32), "b": np.zeros((kr,), np.float32)}}
    return enc, dec


def init_hidden(seed: int, cfg: HiddenConfig, device=None) -> Tuple[HiddenEncoder, HiddenDecoder]:
    """An encoder and a decoder with JAX's ``init_hidden_params(seed, cfg)`` weights."""
    from wmar_tpu_torch import bridge

    enc_p, dec_p = init_hidden_params(seed, cfg)
    enc_sd, dec_sd = bridge.hidden_state_dicts(enc_p, dec_p)
    return (_strict(HiddenEncoder(cfg), enc_sd, "hidden encoder").to(device),
            _strict(HiddenDecoder(cfg), dec_sd, "hidden decoder").to(device))


def normalize(imgs01: torch.Tensor) -> torch.Tensor:
    return (imgs01 - imgs01.new_tensor(IMAGENET_MEAN)) / imgs01.new_tensor(IMAGENET_STD)


def denormalize_signal(x: torch.Tensor) -> torch.Tensor:
    """The reference's postprocess ``Normalize(mean=0, std=1/std)``: times
    the channel stds only (``baselines.py:27,48``)."""
    return x * x.new_tensor(IMAGENET_STD)
