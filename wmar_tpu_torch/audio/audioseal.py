"""AudioSeal's generator and detector (PyTorch), the sync watermark's model.

Port of ``wmar_tpu.audio.audioseal``, the counterpart of the ``audioseal``
package's ``audioseal_wm_16bits`` / ``audioseal_detector_16bits`` that the
reference's sync pattern and ``eval_audioseal`` load:

* the generator: a SEANet encoder, the 16-bit message embedding added to
  the latent (rows ``2k + bit_k`` summed; a zero message by default), a
  SEANet decoder whose output, cropped to the input, is the watermark delta;
* the detector: a SEANet encoder, a hop-wide ``ConvTranspose1d`` back to
  the sample rate, a 1x1 conv to ``2 + nbits`` channels; presence is
  ``softmax(ch 0:2)[..., 1]``, the rest are the bits' logits.

The SEANet is :mod:`wmar_tpu_torch.audio.codecs`'s, built non-causal with
zero padding (the audioseal cards: ``causal: false``, ``pad_mode:
constant``). Audio is ``[B, T, 1]`` at the interface.

The converters are the JAX package's, copied: shape-driven, so the
Sequential layout, filters, ratios and nbits come from the state dict.
:func:`synthetic_generator_sd` / :func:`synthetic_detector_sd` draw the
same numpy arrays as JAX's, so a ``--tiny`` run builds JAX's tiny model;
:func:`audioseal_state_dicts` writes a module in the audioseal layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from wmar_tpu_torch.audio.codecs import (
    SEANetDecoder,
    SEANetEncoder,
    _lstm_params,
    _state_dict,
    _wn_conv,
    _wn_convtr,
    seanet_pairs,
)


@dataclasses.dataclass(frozen=True)
class AudioSealConfig:
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
    n_residual_layers: int = 1
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    lstm_layers: int = 2
    nbits: int = 16
    detector_output_dim: int = 32
    sample_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))


AUDIOSEAL_16B = AudioSealConfig()
#: the JAX package's ``--tiny`` AudioSeal (``audio_eval``, ``eval_audioseal``)
AUDIOSEAL_TINY = AudioSealConfig(dimension=16, n_filters=4, ratios=(4, 2), nbits=4, detector_output_dim=8)


class AudioSealGenerator(nn.Module):
    def __init__(self, cfg: AudioSealConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg, causal=False)
        self.decoder = SEANetDecoder(cfg, causal=False)
        if cfg.nbits:
            self.msg_embed = nn.Parameter(torch.zeros((2 * cfg.nbits, cfg.dimension)))

    def forward(self, audio: torch.Tensor, message: Optional[torch.Tensor] = None) -> torch.Tensor:
        """audio ``[B, T, 1]``, message ``[B, nbits]`` in {0, 1} (zeros by
        default) -> the watermark delta ``[B, T, 1]``."""
        t = audio.shape[1]
        hidden = self.encoder(audio.transpose(1, 2))
        if self.cfg.nbits:
            if message is None:
                message = torch.zeros((audio.shape[0], self.cfg.nbits), dtype=torch.int64, device=audio.device)
            idx = 2 * torch.arange(self.cfg.nbits, device=audio.device)[None, :] + message.to(torch.int64)
            hidden = hidden + self.msg_embed[idx].sum(dim=1)[:, :, None]
        return self.decoder(hidden).transpose(1, 2)[:, :t]


class AudioSealDetector(nn.Module):
    def __init__(self, cfg: AudioSealConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg, causal=False)
        self.reverse_conv = nn.ConvTranspose1d(cfg.dimension, cfg.detector_output_dim, cfg.hop_length,
                                               stride=cfg.hop_length)
        self.head = nn.Conv1d(cfg.detector_output_dim, 2 + cfg.nbits, 1)

    def forward(self, audio: torch.Tensor):
        """audio ``[B, T, 1]`` -> (presence ``[B, T]``, bit logits ``[B, T, nbits]``)."""
        t = audio.shape[1]
        logits = self.head(self.reverse_conv(self.encoder(audio.transpose(1, 2)))[..., :t])
        return torch.softmax(logits[:, :2], dim=1)[:, 1], logits[:, 2:].transpose(1, 2)


def decode_message(msg_logits: torch.Tensor) -> torch.Tensor:
    """``[B, T, nbits]`` -> hard bits ``[B, nbits]``: the sigmoid's mean over
    time above 0.5 (audioseal's ``detect_watermark``)."""
    return (torch.sigmoid(msg_logits).mean(dim=1) > 0.5).to(torch.int32)


class AudioSealModel(nn.Module):
    """Generator and detector with the interface
    :class:`wmar_tpu_torch.audio.sync.SyncPattern` needs
    (``get_watermark`` / ``detect``), on the modules' device."""

    def __init__(self, cfg: AudioSealConfig = AUDIOSEAL_16B):
        super().__init__()
        self.cfg = cfg
        self.generator = AudioSealGenerator(cfg)
        self.detector = AudioSealDetector(cfg)

    @torch.no_grad()
    def get_watermark(self, audio: torch.Tensor, message: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.generator(audio.to(torch.float32), message)

    @torch.no_grad()
    def detect(self, audio: torch.Tensor) -> torch.Tensor:
        return self.detector(audio.to(torch.float32))[0]

    @torch.no_grad()
    def detect_full(self, audio: torch.Tensor):
        return self.detector(audio.to(torch.float32))

    @staticmethod
    def from_checkpoints(gen_path: str, det_path: str, device="cpu") -> "AudioSealModel":
        """From the two published files (``.pth`` or ``.safetensors``), the
        geometry read from their shapes."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.augmentations.neural import read_state_dict

        gp, cfg = convert_audioseal_generator(read_state_dict(gen_path))
        dp, dcfg = convert_audioseal_detector(read_state_dict(det_path))
        cfg = dataclasses.replace(cfg, detector_output_dim=dcfg.detector_output_dim, nbits=dcfg.nbits)
        return bridge.load_audioseal(gp, dp, cfg, device)


# ---------------------------------------------------------------------------
# Shape-driven converters (audioseal package layout)
# ---------------------------------------------------------------------------


def _conv_shape(sd, prefix):
    """(out, in, k) of a (possibly weight-normed) torch conv at prefix."""
    for suffix in (".weight", ".weight_v", ".parametrizations.weight.original1"):
        if prefix + suffix in sd:
            return tuple(np.asarray(sd[prefix + suffix]).shape)
    raise KeyError(prefix)


def _walk_seanet(sd, prefix):
    """Classify the Sequential slots under ``{prefix}.{i}`` (audiocraft
    naming: convs at ``.conv.conv``, transposed at ``.convtr.convtr``,
    resblock convs at ``.block.{1,3}.conv.conv``, LSTM at ``.lstm``)."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    idxs = sorted({int(m.group(1)) for k in sd if (m := pat.match(k))})
    slots = []
    for i in idxs:
        base = f"{prefix}.{i}"
        if f"{base}.lstm.weight_ih_l0" in sd:
            n_layers = len({k for k in sd if k.startswith(f"{base}.lstm.weight_ih_l")})
            slots.append((i, "lstm", n_layers))
        elif any(k.startswith(f"{base}.block.") for k in sd):
            slots.append((i, "res", None))
        elif any(k.startswith(f"{base}.convtr.") for k in sd):
            slots.append((i, "convtr", _conv_shape(sd, f"{base}.convtr.convtr")))
        else:
            slots.append((i, "conv", _conv_shape(sd, f"{base}.conv.conv")))
    return slots


def _res_params(sd, prefix):
    return {
        "conv1": _wn_conv(sd, prefix + ".block.1.conv.conv"),
        "conv2": _wn_conv(sd, prefix + ".block.3.conv.conv"),
        "shortcut": _wn_conv(sd, prefix + ".shortcut.conv.conv"),
    }


def _convert_seanet_encoder(sd, prefix):
    """-> (params, dict of inferred geometry)."""
    slots = _walk_seanet(sd, prefix)
    conv_slots = [s for s in slots if s[1] == "conv"]
    first_i, _, (n_filters, channels, kernel_size) = conv_slots[0]
    last_i, _, (dimension, _, last_kernel) = conv_slots[-1]
    _, _, lstm_layers = next(s for s in slots if s[1] == "lstm")

    params = {"conv_in": _wn_conv(sd, f"{prefix}.{first_i}.conv.conv"), "down": []}
    ratios_rev, stage = [], {"res": []}
    for i, kind, shape in slots[1:]:
        if kind == "res":
            stage["res"].append(_res_params(sd, f"{prefix}.{i}"))
        elif kind == "conv" and i != last_i:
            stage["down"] = _wn_conv(sd, f"{prefix}.{i}.conv.conv")
            ratios_rev.append(shape[2] // 2)  # kernel = 2 * ratio
            params["down"].append(stage)
            stage = {"res": []}
        elif kind == "lstm":
            params["lstm"] = _lstm_params(sd, f"{prefix}.{i}.lstm", lstm_layers)
    params["conv_out"] = _wn_conv(sd, f"{prefix}.{last_i}.conv.conv")
    geom = dict(
        channels=channels, n_filters=n_filters, kernel_size=kernel_size,
        last_kernel_size=last_kernel, dimension=dimension,
        ratios=tuple(reversed(ratios_rev)), lstm_layers=lstm_layers,
        n_residual_layers=len(params["down"][0]["res"]) if params["down"] else 1,
    )
    return params, geom


def _convert_seanet_decoder(sd, prefix):
    slots = _walk_seanet(sd, prefix)
    conv_slots = [s for s in slots if s[1] == "conv"]
    first_i, _, (_, dimension, kernel_size) = conv_slots[0]
    last_i, _, (channels, n_filters, last_kernel) = conv_slots[-1]
    lstm_i, _, lstm_layers = next(s for s in slots if s[1] == "lstm")

    params = {"conv_in": _wn_conv(sd, f"{prefix}.{first_i}.conv.conv"),
              "lstm": _lstm_params(sd, f"{prefix}.{lstm_i}.lstm", lstm_layers)}
    ratios, up = [], []
    stage = None
    for i, kind, shape in slots:
        if kind == "convtr":
            if stage is not None:
                up.append(stage)
            stage = {"up": _wn_convtr(sd, f"{prefix}.{i}.convtr.convtr"), "res": []}
            ratios.append(shape[2] // 2)
        elif kind == "res":
            stage["res"].append(_res_params(sd, f"{prefix}.{i}"))
    if stage is not None:
        up.append(stage)
    params["up"] = up
    params["conv_out"] = _wn_conv(sd, f"{prefix}.{last_i}.conv.conv")
    geom = dict(channels=channels, n_filters=n_filters, kernel_size=kernel_size,
                last_kernel_size=last_kernel, dimension=dimension,
                ratios=tuple(ratios), lstm_layers=lstm_layers,
                n_residual_layers=len(up[0]["res"]) if up else 1)
    return params, geom


def convert_audioseal_generator(sd) -> Tuple[dict, AudioSealConfig]:
    """``audioseal_wm_16bits`` state dict -> (tree, inferred config):
    ``encoder.model.*`` / ``decoder.model.*`` SEANets and
    ``msg_processor.msg_processor.weight`` (``[2 nbits, dimension]``)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    enc, eg = _convert_seanet_encoder(sd, "encoder.model")
    dec, dg = _convert_seanet_decoder(sd, "decoder.model")
    params = {"encoder": enc, "decoder": dec}
    nbits = 0
    for k in ("msg_processor.msg_processor.weight", "msg_processor.weight"):
        if k in sd:
            emb = np.asarray(sd[k])
            params["msg_embed"] = emb
            nbits = emb.shape[0] // 2
            break
    cfg = AudioSealConfig(
        channels=eg["channels"], dimension=eg["dimension"], n_filters=eg["n_filters"], ratios=eg["ratios"],
        n_residual_layers=eg["n_residual_layers"], kernel_size=eg["kernel_size"],
        last_kernel_size=eg["last_kernel_size"], lstm_layers=eg["lstm_layers"], nbits=nbits,
    )
    if dg["ratios"] != eg["ratios"]:
        raise ValueError(f"generator: decoder ratios {dg['ratios']} against the encoder's {eg['ratios']}")
    return params, cfg


def convert_audioseal_detector(sd) -> Tuple[dict, AudioSealConfig]:
    """``audioseal_detector_16bits`` state dict -> (tree, inferred config):
    ``detector.0`` is ``SEANetEncoderKeepDimension`` (``model.*`` and
    ``reverse_convolution``, kernel = stride = hop), ``detector.1`` the
    ``Conv1d(output_dim, 2 + nbits, 1)``."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    enc, eg = _convert_seanet_encoder(sd, "detector.0.model")
    params = {
        "encoder": enc,
        "reverse_conv": _wn_convtr(sd, "detector.0.reverse_convolution"),
        "head": _wn_conv(sd, "detector.1"),
    }
    head_out = _conv_shape(sd, "detector.1")[0]
    rev_out = _conv_shape(sd, "detector.0.reverse_convolution")[1]
    cfg = AudioSealConfig(
        channels=eg["channels"], dimension=eg["dimension"], n_filters=eg["n_filters"], ratios=eg["ratios"],
        n_residual_layers=eg["n_residual_layers"], kernel_size=eg["kernel_size"],
        last_kernel_size=eg["last_kernel_size"], lstm_layers=eg["lstm_layers"], nbits=head_out - 2,
        detector_output_dim=rev_out,
    )
    return params, cfg


def audioseal_state_dicts(model: AudioSealModel) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``model`` as the two published state dicts (generator, detector) in
    the audioseal layout, plain weights: the inverse of the converters."""
    cfg = model.cfg
    gen = _state_dict(model.generator, seanet_pairs(cfg, "encoder.model", "decoder.model"), None)
    if cfg.nbits:
        gen["msg_processor.msg_processor.weight"] = model.generator.msg_embed.detach().clone()
    det = _state_dict(model.detector, seanet_pairs(cfg, "detector.0.model", None)
                      + [(("reverse_conv",), "detector.0.reverse_convolution", "convtr"),
                         (("head",), "detector.1", "conv")], None)
    return gen, det


# ---------------------------------------------------------------------------
# Synthetic state dicts (the JAX package's draws, array for array)
# ---------------------------------------------------------------------------


def synthetic_generator_sd(cfg: AudioSealConfig = AUDIOSEAL_16B, seed: int = 0,
                           scale: float = 0.1) -> Dict[str, np.ndarray]:
    """A random audioseal-layout generator state dict at ``cfg``'s geometry,
    drawn from ``np.random.default_rng(seed)`` in the JAX package's order."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, i, o, k):
        sd[prefix + ".weight"] = rng.normal(0, scale, (o, i, k)).astype(np.float32)
        sd[prefix + ".bias"] = rng.normal(0, scale, (o,)).astype(np.float32)

    def convtr(prefix, i, o, k):
        sd[prefix + ".weight"] = rng.normal(0, scale, (i, o, k)).astype(np.float32)
        sd[prefix + ".bias"] = rng.normal(0, scale, (o,)).astype(np.float32)

    def lstm(prefix, dim, layers):
        for layer in range(layers):
            sd[f"{prefix}.weight_ih_l{layer}"] = rng.normal(0, scale, (4 * dim, dim)).astype(np.float32)
            sd[f"{prefix}.weight_hh_l{layer}"] = rng.normal(0, scale, (4 * dim, dim)).astype(np.float32)
            sd[f"{prefix}.bias_ih_l{layer}"] = rng.normal(0, scale, (4 * dim,)).astype(np.float32)
            sd[f"{prefix}.bias_hh_l{layer}"] = rng.normal(0, scale, (4 * dim,)).astype(np.float32)

    def res(prefix, dim, k):
        conv(f"{prefix}.block.1.conv.conv", dim, dim // 2, k)
        conv(f"{prefix}.block.3.conv.conv", dim // 2, dim, 1)
        conv(f"{prefix}.shortcut.conv.conv", dim, dim, 1)

    def encoder(prefix):
        f, idx = cfg.n_filters, 0
        conv(f"{prefix}.{idx}.conv.conv", cfg.channels, f, cfg.kernel_size)
        idx += 1
        mult = 1
        for ratio in reversed(cfg.ratios):
            for _ in range(cfg.n_residual_layers):
                res(f"{prefix}.{idx}", mult * f, cfg.residual_kernel_size)
                idx += 1
            idx += 1  # ELU
            conv(f"{prefix}.{idx}.conv.conv", mult * f, mult * f * 2, 2 * ratio)
            idx += 1
            mult *= 2
        lstm(f"{prefix}.{idx}.lstm", mult * f, cfg.lstm_layers)
        idx += 2  # LSTM + ELU
        conv(f"{prefix}.{idx}.conv.conv", mult * f, cfg.dimension, cfg.last_kernel_size)
        return mult

    mult = encoder("encoder.model")
    f, idx = cfg.n_filters, 0
    conv(f"decoder.model.{idx}.conv.conv", cfg.dimension, mult * f, cfg.kernel_size)
    idx += 1
    lstm(f"decoder.model.{idx}.lstm", mult * f, cfg.lstm_layers)
    idx += 1
    for ratio in cfg.ratios:
        idx += 1  # ELU
        convtr(f"decoder.model.{idx}.convtr.convtr", mult * f, mult * f // 2, 2 * ratio)
        idx += 1
        for _ in range(cfg.n_residual_layers):
            res(f"decoder.model.{idx}", mult * f // 2, cfg.residual_kernel_size)
            idx += 1
        mult //= 2
    idx += 1  # ELU
    conv(f"decoder.model.{idx}.conv.conv", f, cfg.channels, cfg.last_kernel_size)
    sd["msg_processor.msg_processor.weight"] = rng.normal(
        0, scale, (2 * cfg.nbits, cfg.dimension)).astype(np.float32)
    return sd


def synthetic_detector_sd(cfg: AudioSealConfig = AUDIOSEAL_16B, seed: int = 1,
                          scale: float = 0.1) -> Dict[str, np.ndarray]:
    """A random detector state dict: the encoder of
    ``synthetic_generator_sd(cfg, seed)``, then the reverse conv and head
    from ``default_rng(seed)``, as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    gen = synthetic_generator_sd(cfg, seed, scale)
    sd = {("detector.0.model" + k[len("encoder.model"):]): v
          for k, v in gen.items() if k.startswith("encoder.model")}
    hop = cfg.hop_length
    sd["detector.0.reverse_convolution.weight"] = rng.normal(
        0, scale, (cfg.dimension, cfg.detector_output_dim, hop)).astype(np.float32)
    sd["detector.0.reverse_convolution.bias"] = rng.normal(
        0, scale, (cfg.detector_output_dim,)).astype(np.float32)
    sd["detector.1.weight"] = rng.normal(
        0, scale, (2 + cfg.nbits, cfg.detector_output_dim, 1)).astype(np.float32)
    sd["detector.1.bias"] = rng.normal(0, scale, (2 + cfg.nbits,)).astype(np.float32)
    return sd


def synthetic_model(cfg: AudioSealConfig, gen_seed: int = 0, det_seed: int = 1, device="cpu") -> AudioSealModel:
    """The model of :func:`synthetic_generator_sd` / :func:`synthetic_detector_sd`
    through the converters (the JAX package's ``--tiny`` route)."""
    from wmar_tpu_torch import bridge

    gp, gcfg = convert_audioseal_generator(synthetic_generator_sd(cfg, gen_seed))
    dp, _ = convert_audioseal_detector(synthetic_detector_sd(cfg, det_seed))
    return bridge.load_audioseal(gp, dp, dataclasses.replace(
        gcfg, detector_output_dim=cfg.detector_output_dim, sample_rate=cfg.sample_rate), device)
