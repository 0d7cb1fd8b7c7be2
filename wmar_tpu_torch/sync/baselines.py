"""Baseline watermark methods behind one embed/detect wrapper (PyTorch
port of ``wmar_tpu.sync.baselines``).

The reference's baseline bank (``syncseal/syncseal/evals/baselines.py:16-639``)
wraps six post-hoc watermarking methods in one ``EmbedderExtractor`` that
owns the shared logic: resize to the method's size, scale the signal,
optional attenuation, clamp, straight-through 8-bit rounding, and the
``detect -> [B, 1 + nbits]`` convention. Here the wrapper is that logic over
NHWC [0, 1] images; the registry provides:

* ``ss``: a spread-spectrum baseline with fixed numpy carriers (bit for bit
  JAX's), which needs no checkpoint, so ``eval_wm`` runs end to end here;
* ``wam`` / ``wam_noattenuation``: ``wam_exact.WamExact``;
* ``hidden``: the public HiDDeN architecture (``sync/hidden.py``) read from
  the reference's TorchScript blobs;
* ``mbrs`` / ``cin`` / ``trustmark`` / ``videoseal``: third-party blobs whose
  architectures the reference does not hold; they refuse with instructions
  rather than watermark with random weights.

Resizing is ``augmentations.geometric.resize_linear``, JAX's
``jax.image.resize(..., "bilinear")`` (antialiased when it shrinks).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from wmar_tpu_torch.augmentations.geometric import resize_linear
from wmar_tpu_torch.augmentations.valuemetric import clip01

__all__ = ["EmbedderExtractor", "SpreadSpectrum", "build_baseline", "bit_accuracy", "mean_like_jax", "pvalue"]


def mean_like_jax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The float32 mean as XLA computes ``jnp.mean``: the sum times the
    float32 reciprocal of the count (which may round a last bit otherwise
    than a division)."""
    n = x.numel() if dim is None else x.shape[dim]
    total = x.float().sum() if dim is None else x.float().sum(dim=dim)
    return total * torch.tensor(1.0 / n, dtype=torch.float32)


def bit_accuracy(preds: torch.Tensor, targets: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """The fraction of correctly decoded bits of each item: ``preds [B, K]``
    real scores (> threshold decodes to 1), ``targets [B, K]`` in {0, 1}
    (``evals/metrics.py:107-131``)."""
    hard = (preds > threshold).to(torch.int32)
    return mean_like_jax(hard == targets.to(hard.device, torch.int32), dim=-1)


def pvalue(preds: torch.Tensor, targets: torch.Tensor, threshold: float = 0.0) -> np.ndarray:
    """The one-sided binomial p-value of each item's decoded bit count
    against coin-flip bits (``evals/metrics.py:61-78``), on the host."""
    from scipy import stats

    accs = bit_accuracy(preds, targets, threshold).cpu().numpy()
    nbits = targets.shape[-1]
    return np.asarray([stats.binomtest(int(round(a * nbits)), nbits, 0.5, alternative="greater").pvalue
                       for a in accs])


def _resize(imgs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if imgs.shape[1] == h and imgs.shape[2] == w:
        return imgs
    return resize_linear(imgs, (h, w))


@dataclasses.dataclass
class EmbedderExtractor:
    """The embed/detect wrapper every baseline shares.

    ``embedder(imgs01 [B, S, S, 3], msgs_pm1 [B, K]) -> preds_w [B, S, S, 3]``
    (the raw signal at the method's size ``img_size``), ``detector(imgs01
    [B, S, S, 3]) -> [B, 1 + K]`` scores (the first the mask/detection slot).
    ``embed`` resizes in and out, blends ``imgs * scaling_i + preds_w *
    scaling_w``, attenuates, clamps and rounds to 8 bits straight through
    (``evals/baselines.py:440-498``)."""

    embedder: Callable
    detector: Callable
    nbits: int
    attenuation: Optional[Callable] = None  # (imgs01, imgs_w01) -> imgs_w01
    scaling_w: float = 1.0
    scaling_i: float = 1.0
    img_size: int = 256
    clamp: bool = True
    rounding: bool = True

    def get_random_msg(self, generator: Optional[torch.Generator] = None, bsz: int = 1) -> torch.Tensor:
        return torch.randint(0, 2, (bsz, self.nbits), generator=generator)

    def embed(self, imgs01: torch.Tensor, msgs: torch.Tensor) -> dict:
        msgs = msgs.to(imgs01.device)
        original = imgs01.shape[1:3]
        preds_w = self.embedder(_resize(imgs01, self.img_size, self.img_size), 2.0 * msgs.float() - 1.0)
        preds_w = _resize(preds_w * self.scaling_w, *original)
        imgs_w = imgs01 * self.scaling_i + preds_w
        if self.attenuation is not None:
            imgs_w = self.attenuation(imgs01, imgs_w)
        if self.clamp:
            imgs_w = clip01(imgs_w)
        if self.rounding:
            imgs_w = imgs_w + (torch.round(imgs_w * 255.0) / 255.0 - imgs_w).detach()
        return {"msgs": msgs, "preds_w": preds_w, "imgs_w": imgs_w}

    def detect(self, imgs01: torch.Tensor) -> dict:
        return {"preds": self.detector(_resize(imgs01, self.img_size, self.img_size))}


class SpreadSpectrum:
    """An additive spread-spectrum watermark with fixed pseudorandom
    carriers: bit ``k`` adds ``+-C_k / sqrt(K)`` (``C_k`` a fixed +-1 carrier
    over the image, from ``numpy.random.default_rng(seed)`` as in JAX);
    detection correlates the mean-removed image with each carrier. The
    classical Cox-style scheme, with no weights."""

    def __init__(self, nbits: int = 48, img_size: int = 256, seed: int = 0, device=None):
        self.nbits = nbits
        self.img_size = img_size
        carriers = np.random.default_rng(seed).integers(0, 2, size=(nbits, img_size, img_size, 3)).astype(np.float32)
        self.carriers = torch.as_tensor((2.0 * carriers - 1.0) / np.float32(np.sqrt(nbits)), device=device)

    def embed(self, imgs01: torch.Tensor, msgs_pm1: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bk,kxyc->bxyc", msgs_pm1, self.carriers.to(imgs01.device))

    def detect(self, imgs01: torch.Tensor) -> torch.Tensor:
        x = imgs01 - imgs01.mean(dim=(1, 2, 3), keepdim=True)
        scores = torch.einsum("bxyc,kxyc->bk", x, self.carriers.to(imgs01.device))
        scores = scores / (self.img_size * self.img_size * 3)
        return torch.cat([scores.abs().amax(dim=-1, keepdim=True), scores], dim=-1)


_CONVERT_HINT = ("the reference distributes '{m}' as third-party TorchScript checkpoints (checkpoints/{files}) "
                 "whose architecture it does not hold; use the 'ss' baseline, the 'hidden' blobs or the 'wam' port")

_STUB_FILES = {
    "mbrs": "mbrs_256_m256_{encoder,decoder}.pt",
    "cin": "cin_nsm_{encoder,decoder}.pt",
    "trustmark": "trustmark_{encoder,decoder}_q.pt",
    "videoseal": "y_256b_img.pt",
}


def build_baseline(method: str, params_path: Optional[str] = None, scaling_i: float = 1.0, img_size: int = 256,
                   clamp: bool = True, rounding: bool = True, allow_random: bool = False, nbits: int = 48,
                   seed: int = 0, device=None) -> EmbedderExtractor:
    """A baseline by name, with the reference registry's per-method scaling
    (``evals/baselines.py:558-628``); its weights on ``device``."""
    common = dict(scaling_i=scaling_i, img_size=img_size, clamp=clamp, rounding=rounding)
    if method == "ss":
        ss = SpreadSpectrum(nbits=nbits, img_size=img_size, seed=seed, device=device)
        # unit-variance carriers: scaling_w is the per-pixel amplitude (~30 dB PSNR)
        return EmbedderExtractor(ss.embed, ss.detect, nbits=nbits, scaling_w=8.0 / 255.0, **common)
    if method in ("wam", "wam_noattenuation"):
        from wmar_tpu_torch.sync.wam_exact import WamExact, init_wam

        if params_path:
            wam = WamExact.load(params_path, device=device)
        elif allow_random:
            wam = init_wam(seed, device=device)
        else:
            raise ValueError("wam baseline needs wam_mit.pth (params_path=...): random weights do not watermark; "
                             "pass allow_random=True only for smoke tests")

        def wam_embed(imgs01, msgs_pm1):
            # WamExact.embed returns the finished image (its JND and scaling inside):
            # the wrapper gets the residual, so scaling_w means what the reference's does
            return wam.embed(imgs01, (msgs_pm1 + 1.0) / 2.0) - imgs01

        def wam_detect(imgs01):
            return wam.detect(imgs01).mean(dim=(2, 3))  # [B, 1 + 32]

        return EmbedderExtractor(wam_embed, wam_detect, nbits=32, scaling_w=1.0 if method == "wam" else 0.01,
                                 **common)
    if method == "hidden":
        from wmar_tpu_torch.sync import hidden as H

        if params_path:
            # a directory holding the two blobs, or "encoder.pt,decoder.pt"
            if "," in params_path:
                enc_path, dec_path = params_path.split(",", 1)
            else:
                enc_path = os.path.join(params_path, "hidden_encoder_48b.pt")
                dec_path = os.path.join(params_path, "hidden_decoder_48b.pt")
            enc, dec, enc_cfg, _ = H.load_hidden_torchscript(enc_path, dec_path, device=device)
        elif allow_random:
            enc_cfg = H.HiddenConfig(num_bits=nbits)
            enc, dec = H.init_hidden(seed, enc_cfg, device=device)
        else:
            raise ValueError("hidden baseline needs the reference's TorchScript blobs (params_path=checkpoints/ or "
                             "'enc.pt,dec.pt'): random weights do not watermark; pass allow_random=True only for "
                             "smoke tests")

        def hidden_embed(imgs01, msgs_pm1):
            # BaselineHiddenEmbedder.forward (baselines.py:32-48): normalize, encode, times the
            # channel stds; the full output, not a residual, which scaling_w 0.2 scales
            return H.denormalize_signal(enc(H.normalize(imgs01), msgs_pm1))

        def hidden_detect(imgs01):
            msgs = dec(H.normalize(imgs01))
            return torch.cat([torch.zeros_like(msgs[:, :1]), msgs], dim=-1)

        return EmbedderExtractor(hidden_embed, hidden_detect, nbits=enc_cfg.num_bits, scaling_w=0.2, **common)
    if method in _STUB_FILES:
        raise NotImplementedError(_CONVERT_HINT.format(m=method, files=_STUB_FILES[method]))
    raise ValueError(f"Unknown baseline method: {method}")
