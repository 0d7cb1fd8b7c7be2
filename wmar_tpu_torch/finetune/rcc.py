"""Reverse-cycle-consistency (RCC) tokenizer finetuning (PyTorch port of
``wmar_tpu.finetune.rcc``).

From precomputed codes, one step of the reference's ``finetune.py`` and
patched ``VQModel.forward`` (``deps/taming/models/vqgan.py:86-169``):

  z_q = embed(codes)
  xrec = decoder(z_q)                 # trainable decoder
  xrec_orig = orig_decoder(z_q)       # frozen original
  drift = L1(xrec_orig, xrec) + perceptual(xrec_orig, xrec)
  x_aug = random_augmentation(xrec)   # gradients flow; JPEG straight-through
  zrec = quant_conv(watermark_encoder(x_aug))   # trainable encoder clone
  idem = masked_mse(z_q, zrec)        # rotation/crop masks (:140-154)
  loss = drift + w * idem (+ the GAN term, Taming only)

The augmentation is one (class, param) branch of the curriculum level for
the whole batch, chosen on the host from a CPU ``torch.Generator`` (no
device sync), applied with probability ``aug_prob``. The optimizer is
``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` with a per-step
``LambdaLR`` of ``lr * 0.9 ** (step // steps_per_epoch)``: optax's
schedule evaluated at the count before the update, as the JAX package's
``make_optimizer``. Images are NHWC at the adapters' boundary, as in JAX;
the tokenizers run NCHW inside.

Data parallelism (``mesh``, None for one process): each dp rank takes its
rows of the global batch. The augmentation's gate and branch come from the
host generator, alike on every rank; the noise branch draws the global
batch's noise and keeps this rank's rows. The gradients are averaged over
the ranks before ``grad_norm`` and Adam, the GAN branch's last-kernel
gradients before its adaptive weight, and the metrics (each a mean over
the rank's rows) after the step: the global batch's step and numbers.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from wmar_tpu_torch.augmentations import geometric as G
from wmar_tpu_torch.augmentations import valuemetric as V
from wmar_tpu_torch.finetune.perceptual import PerceptualLoss
from wmar_tpu_torch.parallel import dp_size, global_randn, mean_grads, mean_metrics, rows_of

# ---------------------------------------------------------------------------
# Train-time augmentation bank (branches + idempotence masks)
# ---------------------------------------------------------------------------

# The reference's curriculum levels (``finetune.py:323-350``).
AUG_LEVELS: dict = {
    "warmup": [],
    "weak": [
        ("jpeg", [90, 80, 70]),
        ("blur", [1, 3]),
        ("noise", [0.005, 0.01, 0.015, 0.02]),
        ("brightness", [1.0, 1.1, 1.2]),
        ("rotate", [-1, 1]),
        ("croppad", [0.8, 0.9]),
    ],
    "medium": [
        ("jpeg", [80, 60, 40]),
        ("blur", [3, 5]),
        ("noise", [0.02, 0.04, 0.06]),
        ("brightness", [1.2, 1.3, 1.4]),
        ("rotate", [-3, -2, -1, 1, 2, 3]),
        ("croppad", [0.5, 0.6, 0.7, 0.8, 0.9]),
    ],
    "strong": [
        ("jpeg", [40, 30, 20]),
        ("blur", [5, 7, 9]),
        ("noise", [0.06, 0.08, 0.1]),
        ("brightness", [1.4, 1.7, 2.0]),
        ("rotate", [-3, -2, -1, 1, 2, 3]),
        ("croppad", [0.5, 0.6, 0.7, 0.8, 0.9]),
    ],
}

_MASK_KIND = {"rotate": "rotate", "croppad": "croppad"}


@dataclasses.dataclass(frozen=True)
class AugBranch:
    """One (class, param) augmentation: images NHWC in [0, 1] -> [0, 1]."""

    name: str
    param: float
    mask_kind: str = "full"  # full | rotate | croppad

    def __call__(self, x01: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
        """``noise`` (standard normal, the images' shape) feeds the noise
        branch's draw; else it is drawn from ``generator`` on the images'
        device, at the global batch's shape on a dp rank of ``mesh``."""
        if self.name == "jpeg":
            return V.jpeg_diff(x01, int(self.param))
        if self.name == "blur":
            return V.gaussian_blur(x01, int(self.param))
        if self.name == "noise":
            if noise is None and dp_size(mesh) > 1:
                noise = rows_of(mesh, global_randn(mesh, x01.shape, generator, x01.dtype, x01.device))
            return V.gaussian_noise(x01, float(self.param), generator=generator, noise=noise)
        if self.name == "brightness":
            return V.brightness(x01, float(self.param))
        if self.name == "rotate":
            return G.rotate(x01, float(self.param))
        if self.name == "croppad":
            return G.upper_left_crop_pad_back(x01, float(self.param))
        raise ValueError(self.name)


def expand_level(level: str) -> List[AugBranch]:
    """A curriculum level as its (class, param) branches, in order."""
    return [AugBranch(name, p, _MASK_KIND.get(name, "full")) for name, params in AUG_LEVELS[level] for p in params]


def _branch_logits(level: str) -> np.ndarray:
    """Log-probs so that the class is uniform, then the param uniform."""
    entries = AUG_LEVELS[level]
    probs = []
    for _, params in entries:
        probs += [1.0 / (len(entries) * len(params))] * len(params)
    return np.log(np.asarray(probs, dtype=np.float32))


def _latent_mask(branch: AugBranch, side: int) -> np.ndarray:
    m = np.ones((side, side), dtype=np.float32)
    if branch.mask_kind == "rotate":
        skip = side // 8
        if skip:
            m[:] = 0.0
            m[skip:-skip, skip:-skip] = 1.0
    elif branch.mask_kind == "croppad":
        cutoff = int(np.floor(side * branch.param))
        m[:] = 0.0
        m[:cutoff, :cutoff] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _mask_on(branch: AugBranch, side: int, device: torch.device) -> torch.Tensor:
    """The branch's latent mask on ``device``, made once (a host-to-device
    copy per step would wait for the queued step)."""
    return torch.from_numpy(_latent_mask(branch, side)).to(device)


def apply_random_augmentation(
    x01: torch.Tensor,
    branches: Sequence[AugBranch],
    branch_logits: np.ndarray,
    latent_side: int,
    generator: Optional[torch.Generator] = None,
    p: float = 0.5,
    *,
    noise_generator: Optional[torch.Generator] = None,
    gate: Optional[float] = None,
    index: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wmar/utils/utils.py:25-44``: with probability ``p`` one branch,
    drawn by ``branch_logits``, for the whole batch. Returns (images in
    [0, 1], latent idempotence mask ``[side, side]``).

    The gate's uniform and the branch index come from ``generator`` (a CPU
    generator: a host decision, no device sync), the noise branch's draw
    from ``noise_generator`` on the images' device (at the global batch's
    shape on a dp rank of ``mesh``); ``gate``, ``index`` and ``noise`` feed
    those draws instead (a test passes JAX's)."""
    ones = torch.ones((latent_side, latent_side), dtype=torch.float32, device=x01.device)
    if not branches:
        return x01, ones
    if gate is None:
        gate = float(torch.rand((), generator=generator))
    if index is None:
        probs = torch.from_numpy(np.exp(branch_logits.astype(np.float64)))
        index = int(torch.multinomial(probs, 1, generator=generator))
    if not gate < p:
        return x01, ones
    branch = branches[index]
    return branch(x01, generator=noise_generator, noise=noise, mesh=mesh), _mask_on(branch, latent_side, x01.device)


# ---------------------------------------------------------------------------
# Tokenizer adapters
# ---------------------------------------------------------------------------


class TamingRCCAdapter:
    """The Taming VQGAN in the RCC loop. The tokenizer itself stays frozen
    (``quant_conv``, ``post_quant_conv``, codebook, original encoder and
    decoder); the trainable parts are a decoder and a clone of the encoder
    (``watermark_encoder``), the reference's ``newenc-dec`` mode
    (``finetune.py:296-304``)."""

    def __init__(self, model):
        self.model = model.requires_grad_(False)
        self.latent_side = model.cfg.codes_per_side

    @property
    def device(self) -> torch.device:
        return self.model.quantize.embedding.device

    def init_trainable(self) -> nn.ModuleDict:
        return nn.ModuleDict({"decoder": copy.deepcopy(self.model.decoder).requires_grad_(True),
                              "watermark_encoder": copy.deepcopy(self.model.encoder).requires_grad_(True)})

    def frozen_parts(self) -> Dict[str, nn.Module]:
        """The frozen originals of the trainable parts, by the same names."""
        return {"decoder": self.model.decoder, "watermark_encoder": self.model.encoder}

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        s = self.latent_side
        return self.model.quantize.embedding[codes.reshape(codes.shape[0], s, s)]

    def decode(self, decoder: nn.Module, z_q: torch.Tensor) -> torch.Tensor:
        return self.model.decode_latent(z_q, decoder)

    def decode_with(self, decoder: nn.Module, params: Dict[str, torch.Tensor], z_q: torch.Tensor) -> torch.Tensor:
        """``decode`` with ``decoder``'s parameters replaced by ``params``."""
        from torch.func import functional_call

        return self.model.decode_latent(z_q, lambda h: functional_call(decoder, params, (h,)))

    def decode_orig(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decode(self.model.decoder, z_q)

    def encode_latent(self, encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
        return self.model.encode_latent(images, encoder)

    def nearest_codes(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.quantize.nearest(z).reshape(z.shape[0], -1)


class MaskGitRCCAdapter:
    """The same protocol for RAR's MaskGit tokenizer, in [0, 1] pixel space
    inside (``deps/rar/modeling/titok.py:125-208``); its decode clips with
    JAX's gradient at the bounds."""

    def __init__(self, model):
        self.model = model.requires_grad_(False)
        self.latent_side = model.cfg.codes_per_side

    @property
    def device(self) -> torch.device:
        return self.model.embedding.device

    def init_trainable(self) -> nn.ModuleDict:
        return nn.ModuleDict({"decoder": copy.deepcopy(self.model.decoder).requires_grad_(True),
                              "watermark_encoder": copy.deepcopy(self.model.encoder).requires_grad_(True)})

    def frozen_parts(self) -> Dict[str, nn.Module]:
        return {"decoder": self.model.decoder, "watermark_encoder": self.model.encoder}

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        s = self.latent_side
        return self.model.embedding[codes.reshape(codes.shape[0], s, s)]

    def decode(self, decoder: nn.Module, z_q: torch.Tensor) -> torch.Tensor:
        return V.clip01(decoder(z_q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)) * 2.0 - 1.0

    def decode_orig(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decode(self.model.decoder, z_q)

    def encode_latent(self, encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
        return self.model.encode_latent((images + 1.0) / 2.0, encoder)

    def nearest_codes(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.nearest(z).reshape(z.shape[0], -1)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RCCConfig:
    lr: float = 1e-5
    idem_weight: float = 2.0
    aug_prob: float = 0.5
    lr_decay: float = 0.9  # per-epoch StepLR gamma (``finetune.py:372``)


@dataclasses.dataclass
class RCCState:
    """The trainable parts, their optimizer and schedule, and the step."""

    trainable: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def make_optimizer(trainable: nn.Module, cfg: RCCConfig, steps_per_epoch: Optional[int] = None):
    """(Adam, LambdaLR) of ``make_optimizer``: ``cfg.lr * lr_decay **
    (step // steps_per_epoch)`` at the step's count, or a constant rate."""
    opt = torch.optim.Adam(trainable.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if steps_per_epoch:
        factor = lambda step: cfg.lr_decay ** (step // steps_per_epoch)  # noqa: E731
    else:
        factor = lambda step: 1.0  # noqa: E731
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def init_state(adapter, cfg: RCCConfig, steps_per_epoch: Optional[int] = None) -> RCCState:
    trainable = adapter.init_trainable()
    opt, sched = make_optimizer(trainable, cfg, steps_per_epoch)
    return RCCState(trainable=trainable, optimizer=opt, scheduler=sched)


def _idem_loss(z_q: torch.Tensor, zrec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    sq = (z_q - zrec) ** 2
    m = mask[None, :, :, None]
    return (sq * m).sum() / (m.sum() * sq.shape[0] * sq.shape[-1])


def make_loss_fn(adapter, cfg: RCCConfig, level: str, perceptual: Optional[PerceptualLoss] = None, gan=None,
                 mesh=None):
    """``loss_fn(trainable, codes, step, generator=None, noise_generator=None,
    **draws) -> (loss, metrics)`` of one curriculum level (``draws``: the
    fed ``gate``, ``index`` and ``noise`` of the augmentation); ``codes``
    this rank's rows on a dp rank of ``mesh``."""
    branches = expand_level(level)
    logits = _branch_logits(level) if branches else None
    perceptual = perceptual or PerceptualLoss()
    side = adapter.latent_side

    def loss_fn(trainable, codes, step: int = 0, generator=None, noise_generator=None, **draws):
        z_q = adapter.lookup(codes)
        decoder = trainable["decoder"]
        xrec = adapter.decode(decoder, z_q)
        with torch.no_grad():
            xrec_orig = adapter.decode_orig(z_q)
        rec_l1 = (xrec_orig - xrec).abs().mean()
        p_loss = perceptual(xrec_orig, xrec).mean()

        x01 = xrec / 2.0 + 0.5
        x_aug01, mask = apply_random_augmentation(x01, branches, logits, side, generator, cfg.aug_prob,
                                                  noise_generator=noise_generator, mesh=mesh, **draws)
        zrec = adapter.encode_latent(trainable["watermark_encoder"], x_aug01 * 2.0 - 1.0)
        idem = _idem_loss(z_q, zrec, mask)
        loss = rec_l1 + p_loss + cfg.idem_weight * idem
        metrics = {"loss": loss, "rec_l1": rec_l1, "perceptual": p_loss, "idem": idem}
        if gan is not None:
            from wmar_tpu_torch.finetune.gan import gan_generator_terms

            terms = gan_generator_terms(
                gan, decoder, lambda params: adapter.decode_with(decoder, params, z_q), xrec,
                lambda xr: (xrec_orig - xr).abs().mean() + perceptual(xrec_orig, xr).mean(), step, mesh)
            loss = loss + terms["d_weight"] * terms["disc_factor"] * terms["g_loss"]
            metrics.update(loss=loss, vqgan_gan_loss=terms["g_loss"], vqgan_gan_weight=terms["d_weight"],
                           vqgan_gan_factor=torch.tensor(terms["disc_factor"]))
        return loss, metrics

    return loss_fn


def make_train_step(adapter, cfg: RCCConfig, level: str, perceptual: Optional[PerceptualLoss] = None, gan=None,
                    mesh=None):
    """``train_step(state, codes, generator=None, noise_generator=None,
    **draws) -> metrics``: one Adam step on ``state`` in place. Metrics stay
    tensors on the device (no sync); ``grad_norm`` is the global norm of
    the gradients, as ``optax.global_norm``. On a dp rank of ``mesh``
    (``codes`` its rows) the gradients are the ranks' mean and the metrics
    too."""
    loss_fn = make_loss_fn(adapter, cfg, level, perceptual, gan, mesh)

    def train_step(state: RCCState, codes: torch.Tensor, generator=None, noise_generator=None, **draws):
        params = [p for p in state.trainable.parameters()]
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.trainable, codes, state.step, generator, noise_generator, **draws)
        loss.backward()
        mean_grads(params, mesh)
        grads = [p.grad for p in params if p.grad is not None]
        metrics = dict(metrics, grad_norm=torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return mean_metrics(metrics, mesh)

    return train_step


def make_val_step(adapter, cfg: RCCConfig, branch: Optional[AugBranch], perceptual: Optional[PerceptualLoss] = None,
                  mesh=None):
    """Validation of one (aug, param) cell, the reference's ``validate()``
    (``finetune.py:73-128``): the branch at p = 1 (``None``: Identity), and
    loss / idem loss / drift loss / token mismatch L0, as tensors (on a dp
    rank of ``mesh``, ``codes`` its rows, the ranks' means)."""
    perceptual = perceptual or PerceptualLoss()
    side = adapter.latent_side

    @torch.no_grad()
    def val_step(trainable, codes, generator=None, noise=None):
        z_q = adapter.lookup(codes)
        xrec = adapter.decode(trainable["decoder"], z_q)
        xrec_orig = adapter.decode_orig(z_q)
        rec_l1 = (xrec_orig - xrec).abs().mean()
        p_loss = perceptual(xrec_orig, xrec).mean()
        x01 = xrec / 2.0 + 0.5
        if branch is not None:
            x01 = V.clip01(branch(x01, generator=generator, noise=noise, mesh=mesh))
            mask = _mask_on(branch, side, x01.device)
        else:
            mask = torch.ones((side, side), dtype=torch.float32, device=x01.device)
        zrec = adapter.encode_latent(trainable["watermark_encoder"], x01 * 2.0 - 1.0)
        idem = _idem_loss(z_q, zrec, mask)
        l0 = (adapter.nearest_codes(zrec) != codes.reshape(codes.shape[0], -1)).float().mean()
        return mean_metrics({"loss": rec_l1 + p_loss + cfg.idem_weight * idem, "idem_loss": idem,
                              "vqgan_loss": rec_l1 + p_loss, "vqgan_rec_loss": rec_l1, "l0": l0}, mesh)

    return val_step


@torch.no_grad()
def validation_l0(adapter, trainable, codes, aug=None, generator=None) -> torch.Tensor:
    """decode -> (aug) -> re-encode -> the token mismatch fraction per row."""
    z_q = adapter.lookup(codes)
    x01 = adapter.decode(trainable["decoder"], z_q) / 2.0 + 0.5
    if aug is not None:
        x01 = aug(x01, generator=generator)
    zrec = adapter.encode_latent(trainable["watermark_encoder"], x01 * 2.0 - 1.0)
    return (adapter.nearest_codes(zrec) != codes.reshape(codes.shape[0], -1)).float().mean(dim=-1)
