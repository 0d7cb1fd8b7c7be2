"""Mimi RCC finetuning: make audio tokens survive decode -> attack -> encode
(PyTorch).

Port of ``wmar_tpu.audio.finetune``. A frozen Mimi gives the targets; the
trainable copies of its encoder and decoder (and their bottleneck
transformers) are updated so that re-encoding the (augmented) decoded audio
gives back the original latents. :func:`rcc_forward` is the reference's
pipeline:

    frozen encoder -> frozen quantizer (every level's pre / post latents)
      -> {frozen decoder: the audio target, trainable decoder: the prediction}
      -> (augment) -> trainable encoder -> frozen quantizer again

and :func:`rcc_losses_and_metrics` its loss (an audio loss on the decoded
audio, a code loss on the re-encoded latents) and the per-codebook
idempotence rate ``idemp_k``. The quantizer is straight-through, so the
code loss reaches the trainable decoder through the trainable encoder.

The frozen passes run without a graph. The optimizer is ``torch.optim.
AdamW`` with optax's defaults (``weight_decay=1e-4``, ``eps=1e-8``, betas
(0.9, 0.999)) and an absolute learning rate from ``schedule(count)`` at
the count before each update, as ``optax.adamw(schedule)`` applies it;
:func:`warmup_cosine_decay` is ``optax.warmup_cosine_decay_schedule``.
Parts left out of ``parts`` are frozen and not in the optimizer
(``optax.set_to_zero`` on them). Randomness: a ``torch.Generator``, or fed
draws through the augmentation callable.

Data parallelism (``mesh``, None for one process): a dp rank takes its rows
of the global batch; the losses that are not row means come over the
gathered batch (:func:`~wmar_tpu_torch.audio.losses.get_audio_loss`,
:func:`multi_res_stft_loss`), the noise at the global shape, the trainable
gradients are averaged over the ranks before the update, and the metrics
after it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from wmar_tpu_torch.audio import augmentations as A
from wmar_tpu_torch.audio.mimi import Mimi
from wmar_tpu_torch.parallel import gather_rows, mean_grads, mean_metrics

PARTS = ("encoder", "enc_transformer", "decoder", "dec_transformer")
# optax.adamw's defaults, which torch.optim.AdamW does not share (its decay is 1e-2)
ADAMW_BETAS, ADAMW_EPS, ADAMW_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    frames = x.unfold(-1, n_fft, hop) * torch.from_numpy(np.hanning(n_fft)).to(x)
    return torch.abs(torch.fft.rfft(frames, dim=-1))


def multi_res_stft_loss(a: torch.Tensor, b: torch.Tensor, fft_sizes=(256, 512, 1024), mesh=None) -> torch.Tensor:
    """The legacy step's drift term: spectral convergence + log-magnitude L1
    over unpadded symmetric-Hann STFTs at each size the clip fills, summed
    and divided by the number of sizes. The eps sits inside the square root
    (the first step compares equal audio). On a dp rank of ``mesh``, over the
    ranks' gathered rows: the convergence sums over the whole batch."""
    total = 0.0
    x, y = gather_rows(a, mesh)[..., 0], gather_rows(b, mesh)[..., 0]
    for n_fft in fft_sizes:
        if x.shape[-1] < n_fft:
            continue
        fx, fy = _stft_mag(x, n_fft, n_fft // 4), _stft_mag(y, n_fft, n_fft // 4)
        sc = torch.sqrt(((fy - fx) ** 2).sum() + 1e-12) / (torch.sqrt((fy**2).sum()) + 1e-7)
        lm = torch.abs(torch.log(fx + 1e-5) - torch.log(fy + 1e-5)).mean()
        total = total + sc + lm
    return total / len(fft_sizes)


# The legacy step's bank: (name, fn(x, generator, noise, mesh)), one picked uniformly a step
TRAIN_AUGS = [
    ("identity", lambda x, g, z, m=None: x),
    ("noise", lambda x, g, z, m=None: A.gaussian_noise(x, 0.01, g, noise=z, mesh=m)),
    ("pink", lambda x, g, z, m=None: A.pink_noise(x, 0.02, g, white=z, mesh=m)),
    ("lowpass", lambda x, g, z, m=None: A.lowpass(x, 0.5)),
    ("smooth", lambda x, g, z, m=None: A.smooth(x, 5)),
    ("echo", lambda x, g, z, m=None: A.echo(x, 0.05, 0.3)),
    ("amplitude", lambda x, g, z, m=None: torch.clamp(x * 0.7, -1.0, 1.0)),
]
if A.mp3_available():
    TRAIN_AUGS.append(("mp3", lambda x, g, z, m=None: A.mp3_compression_st(x, 64)))


@dataclasses.dataclass(frozen=True)
class MimiFTConfig:
    """The legacy step's weight of the idempotence term and its
    augmentation probability."""

    code_loss_weight: float = 2.0
    aug_prob: float = 0.5


class MimiFTWrapper(nn.Module):
    """A frozen Mimi (``model``, no gradients) and trainable copies of its
    ``encoder``, ``enc_transformer``, ``decoder`` and ``dec_transformer``
    (``trainable``)."""

    def __init__(self, model: Mimi):
        super().__init__()
        self.model = model.requires_grad_(False)
        self.trainable = nn.ModuleDict({p: copy.deepcopy(getattr(model, p)).requires_grad_(True) for p in PARTS})

    @property
    def cfg(self):
        return self.model.cfg

    def _quantize_all(self, z: torch.Tensor):
        """Both RVQs straight through: (codes, post-quant latent, all_pre,
        all_post) with the levels of ``rvq_first`` then ``rvq_rest``."""
        m = self.model
        c1, q1, pre1, post1 = m.rvq_first.encode_decode_all(z)
        c2, q2, pre2, post2 = m.rvq_rest.encode_decode_all(z)
        return torch.cat([c1, c2], dim=1), q1 + q2, torch.cat([pre1, pre2]), torch.cat([post1, post2])

    @torch.no_grad()
    def codes_to_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """Frozen RVQ decode: codes ``[B, K, T]`` -> latent ``[B, T, D]``."""
        m, nq_sem = self.model, self.cfg.n_q_semantic
        return m.rvq_first.decode(codes[:, :nq_sem]) + m.rvq_rest.decode(codes[:, nq_sem:])

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        t = self.trainable
        return self.model._from_latent(z, decoder=t["decoder"], dec_transformer=t["dec_transformer"])

    @torch.no_grad()
    def decode_frozen(self, z: torch.Tensor) -> torch.Tensor:
        return self.model._from_latent(z)

    def encode_latent(self, audio: torch.Tensor) -> torch.Tensor:
        t = self.trainable
        return self.model._to_latent(audio, encoder=t["encoder"], enc_transformer=t["enc_transformer"])

    @torch.no_grad()
    def encode_codes(self, audio: torch.Tensor) -> torch.Tensor:
        """Trainable encoder, frozen quantizer: ``[B, T, 1]`` -> codes."""
        z = self.encode_latent(audio)
        return torch.cat([self.model.rvq_first.encode(z), self.model.rvq_rest.encode(z)], dim=1)


def parse_code_target_indices(code_target_type: str) -> Optional[list]:
    """``pre_q`` / ``post_q`` -> None; digits, ranges and comma lists
    (``"0-2,5"``, ``"013"``) -> the sorted level indices."""
    if code_target_type in ("pre_q", "post_q"):
        return None
    indices = set()
    for part in code_target_type.split(","):
        part = part.strip()
        m = re.match(r"(\d+)-(\d+)$", part)
        if m:
            start, end = int(m.group(1)), int(m.group(2))
            if start > end:
                raise ValueError(f"Invalid range in code_target_type: {start}-{end}")
            indices.update(range(start, end + 1))
        elif part.isdigit():
            indices.update(int(d) for d in part)
        else:
            raise ValueError(f"Invalid format in code_target_type: {part}. Use 'pre_q', 'post_q', digits "
                             "(e.g. '0', '13'), or ranges ('0-2', '1-3,5').")
    if not indices:
        raise ValueError(f"Could not parse indices from: {code_target_type}")
    return sorted(indices)


AugFn = Callable[[torch.Tensor, Optional[torch.Generator]], tuple]


def rcc_forward(wrapper: MimiFTWrapper, audio: torch.Tensor, aug_fn: Optional[AugFn] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The RCC pipeline on ``audio [B, T, 1]``; ``aug_fn(audio, generator)``
    returns (augmented audio, picked branches), e.g. an :class:`~wmar_tpu_torch.
    audio.augmenter.Augmenter`."""
    m = wrapper.model
    with torch.no_grad():
        embs_pre_q = m._to_latent(audio)
        codes, embs_post_q, all_pre_q, all_post_q = wrapper._quantize_all(embs_pre_q)
        audio_recon = m._from_latent(embs_post_q)
    audio_recon_pred = wrapper.decode(embs_post_q)
    if aug_fn is not None:
        audio_recon_pred_aug, selected = aug_fn(audio_recon_pred, generator)
    else:
        audio_recon_pred_aug, selected = audio_recon_pred, torch.zeros((1,), dtype=torch.int32)
    recons_pre_q = wrapper.encode_latent(audio_recon_pred_aug)
    recons_codes, recons_post_q, recons_all_pre_q, recons_all_post_q = wrapper._quantize_all(recons_pre_q)
    return {
        "audio_recon": audio_recon,
        "audio_recon_pred": audio_recon_pred,
        "audio_recon_pred_aug": audio_recon_pred_aug,
        "embs_pre_q": embs_pre_q,
        "embs_post_q": embs_post_q,
        "all_pre_q": all_pre_q,
        "all_post_q": all_post_q,
        "codes": codes,
        "recons_embs_pre_q_pred": recons_pre_q,
        "recons_embs_post_q_pred": recons_post_q,
        "recons_all_pre_q": recons_all_pre_q,
        "recons_all_post_q": recons_all_post_q,
        "recons_codes": recons_codes,
        "selected_aug": selected,
    }


def rcc_losses_and_metrics(out, audio, audio_loss_fn, code_loss_fn, audio_loss_weight, code_loss_weight,
                           audio_target_type: str = "replica", code_target_type: str = "pre_q"):
    """(loss, metrics): the audio loss of the prediction against the frozen
    decode (``replica``) or the input (``original``), the code loss of the
    re-encoded latents against ``embs_pre_q`` / ``embs_post_q`` or, for an
    index list, the mean over those levels of the re-encoded residual
    against the original code vector; ``idemp_k`` the share of codebook
    ``k``'s codes the round trip kept."""
    if audio_target_type == "replica":
        audio_target = out["audio_recon"].detach()
    elif audio_target_type == "original":
        audio_target = audio
    else:
        raise ValueError(f"Unknown audio target type: {audio_target_type}")
    audio_loss = audio_loss_fn(out["audio_recon_pred"], audio_target)
    idx = parse_code_target_indices(code_target_type)
    if idx is None:
        if code_target_type == "post_q":
            tgt, pred = out["embs_post_q"], out["recons_embs_post_q_pred"]
        else:
            tgt, pred = out["embs_pre_q"], out["recons_embs_pre_q_pred"]
        code_loss = code_loss_fn(pred, tgt.detach())
    else:
        tgt = out["all_post_q"][idx].detach()
        pred = out["recons_all_pre_q"][idx]
        code_loss = torch.stack([code_loss_fn(pred[i], tgt[i]) for i in range(len(idx))]).mean()
    loss = audio_loss_weight * audio_loss + code_loss_weight * code_loss
    idemp = (out["codes"] == out["recons_codes"]).to(torch.float32).mean(dim=(0, 2))  # [K]
    metrics = {"loss": loss, "audio_loss": audio_loss, "code_loss": code_loss}
    for k in range(idemp.shape[0]):
        metrics[f"idemp_{k}"] = idemp[k]
    return loss, metrics


# ---------------------------------------------------------------------------
# Optimizer and state
# ---------------------------------------------------------------------------


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps`` (warmup included)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got {decay_steps - warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps))) + alpha)

    return schedule


@dataclasses.dataclass
class MimiFTState:
    """The wrapper, its AdamW and schedule, and the number of updates."""

    wrapper: MimiFTWrapper
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @property
    def trainable(self) -> nn.ModuleDict:
        return self.wrapper.trainable


def init_state(wrapper: MimiFTWrapper, lr: float = 1e-5, schedule: Optional[Callable[[int], float]] = None,
               parts: Sequence[str] = PARTS) -> MimiFTState:
    """AdamW (optax's defaults) over the trainable ``parts`` at
    ``schedule(count)`` (constant ``lr`` without one); the other parts are
    frozen."""
    for part, module in wrapper.trainable.items():
        module.requires_grad_(part in parts)
    params = [p for part in parts for p in wrapper.trainable[part].parameters()]
    opt = torch.optim.AdamW(params, lr=1.0, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule or (lambda count: lr))
    return MimiFTState(wrapper, opt, sched)


def _update(state: MimiFTState, loss: torch.Tensor, mesh=None) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mean_grads([p for group in state.optimizer.param_groups for p in group["params"]], mesh)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_rcc_train_step(state: MimiFTState, audio_loss_fn, code_loss_fn, audio_loss_weight: float,
                        code_loss_weight: float, aug_fn: Optional[AugFn] = None, audio_target_type: str = "replica",
                        code_target_type: str = "pre_q", mesh=None):
    """``train_step(audio, generator=None) -> metrics`` (detached): one RCC
    forward, its loss and one AdamW update of ``state``. On a dp rank of
    ``mesh`` (``audio`` its rows; ``audio_loss_fn`` and ``aug_fn`` made for
    that mesh) the trainable gradients and the metrics are the ranks'
    means."""

    def train_step(audio, generator=None):
        out = rcc_forward(state.wrapper, audio, aug_fn, generator)
        loss, metrics = rcc_losses_and_metrics(out, audio, audio_loss_fn, code_loss_fn, audio_loss_weight,
                                               code_loss_weight, audio_target_type, code_target_type)
        _update(state, loss, mesh)
        return mean_metrics(metrics, mesh)

    return train_step


def make_rcc_eval_step(wrapper: MimiFTWrapper, audio_loss_fn, code_loss_fn, aug_fn: Optional[AugFn] = None,
                       audio_target_type: str = "replica", code_target_type: str = "pre_q", mesh=None):
    """``eval_step(audio, generator=None) -> (metrics, audio_recon,
    audio_recon_pred)``: the losses at weights 1 and 1 (without ``loss``)
    and the idempotence rates, with the reconstructions for the host's
    SI-SNR / SNR / STOI / PESQ and the sample wavs. On a dp rank of
    ``mesh`` the metrics are the ranks' means and the reconstructions this
    rank's rows."""

    @torch.no_grad()
    def eval_step(audio, generator=None):
        out = rcc_forward(wrapper, audio, aug_fn, generator)
        _, metrics = rcc_losses_and_metrics(out, audio, audio_loss_fn, code_loss_fn, 1.0, 1.0, audio_target_type,
                                            code_target_type)
        del metrics["loss"]
        return mean_metrics(metrics, mesh), out["audio_recon"], out["audio_recon_pred"]

    return eval_step


def make_train_step(state: MimiFTState, cfg: MimiFTConfig, mesh=None):
    """The legacy step on codes: ``train_step(codes, generator=None, gate=
    None, pick=None, noise=None) -> metrics``. Decode with the trainable
    decoder, the drift (L1 + :func:`multi_res_stft_loss`) against the frozen
    decode, one :data:`TRAIN_AUGS` branch (``pick``, uniform) applied when
    ``gate < cfg.aug_prob`` (``gate`` uniform in [0, 1)), re-encode, MSE to
    the codes' latent. On a dp rank of ``mesh`` (``codes`` its rows) the
    gate and pick are drawn alike on every rank (the same generator seed),
    the noise at the global batch's shape, the drift's STFT term over the
    gathered batch, and the gradients and metrics are the ranks' means."""
    n_augs = len(TRAIN_AUGS)
    wrapper = state.wrapper

    def train_step(codes, generator=None, gate=None, pick=None, noise=None):
        z_q = wrapper.codes_to_latent(codes)
        audio = wrapper.decode(z_q)
        audio_orig = wrapper.decode_frozen(z_q)
        drift = torch.abs(audio - audio_orig).mean() + multi_res_stft_loss(audio, audio_orig, mesh=mesh)
        if gate is None:
            gate = float(torch.rand((), generator=generator, device=codes.device))
            pick = int(torch.randint(0, n_augs, (), generator=generator, device=codes.device))
        a_aug = TRAIN_AUGS[pick][1](audio, generator, noise, mesh) if gate < cfg.aug_prob else audio
        z_rec = wrapper.encode_latent(a_aug)
        idem = ((z_rec - z_q) ** 2).mean()
        loss = drift + cfg.code_loss_weight * idem
        _update(state, loss, mesh)
        return mean_metrics({"loss": loss, "drift": drift, "idem": idem}, mesh)

    return train_step


@torch.no_grad()
def validation_token_match(wrapper: MimiFTWrapper, codes: torch.Tensor, aug_fn=None, generator=None) -> torch.Tensor:
    """Decode (trainable) -> ``aug_fn(audio, generator)`` -> encode ->
    per-stream token match ``[B, K]``."""
    audio = wrapper.decode(wrapper.codes_to_latent(codes))
    if aug_fn is not None:
        audio = aug_fn(audio, generator)
    return (wrapper.encode_codes(audio) == codes).to(torch.float32).mean(dim=-1)
