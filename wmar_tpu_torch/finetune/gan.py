"""GAN branch of taming's ``VQLPIPSWithDiscriminator`` for RCC finetuning
(PyTorch port of ``wmar_tpu.finetune.gan``).

Unless ``--disable_gan``, the reference's generator objective adds
``d_weight * disc_factor * g_loss``:

* ``g_loss = -mean(D(xrec))`` against the checkpoint's PatchGAN
  discriminator, frozen during RCC (eval-mode BatchNorm from its running
  statistics);
* ``d_weight`` is the adaptive grad-norm ratio ``||d nll / d last|| /
  (||d g / d last|| + 1e-4)`` clipped to 1e4 and detached, ``last`` being
  the decoder's final conv weight (``vqperceptual.py:62-81``). It is taken
  by :func:`last_layer_grads`: one forward of a detached copy of the
  decoder through ``torch.func.functional_call`` with only
  ``conv_out.weight`` requiring a gradient, so the outer backward does not
  differentiate through it;
* ``disc_factor`` gates on ``global_step >= disc_start``.

On a dp rank the two last-kernel gradients are averaged over the ranks
before their norms, so ``d_weight`` is the global batch's (both losses are
means over the batch's rows).

The discriminator's ``state_dict`` maps to the JAX package's parameter list
through :func:`wmar_tpu_torch.bridge.flax_tree` (``layers.{i}`` ->
``{"layers": {"0": {"kernel", "bias"}, "1": {"kernel", "bn": {"scale",
"bias", "mean", "var"}}, ...}}``, the layout of ``discriminator.msgpack``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


class _DiscConv(nn.Conv2d):
    """A 4x4 conv with padding 1, with the BatchNorm that follows it as
    ``bn`` (None for the first and the last conv)."""

    def __init__(self, c_in: int, c_out: int, stride: int, bias: bool, bn: bool):
        super().__init__(c_in, c_out, 4, stride=stride, padding=1, bias=bias)
        self.bn = nn.BatchNorm2d(c_out) if bn else None


class PatchGAN(nn.Module):
    """Taming's ``NLayerDiscriminator`` (``use_actnorm=False``): conv(s2) +
    leaky ReLU, ``n_layers - 1`` x [conv(s2, no bias) + BN + leaky ReLU],
    conv(s1, no bias) + BN + leaky ReLU, and a 1-channel conv(s1). Images
    NHWC in [-1, 1] -> patch logits NHWC ``[B, h, w, 1]``. BatchNorm always
    runs in eval mode: the discriminator is frozen."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [_DiscConv(input_nc, ndf, 2, bias=True, bn=False)]
        nf_prev = 1
        for n in range(1, n_layers + 1):
            nf = min(2**n, 8)
            layers.append(_DiscConv(ndf * nf_prev, ndf * nf, 2 if n < n_layers else 1, bias=False, bn=True))
            nf_prev = nf
        layers.append(_DiscConv(ndf * nf_prev, 1, 1, bias=True, bn=False))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for i, conv in enumerate(self.layers):
            h = conv(h)
            if conv.bn is not None:
                bn = conv.bn
                h = F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
            if i < len(self.layers) - 1:
                h = F.leaky_relu(h, 0.2)
        return h.permute(0, 2, 3, 1)


def _geometry(shapes: List[tuple]) -> dict:
    """(input_nc, ndf, n_layers) from the OIHW conv weight shapes in order."""
    return {"input_nc": shapes[0][1], "ndf": shapes[0][0], "n_layers": len(shapes) - 2}


@torch.no_grad()
def init_taming_discriminator(generator: torch.Generator, input_nc: int = 3, ndf: int = 64,
                              n_layers: int = 3, device=None) -> PatchGAN:
    """A fresh discriminator by the reference's ``weights_init``: convs
    N(0, 0.02), BatchNorm scale N(1, 0.02), bias 0, identity statistics."""
    disc = PatchGAN(input_nc, ndf, n_layers)
    for conv in disc.layers:
        conv.weight.normal_(0.0, 0.02, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
        if conv.bn is not None:
            conv.bn.weight.normal_(1.0, 0.02, generator=generator)
            conv.bn.bias.zero_()
    return disc.to(device).requires_grad_(False).eval()


@torch.no_grad()
def convert_taming_discriminator(sd: Dict[str, torch.Tensor], prefix: str = "loss.discriminator.main.",
                                 device=None) -> PatchGAN:
    """The reference's ``NLayerDiscriminator.main`` Sequential (a torch
    state dict) as a :class:`PatchGAN`. Scans the indices in order: 4-d
    weights are convs, entries with a ``running_mean`` are the BatchNorm of
    the conv before them."""
    idxs = sorted({int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)})
    convs, bns = [], {}
    for i in idxs:
        base = f"{prefix}{i}"
        if f"{base}.running_mean" in sd:
            bns[len(convs) - 1] = base
        elif f"{base}.weight" in sd and sd[f"{base}.weight"].dim() == 4:
            convs.append(base)
    disc = PatchGAN(**_geometry([tuple(sd[f"{c}.weight"].shape) for c in convs]))
    if len(convs) != len(disc.layers) or set(bns) != set(range(1, len(convs) - 1)):
        raise ValueError(f"not a PatchGAN state dict: convs {convs}, batch norms {bns}")
    for conv, base in zip(disc.layers, convs):
        conv.weight.copy_(torch.as_tensor(sd[f"{base}.weight"]))
        if conv.bias is not None:
            conv.bias.copy_(torch.as_tensor(sd[f"{base}.bias"]))
    for li, base in bns.items():
        bn = disc.layers[li].bn
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.as_tensor(sd[f"{base}.{name}"]))
    return disc.to(device).requires_grad_(False).eval()


def discriminator_from_flax(tree, device=None) -> PatchGAN:
    """A :class:`PatchGAN` from the JAX package's parameter list, or from
    ``discriminator.msgpack``'s ``{"layers": {"0": ...}}``."""
    from wmar_tpu_torch import bridge

    layers = tree["layers"] if isinstance(tree, dict) and "layers" in tree else tree
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    shapes = [tuple(bridge.to_tensor(p["kernel"]).permute(3, 2, 0, 1).shape) for p in layers]
    disc = PatchGAN(**_geometry(shapes))
    return bridge.load_flax(disc, {"layers": list(layers)}).to(device).requires_grad_(False).eval()


# ---------------------------------------------------------------------------
# Loss pieces (vqperceptual.py:13-30)
# ---------------------------------------------------------------------------


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    """``disc_factor`` gate: ``value`` before ``threshold`` steps."""
    return float(value) if global_step < threshold else float(weight)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adaptive_weight(nll_grad_last: torch.Tensor, g_grad_last: torch.Tensor, disc_weight: float = 1.0) -> torch.Tensor:
    """``calculate_adaptive_weight``: the grad-norm ratio on the decoder's
    last conv weight, clipped to [0, 1e4] and detached."""
    d = torch.linalg.vector_norm(nll_grad_last) / (torch.linalg.vector_norm(g_grad_last) + 1e-4)
    return d.clamp(0.0, 1e4).detach() * disc_weight


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """The generator-side GAN branch: a frozen discriminator and its gates."""

    disc: PatchGAN
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_start: int = 0


LAST_LAYER = "conv_out.weight"


def last_layer_grads(decoder: nn.Module, run: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                     losses: Callable[[torch.Tensor], List[torch.Tensor]]) -> List[torch.Tensor]:
    """Gradients of each of ``losses(images)`` with respect to the decoder's
    ``conv_out.weight`` only: ``run(params)`` decodes with a detached copy
    of the decoder's parameters (through ``torch.func.functional_call``)
    whose last conv weight alone requires a gradient. Values equal JAX's
    ``jax.grad`` of the loss with that kernel substituted
    (``rcc.py:333-355``); nothing reaches the trainable parameters."""
    params = {k: v.detach() for k, v in decoder.named_parameters()}
    last = params[LAST_LAYER].clone().requires_grad_(True)
    params[LAST_LAYER] = last
    with torch.enable_grad():
        outs = losses(run(params))
        return [torch.autograd.grad(loss, last, retain_graph=i < len(outs) - 1)[0] for i, loss in enumerate(outs)]


def gan_generator_terms(gan: GanConfig, decoder: nn.Module, run, xrec: torch.Tensor, nll_fn, step: int,
                        mesh=None) -> Optional[dict]:
    """``g_loss``, ``d_weight`` and ``disc_factor`` of one step: ``xrec`` the
    trainable decoder's images, ``run(params)`` its decode with substituted
    parameters, ``nll_fn(images)`` the drift loss (L1 + perceptual);
    ``mesh``: the run's rank grid (None: one process)."""
    from wmar_tpu_torch.parallel import mean_over

    g_loss = -gan.disc(xrec).mean()
    nll_grad, g_grad = mean_over(torch.stack(last_layer_grads(
        decoder, run, lambda xr: [nll_fn(xr), -gan.disc(xr).mean()])), mesh)
    return {"g_loss": g_loss, "d_weight": adaptive_weight(nll_grad, g_grad, gan.disc_weight),
            "disc_factor": adopt_weight(gan.disc_factor, step, gan.disc_start)}
