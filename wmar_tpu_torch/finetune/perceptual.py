"""Perceptual losses for RCC finetuning (PyTorch port of
``wmar_tpu.finetune.perceptual``).

The reference's tokenizer-drift loss is ``L1 + LPIPS`` between the frozen
decoder's output and the trainable decoder's (``VQLPIPSWithDiscriminator``
with the GAN off). Here: a VGG16-feature LPIPS whose weights load from a
Flax-layout msgpack (``lpips_vgg.msgpack``, read by the port's own codec),
and the weight-free Laplacian-pyramid L1 fallback for runs without them.
Both take NHWC images in [-1, 1] and return one distance per image.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# VGG16 feature blocks used by LPIPS: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_IMAGENET_SHIFT = (-0.030, -0.088, -0.188)
_IMAGENET_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv trunk emitting the 5 LPIPS tap activations (NCHW); the
    convolutions carry the Flax names ``conv{block}_{i}``."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for bi, (ch, n_convs) in enumerate(_VGG_CFG):
            for ci in range(n_convs):
                self.add_module(f"conv{bi}_{ci}", nn.Conv2d(c_in, ch, 3, padding=1))
                c_in = ch

    def forward(self, x):
        taps = []
        for bi, (_, n_convs) in enumerate(_VGG_CFG):
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            taps.append(x)
            if bi < len(_VGG_CFG) - 1:
                x = F.max_pool2d(x, 2)
        return taps


class LPIPS(nn.Module):
    """LPIPS distance with learned linear heads (1x1 convs, no bias)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_CFG):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_IMAGENET_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_IMAGENET_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, a, b):
        """``a``, ``b``: NHWC in [-1, 1] -> ``[B]``."""
        fa = self.vgg((a.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fb = self.vgg((b.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa * torch.rsqrt((xa**2).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt((xb**2).sum(1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((na - nb) ** 2).mean(dim=(1, 2, 3))
        return total


def laplacian_pyramid_l1(a: torch.Tensor, b: torch.Tensor, levels: int = 3) -> torch.Tensor:
    """Weight-free multi-scale perceptual proxy: L1 across a 2x2
    average-pool pyramid of NHWC images, ``[B]``."""
    total = (a - b).abs().mean(dim=(1, 2, 3))
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    for _ in range(levels):
        if min(a.shape[2], a.shape[3]) < 4:
            break
        a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
        total = total + (a - b).abs().mean(dim=(1, 2, 3))
    return total


class PerceptualLoss:
    """LPIPS where a module with weights is given, pyramid L1 otherwise.
    Returns ``[B]``."""

    def __init__(self, lpips: Optional[LPIPS] = None):
        self.module = lpips.requires_grad_(False).eval() if lpips is not None else None

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.module is not None:
            return self.module(a, b)
        return laplacian_pyramid_l1(a, b)


def load_lpips(path: str, device=None) -> LPIPS:
    """An LPIPS module with the weights of a Flax-layout msgpack file
    (``{"params": {"vgg": ..., "lin0": ...}}``)."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    return bridge.load_flax(LPIPS(), load_pytree(path)).to(device)
