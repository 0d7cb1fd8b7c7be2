"""The compressai zoo's six image codecs in PyTorch (eval-mode inference).

Port of ``wmar_tpu.augmentations.compressai_jax``: the families the
reference's attack bank loads pretrained (``wmar/augmentations/
neuralcompression.py:93-116``): bmshj2018-factorized, bmshj2018-hyperprior,
mbt2018-mean, mbt2018, cheng2020-anchor and cheng2020-attn. Modules run
NCHW:

* torch's conv geometry (kernel k, stride s, padding k//2) and
  ``ConvTranspose2d(output_padding=s-1)``;
* GDN on de-reparametrized ``beta`` / ``gamma_t`` (``convert_compressai``
  inverts the NonNegativeParametrizer), ``x * rsqrt(conv1x1(x^2) + beta)``;
* the EntropyBottleneck's likelihood from the checkpoint's ``_matrix{i}`` /
  ``_bias{i}`` / ``_factor{i}`` and the ``quantiles`` medians, so the bpp is
  the reference's exact ``-log2(likelihood) / num_pixels``;
* the GaussianConditional likelihood with the 0.11 scale bound;
* the mbt2018 / cheng2020 context model as one masked-conv pass over the
  quantized latents (the mask is applied to the weights at conversion).

Each family's ``forward(x)`` takes images in [0, 1] and returns
``(x_hat, [likelihoods])``. Weights come as the JAX package's parameter
trees (numpy leaves, HWIO kernels) from :func:`convert_compressai` or
``neural.init_compressai_params``; ``wmar_tpu_torch.bridge.load_compressai``
builds a module from one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# quality -> (N, M), compressai.zoo.image's cfgs
_QUALITY_CFG = {
    "bmshj2018-factorized": lambda q: (128, 192) if q < 6 else (192, 320),
    "bmshj2018-hyperprior": lambda q: (128, 192) if q < 6 else (192, 320),
    "mbt2018-mean": lambda q: (128, 192) if q < 5 else (192, 320),
    "mbt2018": lambda q: (192, 192) if q < 5 else (192, 320),
    "cheng2020-anchor": lambda q: (128, 128) if q < 4 else (192, 192),
    "cheng2020-attn": lambda q: (128, 128) if q < 4 else (192, 192),
}

LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11


def quality_nm(arch: str, quality: int) -> Tuple[int, int]:
    return _QUALITY_CFG[arch](quality)


def parse_codec_name(name: str) -> Tuple[str, Optional[int]]:
    """``"cheng2020-anchor-q=3"`` -> ("cheng2020-anchor", 3)."""
    if "-q=" in name:
        arch, q = name.rsplit("-q=", 1)
        return arch, int(q)
    return name, None


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def st_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round, as compressai quantizes in eval mode: the
    value ``x + (round(x) - x)``, which float32 may leave an ulp off
    ``round(x)`` (the JAX package computes the same sum)."""
    return x + (torch.round(x) - x).detach()


def conv(cin: int, cout: int, k: int = 5, stride: int = 2) -> nn.Conv2d:
    """torch ``Conv2d(k, stride, padding=k // 2)``."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def deconv(cin: int, cout: int, k: int = 5, stride: int = 2) -> nn.ConvTranspose2d:
    """torch ``ConvTranspose2d(k, stride, padding=k // 2, output_padding=stride - 1)``."""
    return nn.ConvTranspose2d(cin, cout, k, stride=stride, padding=k // 2, output_padding=stride - 1)


def subpel_conv(layer: nn.Conv2d, x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """conv3x3(in, out * r^2), then ``PixelShuffle(r)``."""
    return F.pixel_shuffle(layer(x), r)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


class GDN(nn.Module):
    """compressai's GDN (``inverse``: IGDN) on de-reparametrized ``beta``
    and ``gamma_t`` (gamma transposed, ``[C_in, C_out]``, the tree's
    layout): ``x * rsqrt(x^2 @ gamma_t + beta)``, ``sqrt`` when inverse."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.gamma_t = nn.Parameter(0.1 * torch.eye(channels), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = F.conv2d(x * x, self.gamma_t.t()[:, :, None, None], self.beta)
        return x * torch.sqrt(norm) if self.inverse else x * torch.rsqrt(norm)


class EntropyBottleneck(nn.Module):
    """The factorized prior's exact eval-mode likelihood
    (``entropy_models.py``'s ``_logits_cumulative``): ``z -> (z_hat,
    likelihood)``, ``z_hat = st_round(z - median) + median``."""

    def __init__(self, channels: int, filters=(3, 3, 3, 3)):
        super().__init__()
        fs = (1,) + tuple(filters) + (1,)
        frozen = lambda *shape: nn.Parameter(torch.zeros(shape), requires_grad=False)  # noqa: E731
        self.matrices = nn.ParameterList([frozen(channels, fs[i + 1], fs[i]) for i in range(len(filters) + 1)])
        self.biases = nn.ParameterList([frozen(channels, fs[i + 1], 1) for i in range(len(filters) + 1)])
        self.factors = nn.ParameterList([frozen(channels, fs[i + 1], 1) for i in range(len(filters))])
        self.quantiles = frozen(channels, 1, 3)

    def _logits_cumulative(self, v: torch.Tensor) -> torch.Tensor:
        logits = v  # [C, 1, L]
        for i, (m, b) in enumerate(zip(self.matrices, self.biases)):
            logits = torch.matmul(F.softplus(m), logits) + b
            if i < len(self.factors):
                logits = logits + torch.tanh(self.factors[i]) * torch.tanh(logits)
        return logits

    def forward(self, z: torch.Tensor):
        medians = self.quantiles[:, 0, 1]
        b, c, h, w = z.shape
        m = medians[None, :, None, None]
        z_hat = st_round(z - m) + m
        v = z_hat.transpose(0, 1).reshape(c, 1, -1)
        lower = self._logits_cumulative(v - 0.5)
        upper = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper).detach()
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        lik = torch.clamp(lik, min=LIKELIHOOD_BOUND)
        return z_hat, lik.reshape(c, b, h, w).transpose(0, 1)


def _std_cumulative(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.special.erfc(-(2**-0.5) * x)


def gaussian_likelihood(y_hat: torch.Tensor, scales: torch.Tensor, means: Optional[torch.Tensor] = None):
    """GaussianConditional's likelihood of the quantized values."""
    scales = torch.clamp(scales, min=SCALE_BOUND)
    values = torch.abs(y_hat - means if means is not None else y_hat)
    upper = _std_cumulative((0.5 - values) / scales)
    lower = _std_cumulative((-0.5 - values) / scales)
    return torch.clamp(upper - lower, min=LIKELIHOOD_BOUND)


def bpp_from_likelihoods(liks: List[torch.Tensor], num_pixels: int) -> torch.Tensor:
    """The reference's bpp (``neuralcompression.py:66-71``): the batch's
    total bits over its pixels."""
    return sum(-torch.log2(lik).sum() for lik in liks) / num_pixels


# ---------------------------------------------------------------------------
# bmshj2018 / mbt2018
# ---------------------------------------------------------------------------


def _g_a(n: int, m: int) -> nn.Sequential:
    """conv5s2, GDN x3, final conv5s2."""
    return nn.Sequential(conv(3, n), GDN(n), conv(n, n), GDN(n), conv(n, n), GDN(n), conv(n, m))


def _g_s(n: int, m: int) -> nn.Sequential:
    """deconv5s2, IGDN x3, final deconv5s2."""
    return nn.Sequential(deconv(m, n), GDN(n, True), deconv(n, n), GDN(n, True), deconv(n, n), GDN(n, True),
                         deconv(n, 3))


class _Codec(nn.Module):
    """A family's analysis ``g_a`` (images -> latents ``y``) and synthesis
    (quantized latents -> images)."""

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return self.g_s(y_hat)


class FactorizedPrior(_Codec):
    """bmshj2018-factorized: ``x_hat = g_s(round(g_a(x)))``."""

    def __init__(self, n: int, m: int):
        super().__init__()
        self.g_a, self.g_s = _g_a(n, m), _g_s(n, m)
        self.eb = EntropyBottleneck(m)

    def forward(self, x):
        y_hat, y_lik = self.eb(self.g_a(x))
        return self.synthesis(y_hat), [y_lik]


class ScaleHyperprior(_Codec):
    """bmshj2018-hyperprior: ``h_a`` on ``|y|``, a ReLU-ended ``h_s``
    predicts the scales."""

    def __init__(self, n: int, m: int):
        super().__init__()
        self.g_a, self.g_s = _g_a(n, m), _g_s(n, m)
        self.h_a = nn.ModuleList([conv(m, n, 3, 1), conv(n, n), conv(n, n)])
        self.h_s = nn.ModuleList([deconv(n, n), deconv(n, n), conv(n, m, 3, 1)])
        self.eb = EntropyBottleneck(n)

    def forward(self, x):
        y = self.g_a(x)
        ha, hs = self.h_a, self.h_s
        z = ha[2](F.relu(ha[1](F.relu(ha[0](torch.abs(y))))))
        z_hat, z_lik = self.eb(z)
        scales = F.relu(hs[2](F.relu(hs[1](F.relu(hs[0](z_hat))))))
        y_hat = st_round(y)
        y_lik = gaussian_likelihood(y_hat, scales)
        return self.synthesis(y_hat), [y_lik, z_lik]


class MeanScaleHyperprior(_Codec):
    """mbt2018-mean: quantize ``round(y - mu) + mu``, likelihood N(mu, sigma)."""

    def __init__(self, n: int, m: int):
        super().__init__()
        self.g_a, self.g_s = _g_a(n, m), _g_s(n, m)
        self.h_a = nn.ModuleList([conv(m, n, 3, 1), conv(n, n), conv(n, n)])
        self.h_s = nn.ModuleList([deconv(n, m), deconv(m, m * 3 // 2), conv(m * 3 // 2, 2 * m, 3, 1)])
        self.eb = EntropyBottleneck(n)

    def hyper(self, y):
        """The shared mbt2018(-mean) hyper branch: ``y -> (z_lik, 2M params)``."""
        ha, hs = self.h_a, self.h_s
        z = ha[2](leaky_relu(ha[1](leaky_relu(ha[0](y)))))
        z_hat, z_lik = self.eb(z)
        g = leaky_relu(hs[1](leaky_relu(hs[0](z_hat))))
        return z_lik, hs[2](g)

    def forward(self, x):
        y = self.g_a(x)
        z_lik, gparams = self.hyper(y)
        scales, means = gparams.chunk(2, dim=1)
        y_hat = st_round(y - means) + means
        y_lik = gaussian_likelihood(y_hat, scales, means)
        return self.synthesis(y_hat), [y_lik, z_lik]


def _context_params(model: nn.Module, hyper: torch.Tensor, y_hat: torch.Tensor):
    """Masked-conv context + the entropy_parameters 1x1 stack -> (scales, means)."""
    ctx = model.context_prediction(y_hat)
    ep = model.entropy_parameters
    g = leaky_relu(ep[0](torch.cat([hyper, ctx], dim=1)))
    g = ep[2](leaky_relu(ep[1](g)))
    return g.chunk(2, dim=1)


def _entropy_parameters(m: int) -> nn.ModuleList:
    return nn.ModuleList([conv(m * 4, m * 10 // 3, 1, 1), conv(m * 10 // 3, m * 8 // 3, 1, 1),
                          conv(m * 8 // 3, m * 2, 1, 1)])


class JointAutoregressive(MeanScaleHyperprior):
    """mbt2018: ``x_hat = g_s(round(y))``; the context model shapes only the
    likelihoods, which are taken of the unquantized ``y``."""

    def __init__(self, n: int, m: int):
        super().__init__(n, m)
        self.context_prediction = conv(m, 2 * m, 5, 1)
        self.entropy_parameters = _entropy_parameters(m)

    def forward(self, x):
        y = self.g_a(x)
        z_lik, hyper = self.hyper(y)
        y_hat = st_round(y)
        scales, means = _context_params(self, hyper, y_hat)
        y_lik = gaussian_likelihood(y, scales, means)
        return self.synthesis(y_hat), [y_lik, z_lik]


# ---------------------------------------------------------------------------
# cheng2020
# ---------------------------------------------------------------------------


class ResidualBlock(nn.Module):
    """conv3x3 lrelu conv3x3 lrelu (+ a 1x1 skip when the width changes)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1, self.conv2 = conv(cin, cout, 3, 1), conv(cout, cout, 3, 1)
        if cin != cout:
            self.skip = conv(cin, cout, 1, 1)

    def forward(self, x):
        out = leaky_relu(self.conv2(leaky_relu(self.conv1(x))))
        return out + (self.skip(x) if hasattr(self, "skip") else x)


class ResidualBlockWithStride(nn.Module):
    """conv3x3(s) lrelu conv3x3 GDN (+ a 1x1(s) skip)."""

    def __init__(self, cin: int, cout: int, stride: int = 2):
        super().__init__()
        self.conv1, self.conv2 = conv(cin, cout, 3, stride), conv(cout, cout, 3, 1)
        self.gdn = GDN(cout)
        self.skip = conv(cin, cout, 1, stride)

    def forward(self, x):
        return self.gdn(self.conv2(leaky_relu(self.conv1(x)))) + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    """subpel lrelu conv3x3 IGDN + a subpel skip."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__()
        self.r = r
        self.subpel = conv(cin, cout * r * r, 3, 1)
        self.conv = conv(cout, cout, 3, 1)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = conv(cin, cout * r * r, 3, 1)

    def forward(self, x):
        out = self.igdn(self.conv(leaky_relu(subpel_conv(self.subpel, x, self.r))))
        return out + subpel_conv(self.upsample, x, self.r)


class ResidualUnit(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = conv(n, n // 2, 1, 1), conv(n // 2, n // 2, 3, 1), conv(n // 2, n, 1, 1)

    def forward(self, x):
        h = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(x + h)


class AttentionBlock(nn.Module):
    """cheng2020's attention: ``x + a * sigmoid(b)``, a and b three
    residual units each (b ends in a 1x1 conv)."""

    def __init__(self, n: int):
        super().__init__()
        self.conv_a = nn.ModuleList([ResidualUnit(n) for _ in range(3)])
        self.conv_b = nn.ModuleList([ResidualUnit(n) for _ in range(3)] + [conv(n, n, 1, 1)])

    def forward(self, x):
        a = x
        for unit in self.conv_a:
            a = unit(a)
        b = x
        for unit in self.conv_b:
            b = unit(b)
        return x + a * torch.sigmoid(b)


class Cheng2020(_Codec):
    """cheng2020-anchor, or with ``attn`` cheng2020-attn (the
    JointAutoregressive reconstruction and likelihoods)."""

    def __init__(self, n: int, attn: bool = False):
        super().__init__()
        self.attn = attn
        att = [AttentionBlock(n)] if attn else []
        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, n), ResidualBlock(n, n), ResidualBlockWithStride(n, n), *att,
            ResidualBlock(n, n), ResidualBlockWithStride(n, n), ResidualBlock(n, n), conv(n, n, 3, 2),
            *[AttentionBlock(n) for _ in att])
        self.g_s = nn.ModuleList([
            *[AttentionBlock(n) for _ in att], ResidualBlock(n, n), ResidualBlockUpsample(n, n), ResidualBlock(n, n),
            ResidualBlockUpsample(n, n), *[AttentionBlock(n) for _ in att], ResidualBlock(n, n),
            ResidualBlockUpsample(n, n), ResidualBlock(n, n), conv(n, 3 * 4, 3, 1)])
        self.h_a = nn.ModuleList([conv(n, n, 3, 1), conv(n, n, 3, 1), conv(n, n, 3, 2), conv(n, n, 3, 1),
                                  conv(n, n, 3, 2)])
        self.h_s = nn.ModuleList([conv(n, n, 3, 1), conv(n, n * 4, 3, 1), conv(n, n * 3 // 2, 3, 1),
                                  conv(n * 3 // 2, n * 3 // 2 * 4, 3, 1), conv(n * 3 // 2, n * 2, 3, 1)])
        self.context_prediction = conv(n, 2 * n, 5, 1)
        self.entropy_parameters = _entropy_parameters(n)
        self.eb = EntropyBottleneck(n)

    def forward(self, x):
        y = self.g_a(x)
        ha, hs = self.h_a, self.h_s
        z = ha[0](y)
        for layer in ha[1:]:
            z = layer(leaky_relu(z))
        z_hat, z_lik = self.eb(z)
        g = leaky_relu(hs[0](z_hat))
        g = leaky_relu(subpel_conv(hs[1], g))
        g = leaky_relu(hs[2](g))
        g = leaky_relu(subpel_conv(hs[3], g))
        hyper = hs[4](g)
        y_hat = st_round(y)
        scales, means = _context_params(self, hyper, y_hat)
        y_lik = gaussian_likelihood(y, scales, means)
        return self.synthesis(y_hat), [y_lik, z_lik]

    def synthesis(self, y_hat):
        h = y_hat
        for layer in self.g_s[:-1]:
            h = layer(h)
        return subpel_conv(self.g_s[-1], h)


#: arch -> the module built from the tree's widths (N, M)
FORWARDS = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": JointAutoregressive,
    "cheng2020-anchor": lambda n, m: Cheng2020(n, attn=False),
    "cheng2020-attn": lambda n, m: Cheng2020(n, attn=True),
}


def tree_nm(arch: str, tree: dict) -> Tuple[int, int]:
    """The widths (N, M) of a parameter tree of ``arch``."""
    if arch.startswith("cheng2020"):
        n = int(tree["g_a"][0]["conv1"]["kernel"].shape[3])
        return n, n
    return int(tree["g_a"][0]["kernel"].shape[3]), int(tree["g_a"][6]["kernel"].shape[3])


# ---------------------------------------------------------------------------
# state-dict conversion (numpy, the JAX package's converter and layout)
# ---------------------------------------------------------------------------

_PEDESTAL = float(2**-18) ** 2


def _nonneg(stored: np.ndarray, minimum: float) -> np.ndarray:
    """Invert compressai's NonNegativeParametrizer at load time."""
    bound = (minimum + _PEDESTAL) ** 0.5
    return np.maximum(stored, bound) ** 2 - _PEDESTAL


def _cv(sd, p):
    out = {"kernel": np.ascontiguousarray(np.transpose(sd[p + ".weight"], (2, 3, 1, 0)))}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _dcv(sd, p):
    """ConvTranspose2d weight [I, O, kh, kw] -> flipped [kh, kw, I, O]."""
    w = np.transpose(sd[p + ".weight"], (2, 3, 0, 1))[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w)}
    if p + ".bias" in sd:
        out["bias"] = np.asarray(sd[p + ".bias"])
    return out


def _gdn(sd, p):
    beta = _nonneg(np.asarray(sd[p + ".beta"]), 1e-6)
    gamma = _nonneg(np.asarray(sd[p + ".gamma"]), 0.0)
    return {"beta": beta, "gamma_t": np.ascontiguousarray(gamma.T)}


def _masked_cv(sd, p):
    """MaskedConv2d type A: zero the center and everything after it."""
    w = np.array(sd[p + ".weight"])
    _, _, kh, kw = w.shape
    w[:, :, kh // 2, kw // 2:] = 0.0
    w[:, :, kh // 2 + 1:, :] = 0.0
    return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))), "bias": np.asarray(sd[p + ".bias"])}


def _eb(sd, prefix="entropy_bottleneck"):
    mats, biases, factors = [], [], []
    i = 0
    while f"{prefix}._matrix{i}" in sd:
        mats.append(np.asarray(sd[f"{prefix}._matrix{i}"]))
        biases.append(np.asarray(sd[f"{prefix}._bias{i}"]))
        if f"{prefix}._factor{i}" in sd:
            factors.append(np.asarray(sd[f"{prefix}._factor{i}"]))
        i += 1
    if not mats:
        raise KeyError(f"no EntropyBottleneck params under '{prefix}.' — is this a compressai checkpoint?")
    return {"matrices": mats, "biases": biases, "factors": factors,
            "quantiles": np.asarray(sd[f"{prefix}.quantiles"])}


def _seq_convs(sd, prefix, layers):
    """A Sequential's (index, kind) layers, kind in {conv, deconv, gdn, subpel}."""
    out = []
    for idx, kind in layers:
        p = f"{prefix}.{idx}"
        if kind == "conv":
            out.append(_cv(sd, p))
        elif kind == "deconv":
            out.append(_dcv(sd, p))
        elif kind == "gdn":
            out.append(_gdn(sd, p))
        elif kind == "subpel":
            out.append(_cv(sd, p + ".0"))
        else:
            raise ValueError(kind)
    return out


def _res_block(sd, p):
    out = {"conv1": _cv(sd, p + ".conv1"), "conv2": _cv(sd, p + ".conv2")}
    if p + ".skip.weight" in sd:
        out["skip"] = _cv(sd, p + ".skip")
    return out


def _res_block_stride(sd, p):
    out = {"conv1": _cv(sd, p + ".conv1"), "conv2": _cv(sd, p + ".conv2"), "gdn": _gdn(sd, p + ".gdn")}
    if p + ".skip.weight" in sd:
        out["skip"] = _cv(sd, p + ".skip")
    return out


def _res_block_up(sd, p):
    return {"subpel": _cv(sd, p + ".subpel_conv.0"), "conv": _cv(sd, p + ".conv"), "igdn": _gdn(sd, p + ".igdn"),
            "upsample": _cv(sd, p + ".upsample.0")}


def _attn_block(sd, p):
    def units(branch, n):
        return [{"conv1": _cv(sd, f"{p}.{branch}.{j}.conv.0"), "conv2": _cv(sd, f"{p}.{branch}.{j}.conv.2"),
                 "conv3": _cv(sd, f"{p}.{branch}.{j}.conv.4")} for j in range(n)]

    return {"conv_a": units("conv_a", 3), "conv_b": units("conv_b", 3) + [_cv(sd, p + ".conv_b.3")]}


_GA_LAYERS = [(0, "conv"), (1, "gdn"), (2, "conv"), (3, "gdn"), (4, "conv"), (5, "gdn"), (6, "conv")]
_GS_LAYERS = [(0, "deconv"), (1, "gdn"), (2, "deconv"), (3, "gdn"), (4, "deconv"), (5, "gdn"), (6, "deconv")]


def convert_compressai(sd: Dict[str, np.ndarray], arch: str) -> dict:
    """A compressai zoo state dict (numpy) -> the parameter tree of
    ``arch`` (the JAX package's layout: HWIO kernels, deconv kernels
    flipped, GDN de-reparametrized, the context mask applied).

    Layouts: compressai/models/google.py (FactorizedPrior, ScaleHyperprior,
    MeanScaleHyperprior, JointAutoregressiveHierarchicalPriors) and
    waseda.py (Cheng2020Anchor/Attention).
    """
    if arch == "bmshj2018-factorized":
        return {"g_a": _seq_convs(sd, "g_a", _GA_LAYERS), "g_s": _seq_convs(sd, "g_s", _GS_LAYERS), "eb": _eb(sd)}
    if arch == "bmshj2018-hyperprior":
        return {
            "g_a": _seq_convs(sd, "g_a", _GA_LAYERS), "g_s": _seq_convs(sd, "g_s", _GS_LAYERS),
            "h_a": _seq_convs(sd, "h_a", [(0, "conv"), (2, "conv"), (4, "conv")]),
            "h_s": _seq_convs(sd, "h_s", [(0, "deconv"), (2, "deconv"), (4, "conv")]),
            "eb": _eb(sd),
        }
    if arch in ("mbt2018-mean", "mbt2018"):
        params = {
            "g_a": _seq_convs(sd, "g_a", _GA_LAYERS), "g_s": _seq_convs(sd, "g_s", _GS_LAYERS),
            "h_a": _seq_convs(sd, "h_a", [(0, "conv"), (2, "conv"), (4, "conv")]),
            "h_s": _seq_convs(sd, "h_s", [(0, "deconv"), (2, "deconv"), (4, "conv")]),
            "eb": _eb(sd),
        }
        if arch == "mbt2018":
            params["context_prediction"] = _masked_cv(sd, "context_prediction")
            params["entropy_parameters"] = _seq_convs(sd, "entropy_parameters", [(0, "conv"), (2, "conv"), (4, "conv")])
        return params
    if arch in ("cheng2020-anchor", "cheng2020-attn"):
        if arch == "cheng2020-attn":
            g_a = [_res_block_stride(sd, "g_a.0"), _res_block(sd, "g_a.1"), _res_block_stride(sd, "g_a.2"),
                   _attn_block(sd, "g_a.3"), _res_block(sd, "g_a.4"), _res_block_stride(sd, "g_a.5"),
                   _res_block(sd, "g_a.6"), _cv(sd, "g_a.7"), _attn_block(sd, "g_a.8")]
            g_s = [_attn_block(sd, "g_s.0"), _res_block(sd, "g_s.1"), _res_block_up(sd, "g_s.2"),
                   _res_block(sd, "g_s.3"), _res_block_up(sd, "g_s.4"), _attn_block(sd, "g_s.5"),
                   _res_block(sd, "g_s.6"), _res_block_up(sd, "g_s.7"), _res_block(sd, "g_s.8"), _cv(sd, "g_s.9.0")]
        else:
            g_a = [_res_block_stride(sd, "g_a.0"), _res_block(sd, "g_a.1"), _res_block_stride(sd, "g_a.2"),
                   _res_block(sd, "g_a.3"), _res_block_stride(sd, "g_a.4"), _res_block(sd, "g_a.5"), _cv(sd, "g_a.6")]
            g_s = [_res_block(sd, "g_s.0"), _res_block_up(sd, "g_s.1"), _res_block(sd, "g_s.2"),
                   _res_block_up(sd, "g_s.3"), _res_block(sd, "g_s.4"), _res_block_up(sd, "g_s.5"),
                   _res_block(sd, "g_s.6"), _cv(sd, "g_s.7.0")]
        return {
            "g_a": g_a, "g_s": g_s,
            "h_a": _seq_convs(sd, "h_a", [(0, "conv"), (2, "conv"), (4, "conv"), (6, "conv"), (8, "conv")]),
            "h_s": _seq_convs(sd, "h_s", [(0, "conv"), (2, "subpel"), (4, "conv"), (6, "subpel"), (8, "conv")]),
            "context_prediction": _masked_cv(sd, "context_prediction"),
            "entropy_parameters": _seq_convs(sd, "entropy_parameters", [(0, "conv"), (2, "conv"), (4, "conv")]),
            "eb": _eb(sd),
        }
    raise ValueError(f"unknown compressai arch: {arch}")
