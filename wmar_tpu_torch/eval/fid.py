"""FID: the FID InceptionV3 and the Frechet distance (PyTorch port of
``wmar_tpu.eval.fid``).

The reference writes an ``--orig_only`` tree for outside FID tools (the
paper reports FID; its repository ships no scorer). This module scores it:

- :class:`FIDInceptionV3`, the pytorch-fid / TF "inception-2015-12-05"
  variant of torchvision's ``inception_v3`` with its state-dict names
  (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
  ...): BasicConv2d is conv + BatchNorm (eps 1e-3) + relu; the towers'
  average pools leave the padding out of the count; Mixed_7c's pool branch
  is a max pool; the features are the 2048-d final average pool ("pool3").
  Its widths come from the state dict, so reduced-width weights load too.
- :func:`preprocess`: pytorch-fid's ``resize_input`` and
  ``normalize_input``, ``F.interpolate(..., (299, 299), mode="bilinear",
  align_corners=False)`` without antialiasing, then [-1, 1]. The JAX
  package resizes with ``jax.image.resize``, which antialiases when it
  shrinks, so a 512 px image (Chameleon's) differs there by up to 0.5
  (ROADMAP queue 3, fault (i)).
- :func:`frechet_distance`: pytorch-fid's, with scipy on the host.

CLI (``--device`` defaults to ``cuda`` and never falls back to the CPU)::

    python -m wmar_tpu_torch.eval.fid DIR1 DIR2 --weights pt_inception.pth
    python -m wmar_tpu_torch.eval.fid DIR1 unused --weights w.pth --save_stats ref.npz
    python -m wmar_tpu_torch.eval.fid ref.npz DIR2 --weights w.pth
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BLOCK_BRANCHES = {
    "a": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "b": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "c": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "d": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
          "branch7x7x3_3", "branch7x7x3_4"],
    "e": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
          "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
          "branch3x3dbl_3b", "branch_pool"],
}

_LAYOUT = [
    ("Conv2d_1a_3x3", None), ("Conv2d_2a_3x3", None), ("Conv2d_2b_3x3", None),
    ("Conv2d_3b_1x1", None), ("Conv2d_4a_3x3", None),
    ("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"),
    ("Mixed_6a", "b"),
    ("Mixed_6b", "c"), ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"),
    ("Mixed_7a", "d"),
    ("Mixed_7b", "e"), ("Mixed_7c", "e"),
]

# BasicConv2d layers with stride 2; these and the stem's 2a and 4a take no padding
_STRIDE_2 = {"Conv2d_1a_3x3", "Mixed_6a.branch3x3", "Mixed_6a.branch3x3dbl_3", "Mixed_7a.branch3x3_2",
             "Mixed_7a.branch7x7x3_4"}
_VALID = _STRIDE_2 | {"Conv2d_2a_3x3", "Conv2d_4a_3x3"}

# torchvision's inception_v3 widths: (in, out, kh, kw) of every BasicConv2d
_A = lambda cin, pf: {"branch1x1": (cin, 64, 1, 1), "branch5x5_1": (cin, 48, 1, 1),  # noqa: E731
                      "branch5x5_2": (48, 64, 5, 5), "branch3x3dbl_1": (cin, 64, 1, 1),
                      "branch3x3dbl_2": (64, 96, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3),
                      "branch_pool": (cin, pf, 1, 1)}
_C = lambda c7: {"branch1x1": (768, 192, 1, 1), "branch7x7_1": (768, c7, 1, 1),  # noqa: E731
                 "branch7x7_2": (c7, c7, 1, 7), "branch7x7_3": (c7, 192, 7, 1), "branch7x7dbl_1": (768, c7, 1, 1),
                 "branch7x7dbl_2": (c7, c7, 7, 1), "branch7x7dbl_3": (c7, c7, 1, 7),
                 "branch7x7dbl_4": (c7, c7, 7, 1), "branch7x7dbl_5": (c7, 192, 1, 7),
                 "branch_pool": (768, 192, 1, 1)}
_E = lambda cin: {"branch1x1": (cin, 320, 1, 1), "branch3x3_1": (cin, 384, 1, 1),  # noqa: E731
                  "branch3x3_2a": (384, 384, 1, 3), "branch3x3_2b": (384, 384, 3, 1),
                  "branch3x3dbl_1": (cin, 448, 1, 1), "branch3x3dbl_2": (448, 384, 3, 3),
                  "branch3x3dbl_3a": (384, 384, 1, 3), "branch3x3dbl_3b": (384, 384, 3, 1),
                  "branch_pool": (cin, 192, 1, 1)}
_WIDTHS = {
    "Conv2d_1a_3x3": (3, 32, 3, 3), "Conv2d_2a_3x3": (32, 32, 3, 3), "Conv2d_2b_3x3": (32, 64, 3, 3),
    "Conv2d_3b_1x1": (64, 80, 1, 1), "Conv2d_4a_3x3": (80, 192, 3, 3),
    "Mixed_5b": _A(192, 32), "Mixed_5c": _A(256, 64), "Mixed_5d": _A(288, 64),
    "Mixed_6a": {"branch3x3": (288, 384, 3, 3), "branch3x3dbl_1": (288, 64, 1, 1), "branch3x3dbl_2": (64, 96, 3, 3),
                 "branch3x3dbl_3": (96, 96, 3, 3)},
    "Mixed_6b": _C(128), "Mixed_6c": _C(160), "Mixed_6d": _C(160), "Mixed_6e": _C(192),
    "Mixed_7a": {"branch3x3_1": (768, 192, 1, 1), "branch3x3_2": (192, 320, 3, 3), "branch7x7x3_1": (768, 192, 1, 1),
                 "branch7x7x3_2": (192, 192, 1, 7), "branch7x7x3_3": (192, 192, 7, 1),
                 "branch7x7x3_4": (192, 192, 3, 3)},
    "Mixed_7b": _E(1280), "Mixed_7c": _E(2048),
}


def inception_state_dict_shapes(div: int = 1, num_classes: int = 1008) -> Dict[str, tuple]:
    """The shape of every tensor of the FID InceptionV3's state dict
    (pytorch-fid's ``pt_inception`` names, its 1008-way ``fc`` included)
    with every width but the 3 input channels divided by ``div``."""
    shapes = {}
    for name, kind in _LAYOUT:
        convs = {name: _WIDTHS[name]} if kind is None else {f"{name}.{b}": _WIDTHS[name][b]
                                                             for b in _BLOCK_BRANCHES[kind]}
        for prefix, (cin, cout, kh, kw) in convs.items():
            cin, cout = cin if cin == 3 else cin // div, cout // div
            shapes[f"{prefix}.conv.weight"] = (cout, cin, kh, kw)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}.bn.{leaf}"] = (cout,)
    shapes["fc.weight"], shapes["fc.bias"] = (num_classes, 2048 // div), (num_classes,)
    return shapes


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                                   bn.eps))


def _avg_pool_nip(x):
    """3x3 stride-1 average pool that leaves the padding out of the count (the FID towers)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class _Tower(nn.Module):
    """One Mixed block: its BasicConv2d branches and the concat of kind ``kind``."""

    def __init__(self, kind: str, convs: Dict[str, BasicConv2d], max_pool_branch: bool = False):
        super().__init__()
        self.kind, self.max_pool_branch = kind, max_pool_branch
        for name, conv in convs.items():
            self.add_module(name, conv)

    def forward(self, x):
        p = lambda name, h: getattr(self, name)(h)  # noqa: E731
        if self.kind == "a":
            b5 = p("branch5x5_2", p("branch5x5_1", x))
            b3 = p("branch3x3dbl_3", p("branch3x3dbl_2", p("branch3x3dbl_1", x)))
            return torch.cat([p("branch1x1", x), b5, b3, p("branch_pool", _avg_pool_nip(x))], 1)
        if self.kind == "b":
            bd = p("branch3x3dbl_3", p("branch3x3dbl_2", p("branch3x3dbl_1", x)))
            return torch.cat([p("branch3x3", x), bd, F.max_pool2d(x, 3, 2)], 1)
        if self.kind == "c":
            b7 = p("branch7x7_3", p("branch7x7_2", p("branch7x7_1", x)))
            bd = x
            for i in range(1, 6):
                bd = p(f"branch7x7dbl_{i}", bd)
            return torch.cat([p("branch1x1", x), b7, bd, p("branch_pool", _avg_pool_nip(x))], 1)
        if self.kind == "d":
            b3 = p("branch3x3_2", p("branch3x3_1", x))
            b7 = x
            for i in range(1, 5):
                b7 = p(f"branch7x7x3_{i}", b7)
            return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)
        b3 = p("branch3x3_1", x)
        b3 = torch.cat([p("branch3x3_2a", b3), p("branch3x3_2b", b3)], 1)
        bd = p("branch3x3dbl_2", p("branch3x3dbl_1", x))
        bd = torch.cat([p("branch3x3dbl_3a", bd), p("branch3x3dbl_3b", bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.max_pool_branch else _avg_pool_nip(x)  # Mixed_7c: the TF port's max
        return torch.cat([p("branch1x1", x), b3, bd, p("branch_pool", bp)], 1)


class FIDInceptionV3(nn.Module):
    """``x [B, 3, H, W]`` in [-1, 1] (H, W >= 75) -> pool3 features ``[B, C]``,
    torchvision's topology with the FID pools. ``shapes``: each BasicConv2d's
    ``conv.weight`` shape by its state-dict prefix."""

    def __init__(self, shapes: Dict[str, tuple]):
        super().__init__()
        for name, kind in _LAYOUT:
            prefixes = [name] if kind is None else [f"{name}.{b}" for b in _BLOCK_BRANCHES[kind]]
            convs = {}
            for prefix in prefixes:
                cout, cin, kh, kw = shapes[prefix]
                pad = (0, 0) if prefix in _VALID else (kh // 2, kw // 2)
                convs[prefix.split(".")[-1]] = BasicConv2d(cin, cout, (kh, kw), 2 if prefix in _STRIDE_2 else 1, pad)
            self.add_module(name, convs[name] if kind is None else _Tower(kind, convs, name == "Mixed_7c"))

    @staticmethod
    def from_state_dict(sd, device="cpu") -> "FIDInceptionV3":
        """The module at the widths of ``sd`` (torchvision / pytorch-fid
        names; numpy or tensor values; ``fc``, ``AuxLogits`` and
        ``num_batches_tracked`` are ignored) with its weights on ``device``,
        float32. A missing tensor raises ``KeyError``."""
        shapes = {k[: -len(".conv.weight")]: tuple(v.shape) for k, v in sd.items() if k.endswith(".conv.weight")}
        with torch.device("meta"):
            model = FIDInceptionV3(shapes)
        model = model.to_empty(device=device)
        own = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
        missing = sorted(own - set(sd))
        if missing:
            raise KeyError(f"the Inception state dict lacks {missing[:5]}")
        with torch.no_grad():
            for key, t in model.state_dict().items():
                v = sd[key] if key in own else 0  # num_batches_tracked: unused in eval
                t.copy_(torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), dtype=t.dtype))
        return model.eval()

    def forward(self, x):
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = F.max_pool2d(h, 3, 2)
        h = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)), 3, 2)
        for name, kind in _LAYOUT[5:]:
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))  # the adaptive average pool to 1x1


def preprocess(imgs01: torch.Tensor, size: int = 299) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> ``[B, 3, size, size]`` in [-1, 1]: pytorch-fid's
    bilinear resize (``align_corners=False``, no antialiasing), then ``2x - 1``."""
    x = imgs01.float().permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return 2.0 * x - 1.0


def convert_inception(sd) -> dict:
    """torchvision/pytorch-fid InceptionV3 state dict -> the JAX package's
    forward params (per BasicConv2d ``kernel`` HWIO, ``scale``, ``bias``,
    ``mean``, ``var``). Ignores the classifier (``fc``) and aux heads;
    shape-driven, so reduced-width weights convert too."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def cv_bn(prefix):
        return {
            "kernel": np.ascontiguousarray(np.transpose(sd[prefix + ".conv.weight"], (2, 3, 1, 0))),
            "scale": sd[prefix + ".bn.weight"], "bias": sd[prefix + ".bn.bias"],
            "mean": sd[prefix + ".bn.running_mean"], "var": sd[prefix + ".bn.running_var"],
        }

    params: Dict[str, dict] = {}
    for name, kind in _LAYOUT:
        params[name] = cv_bn(name) if kind is None else {b: cv_bn(f"{name}.{b}") for b in _BLOCK_BRANCHES[kind]}
    return params


# ---------------------------------------------------------------------------
# statistics + Frechet distance
# ---------------------------------------------------------------------------


@torch.inference_mode()
def compute_activations(model: FIDInceptionV3, imgs01: np.ndarray, batch_size: int = 32) -> np.ndarray:
    """``[N, H, W, 3]`` in [0, 1] -> ``[N, C]`` pool3 features, in batches
    of ``batch_size`` on the model's device."""
    device = next(model.parameters()).device
    feats: List[np.ndarray] = []
    for i in range(0, imgs01.shape[0], batch_size):
        chunk = torch.as_tensor(np.asarray(imgs01[i: i + batch_size], np.float32), device=device)
        feats.append(model(preprocess(chunk)).cpu().numpy())
    return np.concatenate(feats, axis=0)


def compute_statistics(model: FIDInceptionV3, imgs01: np.ndarray, batch_size: int = 32):
    acts = compute_activations(model, imgs01, batch_size)
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """pytorch-fid's calculate_frechet_distance, including the eps-jitter
    retry and imaginary-part check. ``sqrtm`` is called without pytorch-fid's
    ``disp=False`` (deprecated in SciPy 1.17, gone in 1.18): the same root."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


# ---------------------------------------------------------------------------
# directory workflow (the generate --orig_only tree)
# ---------------------------------------------------------------------------


def _load_images(path: str, limit: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    files = sorted(
        os.path.join(root, f)
        for root, _, fs in os.walk(path)
        for f in fs if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    imgs = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0 for f in files]
    return np.stack(imgs)


def fid_from_dirs(model: FIDInceptionV3, dir1: str, dir2: str, batch_size: int = 32,
                  limit: Optional[int] = None) -> float:
    m1, s1 = compute_statistics(model, _load_images(dir1, limit), batch_size)
    m2, s2 = compute_statistics(model, _load_images(dir2, limit), batch_size)
    return frechet_distance(m1, s1, m2, s2)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from wmar_tpu_torch.augmentations.neural import read_state_dict

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("dirs", nargs=2, help="two image directories (or .npz stats files)")
    p.add_argument("--weights", required=True,
                   help="pt_inception/torchvision inception_v3 state dict (.pth)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--save_stats", type=str, default=None,
                   help="save (mu, sigma) of dirs[0] to this .npz and exit")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    model = FIDInceptionV3.from_state_dict(read_state_dict(args.weights), device)

    def stats(path):
        if path.endswith(".npz"):
            z = np.load(path)
            return z["mu"], z["sigma"]
        return compute_statistics(model, _load_images(path, args.limit), args.batch_size)

    if args.save_stats:
        mu, sigma = stats(args.dirs[0])
        np.savez(args.save_stats, mu=mu, sigma=sigma)
        print(f"saved stats to {args.save_stats}")
        return 0
    m1, s1 = stats(args.dirs[0])
    m2, s2 = stats(args.dirs[1])
    print(f"FID: {frechet_distance(m1, s1, m2, s2):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
