"""Convert LPIPS (VGG16 and its linear heads) weights to the msgpack file
that :func:`wmar_tpu_torch.finetune.perceptual.load_lpips` reads (PyTorch
port of ``tools/convert_lpips.py``; host-side).

    python -m wmar_tpu_torch.tools.convert_lpips --vgg_ckpt vgg16.pth \\
        --lpips_ckpt vgg.pth --out lpips_vgg.msgpack

``--vgg_ckpt`` is a torchvision VGG16 state dict (``features.<i>.*``),
``--lpips_ckpt`` the ``lpips`` package's head weights
(``lin<i>.model.1.weight``). Only files are read: the JAX tool's other
route, through the ``lpips`` package (which downloads VGG16 on first use),
is not ported.
"""

from __future__ import annotations

import argparse
import re

import torch

# VGG16 conv indices in torchvision's features Sequential, per LPIPS block.
_VGG_TORCH_IDX = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]


def _seq_idx(key: str) -> int:
    return int(re.search(r"(\d+)", key).group(1))


def convert_lpips_arrays(vgg_sd: dict, lins) -> dict:
    """A VGG16 Sequential conv state dict and optional lin-head weights ->
    the flax LPIPS params. Sorted by the numeric Sequential index:
    alphabetical order would scramble the blocks ("features.10" <
    "features.2")."""
    weights = sorted(((k, v) for k, v in vgg_sd.items() if k.endswith("weight") and torch.as_tensor(v).dim() == 4),
                     key=lambda kv: _seq_idx(kv[0]))
    biases = sorted(((k, v) for k, v in vgg_sd.items() if k.endswith("bias")), key=lambda kv: _seq_idx(kv[0]))
    params = {"vgg": {}}
    ci = 0
    for bi, idxs in enumerate(_VGG_TORCH_IDX):
        for j in range(len(idxs)):
            params["vgg"][f"conv{bi}_{j}"] = {"kernel": torch.as_tensor(weights[ci][1]).permute(2, 3, 1, 0).contiguous(),
                                              "bias": torch.as_tensor(biases[ci][1])}
            ci += 1
    if lins is not None:
        for i, w in enumerate(lins):
            params[f"lin{i}"] = {"kernel": torch.as_tensor(w).permute(2, 3, 1, 0).contiguous()}
    return params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--vgg_ckpt", required=True, help="torchvision vgg16 state dict")
    p.add_argument("--lpips_ckpt", default=None, help="LPIPS lin weights (optional)")
    args = p.parse_args(argv)

    from wmar_tpu_torch.utils.checkpoint import save_pytree
    from wmar_tpu_torch.utils.convert import load_torch_state_dict

    lins = None
    if args.lpips_ckpt:
        lin_sd = load_torch_state_dict(args.lpips_ckpt)  # lin{i}.model.1.weight [1, C, 1, 1]
        lins = [lin_sd[f"lin{i}.model.1.weight"] for i in range(5)]
    save_pytree(args.out, {"params": convert_lpips_arrays(load_torch_state_dict(args.vgg_ckpt), lins)})
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
