"""Standalone SyncSeal demo (PyTorch port of ``examples/standalone_sync.py``,
the reference's ``syncseal/notebooks/standalone.ipynb``).

Embed the sync signal, attack with an upper-left crop and a brightness
change, predict the corners, unwarp the attacked image back into the
canonical frame; report where the predicted corners landed against the
truth and how close the unwarped image is to the watermarked one. A second,
harsher pass is the notebook's failure case.

    python -m wmar_tpu_torch.examples.standalone_sync --outdir /tmp/sync_demo --tiny --device cpu

Random weights (JAX's ``SyncSealRef.init(0)``) by default, so the corners
are wrong and the point is the plumbing; ``--ckpt`` takes the released
``syncmodel`` state dict (``SyncSealRef.load_torch``) for real predictions.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch


def load_image(path: Optional[str], size: int, device=None) -> torch.Tensor:
    """``[1, H, W, 3]`` float32 in [0, 1]: the photo at ``path``, or a
    smooth random field with a checkerboard on red (from seed 0)."""
    from wmar_tpu_torch.augmentations.geometric import resize_cubic

    if path:
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("RGB").resize((size, size)), np.float32) / 255.0
        return torch.as_tensor(arr, device=device)[None]
    small = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    img = resize_cubic(small, (size, size))
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    img[..., 0] += 0.3 * ((xx // 32 + yy // 32) % 2)
    return torch.clamp(img, 0.0, 1.0).to(device)


def crop_corners(factor: float) -> np.ndarray:
    """Where the original TL/TR/BR/BL corners land (normalized x, y) after
    an upper-left crop of ``factor`` is resized back to the full frame."""
    s = 1.0 / factor
    return np.asarray([[0.0, 0.0], [s, 0.0], [s, s], [0.0, s]], np.float32)


@torch.no_grad()
def run_case(model, img01, factor: float, bright: float, tag: str, outdir: str) -> float:
    from wmar_tpu_torch.augmentations.geometric import upper_left_crop_resize_back
    from wmar_tpu_torch.augmentations.valuemetric import brightness
    from wmar_tpu_torch.sync.homography import unwarp_from_corners
    from wmar_tpu_torch.sync.syncseal import TV_TO_SOLVER
    from wmar_tpu_torch.utils.metrics import psnr

    imgs_w01 = model.embed01(img01)
    attacked = brightness(upper_left_crop_resize_back(imgs_w01, factor), bright)
    preds = model.detect01(attacked)
    pred_tv = ((preds[:, 1:].reshape(-1, 4, 2) + 1.0) / 2.0).cpu().numpy()  # TL TR BR BL
    target_tv = crop_corners(factor)[None]
    err_px = float(np.linalg.norm((pred_tv - target_tv) * img01.shape[1], axis=-1).mean())
    unwarped = unwarp_from_corners(attacked, torch.as_tensor(pred_tv, device=attacked.device)[:, TV_TO_SOLVER])
    rec_psnr, wm_psnr = psnr(unwarped.cpu(), imgs_w01.cpu(), 1.0), psnr(imgs_w01.cpu(), img01.cpu(), 1.0)
    print(f"[{tag}] crop {factor:.2f} + brightness {bright:.2f}: detect logit {float(preds[0, 0]):+.3f}, "
          f"mean corner error {err_px:.1f} px, unwarp PSNR {rec_psnr:.1f} dB (embed PSNR {wm_psnr:.1f} dB)")
    for name, pts in (("pred", pred_tv[0]), ("true", target_tv[0])):
        print(f"    {name} corners (TL TR BR BL, norm xy): " + ", ".join(f"({x:.2f},{y:.2f})" for x, y in pts))
    try:
        from PIL import Image

        panel = np.concatenate([a[0].cpu().numpy() for a in (img01, imgs_w01, attacked, unwarped)], axis=1)
        path = os.path.join(outdir, f"sync_{tag}.png")
        Image.fromarray((np.clip(panel, 0, 1) * 255).astype(np.uint8)).save(path)
        print(f"    panel (orig | embedded | attacked | unwarped): {path}")
    except ImportError as e:
        print(f"    (no panel written: {e})")
    return err_px


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="sync_demo")
    p.add_argument("--image", default=None, help="input photo (procedural if absent)")
    p.add_argument("--ckpt", default=None, help="the released syncmodel state dict")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--tiny", action="store_true", help="tiny random model (fast smoke)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; there is no fallback")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("standalone_sync: no CUDA card visible; pass --device cpu to run on the CPU")
    os.makedirs(args.outdir, exist_ok=True)

    from wmar_tpu_torch.sync import syncseal_models as sm
    from wmar_tpu_torch.sync.syncseal import SyncSealRef

    if args.ckpt:
        model = SyncSealRef.load_torch(args.ckpt, device=device)
    elif args.tiny:
        model = SyncSealRef.init(0, unet_cfg=sm.UNetConfig(z_channels=8, num_blocks=1, z_channels_mults=(1, 2),
                                                           norm_groups=4),
                                 convnext_cfg=sm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16)), device=device)
    else:
        model = SyncSealRef.init(0, device=device)
    img01 = load_image(args.image, args.img_size, device)
    # the notebook's main case (a mild crop), then its failure case (a crop outside the training range)
    return {"ok": run_case(model, img01, 0.7, 1.2, "ok", args.outdir),
            "hard": run_case(model, img01, 0.35, 1.5, "hard", args.outdir)}


if __name__ == "__main__":
    main(sys.argv[1:])
