"""Watermark robustness evaluated through the sync layer (PyTorch port of
``wmar_tpu.sync.eval_wm``, the reference's ``syncseal/syncseal/evals/
eval_wm.py:1-402``): embed a baseline watermark, add the synchronization
signal on top, attack with the geometric x valuemetric grid, invert the
geometry from the sync model's corner predictions, extract the watermark
from the unwarped images, and write bit accuracy, log10 p-value and corner
error per grid cell to a CSV in the reference's columns, with a grouped
summary.

As in JAX, every geometric attack is a corner homography applied by one
``apply_tv_corner_warp``, and each cell runs batched over the images.
The models run on ``--device`` (default ``cuda``; there is no fallback).

    python -m wmar_tpu_torch.sync.eval_wm --baseline ss --sync_model syncseal \\
        --tiny --num_samples 4 --img_size 64 --only_identity true --device cpu \\
        --output_dir /tmp/wm_sync_eval
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from wmar_tpu_torch.augmentations import valuemetric as V
from wmar_tpu_torch.augmentations.geometric import resize_cubic
from wmar_tpu_torch.sync.baselines import EmbedderExtractor, bit_accuracy, build_baseline, mean_like_jax, pvalue
from wmar_tpu_torch.sync.homography import unwarp_from_corners
from wmar_tpu_torch.sync.syncseal import (
    TV_CORNERS,
    TV_TO_SOLVER,
    SyncSealRef,
    apply_tv_corner_warp,
    sift_ransac_corners,
    wam_corner_baseline,
)

CSV_HEADER = ("index,geom_aug,geom_strength,val_aug,val_strength,bit_accuracy,log_pvalue,corner_error,"
              "wm_embed_time,sync_embed_time,sync_detect_time,unwrap_time,wm_detect_time")

# ---------------------------------------------------------------------------
# The geometric grid as corner endpoints (eval_wm.py:69-98)
# ---------------------------------------------------------------------------

GEOM_GRID: Dict[str, List[float]] = {
    "identity": [0],
    "hflip": [0],
    "rotate": [5, 10, 20, 30, 45, 90],
    "crop": [0.1, 0.2, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9],
    "perspective": [0.1, 0.2, 0.3, 0.4, 0.5],
}


def geom_endpoints(name: str, param: float, rng: np.random.Generator, batch: int,
                   topleft_crop: bool = False) -> np.ndarray:
    """Where the original TL/TR/BR/BL corners land, ``[B, 4, 2]`` in [0, 1]
    (numpy, JAX's arithmetic and draws). ``crop``'s param is the retained
    area (torchvision ``RandomResizedCrop``), anchored at the origin with
    ``topleft_crop`` (the reference's ``WAMSyncModel`` runs, eval_wm.py:90-92);
    ``perspective`` moves each corner inward by up to ``param / 2``."""
    canon = np.asarray(TV_CORNERS)
    center = np.asarray([0.5, 0.5], np.float32)
    out = np.tile(canon[None], (batch, 1, 1)).astype(np.float32)
    if name == "identity":
        pass
    elif name == "hflip":
        out[:, :, 0] = 1.0 - out[:, :, 0]
    elif name == "rotate":
        theta = np.deg2rad(param)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.asarray([[c, -s], [s, c]], np.float32)
        out = (out - center) @ rot.T + center
    elif name == "crop":
        f = float(np.sqrt(param))  # the linear fraction of the area ratio
        out = out / f if topleft_crop else (out - center) / f + center
    elif name == "perspective":
        inward = np.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
        jitter = rng.uniform(0.0, param / 2.0, size=(batch, 4, 2)).astype(np.float32)
        out = out + jitter * inward
    else:
        raise ValueError(f"unknown geometric aug: {name}")
    return out


# ---------------------------------------------------------------------------
# The valuemetric grid (augmentation/__init__.py get_validation_augs)
# ---------------------------------------------------------------------------


def valuemetric_grid(only_identity: bool = False) -> List[Tuple[str, list, Callable]]:
    """``(name, strengths, fn(imgs01, strength) -> imgs01)`` rows of
    ``get_validation_augs(only_valuemetric=True)``: 21 cells, or identity."""
    if only_identity:
        return [("identity", [0], lambda x, s: x)]

    def jpeg_brightness(x, s):
        q, b = s
        return V.clip01(V.brightness(V.jpeg_diff(V.clip01(x), q), b))

    return [
        ("identity", [0], lambda x, s: x),
        ("brightness", [0.5, 1.5, 2.0], lambda x, s: V.clip01(V.brightness(x, s))),
        ("contrast", [0.5, 1.5, 2.0], lambda x, s: V.clip01(V.contrast(x, s))),
        ("hue", [-0.2, -0.1, 0.1, 0.2], lambda x, s: V.clip01(V.hue(x, s))),
        ("grayscale", [-1], lambda x, s: V.grayscale(x)),
        ("jpeg", [20, 40, 60, 80], lambda x, s: V.jpeg_diff(V.clip01(x), int(s))),
        ("gaussian_blur", [3, 9, 17], lambda x, s: V.gaussian_blur(x, int(s))),
        ("jpeg+brightness", [(40, 2.0), (80, 2.0)], jpeg_brightness),
    ]


# ---------------------------------------------------------------------------
# Sync models (eval_wm.py:293-328 load_sync_model)
# ---------------------------------------------------------------------------


class SiftSync:
    """SIFT+RANSAC corners against the pre-attack watermarked image
    (``SIFTSyncModel``, sync_model.py:273-360), on the host."""

    needs_reference = True

    def predict_corners(self, attacked01: torch.Tensor, reference01: torch.Tensor) -> np.ndarray:
        b = attacked01.shape[0]
        out = np.tile(np.asarray(TV_CORNERS)[None], (b, 1, 1)).astype(np.float32)
        att, ref = attacked01.cpu().numpy(), reference01.cpu().numpy()
        for i in range(b):
            est = sift_ransac_corners(ref[i], att[i])
            if est is not None:
                out[i] = est
        return out


class SyncSealSync:
    """Corner regression by the SyncSeal extractor."""

    needs_reference = False

    def __init__(self, model: SyncSealRef):
        self.model = model

    @torch.no_grad()
    def predict_corners(self, attacked01, reference01=None) -> np.ndarray:
        preds = self.model.detect01(attacked01)
        return ((preds[:, 1:].reshape(-1, 4, 2) + 1.0) / 2.0).float().cpu().numpy()


class WamSyncBaseline:
    """The WAM quadrant-logic corner baseline (``WAMSyncModel``,
    sync_model.py:363-448) over ``wam_logic.WamSync``."""

    needs_reference = False

    def __init__(self, wam_sync):
        self.wam_sync = wam_sync

    def predict_corners(self, attacked01, reference01=None) -> np.ndarray:
        pred = wam_corner_baseline(self.wam_sync, attacked01 * 2.0 - 1.0)  # [B, 8] in [-1, 1]
        return ((pred.reshape(-1, 4, 2) + 1.0) / 2.0).astype(np.float32)


def load_sync(name: str, sync_path: Optional[str] = None, tiny: bool = False, device=None):
    """'none' | 'sift' | 'syncseal' (JAX's msgpack at ``sync_path``, or with
    ``tiny`` JAX's ``SyncSealRef.init(0)`` weights) | 'wam' (``wam_mit.pth``
    at ``sync_path``, or random with ``tiny``)."""
    if name == "none":
        return None
    if name in ("sift", "baseline/sift"):
        return SiftSync()
    if name == "syncseal":
        if sync_path:
            return SyncSealSync(SyncSealRef.load(sync_path, device=device))
        if tiny:
            return SyncSealSync(SyncSealRef.init(0, device=device))
        raise ValueError("syncseal sync needs --sync_path (msgpack) or --tiny")
    if name in ("wam", "baseline/wam"):
        from wmar_tpu_torch.sync.wam_exact import WamExact, init_wam
        from wmar_tpu_torch.sync.wam_logic import WamSync

        if sync_path:
            wam = WamExact.load(sync_path, device=device)
        elif tiny:
            wam = init_wam(0, device=device)
        else:
            raise ValueError("wam sync needs --sync_path (wam_mit.pth) or --tiny")
        return WamSyncBaseline(WamSync(wam))
    raise ValueError(f"unknown sync model: {name}")


# ---------------------------------------------------------------------------
# The evaluation loop (eval_wm.py:46-267)
# ---------------------------------------------------------------------------


def _timer(device):
    """A stopwatch that synchronizes a CUDA ``device`` at both ends."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()

    def stop():
        sync()
        return time.perf_counter() - t0
    return stop


@torch.no_grad()
def evaluate_watermark_with_sync(baseline: EmbedderExtractor, sync, imgs01: torch.Tensor, output_dir: str,
                                 only_identity: bool = False, seed: int = 0, topleft_crop: bool = False,
                                 geoms: Optional[Dict[str, List[float]]] = None,
                                 msgs: Optional[torch.Tensor] = None) -> List[dict]:
    """The grid over ``imgs01 [B, H, W, 3]`` (on its device): writes
    ``watermark_sync_metrics.csv`` (the reference's columns) and returns the
    rows. ``msgs`` feeds the messages (else drawn from ``seed``); the
    perspective jitter is numpy's from ``seed``, as in JAX."""
    os.makedirs(output_dir, exist_ok=True)
    csv_path = os.path.join(output_dir, "watermark_sync_metrics.csv")
    dev = imgs01.device
    b, h, w, _ = imgs01.shape
    rng = np.random.default_rng(seed)
    if msgs is None:
        msgs = baseline.get_random_msg(torch.Generator().manual_seed(seed), b)
    msgs = msgs.to(dev)

    tic = _timer(dev)
    imgs_wm = baseline.embed(imgs01, msgs)["imgs_w"]
    wm_embed_time = tic()
    tic = _timer(dev)
    if isinstance(sync, SyncSealSync):
        imgs_sync = V.clip01(sync.model.embed01(imgs_wm))
    else:
        imgs_sync = imgs_wm  # SIFT, WAM and none add no signal of their own
    sync_embed_time = tic()

    # only_identity trims the valuemetric axis (eval_wm.py:63-66); the geometric one runs whole
    geoms = GEOM_GRID if geoms is None else geoms
    vgrid = valuemetric_grid(only_identity=only_identity)
    scale = np.asarray([w - 1, h - 1])
    rows: List[dict] = []
    with open(csv_path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for gname, params in geoms.items():
            for gparam in params:
                true_c = geom_endpoints(gname, gparam, rng, b, topleft_crop=topleft_crop)
                geom_imgs = apply_tv_corner_warp(imgs_sync, torch.as_tensor(true_c, device=dev))
                for vname, strengths, vfn in vgrid:
                    for s in strengths:
                        attacked = V.clip01(vfn(geom_imgs, s))
                        tic = _timer(dev)
                        if sync is not None:
                            if getattr(sync, "needs_reference", False):
                                pred_c = sync.predict_corners(attacked, imgs_sync)
                            else:
                                pred_c = sync.predict_corners(attacked)
                            sync_detect_time = tic()
                            tic = _timer(dev)
                            corners = torch.as_tensor(pred_c, device=dev)[:, TV_TO_SOLVER]
                            unwarped = unwarp_from_corners(attacked, corners)
                            unwrap_time = tic()
                            corner_error = float(np.linalg.norm((pred_c - true_c) * scale, axis=-1).mean())
                        else:
                            sync_detect_time = tic()
                            unwarped, unwrap_time, corner_error = attacked, 0.0, float("nan")
                        tic = _timer(dev)
                        preds = baseline.detect(unwarped)["preds"][:, 1:]
                        wm_detect_time = tic()
                        acc = float(mean_like_jax(bit_accuracy(preds, msgs).cpu()))  # the host's order: one value on every device
                        pv = float(np.mean(pvalue(preds, msgs)))
                        row = {"geom_aug": f"{gname}_{gparam}", "geom_strength": gparam, "val_aug": f"{vname}_{s}",
                               "val_strength": s, "bit_accuracy": acc, "log_pvalue": float(np.log10(pv + 1e-300)),
                               "corner_error": corner_error, "wm_embed_time": wm_embed_time,
                               "sync_embed_time": sync_embed_time, "sync_detect_time": sync_detect_time,
                               "unwrap_time": unwrap_time, "wm_detect_time": wm_detect_time}
                        rows.append(row)
                        f.write(f"0,{row['geom_aug']},{gparam},{row['val_aug']},{s},{acc:.4f},"
                                f"{row['log_pvalue']:.4f},{corner_error:.4f},{wm_embed_time:.6f},"
                                f"{sync_embed_time:.6f},{sync_detect_time:.6f},{unwrap_time:.6f},"
                                f"{wm_detect_time:.6f}\n")
                        f.flush()
    return rows


def grouped_summary(rows: List[dict]) -> str:
    """Mean bit accuracy per (geom_aug, val_aug) and over all rows, the
    reference's closing pandas groupby (eval_wm.py:389-397)."""
    by: Dict[Tuple[str, str], List[float]] = {}
    for r in rows:
        by.setdefault((r["geom_aug"], r["val_aug"]), []).append(r["bit_accuracy"])
    lines = ["geom_aug,val_aug,bit_accuracy"]
    for (g, v), accs in sorted(by.items()):
        lines.append(f"{g},{v},{np.mean(accs):.4f}")
    lines.append(f"all,all,{np.mean([r['bit_accuracy'] for r in rows]):.4f}")
    return "\n".join(lines)


def _synthetic_images(n: int, size: int, seed: int) -> torch.Tensor:
    """Structured pseudo-photos (smooth gradients and low-frequency blobs,
    so SIFT has features and JPEG behaves), JAX's: the same numpy draws and
    JAX's bicubic resize."""
    rng = np.random.default_rng(seed)
    low = rng.normal(0, 1, size=(n, size // 8, size // 8, 3)).astype(np.float32)
    base = resize_cubic(torch.as_tensor(low), (size, size)).numpy()
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    grad = (0.3 * xx + 0.2 * yy)[None, :, :, None]
    speck = rng.normal(0, 0.03, size=(n, size, size, 3)).astype(np.float32)
    return torch.as_tensor(np.clip(0.5 + 0.25 * base + grad - 0.25 + speck, 0.0, 1.0))


def _load_images(path: str, n: int, size: int) -> torch.Tensor:
    from PIL import Image

    files = sorted(os.path.join(path, fn) for fn in os.listdir(path)
                   if fn.lower().endswith((".png", ".jpg", ".jpeg")))[:n]
    out = [np.asarray(Image.open(fn).convert("RGB").resize((size, size), Image.BILINEAR), np.float32) / 255.0
           for fn in files]
    if not out:
        raise ValueError(f"no images under {path}")
    return torch.as_tensor(np.stack(out))


def main(argv=None):
    p = argparse.ArgumentParser(description="Watermark detection through sync-based geometric inversion "
                                            "(reference evals/eval_wm.py)")
    p.add_argument("--baseline", required=True,
                   help="ss | wam | wam_noattenuation | hidden | mbrs | cin | trustmark | videoseal")
    p.add_argument("--baseline_path", default=None, help="weights of the checkpoint-backed baselines")
    p.add_argument("--sync_model", required=True, help="none | sift | syncseal | wam")
    p.add_argument("--sync_path", default=None)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--images", default=None, help="directory of images; synthetic if omitted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only_identity", default="false", choices=["true", "false"])
    p.add_argument("--tiny", action="store_true", help="allow random-init models (smoke tests only)")
    p.add_argument("--output_dir", default="output/wm_sync_eval")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; there is no fallback")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("eval_wm: no CUDA card visible; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    baseline = build_baseline(args.baseline, params_path=args.baseline_path, img_size=args.img_size,
                              allow_random=args.tiny, seed=args.seed, device=dev)
    sync = load_sync(args.sync_model, sync_path=args.sync_path, tiny=args.tiny, device=dev)
    if args.images:
        imgs01 = _load_images(args.images, args.num_samples, args.img_size)
    else:
        imgs01 = _synthetic_images(args.num_samples, args.img_size, args.seed)
    rows = evaluate_watermark_with_sync(baseline, sync, imgs01.to(dev), args.output_dir,
                                        only_identity=args.only_identity == "true", seed=args.seed,
                                        topleft_crop=args.sync_model in ("wam", "baseline/wam"))
    summary = grouped_summary(rows)
    print("\nGrouped Bit Accuracy by Geometric and Value-Metric Augmentation:")
    print(summary)
    with open(os.path.join(args.output_dir, "summary.csv"), "w") as f:
        f.write(summary + "\n")
    return rows


if __name__ == "__main__":
    main()
