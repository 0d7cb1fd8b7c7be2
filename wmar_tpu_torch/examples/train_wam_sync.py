"""Train the WAM pixel watermark from scratch, then use it for quadrant
geometric synchronization: estimate and revert a rotation (PyTorch port of
``examples/train_wam_sync.py``).

    python -m wmar_tpu_torch.examples.train_wam_sync --steps 300 --size 64 --device cpu

Trains the small backbone (``sync/wam_model.py``) on synthetic images, then
embeds 4 quadrant messages, rotates the image, assigns each pixel a
message, fits (rotation, cuts, flip) and reverts it; prints the estimated
against the true rotation. Minutes of training learn the watermark's
localization (the mask head) but not yet reliable per-pixel 32-bit
decoding; the reference ships the pretrained ``wam_mit.pth`` for that. This
demonstrates the training and sync loop.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def synthetic_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Smooth random images (mixtures of low-frequency gradients), JAX's example's."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    imgs = []
    for _ in range(n):
        c = rng.uniform(-1, 1, (3, 6))
        img = np.stack([c[k, 0] * yy + c[k, 1] * xx + c[k, 2] * yy * xx
                        + 0.3 * np.sin(c[k, 3] * 6 * yy + c[k, 4] * 6 * xx + c[k, 5]) for k in range(3)], axis=-1)
        imgs.append((img - img.min()) / (img.max() - img.min() + 1e-6))
    return np.stack(imgs).astype(np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--rotation", type=float, default=10.0)
    p.add_argument("--hidden", type=int, default=32, help="WAMConfig.hidden (the released-scale width: 64)")
    p.add_argument("--latent", type=int, default=64, help="WAMConfig.latent (the released-scale width: 128)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; there is no fallback")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_wam_sync: no CUDA card visible; pass --device cpu to run on the CPU")

    from wmar_tpu_torch.augmentations import geometric as G
    from wmar_tpu_torch.sync.wam_logic import SyncConfidence, WamSync
    from wmar_tpu_torch.sync.wam_model import WAMConfig, WamPixelModel, make_train_step

    cfg = WAMConfig(nbits=32, hidden=args.hidden, latent=args.latent, image_size=args.size, scaling_w=2.0)
    model = WamPixelModel.init(0, cfg, device=device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=args.lr))

    rng = np.random.default_rng(0)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        imgs = torch.as_tensor(synthetic_images(rng, args.batch, args.size), device=device)
        metrics = step(imgs, generator=torch.Generator().manual_seed(i))
        losses.append({k: float(v) for k, v in metrics.items()})
        if i % 50 == 0 or i == args.steps - 1:
            m = losses[-1]
            print(f"step {i}: loss={m['loss']:.4f} mask={m['mask_loss']:.4f} bits={m['bit_loss']:.4f}", flush=True)
    train_s = time.perf_counter() - t0
    print(f"trained in {train_s:.1f}s")

    model.eval()
    sync = WamSync(model, image_size=args.size, conf=SyncConfidence(coverage=0.3))
    test = torch.as_tensor(synthetic_images(rng, 1, args.size), device=device) * 2.0 - 1.0
    synced = sync.add_sync(test)
    psnr = float(-10 * torch.log10(((synced - test) ** 2).mean() / 4 + 1e-12))
    rotated = G.rotate((synced + 1) / 2, args.rotation) * 2 - 1
    aug_info, positions = sync.estimate((rotated[0] + 1) / 2)
    coverage = float((positions >= 0).mean())
    print(f"watermark PSNR: {psnr:.1f} dB, detector coverage after rotation: {coverage:.2f}")
    print(f"true rotation: {args.rotation}, estimated: {aug_info[0]} (cuts {aug_info[1]},{aug_info[2]}, "
          f"flip={aug_info[3]})")
    reverted = sync.remove_sync(rotated)
    residual, _ = sync.estimate((reverted[0] + 1) / 2)
    print(f"after revert, residual rotation estimate: {residual[0]}")
    return {"losses": losses, "train_s": train_s, "psnr": psnr, "coverage": coverage, "aug_info": aug_info,
            "residual": residual, "reverted": reverted}


if __name__ == "__main__":
    main(sys.argv[1:])
