"""Card times of the code that resizes inside sync and the attack grid.

    python -m wmar_tpu_torch.tools.bench_sync_resize
    PYTHONPATH=<another checkout> python <this file>   # that checkout's package

Times, on random weights in the released layouts, at 256 px and a batch of
8 (the sizes of ``chip_smoke.py``'s sync phases), with CUDA events (median
of ``--reps`` after a warm-up, TF32 off): the released SyncSeal's
``add_sync`` and ``remove_sync``; WAM's ``embed`` and ``detect`` (its pixel
decoder upsamples with the UNet's ``UpBlock``); the UNet-small2 up-blocks
forward and forward + backward; ``resize_linear`` of a half crop back to
256 px; and the classic attack grid (all 62 cells of
``AugmentationManager``, device JPEG) over the batch. Prints one JSON line
with the package it imported and the card's name and power limit. The file
imports only what every checkout of the port since sync's serving half
has, so it times an older checkout when that checkout comes first on
``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> dict:
    import wmar_tpu_torch
    from wmar_tpu_torch.augmentations import geometric as G
    from wmar_tpu_torch.augmentations.manager import AugmentationManager
    from wmar_tpu_torch.sync import syncseal_models as sm
    from wmar_tpu_torch.sync import wam_exact as twx
    from wmar_tpu_torch.sync.syncseal import init_syncseal_ref

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_sync_resize: no CUDA card is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    b, s, reps = args.batch, args.size, args.reps
    gen = torch.Generator().manual_seed(0)
    imgs = (torch.rand(b, s, s, 3, generator=gen) * 2 - 1).to(dev)
    out = {"package": wmar_tpu_torch.__file__, "card": _card_line(), "batch": b, "size": s, "reps": reps}

    with torch.no_grad():
        ref = init_syncseal_ref(0, device=dev)
        synced = ref.add_sync(imgs)
        out["syncseal_add_ms"] = time_ms(lambda: ref.add_sync(imgs), reps)
        out["syncseal_remove_ms"] = time_ms(lambda: ref.remove_sync(synced), reps)
        wam = twx.init_wam(0, device=dev)
        x01 = (imgs + 1) / 2
        msgs = torch.randint(0, 2, (b, twx.NBITS), generator=gen).to(dev)
        out["wam_embed_ms"] = time_ms(lambda: wam.embed(x01, msgs), max(reps // 4, 3))
        out["wam_detect_ms"] = time_ms(lambda: wam.detect(x01), max(reps // 4, 3))

    # the UNet-small2 up-blocks (channels 128 -> 64 -> 32 -> 16, 32 -> 256 px), forward and with backward
    ups = {}
    for c_in, side in ((128, s // 8), (64, s // 4), (32, s // 2)):
        block = sm.UpBlock(c_in, c_in // 2).to(dev)
        x = torch.randn(b, c_in, side, side, generator=gen).to(dev).requires_grad_(True)
        with torch.no_grad():
            fwd = time_ms(lambda: block(x), reps)

        def step():
            block(x).square().mean().backward()

        ups[f"{c_in}x{side}"] = {"forward_ms": fwd, "forward_backward_ms": time_ms(step, reps)}
    out["unet_upblocks"] = ups

    crop = G.upper_left_crop(x01, 0.5)
    out["resize_half_crop_back_ms"] = time_ms(lambda: G.resize_linear(crop, (s, s)), reps)
    manager = AugmentationManager()
    cells = [(name, fn, param) for name, fn, params in manager.augs for param in params]

    def grid():
        g = torch.Generator(device=dev).manual_seed(0)
        for _, fn, param in cells:
            fn(x01, param, g)

    out["grid_cells"] = len(cells)
    out["grid_ms"] = time_ms(grid, max(reps // 4, 3))
    by_attack = {}
    for name, fn, params in manager.augs:
        g = torch.Generator(device=dev).manual_seed(0)
        by_attack[name] = time_ms(lambda: [fn(x01, q, g) for q in params], max(reps // 4, 3))
    out["grid_ms_by_attack"] = by_attack
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
