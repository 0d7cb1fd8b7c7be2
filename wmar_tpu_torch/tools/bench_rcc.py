"""RCC finetune throughput at the reference's Taming geometry (PyTorch port
of ``tools/bench_rcc.py``).

    python -m wmar_tpu_torch.tools.bench_rcc --batch 4,8 --level strong
    python -m wmar_tpu_torch.tools.bench_rcc --tiny --device cpu --iters 2

Times the train step (decode -> one augmentation branch with p = 0.5 ->
re-encode -> L1 + perceptual fallback + idem, Adam; GAN off, as every
published sweep) on the full-size f16 Taming VQGAN at 256 px with random
weights, for each batch and level: warm-up steps (each kind of
augmentation of the level once, then two drawn), then ``--iters`` steps
between two device syncs. Prints one JSON line per (batch, level)
with images per second, ms per step and peak GiB, the card's name and
power limit from ``nvidia-smi`` and the TF32 switches beside them. The
precision is the entry point's (``finetune.cli.set_precision``), so the
numbers are those of ``python -m wmar_tpu_torch.finetune``.

For context only: the reference's golden run trained 10 epochs x 50k codes
in 6,055 s on 16 GPUs (``logs/0620_taming_ft_stdout.txt``), 5.16 images
per second per GPU at batch 4 on cards its logs do not name.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wmar_tpu_torch.finetune.cli import TINY_TAMING, set_precision

LEVELS = ("warmup", "weak", "medium", "strong")


def bench(adapter, batch: int, level: str, iters: int, warmup: int = 2, seed: int = 0) -> dict:
    """Images per second of ``iters`` train steps at ``batch`` and ``level``."""
    from wmar_tpu_torch.finetune.rcc import RCCConfig, expand_level, init_state, make_train_step

    device = adapter.device
    cfg = RCCConfig()
    state = init_state(adapter, cfg)
    step = make_train_step(adapter, cfg, level)
    codes = torch.as_tensor(np.random.default_rng(seed).integers(
        0, adapter.model.cfg.n_embed, size=(batch, adapter.latent_side**2)), device=device).long()

    def run(i, **draws):
        return step(state, codes, torch.Generator().manual_seed(seed + i),
                    torch.Generator(device=device).manual_seed(seed + i), **draws)

    # warm-up: each kind of augmentation once (its kernels load at first use), then plain draws
    kinds = {}
    for i, b in enumerate(expand_level(level)):
        kinds.setdefault(b.name, i)
    for i in kinds.values():
        run(i, gate=0.0, index=i)
    for i in range(warmup):
        run(i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(iters):
        metrics = run(warmup + i)
    loss = float(metrics["loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    del state
    return {"level": level, "batch": batch, "iters": iters, "step_ms": 1000 * dt / iters,
            "imgs_per_s": batch * iters / dt, "peak_gib": peak, "loss": loss}


def taming_adapter(device, tiny: bool = False, seed: int = 0):
    from wmar_tpu_torch.finetune.rcc import TamingRCCAdapter
    from wmar_tpu_torch.models import TAMING_IMAGENET_F16, VQGANConfig, init_taming_vqgan

    cfg = VQGANConfig(**TINY_TAMING) if tiny else TAMING_IMAGENET_F16
    return TamingRCCAdapter(init_taming_vqgan(cfg, torch.Generator(device=device).manual_seed(seed), device=device))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=str, default="4", help="comma-separated batch sizes")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--level", type=str, default="all", help="warmup|weak|medium|strong, or all")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    set_precision()
    card = "cpu"
    if device.type == "cuda":
        from wmar_tpu_torch.tools.bench_attention import card_line

        card = card_line()
    adapter = taming_adapter(device, args.tiny)
    levels = LEVELS if args.level == "all" else tuple(args.level.split(","))
    out = []
    for batch in (int(b) for b in args.batch.split(",")):
        for level in levels:
            r = bench(adapter, batch, level, args.iters)
            r.update(card=card, tf32={"cudnn": torch.backends.cudnn.allow_tf32,
                                      "matmul": torch.backends.cuda.matmul.allow_tf32},
                     geometry="tiny" if args.tiny else "taming_f16_256px")
            print(json.dumps(r), flush=True)
            out.append(r)
    return out


if __name__ == "__main__":
    main()
