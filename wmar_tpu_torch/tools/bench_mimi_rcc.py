"""Mimi RCC train step at MIMI_V0_1's width on one card.

    python -m wmar_tpu_torch.tools.bench_mimi_rcc --batch 8,16,32,48,56,64 --duration 10
    python -m wmar_tpu_torch.tools.bench_mimi_rcc --tiny --device cpu --batch 2 --duration 0.32

Times ``audio.finetune.make_rcc_train_step`` with the entry point's
defaults (MR-STFT audio loss at weight 1e-3, MSE on the pre-quantization
latents, AdamW) on a random MIMI_V0_1, one batch size after the other:
a warm-up step, then ``--iters`` steps between two device syncs, on
band-limited synthetic clips of ``--duration`` s. Prints one JSON line a
batch with seconds a step, seconds of audio trained a second and the peak
GiB (``max_memory_allocated``, reset before each batch), and stops at the
first batch that runs out of memory (its line says so): the largest batch
before it is the largest that fits. The card's name and power limit from
``nvidia-smi`` go on every line. The precision is the entry point's
(``finetune.cli.set_precision``: cuDNN TF32, float32 matmuls).
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def bench(mimi, batch: int, duration: float, iters: int, seed: int = 0) -> dict:
    from wmar_tpu_torch.audio.finetune import MimiFTWrapper, init_state, make_rcc_train_step
    from wmar_tpu_torch.audio.losses import get_audio_loss, get_code_loss
    from wmar_tpu_torch.finetune_mimi import synthetic_clips

    device = next(mimi.parameters()).device
    wrapper = MimiFTWrapper(mimi)
    state = init_state(wrapper, lr=1e-5)
    step = make_rcc_train_step(state, get_audio_loss("mrstft"), get_code_loss("mse"), 1e-3, 1.0)
    length = int(round(duration * 24000))
    audio = torch.from_numpy(synthetic_clips(batch, length, seed)).to(device)

    def synced() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    step(audio)
    t = synced()
    for _ in range(iters):
        metrics = step(audio)
    s = (synced() - t) / iters
    return {"batch": batch, "duration_s": duration, "s_per_step": s, "audio_s_per_s": batch * duration / s,
            "loss": float(metrics["loss"])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=str, default="8,16,32,48,56,64")
    p.add_argument("--duration", type=float, default=10.0, help="clip seconds")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--tiny", action="store_true", help="the finetune CLI's tiny Mimi")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    from wmar_tpu_torch.audio.mimi import MIMI_V0_1, MimiConfig, init_mimi
    from wmar_tpu_torch.finetune.cli import set_precision
    from wmar_tpu_torch.finetune_mimi import TINY_FT_MIMI

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible")
    set_precision()
    card = "cpu"
    if cuda:
        from wmar_tpu_torch.tools.bench_attention import card_line

        card = card_line()
    cfg = MimiConfig(**TINY_FT_MIMI) if args.tiny else MIMI_V0_1
    mimi = init_mimi(cfg, torch.Generator(device).manual_seed(0), device=device)
    rows = []
    for b in (int(x) for x in args.batch.split(",")):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        try:
            row = bench(mimi, b, args.duration, args.iters)
        except torch.cuda.OutOfMemoryError:
            row = {"batch": b, "duration_s": args.duration, "oom": True}
        if cuda:
            row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        row.update(card=card, tf32_cudnn=torch.backends.cudnn.allow_tf32,
                   tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if row.get("oom"):
            break
    return rows


if __name__ == "__main__":
    main()
