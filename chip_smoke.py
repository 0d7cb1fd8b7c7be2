#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives the port's main path once at full width and checks it, in phases:

1. build: compile the CUDA kernels from ``wmar_tpu_torch/csrc/`` (sm_90a),
   print the build time, the card's name and power limit, and the TF32
   switches (both off, so float32 matmuls and convolutions are exact);
2. kernel vs plain: ``packed4_decode_attention`` at the decode shapes of
   RAR-B, RAR-XL and RAR-XXL (128 rows, 258 slots, 16 heads, D 48/80/88)
   against its plain float32 version, and both timed at the RAR-XL shape;
3. main path: RAR-XL with int8 weights, a packed4 KV cache and the
   ``linear-rand-h=1-d=2.0-g=0.25`` watermark through the port's
   ``generate_and_evaluate`` on 64 classes (one warm-up batch, one timed),
   with random weights from a seed; checks codes, images, p-values, the
   green fraction, and that every decode-attention call went through the
   kernel (255 steps x 32 layers per batch).

Prints, before the last line, one JSON object with each kernel's numbers,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and the last line is not printed. Without
a CUDA card it fails at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerance of the kernel against its plain float32 version, relative to
# the largest output. Both compute scores, softmax and sums in float32 and
# differ only in summation order and exp rounding (about 1e-6 relative;
# F32_REL_TOL allows 1e-5). With a bf16 q the kernel then rounds its output
# to bf16, whose 8 significant bits move a value by at most 2^-8 of its
# magnitude: BF16_REL_TOL is that bound plus the float32 allowance.
BF16_REL_TOL = 2.0**-8 + 1e-5
F32_REL_TOL = 1e-5
ABS_FLOOR = 1e-6

SEED = 0
CLASSES = 64
WATERMARK = "linear-rand-h=1-d=2.0-g=0.25"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build() -> float:
    from wmar_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, seconds, log = build.build()
    build.load()
    print(f"build: {path.name} in {seconds:.2f} s (0 means it was built already)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    print(card_line())  # name, power limit: exactly as nvidia-smi prints them
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    return seconds


def _filled_cache(n_layers, b, h, t, d, gen, device):
    from wmar_tpu_torch.engine.kvcache import Packed4QuantKVCache

    cache = Packed4QuantKVCache.zeros(n_layers, b, h, t, d, device=device)
    for li in range(n_layers):
        k = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        v = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        cache.write(li, 0, k, v)
    return cache


def _median_ms(fn, n_layers: int, reps: int) -> float:
    """Median of per-call CUDA-event times; calls walk the layers, so each
    reads a layer that the previous calls have pushed out of L2, as in a
    decode step."""
    for li in range(n_layers):  # warm-up
        fn(li)
    times = []
    for i in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i % n_layers)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernels(device, b=128, t=258, h=16, shapes=(("rar_b", 24, 48), ("rar_xl", 32, 80), ("rar_xxl", 40, 88)),
                  valid_lens=(1, 2, 129, 258), reps=100) -> dict:
    """Kernel vs plain on the card; returns the RAR-XL numbers."""
    from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention, packed4_decode_attention_plain

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0.0
    result = {}
    for name, n_layers, d in shapes:
        cache = _filled_cache(n_layers, b, h, t, d, gen, device)
        for q_dtype, rel in ((torch.bfloat16, BF16_REL_TOL), (torch.float32, F32_REL_TOL)):
            q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
            for layer in (0, n_layers - 1):
                for n in valid_lens:
                    lens = torch.full((1,), n, dtype=torch.int32, device=device)
                    got = packed4_decode_attention(q, cache.kv, cache.scale, layer, lens)
                    want = packed4_decode_attention_plain(q.float(), cache.kv, cache.scale, layer, n)
                    if got.is_cuda:
                        torch.cuda.synchronize()  # a fault in the kernel shows here
                    if got.shape != want.shape or got.dtype != q_dtype or not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: bad kernel output {got.shape} {got.dtype}")
                    err = (got.float() - want).abs().max().item()
                    tol = rel * want.abs().max().item() + ABS_FLOOR
                    if not err <= tol:
                        raise AssertionError(
                            f"{name} D={d} {q_dtype} layer={layer} valid_len={n}: max abs err {err} > {tol}")
                    worst = max(worst, err) if q_dtype == torch.bfloat16 else worst
        print(f"kernel vs plain {name} (L={n_layers} B={b} T={t} H={h} D={d}): ok, "
              f"valid_len {list(valid_lens)}, layers 0 and {n_layers - 1}, bf16 and f32 q")
        if name == "rar_xl":
            q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
            lens = torch.full((1,), t, dtype=torch.int32, device=device)
            plain_ms = _median_ms(lambda li: packed4_decode_attention_plain(q, cache.kv, cache.scale, li, lens),
                                  n_layers, reps)
            ms = _median_ms(lambda li: packed4_decode_attention(q, cache.kv, cache.scale, li, lens), n_layers, reps)
            ms2 = _median_ms(lambda li: packed4_decode_attention(q, cache.kv, cache.scale, li, lens), n_layers, reps)
            plain_ms2 = _median_ms(lambda li: packed4_decode_attention_plain(q, cache.kv, cache.scale, li, lens),
                                   n_layers, reps)
            nbytes = b * t * h * d + 4 * b * h * t
            result = {"ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2)}
            print(f"time rar_xl decode attention, full cache (plain, kernel, kernel, plain): "
                  f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms; kernel reads {nbytes / 1e6:.1f} MB "
                  f"= {nbytes / (result['ms'] * 1e-3) / 1e9:.0f} GB/s")
        del cache
    result["max_abs_err"] = worst
    print(f"kernel vs plain: worst bf16 max abs err {worst:.3e}")
    return result


class _RecordingRarARMM:
    """Wraps a RarARMM and keeps what the pipeline sampled and decoded."""

    def __init__(self, inner):
        self.inner = inner
        self.sampled = []
        self.decoded = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, *args, **kwargs):
        codes = self.inner.sample(*args, **kwargs)
        self.sampled.append(codes)
        return codes

    def codes_to_images(self, codes):
        imgs = self.inner.codes_to_images(codes)
        self.decoded.append(imgs)
        return imgs


def build_rar(device, cfg=None, vq_cfg=None):
    """The port's counterpart of ``bench.py:build_rar``: RAR-XL and the
    MaskGit f16 tokenizer unless other configs are given, int8 weights, a
    packed4 cache, and the adaLN gates given small random weights so that
    attention reaches the logits."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.models import (
        MASKGIT_IMAGENET_F16, RarARMM, init_maskgit, init_rar, quantize_rar_params_int8, rar_config)

    gen = torch.Generator(device=device).manual_seed(SEED)
    cfg = cfg or rar_config("rar_xl")
    rar = init_rar(cfg, gen, dtype=torch.float32, device=device)
    with torch.no_grad():
        for blk in rar.blocks:
            blk.adaln.w = torch.randn(blk.adaln.w.shape, generator=gen, device=device) * 0.05
    quantize_rar_params_int8(rar, compute_dtype=torch.bfloat16)
    vq = init_maskgit(vq_cfg or MASKGIT_IMAGENET_F16, gen, dtype=torch.bfloat16, device=device)
    wrapper = RarARMM(rar, vq, cache_dtype="packed4", device=device)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


def phase_main_path(device, wrapper, classes: int = CLASSES) -> dict:
    from wmar_tpu_torch.core import green_fraction
    from wmar_tpu_torch.eval import EvalParams, generate_and_evaluate
    from wmar_tpu_torch.models import GenParams
    from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention

    wrapper = _RecordingRarARMM(wrapper)
    cfg = wrapper.rar_cfg
    gen_params = GenParams(temperature=1.0, guidance_scale=4.0)
    eval_params = EvalParams(max_roundtrips=1)
    per_batch = (cfg.image_seq_len - 1) * cfg.depth
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)

    packed4_decode_attention.launches = 0
    seconds = []
    records = []
    for bi in range(2):  # warm-up batch, then the timed one
        conds = [(bi * classes + i) % cfg.num_classes for i in range(classes)]
        with tempfile.TemporaryDirectory() as outdir:
            if is_cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            records = generate_and_evaluate(outdir, wrapper, conds, gen_params, eval_params, None,
                                            batch_size=classes, seed=SEED + bi, log_fn=lambda s: print(f"  {s}"))
            if is_cuda:
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
    launches = packed4_decode_attention.launches
    if is_cuda and launches != 2 * per_batch:
        raise AssertionError(f"kernel launches {launches} != 2 batches x {per_batch}")

    side = wrapper.image_size
    codes, imgs = wrapper.sampled[-1], wrapper.decoded[-2]  # the timed batch's sample and its first decode
    if tuple(codes.shape) != (classes, cfg.image_seq_len) or codes.min() < 0 or codes.max() >= cfg.codebook_size:
        raise AssertionError(f"codes {tuple(codes.shape)} in [{codes.min()}, {codes.max()}]")
    if tuple(imgs.shape) != (classes, side, side, 3) or not torch.isfinite(imgs).all() \
            or imgs.min() < -1 or imgs.max() > 1:
        raise AssertionError(f"images {tuple(imgs.shape)} in [{imgs.min()}, {imgs.max()}]")
    pvals = np.array([r["pvalue"] for r in records])
    if len(pvals) != 2 * classes or not (np.isfinite(pvals).all() and (pvals >= 0).all() and (pvals <= 1).all()):
        raise AssertionError(f"p-values {pvals}")
    frac = green_fraction(wrapper.watermark_spec, wrapper.greenlist, codes).float().mean().item()
    gamma = wrapper.watermark_spec.gamma
    if not frac > gamma + 0.15:
        raise AssertionError(f"green fraction {frac} not well above gamma {gamma}")
    raw_p = np.array([r["pvalue"] for r in records if r["param"] == 0])
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if is_cuda else float("nan")
    out = {
        "launches": launches,
        "seconds": seconds,
        "imgs_per_s": classes / seconds[1],
        "green_fraction": frac,
        "median_raw_pvalue": float(np.median(raw_p)),
        "peak_gib": peak,
    }
    print(f"main path: RAR {cfg.embed_dim} wide x {cfg.depth} layers, int8 weights, packed4 cache, {WATERMARK}, "
          f"{classes} classes, 1 round trip: "
          f"warm-up {seconds[0]:.2f} s, timed {seconds[1]:.2f} s = {out['imgs_per_s']:.2f} imgs/s "
          f"(generate_and_evaluate end to end, files included); kernel launches {launches} "
          f"= 2 x {per_batch}; green fraction {frac:.3f} (gamma {gamma}); median raw p-value "
          f"{out['median_raw_pvalue']:.3e}; peak memory {peak:.2f} GiB")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels(device)
    main_path = phase_main_path(device, build_rar(device))
    print(f"card: {card_line()}; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "packed4_decode_attention",
        "route": "cuda",
        "source": "wmar_tpu_torch/csrc/packed4_decode_attention.cu",
        "replaces": "wmar_tpu/ops/flash_decode.py:677",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
