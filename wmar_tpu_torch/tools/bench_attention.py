#!/usr/bin/env python
"""Microbenchmark of the decode-attention kernels and the two probes on the card.

    python -m wmar_tpu_torch.tools.bench_attention [--reps 50] [--json out.json]

Counterpart of the JAX package's ``tools/bench_attention.py`` and
``tools/bench_call_floor.py``. At the models' own decode shapes (RAR-XL: 128
CFG rows, 16 heads of 80, 258 slots; Chameleon with a 4096-slot cache: 3 CFG
rows, 32 heads of 128) it times, with CUDA events, per call:

  plain        the plain float32 version of the kernel (same inputs)
  kernel       flash_decode_attention (#5, bf16 cache), flash_decode_attention_q8
               (#6, int8 cache), the packed kernels (#1-#4) over the same K/V
  library      one ``F.scaled_dot_product_attention`` call over the bf16 cache
               with a boolean mask (a yardstick only: the port never calls it)
  dma-probe    _packed_dma_probe (#7): the int8 packed kernel's loads alone

each beside its bound: the bytes the call must move (the payload and scales of
the slots that take part, the mask bytes, q and the output) over the card's
3.35 TB/s, or its operations over the peak rate of its type, whichever is
larger. Calls walk the layers of a stacked cache so that each reads from
device memory, not from L2, as in a decode step. The Chameleon shape is timed
twice: over the full cache, and at the end of an interleaved run (1160 valid
slots, the three CFG rows' key masks: everything | image tokens only | <s>
and the current image).

Then the per-call floor (#9, ``row_mean_probe``): 64 launches back to back on
one stream at 1, 64, 1024, 4096 and 16384 rows of 1024 bf16 values, once
enqueued by the host (what a call costs an eager loop) and once replayed
from a CUDA graph (what a launch costs the card: the counterpart of the
JAX tool's calls inside one compiled scan).

It needs a CUDA card and fails without one: every timer here reads CUDA
events. The bounds and masks are plain functions of the shapes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.ops import flash_decode as fd

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12, torch.uint8: 1979e12}

RAR_XL = dict(b=128, h=16, t=258, d=80)          # rar_config("rar_xl"): 1280 wide, 16 heads; 2 + 256 slots
CHAMELEON_4K = dict(b=3, h=32, t=4096, d=128)    # CHAMELEON_7B, three CFG rows over one 4096-slot history
FLOOR_ROWS = (1, 64, 1024, 4096, 16384)
FLOOR_STEPS = 64


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n_rotate: int, reps: int) -> float:
    """Median of per-call CUDA-event times of ``fn(i % n_rotate)``; the
    calls walk ``n_rotate`` layers or buffers, so each reads what the
    previous calls pushed out of L2."""
    for i in range(n_rotate):  # warm-up
        fn(i)
    times = []
    for i in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i % n_rotate)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_turns(kernel_fn, plain_fn, n_rotate: int, reps: int) -> list:
    """Median ms of (plain, kernel, kernel, plain), in turns on one card."""
    return [median_ms(plain_fn, n_rotate, reps), median_ms(kernel_fn, n_rotate, reps),
            median_ms(kernel_fn, n_rotate, reps), median_ms(plain_fn, n_rotate, reps)]


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """``(bound_ms, bound_by)``: the least time the card could take."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def slots_taking_part(b: int, t: int, valid_len: int, start=None, key_mask=None) -> int:
    """How many (row, slot) pairs a call attends to, from this call's data."""
    ok = torch.arange(t)[None, :].expand(b, t) < valid_len
    if start is not None:
        ok = ok & (torch.arange(t)[None, :] >= start.cpu()[:, None])
    if key_mask is not None:
        ok = ok & key_mask.cpu().bool()
    return int(ok.sum())


def attention_bound(b, h, t, d, valid_len, payload_bytes: float, scaled: bool, q_dtype, kv_dtype, start=None,
                    key_mask=None) -> tuple:
    """Bound of one decode-attention call: ``payload_bytes`` per K or V value
    (2 bf16, 1 int8, 0.5 int4), 2 bf16 scales per slot and head where
    ``scaled``, one mask byte per slot in range, q read and out written
    once; 4 flops per value pair."""
    slots = slots_taking_part(b, t, valid_len, start, key_mask)
    nbytes = slots * h * (2 * d * payload_bytes + (4 if scaled else 0))
    if key_mask is not None:
        nbytes += slots_taking_part(b, t, valid_len, start)
    nbytes += 2 * b * h * d * torch.empty((), dtype=q_dtype).element_size()
    return bound(nbytes, 4.0 * slots * h * d, kv_dtype)


def interleaved_masks(t: int, valid_len: int, lp: int, n_text: int, image_seq_len: int, device) -> torch.Tensor:
    """The three CFG rows' key masks late in an interleaved run whose first
    image opened after ``lp`` prompt tokens and ``n_text`` text tokens: row 0
    sees everything, rows 1 and 2 the prompt's <s> (slot 0) and the image
    span <boi> .. <eoi>."""
    km = torch.zeros((3, t), dtype=torch.bool)
    km[0, :valid_len] = True
    boi = lp + n_text
    for row in (1, 2):
        km[row, 0] = True
        km[row, boi: min(boi + image_seq_len + 2, valid_len)] = True
    return km.to(device)


def filled_caches(n_layers, b, h, t, d, gen, device, kinds=("bf16", "int8", "packed", "packed4")) -> dict:
    """Caches of every kind holding the same random K/V."""
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "packed": "packed", "packed4": "packed4"}
    caches = {kind: KVCache.zeros(n_layers, b, h, t, d, dtypes[kind], device=device) for kind in kinds}
    for li in range(n_layers):
        k = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        v = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        for cache in caches.values():
            cache.write(li, 0, k, v)
    return caches


def sdpa_mask(b, t, valid_len, start, key_mask, device) -> torch.Tensor:
    ok = (torch.arange(t, device=device)[None, :] < valid_len).expand(b, t)
    if start is not None:
        ok = ok & (torch.arange(t, device=device)[None, :] >= start[:, None])
    if key_mask is not None:
        ok = ok & key_mask
    return ok[:, None, None, :]


def bench_shape(tag: str, shape: dict, device, n_layers: int, reps: int, valid_len=None, start=None, key_mask=None,
                seed: int = 0) -> dict:
    """Every decode-attention variant at one shape and one set of masks.
    Returns ``{variant: {"ms", "plain_ms", "library_ms", "bound_ms",
    "bound_by", "times"}}``."""
    b, h, t, d = shape["b"], shape["h"], shape["t"], shape["d"]
    valid_len = valid_len or t
    gen = torch.Generator(device=device).manual_seed(seed)
    caches = filled_caches(n_layers, b, h, t, d, gen, device)
    q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
    lens = torch.full((1,), valid_len, dtype=torch.int32, device=device)
    masked = start is not None or key_mask is not None
    mk = dict(start=start, key_mask=key_mask)
    c16, c8, cp, cp4 = (caches[k] for k in ("bf16", "int8", "packed", "packed4"))
    attn_mask = sdpa_mask(b, t, valid_len, start, key_mask, device)
    library_ms = median_ms(lambda li: F.scaled_dot_product_attention(q, c16.k[li], c16.v[li], attn_mask=attn_mask),
                           n_layers, reps)
    variants = {
        "flash_decode_attention": (
            lambda li: fd.flash_decode_attention(q, c16.k[li], c16.v[li], lens, **mk),
            lambda li: fd.flash_decode_attention_plain(q, c16.k[li], c16.v[li], lens, **mk),
            attention_bound(b, h, t, d, valid_len, 2, False, q.dtype, torch.bfloat16, start, key_mask), library_ms),
        "flash_decode_attention_q8": (
            lambda li: fd.flash_decode_attention_q8(q, c8.k[li], c8.v[li], c8.k_scale[li], c8.v_scale[li], lens, **mk),
            lambda li: fd.flash_decode_attention_q8_plain(q, c8.k[li], c8.v[li], c8.k_scale[li], c8.v_scale[li],
                                                          lens, **mk),
            attention_bound(b, h, t, d, valid_len, 1, True, q.dtype, torch.int8, start, key_mask), None),
    }
    if not masked or t >= 1024:  # the packed kernels take masks only on their chunked route
        variants["packed_decode_attention_q8"] = (
            lambda li: fd.packed_decode_attention_q8(q, cp.kv, cp.scale, li, lens, **mk),
            lambda li: fd.packed_decode_attention_q8_plain(q, cp.kv, cp.scale, li, lens, **mk),
            attention_bound(b, h, t, d, valid_len, 1, True, q.dtype, torch.int8, start, key_mask), None)
        variants["packed4_decode_attention"] = (
            lambda li: fd.packed4_decode_attention(q, cp4.kv, cp4.scale, li, lens, **mk),
            lambda li: fd.packed4_decode_attention_plain(q, cp4.kv, cp4.scale, li, lens, **mk),
            attention_bound(b, h, t, d, valid_len, 0.5, True, q.dtype, torch.uint8, start, key_mask), None)
    out = {}
    print(f"{tag}: B={b} H={h} T={t} D={d}, {n_layers} layers walked, valid_len {valid_len}, "
          f"start {'yes' if start is not None else 'no'}, key_mask {'yes' if key_mask is not None else 'no'}")
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), lib) in variants.items():
        times = time_turns(kernel_fn, plain_fn, n_layers, reps)
        out[name] = {"ms": min(times[1], times[2]), "plain_ms": min(times[0], times[3]), "library_ms": lib,
                     "bound_ms": bound_ms, "bound_by": bound_by, "times": times}
        print(f"  {name:34s} plain, kernel, kernel, plain: {' '.join(f'{x:.4f}' for x in times)} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by}" + (f"; library (SDPA, bf16 cache) {lib:.4f} ms" if lib is not None else ""))
    if not masked:  # the probe walks all T slots, so it stands beside the full-cache calls only
        nbytes = b * t * 2 * h * d + 4 * b * h * t + b * h * d * (1 + q.element_size())
        bound_ms, bound_by = bound(nbytes, 0.0, torch.int8)
        times = time_turns(lambda li: fd._packed_dma_probe(q, cp.kv, cp.scale, li),
                           lambda li: fd._packed_dma_probe_plain(q, cp.kv, cp.scale, li), n_layers, reps)
        out["_packed_dma_probe"] = {"ms": min(times[1], times[2]), "plain_ms": min(times[0], times[3]),
                                    "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "times": times}
        print(f"  {'_packed_dma_probe':34s} plain, kernel, kernel, plain: {' '.join(f'{x:.4f}' for x in times)} ms; "
              f"bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB = "
              f"{nbytes / (out['_packed_dma_probe']['ms'] * 1e-3) / 1e9:.0f} GB/s): the loads of "
              f"packed_decode_attention_q8 alone")
    return out


def _back_to_back_us(fn, steps: int) -> float:
    """Microseconds per call of ``steps`` calls enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps * 1e3


def _graph_replay_us(fn, steps: int, replays: int = 5) -> float:
    """Microseconds per call of ``steps`` calls captured into one CUDA graph
    and replayed: the host enqueues nothing per call, so at a small size
    this is what a launch costs the card. The least of ``replays``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(steps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times) / steps * 1e3


def bench_call_floor(device, rows_list=FLOOR_ROWS, cols: int = 1024, steps: int = FLOOR_STEPS, reps: int = 50,
                     l2_bytes: float = 120e6) -> dict:
    """Kernel #9 at each row count: the time per call of ``steps`` launches
    back to back on one stream, enqueued by the host (kernel, plain,
    ``torch.mean``: the host's pace) and replayed from a CUDA graph (kernel,
    ``torch.mean``: the card's), and at the largest row count the (plain, kernel, kernel, plain) turns over enough
    buffers to exceed L2, beside the byte bound."""
    gen = torch.Generator(device=device).manual_seed(0)
    floor = {}
    print(f"per-call floor, row_mean_probe over bf16 [rows, {cols}], {steps} launches back to back:")
    for rows in rows_list:
        x = torch.randn((rows, cols), generator=gen, device=device).to(torch.bfloat16)
        us = _back_to_back_us(lambda: fd.row_mean_probe(x), steps)
        plain_us = _back_to_back_us(lambda: fd.row_mean_probe_plain(x), steps)
        lib_us = _back_to_back_us(lambda: torch.mean(x, 1, dtype=torch.float32), steps)
        graph_us = _graph_replay_us(lambda: fd.row_mean_probe(x), steps)
        lib_graph_us = _graph_replay_us(lambda: torch.mean(x, 1, dtype=torch.float32), steps)
        mb = rows * cols * 2 / 1e6
        floor[rows] = {"us": us, "plain_us": plain_us, "library_us": lib_us, "graph_us": graph_us,
                       "library_graph_us": lib_graph_us}
        print(f"  rows={rows:6d} ({mb:8.3f} MB)  enqueued by the host: kernel {us:8.2f} us/call, plain "
              f"{plain_us:8.2f}, torch.mean {lib_us:8.2f}; replayed from a CUDA graph: kernel {graph_us:8.2f} us/call "
              f"({mb / 1e3 / (graph_us * 1e-6):7.1f} GB/s), torch.mean {lib_graph_us:8.2f}")
    rows = rows_list[-1]
    nbytes = rows * cols * 2 + rows * fd.ROW_MEAN_OUT_COLS * 2
    copies = min(8, max(1, int(-(-l2_bytes // nbytes))))
    xs = [torch.randn((rows, cols), generator=gen, device=device).to(torch.bfloat16) for _ in range(copies)]
    times = time_turns(lambda i: fd.row_mean_probe(xs[i]), lambda i: fd.row_mean_probe_plain(xs[i]), copies, reps)
    library_ms = median_ms(lambda i: torch.mean(xs[i], 1, dtype=torch.float32), copies, reps)
    bound_ms, bound_by = bound(nbytes, 2.0 * rows * cols, torch.float32)
    print(f"  rows={rows}, {copies} buffers walked (plain, kernel, kernel, plain): "
          f"{' '.join(f'{x:.4f}' for x in times)} ms; torch.mean {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by}")
    return {"ms": min(times[1], times[2]), "plain_ms": min(times[0], times[3]), "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "times": times, "floor_us": floor}


def run(device, reps: int = 50, rar: dict = RAR_XL, cham: dict = CHAMELEON_4K, rar_layers: int = 3,
        cham_layers: int = 4, interleaved_end=(1160, 7, 64, 1024), floor_rows=FLOOR_ROWS) -> dict:
    """The whole microbench. ``interleaved_end``: (valid_len, prompt length,
    text tokens before the image, image tokens) of the masked Chameleon case,
    the state at the last step of one prompt with one image and two text
    segments of 64 tokens."""
    out = {"rar_xl": bench_shape("RAR-XL decode (2B CFG rows), full cache", rar, device, rar_layers, reps)}
    out["chameleon_4k_full"] = bench_shape("Chameleon decode (3 CFG rows), full 4k cache", cham, device, cham_layers,
                                           reps, seed=1)
    valid_len, lp, n_text, n_img = interleaved_end
    km = interleaved_masks(cham["t"], valid_len, lp, n_text, n_img, device)
    out["chameleon_4k_interleaved"] = bench_shape(
        "Chameleon decode (3 CFG rows), end of an interleaved run", cham, device, cham_layers, reps,
        valid_len=valid_len, key_mask=km, seed=2)
    out["call_floor"] = bench_call_floor(device, rows_list=floor_rows, reps=reps)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--json", type=str, default=None, help="also write the numbers to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA card visible", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    out = run(device, reps=args.reps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card_line(), **out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
