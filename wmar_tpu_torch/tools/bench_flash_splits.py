#!/usr/bin/env python
"""Sweep of the flash-decode kernels (#5, #6) over the split count and the fill.

    python -m wmar_tpu_torch.tools.bench_flash_splits [--splits 1,2,4,6,8] [--fills 1,64,...,4096]

At the interleaved Chameleon shape (3 CFG rows, 32 heads of 128, a 4096-slot
cache, 4 layers walked) it times ``flash_decode_attention`` (bf16 cache) and
``flash_decode_attention_q8`` (int8 cache) through the private launcher with
``S`` blocks per (row, head) forced, replayed from a CUDA graph
(``bench_attention.graph_ms``) and by CUDA events:

  full, end    every ``S`` of ``--splits`` over the full cache and at the end
               of an interleaved run (1160 valid slots, the three key masks),
               beside one ``scaled_dot_product_attention`` call (a yardstick);
  fill sweep   ``S = 1`` and the planner's ``S`` at every ``valid_len`` of
               ``--fills``: the time at 1 slot is what a launch, the prologue
               and (``S > 1``) the merge cost; the slope is the streaming rate.

This is the tool the kernel's constants (warps per block, passes per tile,
ring stages in ``csrc/flash_decode_attention.cu``) were chosen with: edit one,
run it again (the library is rebuilt from the sources' hash). It needs a CUDA
card and fails without one.
"""

from __future__ import annotations

import argparse
import sys

import torch

from wmar_tpu_torch.ops import flash_decode as fd
from wmar_tpu_torch.tools import bench_attention as ba


def run(device, splits, fills, shape=ba.CHAMELEON_4K, n_layers: int = 4, reps: int = 50) -> None:
    b, h, t, d = shape["b"], shape["h"], shape["t"], shape["d"]
    gen = torch.Generator(device=device).manual_seed(1)
    caches = ba.filled_caches(n_layers, b, h, t, d, gen, device, kinds=("bf16", "int8"))
    c16, c8 = caches["bf16"], caches["int8"]
    q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
    lens = torch.zeros((1,), dtype=torch.int32, device=device)

    def kernels(s, mask):
        return (lambda li: fd._launch_flash(q, c16.k[li], c16.v[li], None, None, lens, None, mask, splits=s),
                lambda li: fd._launch_flash(q, c8.k[li], c8.v[li], c8.k_scale[li], c8.v_scale[li], lens, None, mask,
                                            splits=s))

    end_mask = ba.interleaved_masks(t, 1160, 7, 64, 1024, device)
    for tag, n, mask in (("full", t, None), ("end", 1160, end_mask)):
        lens.fill_(n)
        attn_mask = ba.sdpa_mask(b, t, n, None, mask, device)

        def sdpa(li):
            return ba.library_attention(q, c16.k[li], c16.v[li], attn_mask)

        print(f"{tag} (valid_len {n}): SDPA {ba.graph_ms(sdpa, n_layers):.4f} ms from a graph, "
              f"{ba.median_ms(sdpa, n_layers, reps):.4f} by events")
        for s in splits:
            f5, f8 = kernels(s, mask)
            print(f"  S={s:2d}: #5 {ba.graph_ms(f5, n_layers):.4f} ms from a graph, {ba.median_ms(f5, n_layers, reps):.4f} "
                  f"by events | #6 {ba.graph_ms(f8, n_layers):.4f}, {ba.median_ms(f8, n_layers, reps):.4f}", flush=True)
    planned = fd.flash_decode_splits(b, h, t, torch.cuda.get_device_properties(device).multi_processor_count)
    print(f"fill sweep, us per call from a graph (the planner's S = {planned}):")
    for n in fills:
        lens.fill_(n)
        row = []
        for s in sorted({1, planned}):
            f5, f8 = kernels(s, None)
            row.append(f"S={s}: #5 {ba.graph_ms(f5, n_layers) * 1e3:7.2f}  #6 {ba.graph_ms(f8, n_layers) * 1e3:7.2f}")
        print(f"  valid_len={n:5d}  " + " | ".join(row), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--splits", type=str, default="1,2,4,6,8")
    p.add_argument("--fills", type=str, default="1,64,256,512,1024,2048,3072,4096")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash_splits: no CUDA card visible", file=sys.stderr)
        return 1
    print(f"card: {ba.card_line()}")
    run(torch.device("cuda", 0), [int(s) for s in args.splits.split(",")], [int(n) for n in args.fills.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
