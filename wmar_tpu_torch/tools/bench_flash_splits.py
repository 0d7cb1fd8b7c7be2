#!/usr/bin/env python
"""Sweep of the split-over-T decode kernels (#5, #6; #3, #4) over the split count and the fill.

    python -m wmar_tpu_torch.tools.bench_flash_splits [--splits 1,2,4,6,8] [--fills 1,64,...,4096]
    python -m wmar_tpu_torch.tools.bench_flash_splits --packed [--splits 1,2,4,8,16] [--loads_only]

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

With ``--packed`` the same for the chunked packed kernels
(``packed_decode_attention_q8_chunked``, #3, and
``packed4_decode_attention_chunked``, #4), graph-replayed ms beside the byte
bound: at the 4096-slot shape (full, and the end of an interleaved run) and
at the Chameleon text-to-image shape (24 CFG rows, 1043 slots full, the ragged
``start`` of ``chip_smoke.py``), first through the wrappers (the planner's
``S``), then every ``S`` of ``--splits`` forced, then the fill sweep at the
4096-slot shape. First of all it times the short caches of RAR-XL (128 rows,
258 slots, 16 heads of 80) and Taming-1.4B (32 rows, 257 slots, 16 heads of
104) through the public wrappers ``packed_decode_attention_q8`` (#2) and
``packed4_decode_attention`` (#1, the same tiled kernel as #4 in this tree). ``--loads_only`` builds the library with
``-DWMAR_PACKED_LOADS_ONLY`` (the kernels' math compiled out): what their loads
alone cost. Run with ``PYTHONPATH`` set to an older tree whose launcher takes
no ``splits``, it times that tree's wrappers only: the parent's numbers in the
same session.

This is the tool the kernels' constants (warps per block, passes per tile,
ring stages in ``csrc/flash_decode_attention.cu`` and
``csrc/packed_chunked_attention.cu``, blocks per SM of the planners) were
chosen with: edit one, run it again (the library is rebuilt from the sources'
hash). It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import inspect
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


CHAMELEON_T2I = dict(b=24, h=32, t=1043, d=128)  # CHAMELEON_7B, 8 prompts x 3 CFG rows, 19 + 1024 slots
TAMING = dict(b=32, h=16, t=257, d=104)  # TAMING_GPT_1_4B, 32 classes; 1 + 256 slots


def run_packed(device, splits, fills, n_layers: int = 4) -> None:
    """Kernels #3 and #4: the wrappers and every forced ``S`` at the two
    shapes, then ``S = 1`` and the planner's over the fill."""
    can_force = "splits" in inspect.signature(fd._launch_packed).parameters
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    payloads = (("#3", "packed", False, fd.packed_decode_attention_q8_chunked, 1, torch.int8),
                ("#4", "packed4", True, fd.packed4_decode_attention_chunked, 0.5, torch.uint8))
    # below 1024 slots the public wrappers, kernels #2 (int8) and #1 (int4), in this tree and an older one
    short = {"#3": ("#2", fd.packed_decode_attention_q8), "#4": ("#1", fd.packed4_decode_attention)}
    t2i_start = torch.cat([torch.arange(8), 130 + torch.arange(16)]).to(torch.int32).to(device)
    cases = [("RAR-XL, full", ba.RAR_XL, 258, None, None), ("Taming-1.4B, full", TAMING, 257, None, None),
             ("t2i, full, ragged start", CHAMELEON_T2I, 1043, t2i_start, None),
             ("sampler, full", ba.CHAMELEON_4K, 4096, None, None),
             ("sampler, end of a run", ba.CHAMELEON_4K, 1160, None, "interleaved")]
    caches = {}
    for tag, shape, n, start, mask in cases:
        b, h, t, d = shape["b"], shape["h"], shape["t"], shape["d"]
        layers = max(n_layers, -(-120_000_000 // (b * t * h * d)))  # the int4 layers walked pass the 50 MB L2
        if (b, t) not in caches:
            gen = torch.Generator(device=device).manual_seed(1)
            caches.clear()  # one shape's caches at a time
            caches[(b, t)] = (ba.filled_caches(layers, b, h, t, d, gen, device, kinds=("packed", "packed4")),
                              torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16))
        cs, q = caches[(b, t)]
        lens = torch.full((1,), n, dtype=torch.int32, device=device)
        km = ba.interleaved_masks(t, n, 7, 64, 1024, device) if mask else None
        planned = fd.packed_decode_splits(b, h, t, sms) if can_force else None
        print(f"{tag}: B={b} H={h} T={t} D={d}, valid_len {n}; the planner's S = {planned}")
        for name, kind, int4, wrapper, payload_bytes, kv_dtype in payloads:
            if t < 1024:
                name, wrapper = short[name]
            c = cs[kind]
            bound_ms, _ = ba.attention_bound(b, h, t, d, n, payload_bytes, True, q.dtype, kv_dtype, start, km)
            ms = ba.graph_ms(lambda li: wrapper(q, c.kv, c.scale, li, lens, start=start, key_mask=km), layers)
            row = [f"wrapper {ms:.4f}"]
            for s in splits if can_force else ():
                row.append(f"S={s}: " + "%.4f" % ba.graph_ms(
                    lambda li: fd._launch_packed(q, c.kv, c.scale, li, lens, start, km, int4, splits=s), layers))
            if "warp_head" in inspect.signature(fd._launch_packed).parameters:
                for wh in (True, False):
                    row.append(f"S=1, {'a warp' if wh else 'a block'} per (row, head): " + "%.4f" % ba.graph_ms(
                        lambda li: fd._launch_packed(q, c.kv, c.scale, li, lens, start, km, int4, splits=1,
                                                     warp_head=wh), layers))
            print(f"  {name} ms from a graph, bound {bound_ms:.4f}: " + " | ".join(row), flush=True)
    if not can_force:
        return
    cs, q = caches[(3, 4096)]  # the last case's
    planned = fd.packed_decode_splits(3, 32, 4096, sms)
    lens = torch.zeros((1,), dtype=torch.int32, device=device)
    print(f"fill sweep at the 4096-slot shape, us per call from a graph (the planner's S = {planned}):")
    for n in fills:
        lens.fill_(n)
        row = []
        for s in sorted({1, planned}):
            us = [ba.graph_ms(lambda li, c=cs[kind], i4=int4: fd._launch_packed(q, c.kv, c.scale, li, lens, None, None,
                                                                                 i4, splits=s), n_layers) * 1e3
                  for _, kind, int4, *_ in payloads]
            row.append(f"S={s}: #3 {us[0]:7.2f}  #4 {us[1]:7.2f}")
        print(f"  valid_len={n:5d}  " + " | ".join(row), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--splits", type=str, default="1,2,4,6,8")
    p.add_argument("--fills", type=str, default="1,64,256,512,1024,2048,3072,4096")
    p.add_argument("--packed", action="store_true", help="kernels #3 and #4 instead of #5 and #6")
    p.add_argument("--loads_only", action="store_true",
                   help="with --packed: build the kernels with their math compiled out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash_splits: no CUDA card visible", file=sys.stderr)
        return 1
    print(f"card: {ba.card_line()}")
    splits, fills = [int(s) for s in args.splits.split(",")], [int(n) for n in args.fills.split(",")]
    if args.loads_only:
        from wmar_tpu_torch.ops import build

        build.NVCC_FLAGS.append("-DWMAR_PACKED_LOADS_ONLY")  # part of the library's hash: a build of its own
        print("loads only: the packed chunked kernels' math is compiled out, their outputs mean nothing")
    if args.packed:
        run_packed(torch.device("cuda", 0), splits, fills)
    else:
        run(torch.device("cuda", 0), splits, fills)
    return 0


if __name__ == "__main__":
    sys.exit(main())
