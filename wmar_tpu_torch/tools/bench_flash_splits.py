#!/usr/bin/env python
"""Sweep of the split-over-T decode kernels (#5, #6; #3, #4) over the split count and the fill.

    python -m wmar_tpu_torch.tools.bench_flash_splits [--splits 1,2,4,6,8] [--fills 1,64,...,4096]
    python -m wmar_tpu_torch.tools.bench_flash_splits --packed [--splits 1,2,4,8,16] [--loads_only] [--short]
    python -m wmar_tpu_torch.tools.bench_flash_splits --dims

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
``packed4_decode_attention`` (#1; in this tree both the tiled kernel of #3
and #4). At every int8 shape without masks it also times the DMA probe #7,
which is the int8 kernel's loads alone (its instantiation with the math
compiled out), prints how many blocks of each instantiation share an SM,
and ends with a sweep of both layouts over the rows of the short caches
(:func:`run_rows`). ``--loads_only`` builds the library with
``-DWMAR_PACKED_LOADS_ONLY`` (the int4 kernels' math compiled out): what
their loads alone cost. Run with ``PYTHONPATH`` set to an older tree whose
launcher takes no ``splits``, it times that tree's wrappers (and probe)
only, to set an older tree's numbers beside this one's on one card.
``--short`` stops after the two short caches (for comparing builds of
edited sources). ``--dims`` times kernel #2 and its probe over head dims
48-128 at the same bytes (:func:`run_dims`).

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


def run_packed(device, splits, fills, n_layers: int = 4, short: bool = False) -> None:
    """Kernels #3 and #4: the wrappers and every forced ``S`` at the two
    shapes, then ``S = 1`` and the planner's over the fill; ``short``: the
    short caches of kernels #1, #2 and #7 only."""
    can_force = "splits" in inspect.signature(fd._launch_packed).parameters
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    payloads = (("#3", "packed", False, fd.packed_decode_attention_q8_chunked, 1, torch.int8),
                ("#4", "packed4", True, fd.packed4_decode_attention_chunked, 0.5, torch.uint8))
    # below 1024 slots the public wrappers, kernels #2 (int8) and #1 (int4), in this tree and an older one
    short_cache = {"#3": ("#2", fd.packed_decode_attention_q8), "#4": ("#1", fd.packed4_decode_attention)}
    t2i_start = torch.cat([torch.arange(8), 130 + torch.arange(16)]).to(torch.int32).to(device)
    cases = [("RAR-XL, full", ba.RAR_XL, 258, None, None), ("Taming-1.4B, full", TAMING, 257, None, None),
             ("t2i, full, ragged start", CHAMELEON_T2I, 1043, t2i_start, None),
             ("sampler, full", ba.CHAMELEON_4K, 4096, None, None),
             ("sampler, end of a run", ba.CHAMELEON_4K, 1160, None, "interleaved")]
    cases = cases[:2] if short else cases
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
                name, wrapper = short_cache[name]
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
            if not int4 and start is None and km is None:  # the probe walks all T slots with no mask
                probe_ms = ba.graph_ms(lambda li: fd._packed_dma_probe(q, c.kv, c.scale, li), layers)
                print(f"  #7 (the DMA probe: {name}'s loads alone) ms from a graph {probe_ms:.4f}", flush=True)
    if hasattr(fd, "packed_blocks_per_sm"):
        print("blocks an SM (occupancy calculator, bf16 q): "
              + ", ".join(f"D={d} {'int4' if int4 else 'int8'}{' probe' if probe else ''} "
                          f"{fd.packed_blocks_per_sm(d, int4, True, probe=probe)}"
                          for d in (80, 104, 128) for int4, probe in ((True, False), (False, False), (False, True))))
    if not can_force or short:
        return
    if hasattr(fd, "packed_decode_plan"):
        run_rows(device, sms)
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


def run_rows(device, sms: int, rows=(16, 32, 48, 56, 64, 96, 128), dims=(80, 104), t: int = 258) -> None:
    """The layouts of the short caches against the rows: at ``t`` slots and
    16 heads of each of ``dims``, for both payloads, graph ms of a warp per
    (row, head) and of blocks of four warps with S = 1, 2 and 4, beside the
    planner's choice: where the warp-per-(row, head) layout starts to win
    (``packed_decode_warp_head``'s threshold) and which S the blocks want
    (``_PACKED_BLOCKS_PER_SM``)."""
    h = 16
    print(f"rows sweep at {t} slots x {h} heads, ms from a graph (pairs an SM = rows x heads / {sms}):")
    for d in dims:
        for b in rows:
            layers = -(-160_000_000 // (b * t * h * d))  # the int4 layers walked pass the 50 MB L2
            gen = torch.Generator(device=device).manual_seed(2)
            cs = ba.filled_caches(layers, b, h, t, d, gen, device, kinds=("packed", "packed4"))
            q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
            lens = torch.full((1,), t, dtype=torch.int32, device=device)
            row = []
            for kind, int4 in (("packed", False), ("packed4", True)):
                c = cs[kind]
                plan = fd.packed_decode_plan(b, h, t, d, int4, sms)
                cells = [f"{'#2' if not int4 else '#1'}"]
                for s_, wh in ((1, True), (1, False), (2, False), (4, False)):
                    ms = ba.graph_ms(lambda li: fd._launch_packed(q, c.kv, c.scale, li, lens, None, None, int4,
                                                                  splits=s_, warp_head=wh), layers)
                    cells.append(f"{'warp' if wh else f'S={s_}'} {ms:.4f}")
                row.append(" ".join(cells))
            print(f"  D={d} B={b:3d} ({b * h / sms:5.1f} pairs an SM; planner: S={plan.splits}, "
                  f"{'warp' if plan.warp_head else 'block'}): " + " | ".join(row), flush=True)
            del cs


def run_dims(device, dims=(48, 64, 80, 96, 112, 128, 88, 104), h: int = 16, t: int = 258) -> None:
    """Kernel #2 and its loads alone (#7) over head dims at the same bytes
    (RAR-XL's 128 rows at D = 80, scaled): the rate against how a head's run
    lies in 32-byte sectors and how many bytes one load instruction of a
    warp moves."""
    print(f"head-dim sweep at {t} slots x {h} heads, int8, ~87 MB a layer, ms from a graph:")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for d in dims:
        b = 128 * 80 // d
        layers = max(3, -(-160_000_000 // (b * t * h * d)))
        gen = torch.Generator(device=device).manual_seed(3)
        c8 = ba.filled_caches(layers, b, h, t, d, gen, device, kinds=("packed",))["packed"]
        q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
        lens = torch.full((1,), t, dtype=torch.int32, device=device)
        nbytes = b * t * h * (2 * d + 4)
        sectors = sum(-(-((hh * d) % 32 + d) // 32) for hh in range(h)) * 32 / (h * d)
        plan = fd.packed_decode_plan(b, h, t, d, False, sms)
        k2 = ba.graph_ms(lambda li: fd.packed_decode_attention_q8(q, c8.kv, c8.scale, li, lens), layers)
        k7 = ba.graph_ms(lambda li: fd._packed_dma_probe(q, c8.kv, c8.scale, li), layers)
        per_load = 32 // plan.lanes * min(d + (8 if plan.window else 0), plan.lanes * plan.load_bytes)
        print(f"  D={d:3d} B={b:3d}: {nbytes / 1e6:.1f} MB, sector bytes per byte used {sectors:.3f}, bytes a warp load "
              f"{per_load}, {plan.lanes} lanes of {plan.load_bytes} bytes{' (window)' if plan.window else ''}: #2 "
              f"{k2:.4f} ({nbytes / (k2 * 1e-3) / 1e12:.2f} TB/s) | #7 {k7:.4f} ({nbytes / (k7 * 1e-3) / 1e12:.2f} TB/s)",
              flush=True)
        del c8


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--splits", type=str, default="1,2,4,6,8")
    p.add_argument("--fills", type=str, default="1,64,256,512,1024,2048,3072,4096")
    p.add_argument("--packed", action="store_true", help="kernels #3 and #4 instead of #5 and #6")
    p.add_argument("--loads_only", action="store_true",
                   help="with --packed: build the int4 kernels with their math compiled out")
    p.add_argument("--short", action="store_true",
                   help="with --packed: only the short caches (RAR-XL, Taming: kernels #1, #2 and #7)")
    p.add_argument("--dims", action="store_true", help="kernel #2 and #7 over head dims at the same bytes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash_splits: no CUDA card visible", file=sys.stderr)
        return 1
    print(f"card: {ba.card_line()}")
    splits, fills = [int(s) for s in args.splits.split(",")], [int(n) for n in args.fills.split(",")]
    if args.loads_only:
        from wmar_tpu_torch.ops import build

        build.NVCC_FLAGS.append("-DWMAR_PACKED_LOADS_ONLY")  # part of the library's hash: a build of its own
        print("loads only: the int4 packed kernels' math is compiled out, their outputs mean nothing")
    if args.dims:
        run_dims(torch.device("cuda", 0))
    elif args.packed:
        run_packed(torch.device("cuda", 0), splits, fills, short=args.short)
    else:
        run(torch.device("cuda", 0), splits, fills)
    return 0


if __name__ == "__main__":
    sys.exit(main())
