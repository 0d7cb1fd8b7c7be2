#!/usr/bin/env python
"""Kernel #8 (``matmul_w4``, the w4a16 product) on the card, beside its yardsticks.

    python -m wmar_tpu_torch.tools.bench_w4 [--splits 1,2,4,8] [--reps 50] [--json out.json]
    python -m wmar_tpu_torch.tools.bench_w4 --variant loads_only|math_only --splits 1,2,4,8

At the products of the main paths (Taming-1.4B's four at 32 rows, and
Chameleon-7B's FFN up-projection at 24 rows; group 128) it walks enough
weight copies to exceed the 50 MB L2 cache, as a decode step does, and times:

  kernel        ``matmul_w4`` replayed from a CUDA graph (``graph_ms``: what the
                card needs) and by CUDA events around the call (``ms``: the
                host's gap included), beside the byte bound (nibbles, scales,
                x and the output once each over 3.35 TB/s);
  plain         ``matmul_w4_plain``, the same math in float32 torch;
  int4pack      one ``torch._weight_int4pack_mm`` call on the same nibbles
                (converted once, outside the timing, with zeros 0 so that it
                computes (q - 8) * s): the library yardstick, called nowhere in
                the port;
  bf16 matmul   one ``torch.matmul`` on the dequantized bf16 weight, which reads
                4x the bytes;
  splits        with ``--splits``, the kernel with each split count of K forced
                (the planner's is ``w4_splits``).

``--variant`` builds the tensor-core kernel with its math (``loads_only``) or
its loads (``math_only``) compiled out and times the kernel alone: what each
part costs by itself.

Run with ``PYTHONPATH`` set to an older tree, it times that tree's kernel (the
split sweep only where its wrapper has ``_launch``): the parent's numbers in
the same run on the same card. It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from wmar_tpu_torch.ops import w4_matmul as tw4
from wmar_tpu_torch.ops.wquant import quantize_matrix_int4
from wmar_tpu_torch.tools import bench_attention as ba

# (label, M, K, N): Taming-1.4B's products at 32 rows, Chameleon-7B's FFN up-projection at 24
SHAPES = (("taming qkv/proj", 32, 1664, 1664), ("taming fc", 32, 1664, 6656), ("taming mlp proj", 32, 6656, 1664),
          ("taming head", 32, 1664, 16384), ("chameleon ffn", 24, 4096, 11008))
BF16_REL_TOL = 2.0**-8 + 1e-5


def int4pack_library(w, group: int):
    """One ``torch._weight_int4pack_mm`` call on the nibbles of ``w`` (``q4
    [K/G, G/2, N]``, ``s4 [K/G, N]``), converted to its layout once:
    ``uint8 [N, K/2]`` with an even k in the high nibble, then
    ``_convert_weight_to_int4pack``, and zeros 0."""
    q = tw4.unpack_int4(w["q4"]) + 8  # [gc, G, N] in [0, 16)
    qt = q.reshape(-1, q.shape[-1]).t().contiguous()  # [N, K]
    packed = ((qt[:, ::2] << 4) | qt[:, 1::2]).to(torch.uint8).contiguous()
    wp = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([w["s4"], torch.zeros_like(w["s4"])], dim=-1).contiguous()  # [K/G, N, 2]
    return lambda x: torch._weight_int4pack_mm(x, wp, group, sz)


def dequantized_bf16(w) -> torch.Tensor:
    """The bf16 ``[K, N]`` weight that ``w`` stands for."""
    qf = tw4.unpack_int4(w["q4"]).to(torch.float32) * w["s4"].to(torch.float32)[:, None, :]
    return qf.reshape(-1, qf.shape[-1]).to(torch.bfloat16)


def time_shape(device, label: str, m: int, k: int, n: int, gen, reps: int = 50, l2_bytes: float = 120e6,
               splits=(), yardsticks: bool = True) -> dict:
    """Every variant at one ``(M, K, N)``, group 128; see the module's doc.
    ``yardsticks`` False: the kernel alone (graph-replayed, forced splits)."""
    wbytes = k * n // 2 + 2 * (k // 128) * n  # nibbles + bf16 scales
    copies = max(1, int(-(-l2_bytes // wbytes)))
    ws = [quantize_matrix_int4(torch.randn((k, n), generator=gen, device=device) * 0.02, group=128)
          for _ in range(copies)]
    x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
    want = tw4.matmul_w4_plain(x.float(), ws[0]["q4"], ws[0]["s4"])
    tol = BF16_REL_TOL * want.abs().max().item() + 1e-6

    def kernel(i):
        return tw4.matmul_w4(x, ws[i]["q4"], ws[i]["s4"])

    times = (ba.time_turns(kernel, lambda i: tw4.matmul_w4_plain(x, ws[i]["q4"], ws[i]["s4"]), copies, reps)
             if yardsticks else [float("nan")] * 4)
    # weights and scales, x and the output once each; 2 flops per weight and row at the bf16 rate
    bound_ms, bound_by = ba.bound(wbytes + 2 * m * (k + n), 2.0 * m * k * n, torch.bfloat16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"label": label, "m": m, "k": k, "n": n, "card": ba.card_line(),
           "splits": tw4.w4_splits(m, n, k, 128, sms) if hasattr(tw4, "w4_splits") else None,
           "graph_ms": ba.graph_ms(kernel, copies), "ms": min(times[1], times[2]),
           "plain_ms": min(times[0], times[3]), "bound_ms": bound_ms, "bound_by": bound_by, "times": times,
           "max_abs_err": (kernel(0).float() - want).abs().max().item(), "tol": tol}
    out["forced"] = {}
    if hasattr(tw4, "_launch"):
        for s in splits:
            if 1 <= s <= -(-k // 128):
                out["forced"][s] = ba.graph_ms(lambda i: tw4._launch(x, ws[i]["q4"], ws[i]["s4"], splits=s), copies)
    if not yardsticks:
        print(f"{label} M={m} K={k} N={n}, S = {out['splits']}: kernel {out['graph_ms']:.4f} ms from a graph; "
              f"forced S from a graph: " + " ".join(f"{s}: {t:.4f}" for s, t in out["forced"].items()), flush=True)
        return out
    libs = [int4pack_library(w, 128) for w in ws]
    out["int4pack_max_abs_err"] = (libs[0](x).float() - want).abs().max().item()
    out["int4pack_same_function"] = out["int4pack_max_abs_err"] <= 2 * tol  # the library rounds in bf16 too
    out["int4pack_graph_ms"] = ba.graph_ms(lambda i: libs[i](x), copies)
    out["int4pack_ms"] = ba.median_ms(lambda i: libs[i](x), copies, reps)
    del libs
    dense_copies = max(1, int(-(-l2_bytes // (2 * k * n))))
    dense = [dequantized_bf16(ws[i % copies]) for i in range(dense_copies)]
    out["bf16_matmul_graph_ms"] = ba.graph_ms(lambda i: torch.matmul(x, dense[i]), dense_copies)
    out["bf16_matmul_ms"] = ba.median_ms(lambda i: torch.matmul(x, dense[i]), dense_copies, reps)
    del dense
    print(f"{label} M={m} K={k} N={n}, {copies} weight copies walked, S = {out['splits']}: kernel "
          f"{out['graph_ms']:.4f} ms from a graph, {out['ms']:.4f} by events (bound {bound_ms:.4f} by {bound_by}, "
          f"{100 * bound_ms / out['graph_ms']:.0f}%; max abs err {out['max_abs_err']:.3e}, tol {tol:.3e}); plain "
          f"{out['plain_ms']:.4f}; torch._weight_int4pack_mm {out['int4pack_graph_ms']:.4f} from a graph, "
          f"{out['int4pack_ms']:.4f} by events (max abs err {out['int4pack_max_abs_err']:.3e}"
          f"{'' if out['int4pack_same_function'] else ', NOT the same function'}); bf16 torch.matmul "
          f"{out['bf16_matmul_graph_ms']:.4f} from a graph, {out['bf16_matmul_ms']:.4f} by events"
          + ("; forced S from a graph: " + " ".join(f"{s}: {t:.4f}" for s, t in out["forced"].items())
             if out["forced"] else ""), flush=True)
    return out


def run(device, shapes=SHAPES, reps: int = 50, splits=(), yardsticks: bool = True) -> list:
    gen = torch.Generator(device=device).manual_seed(3)
    return [time_shape(device, *shape, gen, reps=reps, splits=splits, yardsticks=yardsticks) for shape in shapes]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--splits", type=str, default="", help="split counts of K to force, comma-separated")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--variant", choices=("loads_only", "math_only"), default=None,
                   help="build the tensor-core kernel with a part compiled out (its outputs mean nothing)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_w4: no CUDA card visible", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {ba.card_line()}")
    if args.variant:
        from wmar_tpu_torch.ops import build

        build.NVCC_FLAGS.append(f"-DWMAR_W4_{args.variant.upper()}")  # part of the library's hash: a build of its own
        print(f"variant {args.variant}: the kernel's outputs mean nothing; its times are what is left")
    res = run(device, reps=args.reps, splits=[int(s) for s in args.splits.split(",") if s],
              yardsticks=args.variant is None)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": ba.card_line(), "shapes": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
