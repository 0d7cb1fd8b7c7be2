"""Watermarked generation + evaluation on a CUDA card (PyTorch port of
``generate.py`` for ``--model rar``).

    python -m wmar_tpu_torch.generate --model rar --tiny --no_augs \\
        --conditioning 0,1 --num_samples_per_conditioning 2 --batch_size 4 \\
        --cache_dtype packed4 --outdir out/

The flags keep ``generate.py``'s names. ``--device`` (default ``cuda``)
names the device outright: without a CUDA card the default fails rather
than moving to the CPU, and the tests pass ``--device cpu``. Flags whose
paths are not ported yet exit with the ROADMAP item that ports them.
Without ``--tiny`` the model runs at its published widths with random
weights drawn from ``--seed``: loading checkpoints is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

_NOT_PORTED = {
    "modelpath": "checkpoint loading (ROADMAP queue 1, item 14: state-dict loads)",
    "encoder_ft_ckpt": "RCC deltas (ROADMAP queue 1, item 10)",
    "decoder_ft_ckpt": "RCC deltas (ROADMAP queue 1, item 10)",
    "sync": "sync (ROADMAP queue 1, item 11)",
    "include_neural_compress": "the neural attacks (ROADMAP queue 1, item 12)",
    "include_diffpure": "the neural attacks (ROADMAP queue 1, item 12)",
    "wm_torch_compat": "torch-compat greenlist tables (ROADMAP queue 1, item 1)",
    "interleaved": "Chameleon (ROADMAP queue 1, item 9)",
}


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--model", type=str, choices=["taming", "rar", "chameleon7b"], default="rar")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--modelpath", type=str, default=None)
    p.add_argument("--rar_size", type=str, default="rar_xl", choices=["rar_b", "rar_l", "rar_xl", "rar_xxl"])
    p.add_argument("--encoder_ft_ckpt", type=str, default=None)
    p.add_argument("--decoder_ft_ckpt", type=str, default=None)
    p.add_argument("--tiny", action="store_true", help="random tiny model (smoke test)")
    p.add_argument("--cache_dtype", type=str, default=None, choices=["bf16", "f32", "int8", "packed", "packed4"],
                   help="KV cache; packed4 is read by the hand-written CUDA decode-attention kernel")
    p.add_argument("--weight_dtype", type=str, default=None, choices=["int8", "int4"],
                   help="weight-only int8 for the generator's linears")
    p.add_argument("--num_samples_per_conditioning", type=int, default=1)
    p.add_argument("--conditioning", type=str, default="0", help="comma-separated class ids")
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--top_k", type=int, default=600)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=0.92)
    p.add_argument("--guidance_scale", type=float, default=4.0)
    p.add_argument("--chunk_id", type=int, default=0)
    p.add_argument("--num_chunks", type=int, default=1)
    for flag in ("dp", "tp", "sp", "pp"):
        p.add_argument(f"--{flag}", type=int, default=1, help="multi-GPU: not ported yet")
    p.add_argument("--orig_only", type=str2bool, default=False)
    p.add_argument("--include_neural_compress", type=str2bool, default=False)
    p.add_argument("--include_diffpure", type=str2bool, default=False)
    p.add_argument("--max_roundtrips", type=int, default=1)
    p.add_argument("--wm_method", type=str, default="gentime", choices=["none", "gentime"])
    p.add_argument("--wm_seed_strategy", type=str, default="linear", choices=["fixed", "linear", "spatial"])
    p.add_argument("--wm_split_strategy", type=str, default="stratifiedrand",
                   choices=["rand", "stratifiedrand", "clustering"])
    p.add_argument("--wm_context_size", type=int, default=1)
    p.add_argument("--wm_delta", type=float, default=2.0)
    p.add_argument("--wm_gamma", type=float, default=0.25)
    p.add_argument("--wm_torch_compat", type=str2bool, default=False)
    p.add_argument("--sync", type=str2bool, default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_augs", action="store_true")
    p.add_argument("--interleaved", type=str, default=None)
    return p


def _refuse_unported(args) -> None:
    if args.model != "rar":
        raise SystemExit(f"--model {args.model} is not ported yet (ROADMAP queue 1, items 7 and 9)")
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False, "none"):
            raise SystemExit(f"--{name}: {what} is not ported yet")
    if any(getattr(args, f) != 1 for f in ("dp", "tp", "sp", "pp")):
        raise SystemExit("--dp/--tp/--sp/--pp: multi-GPU runs are not ported yet (ROADMAP queue 1, item 14)")
    if not (args.no_augs or args.orig_only):
        raise SystemExit("the attack grid is not ported yet (ROADMAP queue 1, items 8 and 12): pass --no_augs")
    if args.wm_split_strategy == "clustering":
        raise SystemExit("--wm_split_strategy clustering is not ported yet (ROADMAP queue 1, item 1)")
    if args.weight_dtype == "int4":
        raise SystemExit("--weight_dtype int4 is not ported yet (ROADMAP queue 2, kernel 8)")
    if args.cache_dtype == "packed":
        raise SystemExit("--cache_dtype packed is not ported yet (ROADMAP queue 2, kernel 2)")


def load_wrapper(args, device: torch.device):
    from wmar_tpu_torch.models import (
        MASKGIT_IMAGENET_F16,
        MaskGitVQConfig,
        RARConfig,
        RarARMM,
        init_maskgit,
        init_rar,
        rar_config,
    )

    if args.tiny:
        rar_cfg = RARConfig(embed_dim=64, depth=2, num_heads=2, intermediate_size=128,
                            image_seq_len=16, codebook_size=64, num_classes=10)
        vq_cfg = MaskGitVQConfig(resolution=8, hidden_channels=32, channel_mult=(1, 2),
                                 num_res_blocks=1, z_channels=16, n_embed=64, embed_dim=16)
        dtype, cache_dtype = torch.float32, torch.float32
    else:
        rar_cfg, vq_cfg = rar_config(args.rar_size), MASKGIT_IMAGENET_F16
        dtype, cache_dtype = torch.bfloat16, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rar = init_rar(rar_cfg, gen, dtype=dtype, device=device)
    vq = init_maskgit(vq_cfg, gen, dtype=dtype, device=device)
    return RarARMM(rar, vq, cache_dtype=cache_dtype, device=device)


def main(argv=None):
    args = get_parser().parse_args(argv)
    for attr in ("encoder_ft_ckpt", "decoder_ft_ckpt", "modelpath"):
        if getattr(args, attr, None) == "none":
            setattr(args, attr, None)
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")

    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.eval import EvalParams, generate_and_evaluate
    from wmar_tpu_torch.models import GenParams, quantize_rar_params_int8

    wrapper = load_wrapper(args, device)
    if args.cache_dtype:
        wrapper.cache_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
                               "packed4": "packed4"}[args.cache_dtype]
    if args.weight_dtype == "int8":
        quantize_rar_params_int8(wrapper.rar, compute_dtype=torch.bfloat16)

    apply_wm = args.wm_method == "gentime"
    if apply_wm:
        method = (f"{args.wm_seed_strategy}-{args.wm_split_strategy}-"
                  f"h={args.wm_context_size}-d={args.wm_delta:.1f}-g={args.wm_gamma:.2f}")
        spec = WatermarkSpec.from_string(method, vocab_size=wrapper.get_total_vocab_size(),
                                         spatial_dim=wrapper.codes_size)
        wrapper.set_watermarker(spec)

    conds = [int(c) for c in args.conditioning.split(",")]
    all_inputs = [c for c in conds for _ in range(args.num_samples_per_conditioning)]
    gen = GenParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                    guidance_scale=args.guidance_scale, guidance_scale_pow=0.0)
    eval_params = EvalParams(max_roundtrips=args.max_roundtrips, orig_only=args.orig_only)
    records = generate_and_evaluate(
        args.outdir, wrapper, all_inputs, gen, eval_params, None,
        batch_size=args.batch_size, seed=args.seed, chunk_id=args.chunk_id,
        num_chunks=args.num_chunks, apply_watermark=apply_wm,
    )
    print(f"wrote {len(records)} records to {args.outdir}")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
