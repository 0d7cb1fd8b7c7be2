"""Tokenize an image dataset into per-sample ``.npy`` code files (PyTorch
port of the root ``precompute_imagenet_codes.py``).

    python -m wmar_tpu_torch.precompute_imagenet_codes --model taming \\
        --modelpath ckpts/taming --datapath /data/imagenet --outdir codes/ --per_class 50
    python -m wmar_tpu_torch.precompute_imagenet_codes --model rar --tiny \\
        --device cpu --datapath images/ --outdir codes/

Images are centre-cropped and resized (PIL, bicubic) to the tokenizer's
resolution on the host, then encoded in batches on ``--device`` (default
``cuda``; without a card it exits) through the tokenizer of
``wmar_tpu_torch.generate.load_wrapper``: ``--tiny`` random weights,
``--modelpath`` files, or the published widths with random weights from
seed 0. ``python -m wmar_tpu_torch.finetune --datapath <outdir>``
trains on the files.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, choices=["taming", "rar", "chameleon7b"], default="taming")
    p.add_argument("--modelpath", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--datapath", type=str, required=True, help="directory of images (class subdirs optional)")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--per_class", type=int, default=50)
    p.add_argument("--split_file", type=str, default=None,
                   help="restrict to the filenames listed here, one per line (the reference's "
                        "assets/imagenet_512_split_50k.txt custom split for 512px Chameleon)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--total_chunks", type=int, default=1)
    return p


def load_image(path: str, size: int) -> np.ndarray:
    """Centre crop to a square, bicubic resize to ``size``: HWC float32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def select_files(args) -> list:
    """The images of ``--datapath`` (JPEG, jpg, png), sorted, restricted to
    ``--split_file``, at most ``--per_class`` per class directory, then this
    chunk's share."""
    files = sorted(
        glob.glob(os.path.join(args.datapath, "**", "*.JPEG"), recursive=True)
        + glob.glob(os.path.join(args.datapath, "**", "*.jpg"), recursive=True)
        + glob.glob(os.path.join(args.datapath, "**", "*.png"), recursive=True)
    )
    if args.split_file:
        with open(args.split_file) as fh:
            wanted = {line.strip() for line in fh if line.strip()}
        files = [f for f in files
                 if os.path.basename(f) in wanted or os.path.splitext(os.path.basename(f))[0] in wanted]
    by_class = {}
    for f in files:
        cls = os.path.basename(os.path.dirname(f))
        by_class.setdefault(cls, [])
        if len(by_class[cls]) < args.per_class:
            by_class[cls].append(f)
    selected = [f for fs in by_class.values() for f in fs]
    return selected[args.chunk_idx:: args.total_chunks]


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    from wmar_tpu_torch.generate import load_wrapper

    wrapper = load_wrapper(argparse.Namespace(
        model=args.model, modelpath=args.modelpath, tiny=args.tiny, seed=0, rar_size="rar_xl",
        encoder_ft_ckpt=None, decoder_ft_ckpt=None), device)
    size = wrapper.image_size
    selected = select_files(args)
    print(f"encoding {len(selected)} images at {size}px")
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(0, len(selected), args.batch_size):
        batch_files = selected[i: i + args.batch_size]
        imgs = torch.from_numpy(np.stack([load_image(f, size) for f in batch_files])).to(device)
        with torch.no_grad():
            codes = wrapper.images_to_codes(imgs).cpu().numpy()
        for f, c in zip(batch_files, codes):
            cls = os.path.basename(os.path.dirname(f))
            stem = os.path.splitext(os.path.basename(f))[0]
            np.save(os.path.join(args.outdir, f"{cls}_{stem}.npy"), c)
        print(f"{i + len(batch_files)}/{len(selected)}")


if __name__ == "__main__":
    main(sys.argv[1:])
