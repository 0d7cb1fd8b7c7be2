"""Rebuild finetuned weights from a base checkpoint and delta files (PyTorch
port of ``tools/apply_deltas.py``).

    python -m wmar_tpu_torch.tools.apply_deltas --base vqgan.msgpack \\
        --delta out/epoch9_decoder_delta.msgpack=decoder \\
        --delta out/epoch9_encoder_delta.msgpack=encoder \\
        --output vqgan_finetuned.msgpack

Each ``--delta`` is ``PATH[=SUBTREE]``: without ``=SUBTREE`` the delta
matches the whole base tree; with it, the delta is added at that
dot-separated key path inside the base. Files are flax msgpack, read and
written by the port's own codec; deltas are added in float32 and cast to
the base leaf's dtype. No model code is needed.
"""

from __future__ import annotations

import argparse
import os

from wmar_tpu_torch.utils import checkpoint as ckpt
from wmar_tpu_torch.utils import msgpack_codec


def _add_at(base, delta, keypath: str):
    """``base`` with ``delta`` added at the subtree named by ``keypath``."""
    if not keypath:
        return ckpt.apply_delta(base, delta)
    head, _, rest = keypath.partition(".")
    if not isinstance(base, dict) or head not in base:
        raise KeyError(f"subtree {head!r} not found in base checkpoint (top-level keys: "
                       f"{sorted(base) if isinstance(base, dict) else type(base)})")
    return dict(base, **{head: _add_at(base[head], delta, rest)})


def _n_leaves(tree) -> int:
    return sum(_n_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def apply_deltas(base_path: str, delta_specs, output_path: str) -> dict:
    """Load the base, add each ``(path, subtree)`` delta in order, save."""
    tree = ckpt.load_pytree(base_path)
    for path, subtree in delta_specs:
        delta = ckpt.load_pytree(path)
        tree = _add_at(tree, delta, subtree)
        print(f"applied {_n_leaves(delta)} delta leaves from {path}" + (f" at {subtree!r}" if subtree else ""))
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "wb") as f:
        msgpack_codec.dump(tree, f)
    print(f"reconstructed checkpoint saved at: {output_path}")
    return tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="base checkpoint (.msgpack pytree)")
    ap.add_argument("--delta", action="append", required=True, metavar="PATH[=SUBTREE]",
                    help="delta file, optionally anchored at a dot-separated subtree of base; repeatable")
    ap.add_argument("--output", required=True, help="output path (.msgpack)")
    args = ap.parse_args(argv)
    specs = []
    for spec in args.delta:
        path, _, subtree = spec.partition("=")
        if not os.path.exists(path):
            raise FileNotFoundError(f"delta checkpoint not found: {path}")
        specs.append((path, subtree))
    if not os.path.exists(args.base):
        raise FileNotFoundError(f"base checkpoint not found: {args.base}")
    apply_deltas(args.base, specs, args.output)


if __name__ == "__main__":
    main()
