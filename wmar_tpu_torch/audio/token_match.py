"""Decode -> encode token-match evaluation (PyTorch port of
``wmar_tpu.audio.token_match``).

    python -m wmar_tpu_torch.audio.token_match --mode mimi --audio_dir wavs/ \\
        --mimi_weight ft.msgpack --mimi_weight_ori mimi.msgpack --output_dir out/
    python -m wmar_tpu_torch.audio.token_match --mode moshi --tiny --device cpu --output_dir out/

* ``--mode mimi``: encode the files with the original Mimi
  (``--mimi_weight_ori``, default ``--mimi_weight``), decode with
  ``--mimi_weight`` (e.g. RCC-finetuned), re-encode under each validation
  augmentation, and report each stream's token-match rate.
* ``--mode moshi``: generate with the Moshi LM (plain sampling at
  ``--temperature``, optionally teacher-forced by Mimi-encoded files),
  decode the audio streams, and measure how well re-encoding recovers the
  generated tokens. Every batch of files is generated and scored (JAX's
  scores only the first: fault (k)).

Rows go to ``<output_dir>/token_match_results.csv`` (``global_index,
audio_file, aug, strength, tm_rate, tm_rate_<k>``), and the per-(aug,
strength) means are printed. Weights: ``.msgpack`` as the JAX package
writes them or a released ``.safetensors`` (``audio_eval.load_mimi_model``,
``audio_eval.load_moshi_params``); ``--tiny`` takes the tiny configs of
``audio_eval`` with random weights from seeds 1 (Mimi) and 0 (Moshi), or the
files at those configs. Each (aug, strength) cell's generator is seeded
from ``--seed``, the aug's name and the strength's index (JAX's folds in
the name alone, so every strength of an aug reuses one key: fault (l)).
``--device`` (default ``cuda``) never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wmar_tpu_torch.train_syncseal import str2bool

SAMPLE_RATE = 24000  # Mimi is a 24 kHz codec


def compute_tm(tokens1: np.ndarray, tokens2: np.ndarray, per_channel: bool = False):
    """Token-match rate between ``[B, K, T1]`` and ``[B, K, T2]`` grids.
    Equal lengths compare position by position; unequal ones compare the
    truncated prefix per channel, while the flattened (not per-channel)
    rate scans every cyclic shift of the longer sequence and keeps the
    best."""
    t1, t2 = np.asarray(tokens1), np.asarray(tokens2)

    def _prefix_rate(a: np.ndarray, b: np.ndarray) -> float:
        if a.shape[-1] == b.shape[-1]:
            return float((a == b).mean())
        if a.shape[-1] < b.shape[-1]:
            a, b = b, a
        return float((a[..., :b.shape[-1]] == b).mean())

    if not per_channel:
        f1, f2 = t1.reshape(t1.shape[0], -1), t2.reshape(t2.shape[0], -1)
        if f1.shape[-1] == f2.shape[-1]:
            return float((f1 == f2).mean())
        if f1.shape[-1] < f2.shape[-1]:
            f1, f2 = f2, f1
        short, best = f2.shape[-1], 0.0
        for shift in range(f1.shape[-1]):
            best = max(best, float((np.roll(f1, shift, axis=-1)[..., :short] == f2).mean()))
        return best
    return [_prefix_rate(t1[:, k, :], t2[:, k, :]) for k in range(t1.shape[1])]


def get_parser():
    p = argparse.ArgumentParser(description="Standalone decode->encode token-match evaluation CLI.")
    p.add_argument("--mode", choices=["moshi", "mimi"], required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--seed", type=int, default=42424242)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--duration_sec", type=float, default=None, help="crop audio files to this length (None = 4 s)")
    p.add_argument("--save_audio", type=int, default=1, help="number of augmented waveforms to save (0 = none)")
    p.add_argument("--save_tokens", type=int, default=0, help="number of token npz files to save (0 = none)")
    # moshi mode
    p.add_argument("--steps", type=int, default=200, help="frames to generate")
    p.add_argument("--temperature", type=float, default=1.0)
    # mimi mode / prompts
    p.add_argument("--audio_dir", type=str, default=None, help="directory of audio files (required for mimi mode)")
    p.add_argument("--nsamples", type=int, default=-1, help="number of audio files to process (-1 = all)")
    # model weights
    p.add_argument("--moshi_weight", type=str, default=None)
    p.add_argument("--mimi_weight", type=str, default=None,
                   help="Mimi used for decode + re-encode (e.g. RCC-finetuned)")
    p.add_argument("--mimi_weight_ori", type=str, default=None,
                   help="ORIGINAL Mimi for the first encode (defaults to --mimi_weight)")
    p.add_argument("--tiny", action="store_true", help="tiny models (smoke): random, or the weight files")
    p.add_argument("--eval_aug", type=str2bool, default=True, help="sweep the validation augmentations")
    return p


def load_mimis(args, device):
    """(Mimi for decode and re-encode, Mimi for the first encode)."""
    from wmar_tpu_torch.audio.mimi import MIMI_V0_1, MimiConfig, init_mimi
    from wmar_tpu_torch.audio_eval import TINY_MIMI, load_mimi_model

    cfg = MimiConfig(**TINY_MIMI) if args.tiny else MIMI_V0_1
    if args.mimi_weight:
        mimi = load_mimi_model(args.mimi_weight, cfg, device)
    elif args.tiny:
        mimi = init_mimi(cfg, torch.Generator(device).manual_seed(1), device=device)
    else:
        raise SystemExit("--mimi_weight required without --tiny")
    return mimi, load_mimi_model(args.mimi_weight_ori, cfg, device) if args.mimi_weight_ori else mimi


def load_moshi(args, device):
    """``(MoshiConfig, params)`` as the flags say."""
    from wmar_tpu_torch.audio import lm as audio_lm
    from wmar_tpu_torch.audio_eval import TINY_MOSHI, load_moshi_params

    cfg = audio_lm.MoshiConfig(**TINY_MOSHI) if args.tiny else audio_lm.MOSHI_V01
    if args.moshi_weight:
        return cfg, load_moshi_params(args.moshi_weight, cfg, device)
    if not args.tiny:
        raise SystemExit("moshi mode needs --moshi_weight (or --tiny)")
    return cfg, audio_lm.init_moshi_params(cfg, torch.Generator(device).manual_seed(0), device=device)


def load_batches(args, sample_rate: int) -> List[Tuple[List[str], np.ndarray]]:
    """``[(files, pcm [b, T, 1])]`` over ``--audio_dir`` in batches of
    ``--batch_size``, clips cropped or padded to ``--duration_sec`` (4 s)."""
    from wmar_tpu_torch.audio.dataloader import AudioDataset

    if not args.audio_dir:
        raise SystemExit("--audio_dir is required")
    ds = AudioDataset(args.audio_dir, target_sr=sample_rate, target_duration=args.duration_sec or 4.0,
                      cache_dir=None)
    n = len(ds) if args.nsamples < 0 else min(args.nsamples, len(ds))
    batches = []
    for i in range(0, n, args.batch_size):
        idxs = range(i, min(i + args.batch_size, n))
        batches.append((ds.audio_files[idxs.start:idxs.stop], np.stack([ds[j] for j in idxs])))
    return batches


def _augs(args, sample_rate: int):
    from wmar_tpu_torch.audio.augmentations import get_validation_augs

    if not args.eval_aug:
        return [("identity", lambda x, p, g: x, [0])]
    return get_validation_augs(sample_rate=sample_rate)


def cell_seed(seed: int, name: str, strength_index: int) -> int:
    """The generator seed of one (aug, strength) cell."""
    return int(np.random.SeedSequence([seed, zlib.crc32(name.encode()) % 2**31, strength_index]).generate_state(1)[0])


@torch.no_grad()
def _sweep(args, augs, decoded, orig_tokens, encode_fn, files, results, base_idx, sr):
    """Attack the decoded audio, re-encode, token-match; a row per file and cell."""
    for name, fn, params in augs:
        for pi, param in enumerate(params):
            attacked = fn(decoded, param, torch.Generator(decoded.device).manual_seed(cell_seed(args.seed, name, pi)))
            new_tokens = encode_fn(attacked).cpu().numpy()
            rates = compute_tm(orig_tokens, new_tokens, per_channel=True)
            mean_tm = float(np.mean(rates))
            for b, audio_file in enumerate(files):
                gidx = base_idx + b
                row = {"global_index": gidx, "audio_file": audio_file, "aug": name, "strength": str(param),
                       "tm_rate": mean_tm}
                for k, r in enumerate(rates):
                    row[f"tm_rate_{k}"] = r
                results.append(row)
                if gidx < args.save_tokens:
                    np.savez(os.path.join(args.output_dir, f"{name}_{param}_{gidx:03d}.npz"),
                             original=orig_tokens[b], aug_roundtrip=new_tokens[b])
                if gidx < args.save_audio:
                    from scipy.io import wavfile

                    adir = os.path.join(args.output_dir, "audio")
                    os.makedirs(adir, exist_ok=True)
                    wavfile.write(os.path.join(adir, f"{name}_{param}_{gidx:03d}.wav"), sr,
                                  np.clip(attacked[b, :, 0].float().cpu().numpy(), -1, 1))


def run_mimi_eval(args, mimi=None, mimi_ori=None) -> List[dict]:
    """encode (original) -> decode -> aug -> encode -> token match; built
    Mimis may be handed in (``mimi_ori`` defaults to ``mimi``)."""
    device = torch.device(args.device)
    if mimi is None:
        mimi, mimi_ori = load_mimis(args, device)
    mimi_ori = mimi if mimi_ori is None else mimi_ori
    augs = _augs(args, SAMPLE_RATE)
    results: List[dict] = []
    done = 0
    for files, pcm in load_batches(args, SAMPLE_RATE):
        orig_tokens = mimi_ori.encode(torch.from_numpy(pcm).to(device))
        decoded = mimi.decode(orig_tokens)
        _sweep(args, augs, decoded, orig_tokens.cpu().numpy(), mimi.encode, files, results, done, SAMPLE_RATE)
        done += len(files)
    return results


def run_moshi_eval(args, moshi=None, mimi=None, mimi_ori=None, noise=None) -> List[dict]:
    """LM generation -> decode -> aug -> re-encode -> token match. Built
    models may be handed in: ``moshi = (MoshiConfig, params)``, ``mimi``
    (decode, re-encode), ``mimi_ori`` (the prompts' encode); ``noise(t,
    stream, shape)`` feeds the sampler's Gumbel draws. Batch ``i`` of the
    files is generated from seed ``--seed + i``."""
    from wmar_tpu_torch.audio.lm import MoshiGen, WMConfig

    device = torch.device(args.device)
    if mimi is None:
        mimi, mimi_ori = load_mimis(args, device)
    mimi_ori = mimi if mimi_ori is None else mimi_ori
    cfg, params = load_moshi(args, device) if moshi is None else moshi
    # method "none": plain sampling, at --temperature
    gen = MoshiGen(params, cfg, WMConfig(method="none", temp=args.temperature))
    if args.audio_dir:
        batches = [(files, mimi_ori.encode(torch.from_numpy(pcm).to(device))[:, :cfg.n_audio_streams])
                   for files, pcm in load_batches(args, SAMPLE_RATE)]
    else:
        batches = [([f"<silence:{b}>" for b in range(args.batch_size)], None)]
    augs = _augs(args, SAMPLE_RATE)
    results: List[dict] = []
    done = 0
    for bi, (files, prompt_codes) in enumerate(batches):
        _, audio_codes = gen.generate(args.steps, args.seed + bi, batch=len(files), prompt_codes=prompt_codes,
                                      noise=noise)
        decoded = mimi.decode(audio_codes)
        _sweep(args, augs, decoded, audio_codes.cpu().numpy(), mimi.encode, files, results, done, SAMPLE_RATE)
        done += len(files)
    return results


def save_results(results: List[dict], output_dir: str) -> str:
    """The CSV and the grouped means."""
    path = os.path.join(output_dir, "token_match_results.csv")
    keys: List[str] = []
    for row in results:
        for k in row:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(results)
    print(f"Saved token_match evaluation results to {path}")
    groups: Dict[Tuple[str, str], List[float]] = {}
    for row in results:
        groups.setdefault((row["aug"], row["strength"]), []).append(row["tm_rate"])
    print(f"{'aug':<20} {'strength':<12} tm_rate")
    for (aug, strength), vals in sorted(groups.items()):
        print(f"{aug:<20} {strength:<12} {np.mean(vals):.4f}")
    return path


def main(argv=None, models: Optional[dict] = None):
    """Run the eval; returns the rows. ``models`` (``moshi``, ``mimi``,
    ``mimi_ori``, ``noise``) go to :func:`run_moshi_eval` /
    :func:`run_mimi_eval`."""
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA card is visible (pass --device cpu to run on the CPU)")
    os.makedirs(args.output_dir, exist_ok=True)
    models = models or {}
    if args.mode == "moshi":
        results = run_moshi_eval(args, **models)
    else:
        if not args.audio_dir:
            raise SystemExit("--audio_dir is required for mimi mode")
        results = run_mimi_eval(args, models.get("mimi"), models.get("mimi_ori"))
    if results:
        save_results(results, args.output_dir)
    return results


if __name__ == "__main__":
    main()
