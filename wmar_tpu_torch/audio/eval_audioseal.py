#!/usr/bin/env python
"""AudioSeal's robustness over the audio grid (PyTorch).

    python -m wmar_tpu_torch.audio.eval_audioseal --audio_dir <wavs> --output_dir <dir> \\
        --generator_ckpt generator.pth --detector_ckpt detector.pth [--device cuda]

Port of ``wmar_tpu.audio.eval_audioseal``, the counterpart of the
reference's ``wmar_audio/evals/eval_audioseal.py``: watermark a directory
of ``.wav`` clips with the AudioSeal generator, run every cell of the
audio grid on the watermarked and the original clips, score both with the
detector (the presence probability's mean over time), write
``audioseal_eval_results.csv`` and print the TPR at ``--fpr_target`` of
each (augmentation, strength) cell, the original clips of every cell
pooled as negatives.

The watermarked and the original batch of a cell get the same noise: two
generators seeded alike, from ``--seed`` and ``zlib.crc32`` of the cell's
``name/strength``. ``--tiny`` builds the JAX package's tiny random model
(the same numpy draws). ``--device`` (default ``cuda``) never falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
import zlib
from collections import defaultdict

import numpy as np
import torch

from wmar_tpu_torch.generate import str2bool


def get_parser():
    p = argparse.ArgumentParser(description="AudioSeal robustness eval")
    p.add_argument("--audio_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--nsamples", type=int, default=-1)
    p.add_argument("--duration_sec", type=float, default=None)
    p.add_argument("--target_sr", type=int, default=24000)
    p.add_argument("--pad_short_audio", type=str2bool, default=False)
    p.add_argument("--save_audio", type=int, default=0)
    p.add_argument("--eval_aug", type=str2bool, default=True)
    p.add_argument("--generator_ckpt", type=str, default=None,
                   help="audioseal_wm_16bits checkpoint (.pth/.safetensors)")
    p.add_argument("--detector_ckpt", type=str, default=None, help="audioseal_detector_16bits checkpoint")
    p.add_argument("--tiny", action="store_true", help="random tiny models (smoke)")
    p.add_argument("--wm_alpha", type=float, default=1.0)
    p.add_argument("--fpr_target", type=float, default=0.01)
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    return p


def load_audio_batch(files, target_sr, duration_sec, pad_short):
    """``.wav`` files -> ``[B, T, 1]`` float32 mono at ``target_sr``, zero-padded
    to the batch's longest (None if none loads)."""
    from scipy.io import wavfile

    wavs = []
    for f in files:
        try:
            sr, data = wavfile.read(f)
        except ValueError as e:  # an unreadable file is skipped, as in the reference
            print(f"Error loading {f}: {e}")
            continue
        data = np.asarray(data)
        if data.dtype.kind != "f":
            data = data.astype(np.float32) / 32768.0
        data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        if sr != target_sr:
            idx = np.linspace(0, len(data) - 1, int(len(data) * target_sr / sr))
            data = np.interp(idx, np.arange(len(data)), data).astype(np.float32)
        if duration_sec is not None:
            n = int(duration_sec * target_sr)
            if len(data) > n:
                data = data[:n]
            elif len(data) < n and pad_short:
                data = np.pad(data, (0, n - len(data)))
        wavs.append(data)
    if not wavs:
        return None
    batch = np.zeros((len(wavs), max(len(w) for w in wavs), 1), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w), 0] = w
    return batch


def tpr_at_fpr(pos_scores, neg_scores, fpr_target=0.01):
    """The TPR at ``fpr_target``, interpolated on the ROC of the pooled
    scores (sklearn's ``roc_curve`` with ``np.interp``)."""
    pos = np.asarray(pos_scores, np.float64)
    neg = np.asarray(neg_scores, np.float64)
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    labels = labels[np.argsort(-scores, kind="stable")]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    tpr = np.concatenate([[0.0], tps / max(tps[-1], 1)])
    fpr = np.concatenate([[0.0], fps / max(fps[-1], 1)])
    return float(np.interp(fpr_target, fpr, tpr))


def cell_seed(seed: int, name: str, strength) -> int:
    return int(np.random.SeedSequence([seed, zlib.crc32(f"{name}/{strength}".encode()) % 2**31]).generate_state(1)[0])


def main(argv=None):
    args = get_parser().parse_args(argv)
    from wmar_tpu_torch.audio import audioseal as A
    from wmar_tpu_torch.audio.augmentations import get_validation_augs

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is visible (pass --device cpu to run on the CPU)")
    if args.generator_ckpt and args.detector_ckpt:
        model = A.AudioSealModel.from_checkpoints(args.generator_ckpt, args.detector_ckpt, device)
    elif args.tiny:
        model = A.synthetic_model(A.AUDIOSEAL_TINY, device=device)
    else:
        raise SystemExit("need --generator_ckpt + --detector_ckpt, or --tiny")

    files = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
    if args.nsamples > 0:
        files = files[: args.nsamples]
    if not files:
        raise SystemExit(f"no audio files in {args.audio_dir}")
    print(f"Processing {len(files)} audio files from {args.audio_dir}")
    os.makedirs(args.output_dir, exist_ok=True)
    augs = get_validation_augs(args.target_sr) if args.eval_aug else [("identity", lambda x, p, g: x, [0])]

    results = []
    for start in range(0, len(files), args.batch_size):
        batch_files = files[start: start + args.batch_size]
        batch = load_audio_batch(batch_files, args.target_sr, args.duration_sec, args.pad_short_audio)
        if batch is None:
            continue
        orig = torch.from_numpy(batch).to(device)
        wm = orig + args.wm_alpha * model.get_watermark(orig)
        for name, fn, strengths in augs:
            for strength in strengths:
                seed = cell_seed(args.seed, name, strength)
                aug_wm = fn(wm, strength, torch.Generator(device).manual_seed(seed))
                aug_orig = fn(orig, strength, torch.Generator(device).manual_seed(seed))
                score_wm = model.detect(aug_wm).mean(dim=1).cpu().numpy()
                score_orig = model.detect(aug_orig).mean(dim=1).cpu().numpy()
                for i, f in enumerate(batch_files):
                    gi = start + i
                    results.append({"global_index": gi, "audio_file": f, "aug_name": name, "strength": str(strength),
                                    "score_wm": float(score_wm[i]), "score_orig": float(score_orig[i])})
                    if gi < args.save_audio:
                        from scipy.io import wavfile

                        adir = os.path.join(args.output_dir, "audio_samples")
                        os.makedirs(adir, exist_ok=True)
                        wavfile.write(os.path.join(adir, f"{gi:04d}_{name}_{strength}_wm.wav"), args.target_sr,
                                      np.clip(aug_wm[i, :, 0].float().cpu().numpy(), -1, 1))
        print(f"batch {start // args.batch_size} done")

    csv_path = os.path.join(args.output_dir, "audioseal_eval_results.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["global_index", "audio_file", "aug_name", "strength", "score_wm",
                                          "score_orig"])
        w.writeheader()
        w.writerows(results)
    print(f"Saved Audioseal evaluation results to {csv_path}")

    negatives = [r["score_orig"] for r in results]
    cells = defaultdict(list)
    for r in results:
        cells[(r["aug_name"], r["strength"])].append(r["score_wm"])
    summary = {}
    for (aug, strength), pos in sorted(cells.items()):
        t = tpr_at_fpr(pos, negatives, args.fpr_target)
        summary[f"{aug}/{strength}"] = t
        print(f"Aug: {aug}, Strength: {strength}")
        print(f"TPR at FPR={args.fpr_target}: {t:.4f}")
    return results, summary


if __name__ == "__main__":
    main(sys.argv[1:])
