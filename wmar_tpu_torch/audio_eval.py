"""Audio watermark evaluation: generate -> decode -> attack -> re-encode -> detect.

    python -m wmar_tpu_torch.audio_eval --output_dir <dir> [--tiny] [--device cuda]

The port of ``wmar_audio_eval.py``, with its flags and defaults: Moshi
streams text and audio tokens with the Maryland or Gumbel watermark fused
into sampling, Mimi decodes them to a 24 kHz waveform, the audio grid
attacks it (``--no_augs``: identity only), Mimi re-encodes each attacked
waveform, and each re-encoded stream is scored (binomial p-value for
Maryland, Gamma for Gumbel) and compared with the generated tokens. The
records go to ``<output_dir>/results.json``.

``--tiny`` runs the tiny configs: random weights from seeds 0 (Moshi) and 1
(Mimi), or the files ``--moshi_weight`` / ``--mimi_weight`` give (``.msgpack``
as the JAX package writes it, or a released ``.safetensors``). Without
``--tiny`` the configs are ``MOSHI_V01`` / ``MIMI_V0_1`` and both files are
required. ``--device`` (default ``cuda``) never falls back to the CPU; a
packed ``--cache_dtype`` sends the temporal decode attention through the
hand-written CUDA kernels #2 (``packed``) and #1 (``packed4``) there.
Each attack's generator is seeded from ``--seed`` and ``zlib.crc32`` of
the attack's name, so stored p-values repeat across runs.

``--encodec_weight`` / ``--dac_weight`` add the EnCodec and DAC round trips
to the grid (published ``.pth`` / ``.safetensors``: HF or encodec-package
EnCodec, descript DAC). ``--wm_sync`` gates an AudioSeal watermark
(``--sync_generator_ckpt`` / ``--sync_detector_ckpt``, or ``--tiny``'s
random one) with the square-wave sync pattern at ``--sync_alpha`` after the
Mimi decode; each attacked batch is then detected, a row whose mean
presence lies within 0.25 of 0.5 has its speed-up and shift estimated (on
the host) and inverted, every row is re-encoded on its own and the codes
cropped to the shortest, and each record carries its row's
``sync_score``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

TINY_MOSHI = dict(n_audio_streams=4, audio_vocab=64, text_vocab=64, dim=64, n_layers=2, n_heads=2, dep_dim=32,
                  dep_layers=1, dep_heads=2, delays=(0, 1, 1, 1))
TINY_MIMI = dict(dimension=64, n_filters=8, ratios=(4, 2), n_residual_layers=1, n_q=4, n_q_semantic=1,
                 cardinality=64, codebook_dim=16, transformer_layers=1, transformer_heads=2, downsample=2)
SAMPLE_RATE = 24000


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--moshi_weight", type=str, default=None)
    p.add_argument("--mimi_weight", type=str, default=None)
    p.add_argument("--steps", type=int, default=64, help="frames to generate (12.5 fps)")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--wm_method", type=str, default="maryland", choices=["maryland", "gumbel", "none"])
    p.add_argument("--wm_streams", type=str, default="0,1,2,3,4,5,6,7,8")
    p.add_argument("--wm_ngram", type=int, default=0)
    p.add_argument("--wm_delta", type=float, default=4.0)
    p.add_argument("--wm_gamma", type=float, default=0.25)
    p.add_argument("--wm_seed", type=int, default=0)
    p.add_argument("--weight_dtype", type=str, default=None, choices=["int8"],
                   help="weight-only int8 on the Moshi temporal backbone and text head. Not token-exact")
    p.add_argument("--cache_dtype", type=str, default=None, choices=["f32", "bf16", "int8", "packed", "packed4"],
                   help="temporal KV cache; packed and packed4 are read by the hand-written CUDA decode-attention "
                        "kernels. Not token-exact against f32")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_k", type=int, default=250)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_augs", action="store_true")
    p.add_argument("--encodec_weight", type=str, default=None,
                   help="EnCodec 24k checkpoint for the codec-compression attack")
    p.add_argument("--dac_weight", type=str, default=None, help="DAC 24k checkpoint for the codec-compression attack")
    p.add_argument("--mimi_compression", action="store_true",
                   help="add a Mimi round-trip codec attack (uses the loaded Mimi)")
    p.add_argument("--use_prompts", action="store_true",
                   help="teacher-force generation with Mimi-encoded audio prompts")
    p.add_argument("--audio_dir", type=str, default=None, help="directory of .wav prompt files (with --use_prompts)")
    p.add_argument("--nsamples", type=int, default=0, help="cap the number of prompt files (0 = batch_size)")
    p.add_argument("--duration_sec", type=float, default=5.0, help="crop/pad prompts to this length")
    p.add_argument("--eval_aug", type=str, default=None, help="restrict the sweep to one augmentation family")
    p.add_argument("--save_audio", action="store_true", help="write generated waveforms as .wav into output_dir")
    p.add_argument("--save_tokens", action="store_true", help="write generated token streams as .npy into output_dir")
    p.add_argument("--mimi_weight_ori", type=str, default=None,
                   help="ORIGINAL (non-finetuned) Mimi for re-encode/detection: generation may use finetuned weights")
    p.add_argument("--wm_sync", action="store_true",
                   help="gate an AudioSeal watermark with the square-wave sync pattern and invert speed/shift "
                        "before re-encode")
    p.add_argument("--sync_generator_ckpt", type=str, default=None,
                   help="audioseal_wm_16bits checkpoint (random tiny with --tiny)")
    p.add_argument("--sync_detector_ckpt", type=str, default=None, help="audioseal_detector_16bits checkpoint")
    p.add_argument("--sync_alpha", type=float, default=0.5, help="sync watermark strength")
    return p


def build_sync_pattern(args, mimi_cfg, device):
    """The AudioSeal-backed ``SyncPattern``: from the two checkpoints (3
    frames of 1920 samples a half period), or with ``--tiny`` the JAX
    package's tiny random AudioSeal with a half period of 2 Mimi frames."""
    from wmar_tpu_torch.audio import audioseal
    from wmar_tpu_torch.audio.sync import SyncPattern

    if args.sync_generator_ckpt and args.sync_detector_ckpt:
        return SyncPattern(audioseal.AudioSealModel.from_checkpoints(args.sync_generator_ckpt,
                                                                     args.sync_detector_ckpt, device))
    if not args.tiny:
        raise SystemExit("--wm_sync needs --sync_generator_ckpt + --sync_detector_ckpt (or --tiny)")
    model = audioseal.synthetic_model(audioseal.AUDIOSEAL_TINY, device=device)
    return SyncPattern(model, frames_per_period=2, frame_size=mimi_cfg.hop_length)


def load_moshi_params(path: str, cfg, device):
    """Moshi's parameters from a JAX-written ``.msgpack`` (its structure and
    shapes checked against ``cfg``'s) or a released ``.safetensors`` state
    dict (:func:`wmar_tpu_torch.audio.lm.convert_moshi_lm`)."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.audio.lm import convert_moshi_lm, init_moshi_params
    from wmar_tpu_torch.utils.convert import read_safetensors
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    if path.endswith(".msgpack"):
        tree = load_pytree(path, like=init_moshi_params(cfg, None, device="meta"), dtypes=False)
    else:
        tree = convert_moshi_lm(read_safetensors(path), cfg)
    return bridge.load_moshi(tree, device=device)


def load_mimi_model(path: str, cfg, device):
    """A Mimi from a JAX-written ``.msgpack`` (Flax variables) or a released
    ``.safetensors`` (:func:`wmar_tpu_torch.audio.mimi.convert_mimi`)."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.audio.mimi import Mimi, convert_mimi
    from wmar_tpu_torch.utils.convert import read_safetensors
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    variables = load_pytree(path) if path.endswith(".msgpack") else convert_mimi(read_safetensors(path), cfg)
    with torch.device("meta"):
        model = Mimi(cfg)
    return bridge.load_mimi(model.to_empty(device=device), variables)


def _load_prompt_codes(args, mimi, device):
    """Encode ``.wav`` prompts through Mimi into teacher-forcing codes
    ``[B, n_q, T']``; None without files."""
    from scipy.io import wavfile

    files = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
    if not files:
        print(f"No audio files found in {args.audio_dir}. Proceeding without prompts.")
        return None
    n = args.nsamples if args.nsamples > 0 else args.batch_size
    files = files[: min(n, args.batch_size)]
    target = int(args.duration_sec * SAMPLE_RATE)
    wavs = []
    for f in files:
        sr, data = wavfile.read(f)
        data = np.asarray(data, np.float32)
        if data.dtype.kind != "f" or np.abs(data).max() > 1.5:
            data = data / 32768.0
        if data.ndim == 2:
            data = data.mean(axis=1)
        if sr != SAMPLE_RATE:  # linear resample to the Mimi rate
            idx = np.linspace(0, len(data) - 1, int(len(data) * SAMPLE_RATE / sr))
            data = np.interp(idx, np.arange(len(data)), data).astype(np.float32)
        data = data[:target]
        if len(data) < target:
            data = np.pad(data, (0, target - len(data)))
        wavs.append(data)
    while len(wavs) < args.batch_size:  # pad the batch with silence
        wavs.append(np.zeros(target, np.float32))
    codes = mimi.encode(torch.from_numpy(np.stack(wavs))[:, :, None].to(device))
    print(f"Using {len(files)} audio files as prompts ({codes.shape[2]} frames)")
    return codes


def attack_seed(seed: int, name: str) -> int:
    """The generator seed of one attack: ``--seed`` and ``zlib.crc32`` of its
    name (str hashing is salted per process, so ``hash()`` would not repeat)."""
    return int(np.random.SeedSequence([seed, zlib.crc32(name.encode()) % 2**31]).generate_state(1)[0])


def build_models(args, device):
    """``(moshi_cfg, moshi_params, mimi, det_mimi)`` as the flags say."""
    from wmar_tpu_torch.audio import lm as audio_lm
    from wmar_tpu_torch.audio import mimi as audio_mimi

    if args.tiny:
        moshi_cfg = audio_lm.MoshiConfig(**TINY_MOSHI)
        mimi_cfg = audio_mimi.MimiConfig(**TINY_MIMI)
    else:
        if not (args.moshi_weight and args.mimi_weight):
            raise SystemExit("full-size eval needs --moshi_weight (model.safetensors) and --mimi_weight "
                             "(tokenizer-*.safetensors), or use --tiny")
        moshi_cfg, mimi_cfg = audio_lm.MOSHI_V01, audio_mimi.MIMI_V0_1
    if args.moshi_weight:
        moshi_params = load_moshi_params(args.moshi_weight, moshi_cfg, device)
    else:
        moshi_params = audio_lm.init_moshi_params(moshi_cfg, torch.Generator(device).manual_seed(0), device=device)
    if args.mimi_weight:
        mimi = load_mimi_model(args.mimi_weight, mimi_cfg, device)
    else:
        mimi = audio_mimi.init_mimi(mimi_cfg, torch.Generator(device).manual_seed(1), device=device)
    # detection may use the ORIGINAL Mimi while generation used finetuned weights
    det_mimi = load_mimi_model(args.mimi_weight_ori, mimi_cfg, device) if args.mimi_weight_ori else mimi
    return moshi_cfg, moshi_params, mimi, det_mimi


def _synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def evaluate(args, moshi_cfg, moshi_params, mimi, det_mimi=None) -> dict:
    """Generate, decode, attack, re-encode and score with the given models,
    and write ``results.json``. Returns ``{"records", "text", "audio",
    "generate_s", "grid_s", "augs", "cells"}``: the records, the generated tokens
    (``[B, T]``, ``[B, K, T]``), the seconds of the generation and of the
    grid (the decode included), the grid's family names and its number of
    (attack, param) cells; with ``--wm_sync`` also ``"sync_inverted"``, the
    ``(aug, param, row, speed-up, shift)`` of every inverted row, and
    ``"sync_search_s"``, the host's seconds of their period search."""
    from wmar_tpu_torch.audio import lm as audio_lm
    from wmar_tpu_torch.audio import wm as audio_wm
    from wmar_tpu_torch.audio.augmentations import MimiCompression, get_validation_augs
    from wmar_tpu_torch.audio.codecs import CodecCompression
    from wmar_tpu_torch.utils.metrics import pesq_metric, sisnr, stoi

    device = torch.device(args.device)
    det_mimi = mimi if det_mimi is None else det_mimi
    # the sync model and the codecs load before the generation, so a missing file stops the run at once
    sync_pattern = build_sync_pattern(args, mimi.cfg, device) if args.wm_sync else None
    codecs = {} if args.no_augs else {
        kind: CodecCompression.from_checkpoint(kind, path, device=device)
        for kind, path in (("encodec", args.encodec_weight), ("dac", args.dac_weight)) if path}
    streams = tuple(int(s) for s in args.wm_streams.split(","))
    wm = None
    if args.wm_method != "none":
        wm = audio_lm.WMConfig(method=args.wm_method, streams=streams, ngram=args.wm_ngram, delta=args.wm_delta,
                               gamma=args.wm_gamma, seed=args.wm_seed, temp=args.temperature, top_k=args.top_k)
    if args.weight_dtype == "int8":
        moshi_params = audio_lm.quantize_moshi_params_int8(moshi_params,
                                                           compute_dtype=None if args.tiny else torch.bfloat16)
    cache_dtype = {None: torch.float32, "f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
                   "packed": "packed", "packed4": "packed4"}[args.cache_dtype]
    gen = audio_lm.MoshiGen(moshi_params, moshi_cfg, wm, cache_dtype=cache_dtype)
    prompt_codes = None
    if args.use_prompts and args.audio_dir:
        prompt_codes = _load_prompt_codes(args, mimi, device)
        if prompt_codes is not None:
            prompt_codes = prompt_codes[:, : moshi_cfg.n_audio_streams]
    t0 = _synced(device)
    text, audio_codes = gen.generate(args.steps, args.seed, batch=args.batch_size, prompt_codes=prompt_codes)
    t1 = _synced(device)
    pcm = mimi.decode(audio_codes)
    if sync_pattern is not None:
        pcm = sync_pattern.get_sync_wm(pcm, alpha=args.sync_alpha)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.save_audio:
        from scipy.io import wavfile

        for b in range(args.batch_size):
            wavfile.write(os.path.join(args.output_dir, f"gen_{b:03d}.wav"), SAMPLE_RATE,
                          np.clip(pcm[b, :, 0].float().cpu().numpy(), -1, 1))
    if args.save_tokens:
        np.save(os.path.join(args.output_dir, "text_tokens.npy"), text.cpu().numpy())
        np.save(os.path.join(args.output_dir, "audio_tokens.npy"), audio_codes.cpu().numpy())
    if args.no_augs:
        augs = [("identity", lambda x, p, g: x, [0])]
    else:
        augs = get_validation_augs(mimi_codec=MimiCompression(mimi) if args.mimi_compression else None, **codecs)
        if args.eval_aug:
            augs = [(n, f, ps) for n, f, ps in augs if n == args.eval_aug or n == "identity"]
            if len(augs) <= 1:
                raise SystemExit(f"--eval_aug {args.eval_aug!r} not in the grid")

    records, inverted, search_s = [], [], 0.0
    gen_codes = audio_codes.cpu()
    n_pcm = pcm.shape[1]
    for name, fn, params in augs:
        for param in params:
            g = torch.Generator(device).manual_seed(attack_seed(args.seed, name))
            attacked = fn(pcm, param, g)
            sync_scores = [None] * args.batch_size
            if sync_pattern is None:
                re_codes = det_mimi.encode(attacked).cpu()
            else:
                # where the sync is ambiguous (|mean - 0.5| < 0.25), estimate the speed-up and shift and invert
                # them; every row is re-encoded on its own and the codes are cropped to the shortest
                det_sig = sync_pattern.detect_signal(attacked)
                rows = []
                for b in range(args.batch_size):
                    row = attacked[b:b + 1]
                    sync_scores[b] = score = float(det_sig[b].mean())
                    if abs(score - 0.5) < 0.25:
                        ts = time.perf_counter()
                        speedup, shift = sync_pattern.get_speedup_and_shift(det_sig[b])
                        search_s += time.perf_counter() - ts
                        row = sync_pattern.invert(row, speedup, shift)
                        inverted.append((name, param, b, speedup, shift))
                        print(f"sync: {name}/{param} b={b} score={score:.3f} speedup={speedup:.3f} shift={shift}")
                    rows.append(det_mimi.encode(row).cpu())
                n_min = min(r.shape[2] for r in rows)
                re_codes = torch.cat([r[:, :, :n_min] for r in rows], dim=0)
            quality = [{"sisnr": sisnr(attacked[b, :n_pcm], pcm[b]),
                        "stoi": stoi(attacked[b, :n_pcm], pcm[b], fs=SAMPLE_RATE),
                        "pesq": pesq_metric(attacked[b, :n_pcm], pcm[b], fs=SAMPLE_RATE)}
                       for b in range(args.batch_size)]
            # ngram = 0 hashes depend only on the position count; attacks that change the duration change the
            # re-encoded frame count, so they are built per re-encode length
            n_re = re_codes.shape[2]
            hashes_s = audio_wm.window_hash(torch.zeros((n_re, 0), dtype=torch.int64), args.wm_seed)
            for b in range(args.batch_size):
                for s in range(min(moshi_cfg.n_audio_streams, re_codes.shape[1])):
                    if args.wm_method == "maryland" and (s + 1) in streams:
                        ng, ns = audio_wm.score_stream_maryland(re_codes[b, s], hashes_s, args.wm_gamma, salt=0)
                        pval = float(audio_wm.pvalue_maryland(ng, ns, args.wm_gamma))
                    elif args.wm_method == "gumbel" and (s + 1) in streams:
                        scores = audio_wm.gumbel_score(re_codes[b, s], hashes_s)
                        pval = float(audio_wm.pvalue_gumbel(scores.sum(), n_re))
                    else:
                        pval = None
                    tl = min(n_re, gen_codes.shape[2])
                    tm = float((re_codes[b, s][:tl] == gen_codes[b, s][:tl]).to(torch.float32).mean())
                    rec = {"aug": name, "param": param, "batch": b, "stream": s, "pvalue": pval, "token_match": tm,
                           **quality[b]}
                    if sync_scores[b] is not None:
                        rec["sync_score"] = sync_scores[b]
                    records.append(rec)
        print(f"aug {name} done")
    t2 = _synced(device)

    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {len(records)} records")
    out = {"records": records, "text": text, "audio": audio_codes, "generate_s": t1 - t0, "grid_s": t2 - t1,
           "augs": [name for name, _, _ in augs], "cells": sum(len(params) for _, _, params in augs)}
    if sync_pattern is not None:
        out.update(sync_inverted=inverted, sync_search_s=search_s)
    return out


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is visible (pass --device cpu to run on the CPU)")
    moshi_cfg, moshi_params, mimi, det_mimi = build_models(args, device)
    return evaluate(args, moshi_cfg, moshi_params, mimi, det_mimi)["records"]


if __name__ == "__main__":
    main(sys.argv[1:])
