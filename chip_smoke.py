#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives the port's main paths once at full width and checks them, in
phases:

1. build: compile the CUDA kernels from ``wmar_tpu_torch/csrc/`` (sm_90a,
   one nvcc per source, in parallel), print the build time, the card's
   name and power limit, and the TF32 switches (both off, so float32
   matmuls and convolutions are exact; phases 9, 15 and 17's finetune runs
   alone run at their entry points' own precision);
2. kernel vs plain: kernel #1 (``packed4_decode_attention``, below 1024
   slots the tiled kernel of #3/#4 without masks) at the decode shapes of
   RAR-B, RAR-XL and RAR-XXL (128 rows, 258 slots, 16 heads, D 48/80/88),
   one launch replayed from a CUDA graph after ``valid_len`` changed; kernel
   #2 (``packed_decode_attention_q8``, below 1024 slots the same tiled
   kernel over the int8 cache) at the RAR-XL shape through the wrapper (a
   warp per (row, head)) and with both layouts forced (a warp per (row,
   head); blocks of four warps at S = 1, 2 and 4), twice with equal bits,
   and one launch replayed from a CUDA graph after ``valid_len`` changed;
   kernels #3 and #4 (``packed_decode_attention_q8_chunked``,
   ``packed4_decode_attention_chunked``) at the Chameleon-7B shape (24 rows,
   32 heads of 128, 1043 slots, 32 layers) with a ragged ``start`` that
   blanks the first chunk of the CFG rows and once a random ``key_mask``,
   and at the interleaved sampler's shape (3 rows, 4096 slots) with a ragged
   ``start`` and the three interleaved key masks, full and at the end of a
   run, each case also with 1 to 16 blocks per (row, head) forced, twice
   (equal bits; ``valid_len`` 1, 128 and 129 leave shares empty), and one
   launch replayed from a CUDA graph after ``valid_len``, ``start`` and
   ``key_mask`` changed in place;
   kernels #1 and #2 again at the short caches of Taming-1.4B (32 rows,
   257 slots, 16 heads of 104, 48 layers) and Moshi-7B's temporal decode
   (8 rows, 66 slots, 32 heads of 128, 32 layers; there also a CUDA-graph
   replay and the planner's layout beside forced ones), each timed with
   its bound and one SDPA call over a bf16 cache (``short_cache_attention``,
   the kernels line's ``shapes``); kernel #8
   (``matmul_w4``, the w4a16 matmul: bf16 x on the tensor cores, f32 x on the
   CUDA cores) at every (K, N) of Taming-1.4B (32 rows), Chameleon-7B (24
   rows) and RAR-XL (128 rows) and at ragged row counts, for groups 128, 64
   and 32, at group 128 with every split count of K from 1 to its most
   forced, twice (equal bits), one launch replayed from a CUDA graph, and
   timed at Taming's four products and Chameleon's FFN beside its bound,
   ``torch._weight_int4pack_mm`` and a bf16 matmul
   (``wmar_tpu_torch.tools.bench_w4``); kernels #5 and #6 (``flash_decode_attention`` over a bf16 or f32
   cache, ``flash_decode_attention_q8`` over an int8 one) at the
   interleaved Chameleon shape (3 rows, 32 heads of 128, 4096 slots) and at
   a RAR-like shape (16 rows, 16 heads of 80), ``valid_len`` 1, 2, 1043,
   2049 and 4096, with and without ``start``, a random ``key_mask`` and the
   three interleaved masks, each case with the planner's split count and
   with 1, 2, 3 and 8 blocks per (row, head) forced, twice (equal bits),
   and one launch replayed from a CUDA graph after ``valid_len`` and
   ``key_mask`` changed in place; kernel #7 (``_packed_dma_probe``, kernel
   #2's instantiation with its math compiled out) exactly at the RAR-XL,
   Taming and Chameleon shapes, and
   kernel #9 (``row_mean_probe``) within bf16 rounding; each against its
   plain float32 version, and timed beside it (#1-#4 at full fill, by
   CUDA events and replayed from a CUDA graph);
3. microbench: ``wmar_tpu_torch.tools.bench_attention`` at the RAR-XL and
   the Chameleon-4k shapes: #5 and #6 beside their plain versions, the
   packed kernels over the same K/V, one ``scaled_dot_product_attention``
   call (a yardstick, used nowhere in the port), the DMA probe #7, and the
   per-call floor #9 at 1 to 16,384 rows; each by CUDA events around the
   call (``ms``) and replayed from a CUDA graph (``graph_ms``: no host gap);
   every kernel's bound (bytes over 3.35 TB/s or operations over the peak
   rate) is computed from the run's own inputs;
4. RAR path: RAR-XL with int8 weights and the ``linear-rand-h=1-d=2.0-g=0.25``
   watermark through the port's ``generate_and_evaluate`` on 64 classes,
   a warm-up batch on the int8 packed cache (kernel #2) and a timed one on
   the packed4 cache (kernel #1), with random weights from a seed; checks
   codes, images, p-values, the green fraction, and that every
   decode-attention call went through its kernel (255 steps x 32 layers
   per batch);
5. Chameleon path, from the reference's files (``build_chameleon_from_files``):
   a random CHAMELEON_7B at full width and 16 of its 32 layers written as two
   bf16 tensor-parallel ``consolidated.*.pth`` shards in the reference's
   layout, a random CHAMELEON_F16 ``vqgan.ckpt`` and a synthetic 65,536-entry
   byte-level ``tokenizer/text_tokenizer.json``, converted by ``python -m
   wmar_tpu_torch.tools.convert_ckpt`` (``main``) and loaded by
   ``generate.load_wrapper --modelpath`` (the prompts tokenized by the port's
   BPE reader), with int8 weights; prints each file's bytes and seconds, the
   host RSS before and at most during each conversion, and the process's
   peak host RSS. Then 8 prompts of distinct lengths (24 CFG rows),
   temperature 0.9, top-p 0.9, the same watermark and one round trip,
   through ``generate_and_evaluate``: a warm-up batch on the packed cache
   (kernel #3), a timed one on the packed4 cache (kernel #4), at a quarter
   of its depth (the first 8 of the files' 16 layers, ``CHAMELEON_RUN_LAYERS``,
   :func:`first_layers`, for the script's time; #3 and #4 keep their
   full-depth shapes in phase 2), 1023
   steps x 8 layers each; checks image tokens, 512 px images in [-1, 1], p-values,
   the green fraction and the launch counts, and prints peak memory;
6. interleaved path: the same Chameleon wrapper through the entry point
   ``generate --interleaved <prompts file> --max_images 2``
   (``run_interleaved``): one prompt, two images, three text segments of up
   to 64 tokens, 2244 tokens over one cache shared by the three CFG rows
   behind the live ``key_mask``; with two images that cache passes 2048
   slots, so every forward after the prefill takes the flash-decode
   kernels: once on the bf16 cache (kernel #5) and once on the int8 cache
   (kernel #6), at a quarter of its depth (the same 8 layers, for the
   script's time; #5 and #6 keep their full-depth shapes in phase 2),
   exactly 2243 forwards x 8 layers =
   17,944 launches each and none of any other attention kernel; checks the
   tree the run wrote
   (``p=0,idx=0/`` with ``prompt.txt``, ``seg<k>_text.{txt,npy}``,
   ``seg<k>_img.{png,npy,json}``): text segments of text tokens, each whole
   image segment 1024 image tokens, a 512 px PNG, both p-values in [0, 1]
   and the green fraction;
7. interleaved sampler at the reference's 4096-slot cache, which no flag of
   the entry point sets: ``sample_interleaved_fused(cache_budget=4096)``,
   one prompt, one image, on the bf16, the int8 and the packed4 cache
   (kernel #4's ``key_mask`` route), at the same 8 layers, for the
   script's time: exactly 1153
   forwards x 8 layers = 9,224 launches each, one image segment of 1024
   image tokens;
8. Taming path: the 1.4B cin_transformer at full width and depth with
   grouped-int4 weights (every linear and the head on kernel #8), random
   positional embeddings, the f16 ImageNet VQGAN at 256 px, the same
   watermark, 32 classes, temperature 1.0, top-k 250, top-p 0.92 and one
   round trip, through ``generate_and_evaluate``: a warm-up batch on the
   packed cache (kernel #2), a timed one on the packed4 cache (kernel #1);
   checks codes, images, p-values, the green fraction and the exact launch
   counts of every batch (256 forwards x 289 products for #8, 256 x 48
   attention calls), and prints imgs/s and peak memory;
9. RCC finetune: the entry point ``python -m wmar_tpu_torch.finetune``
   (``finetune.cli.main``) on the tokenizers that ``generate.load_wrapper``
   builds at full size from seed 0 (Taming-1.4B's f16 VQGAN; RAR-XL's
   MaskGit-VQGAN runs in the CPU tests, cut here for the script's time),
   written in float32 as ``vqgan.msgpack`` and read back through
   ``--modelpath``: 72
   synthetic code rows, batch 8, lr 1e-4, idem weight 1.0, four epochs
   (``--augs_schedule 1,1,1,1``: warmup, weak, medium, strong; every
   validation cell), Taming with a random discriminator (the GAN branch),
   MaskGit without; at the entry point's precision
   (``finetune.cli.set_precision``: cuDNN may use TF32, matmuls not).
   Checks every logged number finite, the final Identity idem loss below
   epoch 0's, and epoch 3's deltas re-applied to the base equal to
   ``epoch3_trainable.msgpack`` within 4 float32 ulps; prints seconds a
   train step, images per second per level, Identity idem and L0 before and
   after, peak memory; then ``tools/bench_rcc.py``'s train step at the
   Taming geometry, level strong, batch 4 and 8;
10. attack sweep: the entry point ``generate.main`` without ``--no_augs``,
   one batch each, so the reference's default run: sample, decode, one round
   trip, the 62 (attack, param) cells of the classic grid on the card,
   re-tokenize, detect, write. (a) RAR-XL, int8 weights, packed4 cache
   (kernel #1), 8 classes (16 before, cut for the script's time), the
   device JPEG; (b) Taming-1.4B, grouped-int4
   weights (kernel #8), packed4 cache (kernel #1), 8 classes, ``--exact_jpeg
   true --wm_torch_compat true`` (PIL's JPEG, the reference's greenlists
   from a table), ``--include_neural_compress true --nc_allow_random
   true`` (the reference's 22 neural codecs, random, at their published
   widths, each geometry drawn once: 62 + 22 cells; every codec record tagged ``random_weights`` with
   a finite ``bpp``, the diffusers codecs' nominal one; the analyzer's
   TPR-against-bpp table) and phase 9's epoch-3 RCC deltas
   (``--encoder_ft_ckpt/--decoder_ft_ckpt``), its tokenizer checked to be
   the base plus the deltas within bf16 rounding. Checks n x 64 (b: 86) records and
   as many json, png and npy files, images finite in [-1, 1], codes in
   range, p-values in [0, 1], the
   identity cells (blur 0, noise 0, brightness 1, rotation 0, flip 0, crop
   1.0) within 1e-6 of the original with codes equal to the first round
   trip's on >= 99% of the tokens, the exact launch counts, in (b) the
   green fraction under the table and the table's bits against the lazily
   built rows of 64 keys, and the port's analyzer on each tree; prints the
   robustness table and the seconds of the grid a batch beside the
   sampling seconds; in (b) the torch-compat tree's re-score goes through
   the C++ ngram scorer (``wmar_tpu_torch.native``, built by g++ at first
   use; the gates: it built, it was called, the stored p-values), then the
   scorer and the numpy branch re-score the same 2-class subtree, timed,
   with equal p-values; then "neural codecs" on (b)'s bank, its DC-AE
   rebuilt at ``dc-ae-f64c128``'s stage widths (293M parameters): each
   codec on 8 random 256 px images, finite, in [0, 1], its bpp, its ms a
   batch (CUDA events after a warm-up), and on one 64 px image against a
   CPU copy of its weights within 1e-3 of the output's scale (compressai:
   the latents, the share of quantized integers rounded apart at most
   1e-3, the synthesis of the same integers, the bpp); the phase's peak
   GiB;
11. sync, on random weights written in the released layouts: (a) the
   entry point ``generate.main --sync true --syncpath syncseal_random.pt``
   (the released SyncSeal: UNet + ConvNeXt-tiny, its corner head well
   posed) with RAR-XL, int8 weights, 8 classes, a warm-up batch on the
   packed cache (kernel #2, ``--no_augs``) and a batch on the packed4 cache
   (kernel #1) through the 62-cell grid: records, sync calls (one add, a
   remove before each re-tokenize), launch counts, finite images,
   p-values in [0, 1], ``add_sync`` moving the images by at most the
   SyncSeal scale, add and remove timed a batch and held against the CPU;
   (b) the Flax ``SyncSealModel`` from a port-written
   ``syncseal_random.msgpack`` through ``SyncManager.from_path``; (c) WAM
   (SAM-base + vae_small, 256 px) from ``wam_random.pth``: add_sync and the
   per-image remove_sync loop timed, embed and detect held against the CPU
   on 2 images (TF32 off), and ``WamSync`` over a mock pixel watermark after
   a flip, a rotation and a crop, its estimates equal on the card and the
   CPU;
12. sync training (``phase_sync_training``): (a) ``train_syncseal.main``
   at full width (UNet-small2-YUV + ConvNeXt-tiny + the discriminator, 256
   px, batch 8, lr 1e-4, the pyramid perceptual loss, deterministic
   kernels, no SIFT: the card has no OpenCV), one epoch of the quantizable
   UNet from an embedder.yaml, 3 epochs straight (detector-only from the
   2nd) and a copy of them after 2 resumed to 3: finite logs, the UNet
   bit-equal over the detector-only epochs, the resumed run within 4 float32 ulps of
   the straight one, one model step on the card within 1e-3 of the CPU,
   ``syncmodel.msgpack`` served through ``SyncSealRef.load``; s a step,
   images/s, peak memory; (b) WAM from scratch at ``WAMConfig()``'s width
   (``examples/train_wam_sync``), its quadrant estimate and revert; (c)
   ``eval_wm``: ``ss`` through (a)'s model over the 21 x 21 grid on 8
   synthetic 256 px images (441 rows), ``hidden`` through random WAM and
   ``ss`` without sync (21 rows each): finite numbers, ``ss`` at
   identity >= 0.99 bit accuracy, three cells equal to the CPU's; the
   seconds of each run and the per-cell medians of the CSV's timings;
13. audio (``phase_audio``): MOSHI_V01 with random bf16 weights (7.7B
   parameters, drawn on the card) and a random MIMI_V0_1, batch 8, 64
   frames, Maryland on streams 0-8 (delta 4, gamma 0.25): (a) a generation
   on the packed cache (kernel #2); (b) ``audio_eval.evaluate`` with the
   flags of ``python -m wmar_tpu_torch.audio_eval --cache_dtype packed4
   --mimi_compression --encodec_weight E --dac_weight D --save_audio``, E
   and D a random ``ENCODEC_24K`` (HF's layout) and ``DAC_24K``
   (descript's, weight_g / weight_v) written by the port's writers:
   generation on the packed4 cache (kernel #1), Mimi decode, the whole
   audio grid (MP3 where libmp3lame loads, the Mimi, EnCodec and DAC round
   trips: 43 cells on the card), re-encode, scoring, ``results.json`` and
   8 WAVs; (c) a ``--wm_method none``
   control on the packed cache. Gates: exactly 32 layers x 65 loop frames
   launches of the cache's kernel a generation and none of any other, every
   watermarked audio stream's own tokens at Maryland p < 1e-6 in (a) and
   (b), the control's median p above 0.01, cells x 8 rows x 8 streams
   finite records. Prints frames/s of each generation, host and device ms
   a frame (``torch.profiler`` over 8 frames), the launches, whether MP3
   ran and the record count; then ``python -m wmar_tpu_torch.audio_eval
   --tiny`` once on the card;
14. audio sync and codecs (``phase_audio_sync``), on phase 13's models and
   a random ``AUDIOSEAL_16B`` written as audioseal's two ``.pth`` files:
   (a) ``audio_eval.evaluate`` with ``--wm_sync --sync_generator_ckpt G
   --sync_detector_ckpt D --sync_alpha 0.5 --eval_aug speed`` on the packed
   cache (kernel #2): exactly 32 x 65 launches, every record's
   ``sync_score`` finite in [0, 1], the inverted rows with their
   (speed-up, shift) printed; (b) ``python -m
   wmar_tpu_torch.audio.eval_audioseal`` (``main``) with G and D over the
   8 WAVs of phase 13's (b), the whole grid: 8 CSV rows a cell (40 cells
   without libmp3lame), scores and TPRs in [0, 1]; (c) on a 1 s clip,
   AudioSeal's watermark and presence and the EnCodec and DAC round trips
   against CPU copies, TF32 off: within 1e-3 of the output's scale, at most
   1e-3 of the codes flipped, each decoder fed the CPU's codes; (d) ms by
   CUDA events at 8 x 5.12 s of ``get_watermark``, ``detect`` and each
   round trip, the host search's seconds a row, peak GiB;
15. DiffPure (``phase_diffpure``), at the entry point's precision (cuDNN
   TF32 on, matmuls float32): a random ADM UNet at
   ``GUIDED_DIFFUSION_256_UNCOND``'s width (552.8M parameters, every layer
   drawn, the zero-initialised ones too) written as ``adm_random.pt`` in
   guided-diffusion's layout and as a converted ``adm_random.msgpack``;
   the entry point ``generate.main`` with RAR-XL, int8 weights, the packed4
   cache (kernel #1), 1 class (2 planned; cut for the script's time), the 62-cell grid and
   ``--include_diffpure true --diffpure_weights adm_random.pt``. Gates: 62
   + 5 cells and their records and files, the five diffpure cells' images
   finite, in [0, 1], different from the input and from each other,
   exactly 660 UNet calls, kernel #1's exact launches, the analyzer's
   "Adversarial Purification" column; the ``.msgpack`` route's UNet equal
   bit for bit; with TF32 off, one UNet call and a 2-step chain at 64 px,
   fed the same noise, within 1e-3 of a CPU copy (the CPU takes seconds a
   call at full width: the chain was cut from 10 steps for the script's
   time). Prints ms a UNet call at batch 1, 2 and 8 (CUDA events, eager)
   and at the run's batch replayed from DiffPure's CUDA graph, launches an
   eager call, seconds a cell, peak GiB;
16. FID (``phase_fid``): the entry point ``python -m
   wmar_tpu_torch.eval.fid`` with random full-width FID-Inception weights in
   torchvision's layout (positive BatchNorm variances), TF32 off, on phase
   15's tree (69 PNGs at 256 px) against 64 synthetic 512 px PNGs (the
   resize shrinks: JAX fault (i)), then ``--save_stats`` and the ``.npz``
   against the tree itself. Gates: the FID finite and >= 0, FID(tree, its
   own statistics) ~ 0, the ``.npz`` equal to the statistics, pool3
   features on the card within 1e-3 of the CPU's. Prints images/s.

17. Mimi RCC and token match (``phase_mimi_rcc``), run right after phase
   14 on phase 13's MOSHI_V01 and MIMI_V0_1: the Mimi written as a
   ``.msgpack``; the entry point ``python -m wmar_tpu_torch.finetune_mimi``
   at full width, 24 synthetic 10 s clips, batch 8, 2 epochs of 3 steps,
   the augmenter from epoch 1 and the subset token-match eval (finite logs,
   ``idemp_k`` in [0, 1], the four parts' deltas non-zero; seconds a step,
   peak GiB); the same run resumed after 1 epoch (the same batches: JAX's
   fault (m)); the decoder alone (the encoder deltas exactly zero); one
   step on 2 x 0.96 s against a CPU copy, TF32 off; ``python -m
   wmar_tpu_torch.audio.token_match`` in mimi mode (8 wavs of 4 s, the whole
   grid, the finetuned Mimi against the original) and in moshi mode
   (MOSHI_V01, 64 steps, batch 8). It launches no kernel.

Prints, before the last line, one JSON object with each kernel's numbers,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and the last line is not printed. Without
a CUDA card it fails at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerance of the kernel against its plain float32 version, relative to
# the largest output. Both compute scores, softmax and sums in float32 and
# differ only in summation order and exp rounding (about 1e-6 relative;
# F32_REL_TOL allows 1e-5). With a bf16 q the kernel then rounds its output
# to bf16, whose 8 significant bits move a value by at most 2^-8 of its
# magnitude: BF16_REL_TOL is that bound plus the float32 allowance.
BF16_REL_TOL = 2.0**-8 + 1e-5
F32_REL_TOL = 1e-5
ABS_FLOOR = 1e-6

SEED = 0
CLASSES = 64
WATERMARK = "linear-rand-h=1-d=2.0-g=0.25"
# the layers of the random Chameleon-7B written as the reference's files (of 32)
CHAMELEON_FILE_LAYERS = 16
# the first of them that phases 5-7 run: the script's time, not the kernels' shapes
CHAMELEON_RUN_LAYERS = 8
# 8 prompts whose first 16 characters differ in length, so the CFG rows are ragged
PROMPTS = ["a cat", "a red fox", "a bowl of soup", "a lighthouse", "a dog in snow", "two owls",
           "a tall ship", "an old bridge at night"]


TAMING_CLASSES = 32
TAMING_GEN = dict(temperature=1.0, top_k=250, top_p=0.92)  # configs/taming_generate.json
# (K, N) of every weight matrix on each model's path
TAMING_MATMULS = ((1664, 1664), (1664, 6656), (6656, 1664), (1664, 16384))
CHAMELEON_MATMULS = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 65536))
RAR_XL_MATMULS = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1280, 7680), (1280, 2560), (1280, 1024))


def _kernels():
    """(name, launching wrapper, source, TPU kernel it replaces) of every kernel."""
    from wmar_tpu_torch.ops import flash_decode as fd
    from wmar_tpu_torch.ops.w4_matmul import matmul_w4

    return [
        ("packed4_decode_attention", fd.packed4_decode_attention,
         "wmar_tpu_torch/csrc/packed_chunked_attention.cu", "wmar_tpu/ops/flash_decode.py:677"),
        ("packed_decode_attention_q8", fd.packed_decode_attention_q8,
         "wmar_tpu_torch/csrc/packed_chunked_attention.cu", "wmar_tpu/ops/flash_decode.py:127"),
        ("packed_decode_attention_q8_chunked", fd.packed_decode_attention_q8_chunked,
         "wmar_tpu_torch/csrc/packed_chunked_attention.cu", "wmar_tpu/ops/flash_decode.py:341"),
        ("packed4_decode_attention_chunked", fd.packed4_decode_attention_chunked,
         "wmar_tpu_torch/csrc/packed_chunked_attention.cu", "wmar_tpu/ops/flash_decode.py:353"),
        ("flash_decode_attention", fd.flash_decode_attention,
         "wmar_tpu_torch/csrc/flash_decode_attention.cu", "wmar_tpu/ops/flash_decode.py:66"),
        ("flash_decode_attention_q8", fd.flash_decode_attention_q8,
         "wmar_tpu_torch/csrc/flash_decode_attention.cu", "wmar_tpu/ops/flash_decode.py:492"),
        ("_packed_dma_probe", fd._packed_dma_probe, "wmar_tpu_torch/csrc/packed_chunked_attention.cu",
         "wmar_tpu/ops/flash_decode.py:560"),
        ("matmul_w4", matmul_w4, "wmar_tpu_torch/csrc/w4_matmul.cu", "wmar_tpu/ops/w4_matmul.py:40"),
        ("row_mean_probe", fd.row_mean_probe, "wmar_tpu_torch/csrc/probes.cu", "tools/bench_call_floor.py:15"),
    ]


def reset_launches() -> None:
    for _, fn, _, _ in _kernels():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn, _, _ in _kernels()}


def phase_build() -> float:
    from wmar_tpu_torch.ops import build
    from wmar_tpu_torch.tools.bench_attention import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, seconds, log = build.build()
    build.load()
    print(f"build: {path.name} in {seconds:.2f} s (0 means it was built already)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    print(card_line())  # name, power limit: exactly as nvidia-smi prints them
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    return seconds


def _filled_cache(n_layers, b, h, t, d, gen, device, kind="packed4"):
    from wmar_tpu_torch.engine.kvcache import KVCache

    cache = KVCache.zeros(n_layers, b, h, t, d, kind, device=device)
    for li in range(n_layers):
        k = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        v = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        cache.write(li, 0, k, v)
    return cache


def sdpa_library(device, n_layers, b, h, t, d, start=None, reps=50) -> dict:
    """The library yardstick of a decode-attention kernel: one
    ``scaled_dot_product_attention`` call over a bf16 cache of the same
    shape (its own random K/V) with the boolean mask of ``start``, walking
    ``n_layers`` layers, by CUDA events and replayed from a CUDA graph.
    Timed here and called nowhere in the port."""
    from wmar_tpu_torch.tools import bench_attention as ba

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    c16 = ba.filled_caches(n_layers, b, h, t, d, gen, device, kinds=("bf16",))["bf16"]
    q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
    attn_mask = ba.sdpa_mask(b, t, t, start, None, device)

    def sdpa(li):
        return ba.library_attention(q, c16.k[li], c16.v[li], attn_mask)

    out = {"library_ms": ba.median_ms(sdpa, n_layers, reps), "library_graph_ms": ba.graph_ms(sdpa, n_layers)}
    del c16
    torch.cuda.empty_cache()
    print(f"library (SDPA over a bf16 cache, B={b} H={h} T={t} D={d}, {n_layers} layers walked"
          f"{', the ragged start' if start is not None else ''}): {out['library_ms']:.4f} ms, from a CUDA graph "
          f"{out['library_graph_ms']:.4f} ms")
    return out


def phase_kernels(device, b=128, t=258, h=16, shapes=(("rar_b", 24, 48), ("rar_xl", 32, 80), ("rar_xxl", 40, 88)),
                  valid_lens=(1, 2, 129, 258), reps=100) -> dict:
    """Kernel vs plain on the card; returns the RAR-XL numbers."""
    from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention, packed4_decode_attention_plain
    from wmar_tpu_torch.tools.bench_attention import attention_bound, graph_ms, time_turns

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0.0
    result = {}
    for name, n_layers, d in shapes:
        cache = _filled_cache(n_layers, b, h, t, d, gen, device)
        for q_dtype, rel in ((torch.bfloat16, BF16_REL_TOL), (torch.float32, F32_REL_TOL)):
            q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
            for layer in (0, n_layers - 1):
                for n in valid_lens:
                    lens = torch.full((1,), n, dtype=torch.int32, device=device)
                    got = packed4_decode_attention(q, cache.kv, cache.scale, layer, lens)
                    want = packed4_decode_attention_plain(q.float(), cache.kv, cache.scale, layer, n)
                    if got.is_cuda:
                        torch.cuda.synchronize()  # a fault in the kernel shows here
                    if got.shape != want.shape or got.dtype != q_dtype or not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: bad kernel output {got.shape} {got.dtype}")
                    err = (got.float() - want).abs().max().item()
                    tol = rel * want.abs().max().item() + ABS_FLOOR
                    if not err <= tol:
                        raise AssertionError(
                            f"{name} D={d} {q_dtype} layer={layer} valid_len={n}: max abs err {err} > {tol}")
                    worst = max(worst, err) if q_dtype == torch.bfloat16 else worst
        print(f"kernel vs plain {name} (L={n_layers} B={b} T={t} H={h} D={d}): ok, "
              f"valid_len {list(valid_lens)}, layers 0 and {n_layers - 1}, bf16 and f32 q")
        if name == "rar_xl" and torch.device(device).type == "cuda":
            q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
            _short_graph_replay_check(f"kernel #1 {name}", packed4_decode_attention, cache, q, t)
            lens = torch.full((1,), t, dtype=torch.int32, device=device)
            plain_ms, ms, ms2, plain_ms2 = time_turns(
                lambda li: packed4_decode_attention(q, cache.kv, cache.scale, li, lens),
                lambda li: packed4_decode_attention_plain(q, cache.kv, cache.scale, li, lens), n_layers, reps)
            nbytes = b * t * h * d + 4 * b * h * t
            bound_ms, bound_by = attention_bound(b, h, t, d, t, 0.5, True, q.dtype, torch.uint8)
            result = {"ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2), "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      "graph_ms": graph_ms(lambda li: packed4_decode_attention(q, cache.kv, cache.scale, li, lens),
                                           n_layers)}
            del cache
            result.update(sdpa_library(device, n_layers, b, h, t, d))
            print(f"time rar_xl decode attention, full cache (plain, kernel, kernel, plain): "
                  f"{plain_ms:.4f} {ms:.4f} {ms2:.4f} {plain_ms2:.4f} ms; replayed from a CUDA graph "
                  f"{result['graph_ms']:.4f} ms; kernel reads {nbytes / 1e6:.1f} MB "
                  f"= {nbytes / (result['graph_ms'] * 1e-3) / 1e9:.0f} GB/s")
        else:
            del cache
    result["max_abs_err"] = worst
    print(f"kernel vs plain: worst bf16 max abs err {worst:.3e}")
    return result


def _short_graph_replay_check(label, launch, cache, q, t) -> None:
    """One launch of a short-cache kernel (#1, #2) captured in a CUDA graph
    and replayed after ``valid_len`` changed in place to 2, 129 (at most
    ``t - 1``) and ``t`` must give the bits of a fresh call."""
    lens = torch.full((1,), 2, dtype=torch.int32, device=q.device)
    launch(q, cache.kv, cache.scale, 1, lens)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = launch(q, cache.kv, cache.scale, 1, lens)
    for n in (2, min(129, t - 1), t):
        lens.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, launch(q, cache.kv, cache.scale, 1, lens)):
            raise AssertionError(f"{label}: a replayed launch differs from a fresh call at valid_len {n}")
    print(f"{label}: one launch replayed from a CUDA graph at valid_len 2, {min(129, t - 1)}, {t}: equal bits")


def _check_close(label: str, got, want, q_dtype) -> float:
    """Max abs error of a kernel output against its plain float32 version,
    within the tolerance stated at the top of this file."""
    rel = BF16_REL_TOL if q_dtype == torch.bfloat16 else F32_REL_TOL
    if got.shape != want.shape or got.dtype != q_dtype or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(got.shape)} {got.dtype}")
    err = (got.float() - want).abs().max().item()
    tol = rel * want.abs().max().item() + ABS_FLOOR
    if not err <= tol:
        raise AssertionError(f"{label}: max abs err {err} > {tol}")
    return err


def cfg_starts(rows: int, blank: int) -> torch.Tensor:
    """A ragged ``start`` shaped like the instruct-CFG batch: the first third
    (full-prompt rows) starts at 0, 1, 2, ...; the other two thirds at
    ``blank``, ``blank + 1``, ..., which blanks their first chunk when
    ``blank >= 128``."""
    third = rows // 3
    return torch.cat([torch.arange(third), blank + torch.arange(rows - third)]).to(torch.int32)


def _packed_case(label, launch, plain, int4, q, cache, layer, n, st, km, forced) -> float:
    """One call of a packed kernel through its wrapper against its plain
    version; then (on the card: ``forced`` not empty) the private launcher
    with every ``(splits, warp_head)`` of ``forced`` (``warp_head`` None: the
    planner's layout), twice: each within the tolerance, the two with equal
    bits."""
    from wmar_tpu_torch.ops import flash_decode as fd

    lens = torch.full((1,), n, dtype=torch.int32, device=q.device)
    got = launch(q, cache.kv, cache.scale, layer, lens, start=st, key_mask=km)
    if got.is_cuda:
        torch.cuda.synchronize()  # a fault in the kernel shows here
    want = plain(q.float(), cache.kv, cache.scale, layer, n, st, km)
    err = _check_close(label, got, want, q.dtype)
    for splits, warp_head in forced:
        one = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, st, km, int4, splits=splits,
                                warp_head=warp_head)
        two = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, st, km, int4, splits=splits,
                                warp_head=warp_head)
        torch.cuda.synchronize()
        tag = f"{label} S={splits}" + ("" if warp_head is None else f" warp_head={warp_head}")
        _check_close(tag, one, want, q.dtype)
        if not torch.equal(one, two):
            raise AssertionError(f"{tag}: two calls differ in their bits")
    return err


def _packed_graph_replay_check(name, launch, cache, q, gen, device) -> None:
    """One launch of a chunked packed kernel captured in a CUDA graph,
    replayed after ``valid_len``, ``start`` and ``key_mask`` were changed in
    place, must give the bits of a fresh call."""
    b, t = q.shape[0], cache.kv.shape[2]
    lens = torch.full((1,), min(700, t), dtype=torch.int32, device=device)
    start = torch.zeros(b, dtype=torch.int32, device=device)
    key_mask = torch.rand((b, t), generator=gen, device=device) < 0.5
    later = torch.rand((b, t), generator=gen, device=device) < 0.8
    key_mask[:, :40] = later[:, :40] = True  # every start below keeps a slot
    launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)  # the scratch, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)
    for n, first, mask in ((min(700, t), 0, key_mask.clone()), (1, 0, key_mask.clone()), (min(3000, t), 33, later),
                           (t, 7, later)):
        lens.fill_(n)
        start.copy_(torch.tensor([0, first, first // 2] + [first] * (b - 3), dtype=torch.int32)[:b])
        key_mask.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)):
            raise AssertionError(f"{name}: a replayed launch differs from a fresh call at valid_len {n}")


def phase_packed_kernels(device, rar=(128, 258, 16, 80, 32), cham=(24, 1043, 32, 128, 32),
                         rar_lens=(1, 2, 129, 258), cham_lens=(1, 128, 129, 600, 1043), blank=130,
                         reps=50, sampler=(3, 4096, 32, 128, 2), sampler_lens=(1, 128, 129, 1160, 4096),
                         interleaved=(7, 64, 1024), forced=tuple(range(1, 17)),
                         rar_layouts=((1, True), (1, False), (2, False), (4, False)), library_layers=8) -> dict:
    """Kernels #2-#4 against their plain versions, and timed beside them at
    full fill; returns ``{name: {"max_abs_err", "ms", "plain_ms"}}``. Kernel
    #2 runs at the RAR-XL shape ``rar`` through the wrapper (the planner's
    layout: a warp per (row, head)) and (on the card) in every ``(splits,
    warp_head)`` of ``rar_layouts`` (both layouts, blocks of four warps with
    S forced to 1, 2 and 4), twice with equal bits, then one launch is
    replayed from a CUDA graph after ``valid_len`` changed in place. The
    chunked kernels #3 and #4 run at the Chameleon text-to-image shape
    ``cham`` and at the interleaved sampler's shape ``sampler`` (``(B, T, H,
    D, layers)``: three rows, with no mask, a ragged ``start`` and the three
    interleaved key masks at each ``valid_len``), every case through the
    wrapper and (on the card) with every split count of ``forced`` twice
    with equal bits; ``valid_len`` 1, 128 and 129 leave shares empty. Then
    one launch is replayed from a CUDA graph after ``valid_len``, ``start``
    and ``key_mask`` changed in place. Each timed shape also gets its SDPA
    yardstick (:func:`sdpa_library`, at most ``library_layers`` layers
    walked: one bf16 layer of Chameleon's shape is 410 MB, far past L2)."""
    from wmar_tpu_torch.ops import flash_decode as fd
    from wmar_tpu_torch.tools.bench_attention import attention_bound, graph_ms, interleaved_masks, time_turns

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    is_cuda = torch.device(device).type == "cuda"
    out = {}
    chunked_layouts = tuple((s_, None) for s_ in forced)
    library = {}
    cases = [("packed_decode_attention_q8", fd.packed_decode_attention_q8, fd.packed_decode_attention_q8_plain,
              "packed", rar, rar_lens, False, tuple(rar_layouts)),
             ("packed_decode_attention_q8_chunked", fd.packed_decode_attention_q8_chunked,
              fd.packed_decode_attention_q8_plain, "packed", cham, cham_lens, True, chunked_layouts),
             ("packed4_decode_attention_chunked", fd.packed4_decode_attention_chunked,
              fd.packed4_decode_attention_plain, "packed4", cham, cham_lens, True, chunked_layouts)]
    for name, launch, plain, kind, (b, t, h, d, n_layers), lens_list, masked, layouts in cases:
        cache = _filled_cache(n_layers, b, h, t, d, gen, device, kind)
        start0 = cfg_starts(b, blank).to(device)
        key_mask0 = torch.rand((b, t), generator=gen, device=device) < 0.7
        layouts = layouts if is_cuda else ()  # the CPU has no kernel to split
        worst = 0.0
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
            for layer in (0, n_layers - 1):
                for n in lens_list:
                    start = torch.clamp(start0, max=n - 1)  # every row keeps a valid slot
                    key_mask = key_mask0.clone()
                    key_mask[torch.arange(b, device=device), start.long()] = True
                    for st, km in ((None, None), (start, None), (start, key_mask)) if masked else ((None, None),):
                        err = _packed_case(f"{name} {q_dtype} layer={layer} valid_len={n} start={st is not None} "
                                           f"key_mask={km is not None}", launch, plain, kind == "packed4", q, cache,
                                           layer, n, st, km, layouts if layer else ())
                        worst = max(worst, err) if q_dtype == torch.bfloat16 else worst
        variants = "none, start, start + key_mask" if masked else "none"
        forced_text = (f"S forced to each of {[s_ for s_, _ in layouts]}" if masked else
                       f"(S, a warp per (row, head)) forced to each of {list(layouts)}")
        print(f"kernel vs plain {name} (L={n_layers} B={b} T={t} H={h} D={d}): ok, valid_len {list(lens_list)}, "
              f"masks {variants}, layers 0 and {n_layers - 1}, bf16 and f32 q"
              + (f"; on layer {n_layers - 1} also {forced_text}, twice with equal bits" if layouts else "")
              + f"; worst bf16 max abs err {worst:.3e}")
        out[name] = {"max_abs_err": worst, "ms": float("nan"), "plain_ms": float("nan"), "graph_ms": None}
        if not is_cuda:  # times only on the card
            continue
        q = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
        if not masked:
            _short_graph_replay_check(f"kernel #2 {name}", launch, cache, q, t)
        lens = torch.full((1,), t, dtype=torch.int32, device=device)
        st = start0 if masked else None
        times = time_turns(lambda li: launch(q, cache.kv, cache.scale, li, lens, start=st),
                           lambda li: plain(q, cache.kv, cache.scale, li, lens, st), n_layers, reps)
        nbytes = b * t * h * d * (2 if kind == "packed" else 1) + 4 * b * h * t
        if masked:  # slots before start are not read
            nbytes = int(nbytes * (1 - float(st.float().mean()) / t))
        bound_ms, bound_by = attention_bound(b, h, t, d, t, 1 if kind == "packed" else 0.5, True, q.dtype,
                                             torch.int8 if kind == "packed" else torch.uint8, start=st)
        out[name] = {"max_abs_err": worst, "ms": min(times[1], times[2]), "plain_ms": min(times[0], times[3]),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "graph_ms": graph_ms(lambda li: launch(q, cache.kv, cache.scale, li, lens, start=st), n_layers)}
        print(f"time {name}, full cache{' with the ragged start' if masked else ''} (plain, kernel, kernel, "
              f"plain): {' '.join(f'{x:.4f}' for x in times)} ms; replayed from a CUDA graph "
              f"{out[name]['graph_ms']:.4f} ms; bound {bound_ms:.4f} ms; kernel reads {nbytes / 1e6:.1f} MB "
              f"= {nbytes / (out[name]['graph_ms'] * 1e-3) / 1e9:.0f} GB/s")
        del cache
        key = (b, t, h, d, masked)  # #3 and #4 share one shape and mask
        if key not in library:
            library[key] = sdpa_library(device, min(n_layers, library_layers), b, h, t, d, st)
        out[name].update(library[key])
    # the interleaved sampler's shape: three CFG rows over one long cache
    b, t, h, d, n_layers = sampler
    start0 = torch.tensor([0, 130, 37], dtype=torch.int32)[:b].to(device)
    for name, launch, plain, kind, *_ in cases[1:]:
        cache = _filled_cache(n_layers, b, h, t, d, gen, device, kind)
        sampler_layouts = chunked_layouts if is_cuda else ()
        worst = 0.0
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
            for n in sampler_lens:
                masks = [(None, None), (torch.clamp(start0, max=n - 1), None)]
                if b == 3:
                    masks.append((None, interleaved_masks(t, n, *interleaved, device)))
                for st, km in masks:
                    err = _packed_case(f"{name} sampler shape {q_dtype} valid_len={n} start={st is not None} "
                                       f"key_mask={km is not None}", launch, plain, kind == "packed4", q, cache,
                                       n_layers - 1, n, st, km, sampler_layouts)
                    worst = max(worst, err) if q_dtype == torch.bfloat16 else worst
            if is_cuda and q_dtype == torch.bfloat16:
                _packed_graph_replay_check(name, launch, cache, q, gen, device)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], worst)
        print(f"kernel vs plain {name} (B={b} T={t} H={h} D={d}, the interleaved sampler's shape): ok, valid_len "
              f"{list(sampler_lens)}, masks none, start{', interleaved' if b == 3 else ''}, bf16 and f32 q"
              + (f"; S = the planner's and forced to each of {list(forced)}, twice with equal bits; replayed from a "
                 f"CUDA graph after valid_len, start and key_mask changed" if is_cuda else "")
              + f"; worst bf16 max abs err {worst:.3e}")
        del cache
    return out


TAMING_DECODE_SHAPE = (48, 32, 257, 16, 104)  # (L, B, T, H, D) of Taming-1.4B's decode attention


def short_cache_attention(device, label, shape, lens, seed, layouts=False, reps=50) -> dict:
    """Kernels #1 (int4 cache) and #2 (int8) at a short-cache decode shape
    ``(L, B, T, H, D)``: against their plain versions at layers 0 and
    L - 1, bf16 and f32 q, each ``valid_len`` of ``lens``. On the card also
    timed at full fill, walking the layers, by CUDA events (plain, kernel,
    kernel, plain) and replayed from a CUDA graph, beside the byte bound and
    one SDPA call over a bf16 cache of the same shape (the library
    yardstick); with ``layouts``, the planner must take the tiled kernel,
    one launch replayed from a CUDA graph after ``valid_len`` changed must
    give a fresh call's bits, and the planner's layout stands beside forced
    ones, each checked and replayed from a graph. Returns ``{name: the
    shape's numbers}``."""
    from wmar_tpu_torch.ops import flash_decode as fd
    from wmar_tpu_torch.tools import bench_attention as ba

    n_layers, b, t, h, d = shape
    is_cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    q16 = torch.randn((b, h, 1, d), generator=gen, device=device, dtype=torch.bfloat16)
    lens_t = torch.full((1,), t, dtype=torch.int32, device=device)
    library = sdpa_library(device, n_layers, b, h, t, d, reps=reps) if is_cuda else {}
    out = {}
    for name, launch, plain, int4, payload_bytes, kv_dtype in (
            ("packed4_decode_attention", fd.packed4_decode_attention, fd.packed4_decode_attention_plain, True, 0.5,
             torch.uint8),
            ("packed_decode_attention_q8", fd.packed_decode_attention_q8, fd.packed_decode_attention_q8_plain, False,
             1, torch.int8)):
        cache = _filled_cache(n_layers, b, h, t, d, gen, device, "packed4" if int4 else "packed")
        worst = 0.0
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
            for layer in (0, n_layers - 1):
                for n in lens:
                    got = launch(q, cache.kv, cache.scale, layer, torch.full((1,), n, dtype=torch.int32, device=device))
                    if got.is_cuda:
                        torch.cuda.synchronize()  # a fault in the kernel shows here
                    want = plain(q.float(), cache.kv, cache.scale, layer, n)
                    err = _check_close(f"{name} {label} {q_dtype} layer={layer} valid_len={n}", got, want, q_dtype)
                    worst = max(worst, err) if q_dtype == torch.bfloat16 else worst
        print(f"kernel vs plain {name} (L={n_layers} B={b} T={t} H={h} D={d}, {label}): ok, valid_len {list(lens)}, "
              f"layers 0 and {n_layers - 1}, bf16 and f32 q; worst bf16 max abs err {worst:.3e}")
        out[name] = res = {"label": label, "L": n_layers, "B": b, "T": t, "H": h, "D": d, "max_abs_err": worst}
        if not is_cuda:  # the checks alone (the CPU tests run them)
            continue
        if layouts:
            sm = fd._sm_count(device.index or 0)
            plan = fd.packed_decode_plan(b, h, t, d, int4, sm)
            if plan.kernel != "tiled" or plan.splits < 1:
                raise AssertionError(f"{name} at {label}: plan {plan}")
            _short_graph_replay_check(f"{name} at {label}", launch, cache, q16, t)
            want = plain(q16.float(), cache.kv, cache.scale, n_layers - 1, t)
            res["plan"] = {"splits": plan.splits, "warp_head": plan.warp_head, "lanes": plan.lanes, "tile": plan.tile}
            res["layouts_graph_ms"] = {}
            for splits, warp_head in ((plan.splits, plan.warp_head), (1, True), (1, False), (2, False), (3, False)):
                def forced(li, s_=splits, w_=warp_head):
                    return fd._launch_packed(q16, cache.kv, cache.scale, li, lens_t, None, None, int4, splits=s_,
                                             warp_head=w_)
                _check_close(f"{name} {label} S={splits} warp_head={warp_head}", forced(n_layers - 1), want,
                             q16.dtype)
                res["layouts_graph_ms"][f"S={splits},warp_head={warp_head}"] = ba.graph_ms(forced, n_layers)
            print(f"{name} at {label}: planner S = {plan.splits}, warp per (row, head) {plan.warp_head}, "
                  f"{plan.lanes} lanes a slot, tiles of {plan.tile} slots, {b * h} (row, head) pairs over {sm} SMs; "
                  f"graph ms by layout " + ", ".join(f"{k} {v:.4f}" for k, v in res["layouts_graph_ms"].items()))
        times = ba.time_turns(lambda li: launch(q16, cache.kv, cache.scale, li, lens_t),
                              lambda li: plain(q16, cache.kv, cache.scale, li, lens_t), n_layers, reps)
        bound_ms, bound_by = ba.attention_bound(b, h, t, d, t, payload_bytes, True, q16.dtype, kv_dtype)
        res.update(ms=min(times[1], times[2]), plain_ms=min(times[0], times[3]), bound_ms=bound_ms, bound_by=bound_by,
                   graph_ms=ba.graph_ms(lambda li: launch(q16, cache.kv, cache.scale, li, lens_t), n_layers), **library)
        print(f"time {name} at {label} (B={b} T={t} H={h} D={d}), full cache (plain, kernel, kernel, plain): "
              f"{' '.join(f'{x:.4f}' for x in times)} ms; replayed from a CUDA graph {res['graph_ms']:.4f} ms; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / res['graph_ms']:.0f}%); library (SDPA, "
              f"bf16 cache) {res['library_ms']:.4f} ms, from a graph {res['library_graph_ms']:.4f} ms")
    return out


def _w4_weights(k, n, group, gen, device, copies=1):
    """``copies`` int4-quantized random ``[k, n]`` matrices, as
    ``wquant.quantize_matrix_int4`` makes them."""
    from wmar_tpu_torch.ops.wquant import quantize_matrix_int4

    return [quantize_matrix_int4(torch.randn((k, n), generator=gen, device=device) * 0.02, group=group)
            for _ in range(copies)]


def phase_w4(device, cases=None, groups=(128, 64, 32), timed=None, reps=50, l2_bytes=120e6) -> dict:
    """Kernel #8 (``matmul_w4``) against its plain float32 version with bf16
    x, at every ``(label, M, K, N)`` case and group size (and with f32 x, the
    CUDA-core route, at the first case); on the card also, at group 128,
    every split count from 1 to its most forced through the private
    launcher, twice with equal bits, and one launch replayed from a CUDA
    graph. Then timed at the ``timed`` cases by
    ``wmar_tpu_torch.tools.bench_w4``, walking enough weight copies to exceed
    the L2 cache as a decode step does: replayed from a CUDA graph and by
    CUDA events, beside the byte bound, the plain version, one
    ``torch._weight_int4pack_mm`` call (the library yardstick) and one bf16
    ``torch.matmul`` on the dequantized weight. Returns the numbers of the
    first timed case, and every timed case under ``"shapes"``."""
    from wmar_tpu_torch.ops import w4_matmul as tw4
    from wmar_tpu_torch.ops.w4_matmul import matmul_w4, matmul_w4_plain
    from wmar_tpu_torch.tools import bench_w4

    if cases is None:
        cases = ([("taming", 32, k, n) for k, n in TAMING_MATMULS]
                 + [("chameleon", 24, k, n) for k, n in CHAMELEON_MATMULS]
                 + [("rar_xl", 128, k, n) for k, n in RAR_XL_MATMULS]
                 + [("ragged", m, 4096, 4096) for m in (1, 7, 456)])
    if timed is None:
        timed = [("taming", 32, k, n) for k, n in TAMING_MATMULS] + [("chameleon ffn", 24, 4096, 11008)]
    is_cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst = 0.0
    for ci, (label, m, k, n) in enumerate(cases):
        for group in groups:
            (w,) = _w4_weights(k, n, group, gen, device)
            for x_dtype in (torch.bfloat16, torch.float32) if ci == 0 else (torch.bfloat16,):
                x = torch.randn((m, k), generator=gen, device=device).to(x_dtype)
                got = matmul_w4(x, w["q4"], w["s4"])
                if got.is_cuda:
                    torch.cuda.synchronize()  # a fault in the kernel shows here
                want = matmul_w4_plain(x.float(), w["q4"], w["s4"])
                tag = f"matmul_w4 {label} M={m} K={k} N={n} G={group} {x_dtype}"
                err = _check_close(tag, got, want, x_dtype)
                worst = max(worst, err) if x_dtype == torch.bfloat16 else worst
                for splits in range(1, min(-(-k // 128), 8) + 1) \
                        if is_cuda and group == 128 and x_dtype == torch.bfloat16 else ():
                    one, two = tw4._launch(x, w["q4"], w["s4"], splits), tw4._launch(x, w["q4"], w["s4"], splits)
                    torch.cuda.synchronize()
                    _check_close(f"{tag} S={splits}", one, want, x_dtype)
                    if not torch.equal(one, two):
                        raise AssertionError(f"{tag} S={splits}: two calls differ in their bits")
        print(f"kernel vs plain matmul_w4 {label} M={m} K={k} N={n}: ok, groups {list(groups)}"
              f"{', bf16 and f32 x' if ci == 0 else ', bf16 x'}"
              + (f"; at G=128 S forced to each of 1..{min(-(-k // 128), 8)}, twice with equal bits" if is_cuda else ""))
    print(f"kernel vs plain matmul_w4: worst bf16 max abs err {worst:.3e}")
    out = {"max_abs_err": worst, "ms": float("nan"), "plain_ms": float("nan"), "graph_ms": None, "shapes": []}
    if not is_cuda:  # times only on the card
        return out
    # one launch replayed from a CUDA graph after x changed in place
    label, m, k, n = timed[0] if timed else cases[0]
    (w,) = _w4_weights(k, n, 128, gen, device)
    x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
    matmul_w4(x, w["q4"], w["s4"])  # the kernel library is loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = matmul_w4(x, w["q4"], w["s4"])
    for _ in range(2):
        x.copy_(torch.randn((m, k), generator=gen, device=device))
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, matmul_w4(x, w["q4"], w["s4"])):
            raise AssertionError(f"matmul_w4 {label}: a replayed launch differs from a fresh call")
    print(f"matmul_w4 {label} M={m} K={k} N={n}: one launch (S = "
          f"{tw4.w4_splits(m, n, k, 128, torch.cuda.get_device_properties(device).multi_processor_count)}) replayed "
          f"from a CUDA graph after x changed: equal bits")
    for ti, (label, m, k, n) in enumerate(timed):
        shape = bench_w4.time_shape(device, label, m, k, n, gen, reps=reps, l2_bytes=l2_bytes)
        if not shape["max_abs_err"] <= shape["tol"]:
            raise AssertionError(f"matmul_w4 {label}: max abs err {shape['max_abs_err']} > {shape['tol']}")
        out["shapes"].append(shape)
        if ti == 0:
            lib = shape["int4pack_same_function"]
            out.update(ms=shape["ms"], plain_ms=shape["plain_ms"], bound_ms=shape["bound_ms"],
                       bound_by=shape["bound_by"], graph_ms=shape["graph_ms"],
                       library_ms=shape["int4pack_ms"] if lib else None,
                       library_graph_ms=shape["int4pack_graph_ms"] if lib else None)
    return out


def _graph_replay_check(name, launch, layer, q, t, gen, device) -> None:
    """One launch captured in a CUDA graph, replayed after ``valid_len`` and
    ``key_mask`` were changed in place, must give the bits of a fresh call:
    the split count comes from the shapes alone and everything else is read
    on the device."""
    b = q.shape[0]
    lens = torch.full((1,), 700, dtype=torch.int32, device=device)
    key_mask = torch.rand((b, t), generator=gen, device=device) < 0.5
    key_mask[:, 0] = True
    later = torch.rand((b, t), generator=gen, device=device) < 0.8
    later[:, 0] = True
    launch(q, *layer, lens, key_mask=key_mask)  # the wrapper's scratch is allocated outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, *layer, lens, key_mask=key_mask)
    for n, mask in ((700, key_mask.clone()), (1, key_mask.clone()), (3000, later), (t, later)):
        lens.fill_(n)
        key_mask.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, launch(q, *layer, lens, key_mask=key_mask)):
            raise AssertionError(f"{name}: a replayed launch differs from a fresh call at valid_len {n}")


def phase_flash_kernels(device, shapes=(("chameleon_4k", 3, 32, 4096, 128), ("rar_like", 16, 16, 4096, 80)),
                        lens=(1, 2, 1043, 2049, 4096), interleaved=(7, 64, 1024), forced=(1, 2, 3, 8)) -> dict:
    """Kernels #5 and #6 against their plain versions: bf16, f32 and int8
    caches, bf16 and f32 q, every ``valid_len`` of ``lens`` (1 and 2: fewer
    slots than splits), with no mask, a ragged ``start``, a random
    ``key_mask``, both, and (3-row shapes) the three masks of an interleaved
    run (everything | image tokens only | <s> and the current image). Each
    case goes through the wrapper (the planner's split count) and through
    the private launcher with every split count of ``forced``, twice, and the
    two outputs must be equal bit for bit. Then a launch captured in a CUDA
    graph is replayed after the masks changed (card only). Returns each
    one's worst bf16 error."""
    from wmar_tpu_torch.engine.kvcache import KVCache
    from wmar_tpu_torch.ops import flash_decode as fd
    from wmar_tpu_torch.tools.bench_attention import interleaved_masks

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    is_cuda = torch.device(device).type == "cuda"
    worst = {"flash_decode_attention": 0.0, "flash_decode_attention_q8": 0.0}
    for tag, b, h, t, d in shapes:
        k = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        v = torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
        start0 = torch.randint(0, 300, (b,), generator=gen, device=device, dtype=torch.int32)
        key_mask0 = torch.rand((b, t), generator=gen, device=device) < 0.7
        planned = fd.flash_decode_splits(b, h, t, fd._sm_count(torch.device(device).index or 0)) if is_cuda else 1
        for cache_dtype in (torch.bfloat16, torch.float32, torch.int8):
            cache = KVCache.zeros(2, b, h, t, d, cache_dtype, device=device).write(1, 0, k, v)
            if cache_dtype == torch.int8:
                name = "flash_decode_attention_q8"
                layer = (cache.k[1], cache.v[1], cache.k_scale[1], cache.v_scale[1])
                launch, plain = fd.flash_decode_attention_q8, fd.flash_decode_attention_q8_plain
            else:
                name = "flash_decode_attention"
                layer = (cache.k[1], cache.v[1])
                launch, plain = fd.flash_decode_attention, fd.flash_decode_attention_plain
            scales = layer[2:] or (None, None)
            for q_dtype in (torch.bfloat16, torch.float32):
                q = torch.randn((b, h, 1, d), generator=gen, device=device).to(q_dtype)
                for n in lens:
                    n_lens = torch.full((1,), n, dtype=torch.int32, device=device)
                    start = torch.clamp(start0, max=n - 1)  # every row keeps a valid slot
                    key_mask = key_mask0.clone()
                    key_mask[torch.arange(b, device=device), start.long()] = True
                    masks = [(None, None), (start, None), (None, key_mask | (torch.arange(t, device=device) == 0)),
                             (start, key_mask)]
                    if b == 3:
                        masks.append((None, interleaved_masks(t, n, *interleaved, device)))
                    for st, km in masks:
                        label = (f"{name} {tag} cache {cache_dtype} q {q_dtype} valid_len={n} "
                                 f"start={st is not None} key_mask={km is not None}")
                        got = launch(q, *layer, n_lens, start=st, key_mask=km)
                        if got.is_cuda:
                            torch.cuda.synchronize()  # a fault in the kernel shows here
                        want = plain(q.float(), *layer, n, st, km)
                        err = _check_close(label, got, want, q_dtype)
                        if q_dtype == torch.bfloat16:
                            worst[name] = max(worst[name], err)
                        for splits in (sorted({*forced, planned}) if is_cuda else ()):  # the CPU has no kernel to split
                            one = fd._launch_flash(q, layer[0], layer[1], *scales, n_lens, st, km, splits=splits)
                            two = fd._launch_flash(q, layer[0], layer[1], *scales, n_lens, st, km, splits=splits)
                            torch.cuda.synchronize()
                            _check_close(f"{label} S={splits}", one, want, q_dtype)
                            if not torch.equal(one, two) or (splits == planned and not torch.equal(one, got)):
                                raise AssertionError(f"{label} S={splits}: two calls differ in their bits")
                if is_cuda and b == 3 and q_dtype == torch.bfloat16:
                    _graph_replay_check(name, launch, layer, q, t, gen, device)
            del cache
        print(f"kernel vs plain flash_decode_attention{{,_q8}} {tag} (B={b} H={h} T={t} D={d}): ok, bf16, f32 and "
              f"int8 caches, bf16 and f32 q, valid_len {list(lens)}, masks none, start, key_mask, both"
              f"{', interleaved' if b == 3 else ''}"
              + (f"; S = {planned} (the planner's) and forced {list(forced)}, each twice with equal bits"
                 f"{'; replayed from a CUDA graph after the masks changed' if b == 3 else ''}" if is_cuda else "")
              + f"; worst bf16 max abs err {worst}")
    return worst


def phase_probes(device, shapes=(("rar_xl", 128, 258, 16, 80), ("taming", 32, 257, 16, 104),
                                  ("chameleon", 24, 1043, 32, 128)), rows_list=(1, 64, 1024, 4096, 16384)) -> dict:
    """Kernel #7 against its plain version (equal bit for bit: one float32
    add, one rounding) at the packed-cache shapes ``(tag, B, T, H, D)`` of
    kernel #2 (RAR-XL: a warp per (row, head); Taming-1.4B: blocks of four
    warps) and kernel #3, and kernel #9 against its plain version within
    bf16's rounding of the mean (2^-8 + 1e-5 of the largest mean: the two
    sum in different orders). Returns each one's worst error."""
    from wmar_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst = {"_packed_dma_probe": 0.0, "row_mean_probe": 0.0}
    for tag, b, t, h, d in shapes:
        cache = _filled_cache(2, b, h, t, d, gen, device, "packed")
        for q_dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros((b, h, 1, d), dtype=q_dtype, device=device)
            for layer in (0, 1):
                got = fd._packed_dma_probe(q, cache.kv, cache.scale, layer)
                if got.is_cuda:
                    torch.cuda.synchronize()
                want = fd._packed_dma_probe_plain(q, cache.kv, cache.scale, layer)
                if got.shape != want.shape or got.dtype != q_dtype or not torch.equal(got, want):
                    raise AssertionError(f"_packed_dma_probe {tag} {q_dtype} layer={layer}: differs from its plain version")
                if not got.abs().max() > 1:
                    raise AssertionError(f"_packed_dma_probe {tag}: output {got.abs().max()} is not the payload's")
        plan = (fd.packed_decode_plan(b, h, t, d, False, fd._sm_count(torch.device(device).index or 0))
                if torch.device(device).type == "cuda" else None)
        print(f"kernel vs plain _packed_dma_probe {tag} (B={b} T={t} H={h} D={d}): equal, bf16 and f32 q, 2 layers"
              + (f"; {plan}" if plan else ""))
        del cache
    for rows in rows_list:
        x = (torch.randn((rows, 1024), generator=gen, device=device) + 0.5).to(torch.bfloat16)
        got = fd.row_mean_probe(x)
        if got.is_cuda:
            torch.cuda.synchronize()
        want = fd.row_mean_probe_plain(x)
        err = _check_close(f"row_mean_probe rows={rows}", got, want.float(), torch.bfloat16)
        worst["row_mean_probe"] = max(worst["row_mean_probe"], err)
    print(f"kernel vs plain row_mean_probe rows {list(rows_list)} x 1024: ok, worst max abs err "
          f"{worst['row_mean_probe']:.3e}")
    return worst


def phase_microbench(device, **kwargs) -> dict:
    """The kernel microbench (``wmar_tpu_torch.tools.bench_attention``), the
    path that runs the two probes: counts set to 0 before, read after.
    Returns ``{"launches", kernel name: numbers}`` for kernels #5, #6 (at
    the end of an interleaved run), #7 (at the RAR-XL shape of kernel #2)
    and #9 (16,384 rows)."""
    from wmar_tpu_torch.tools import bench_attention

    reset_launches()
    res = bench_attention.run(device, **kwargs)
    counts = launches()
    if not (counts["_packed_dma_probe"] > 0 and counts["row_mean_probe"] > 0):
        raise AssertionError(f"microbench: a probe was never launched: {counts}")
    end = res["chameleon_4k_interleaved"]
    # of this phase's launches only the probes' count as a path's: the others were made to time kernels
    path_counts = {k: (n if k in ("_packed_dma_probe", "row_mean_probe") else 0) for k, n in counts.items()}
    out = {"launches": path_counts, "flash_decode_attention": end["flash_decode_attention"],
           "flash_decode_attention_q8": end["flash_decode_attention_q8"],
           "_packed_dma_probe": res["rar_xl"]["_packed_dma_probe"], "row_mean_probe": res["call_floor"]}
    full = res["chameleon_4k_full"]["flash_decode_attention"]
    print(f"microbench: at the full 4k cache flash_decode_attention (S = {full['splits']}) {full['graph_ms']:.4f} ms "
          f"replayed from a CUDA graph vs SDPA {full['library_graph_ms']:.4f} ms, by events {full['ms']:.4f} ms vs "
          f"{full['library_ms']:.4f} ms; per-launch floor at "
          f"{min(res['call_floor']['floor_us'])} row (row_mean_probe) "
          f"{res['call_floor']['floor_us'][min(res['call_floor']['floor_us'])]['us']:.2f} us enqueued by the host, "
          f"{res['call_floor']['floor_us'][min(res['call_floor']['floor_us'])]['graph_us']:.2f} us replayed from a "
          f"CUDA graph; launches {counts}")
    return out


class _Recording:
    """Wraps an ARMM wrapper and keeps what the pipeline sampled and decoded."""

    def __init__(self, inner):
        self.inner = inner
        self.sampled = []
        self.decoded = []
        self.launches_after = []  # the launch counts after each batch

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, *args, **kwargs):
        codes = self.inner.sample(*args, **kwargs)
        self.sampled.append(codes)
        return codes

    def codes_to_images(self, codes):
        imgs = self.inner.codes_to_images(codes)
        self.decoded.append(imgs)
        return imgs


def build_rar(device, cfg=None, vq_cfg=None):
    """The port's counterpart of ``bench.py:build_rar``: RAR-XL and the
    MaskGit f16 tokenizer unless other configs are given, int8 weights, a
    packed4 cache, and the adaLN gates given small random weights so that
    attention reaches the logits."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.models import (
        MASKGIT_IMAGENET_F16, RarARMM, init_maskgit, init_rar, quantize_rar_params_int8, rar_config)

    gen = torch.Generator(device=device).manual_seed(SEED)
    cfg = cfg or rar_config("rar_xl")
    rar = init_rar(cfg, gen, dtype=torch.float32, device=device)
    with torch.no_grad():
        for blk in rar.blocks:
            blk.adaln.w = torch.randn(blk.adaln.w.shape, generator=gen, device=device) * 0.05
    quantize_rar_params_int8(rar, compute_dtype=torch.bfloat16)
    vq = init_maskgit(vq_cfg or MASKGIT_IMAGENET_F16, gen, dtype=torch.bfloat16, device=device)
    wrapper = RarARMM(rar, vq, cache_dtype="packed4", device=device)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


def _drive(device, wrapper, conds, gen_params, caches, batch_size) -> tuple:
    """One ``generate_and_evaluate`` batch per cache type, with every launch
    count set to 0 just before and read just after. Returns (records of
    the last batch, seconds per batch, launch counts, the recording)."""
    from wmar_tpu_torch.eval import EvalParams, generate_and_evaluate

    rec = _Recording(wrapper)
    is_cuda = torch.device(device).type == "cuda"
    seconds = []
    records = []
    reset_launches()
    for bi, cache in enumerate(caches):
        wrapper.cache_dtype = cache
        with tempfile.TemporaryDirectory() as outdir:
            if is_cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            records = generate_and_evaluate(outdir, rec, conds[bi], gen_params, EvalParams(max_roundtrips=1), None,
                                            batch_size=batch_size, seed=SEED + bi,
                                            log_fn=lambda s, c=cache: print(f"  [{c}] {s}"))
            if is_cuda:
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            rec.launches_after.append(launches())
    return records, seconds, launches(), rec


def _check_launches(device, counts: dict, want: dict, path: str) -> None:
    """On the card every count must be exactly as wanted; on the CPU the
    wrappers take their plain versions, so every count is 0."""
    if torch.device(device).type != "cuda":
        want = {k: 0 for k in want}
    want = {**{k: 0 for k in counts}, **want}
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts} != {want}")


def _check_outputs(path, codes, imgs, records, n_rows, seq_len, side, valid_code, spec, greenlist, margin) -> dict:
    from wmar_tpu_torch.core import green_fraction

    if tuple(codes.shape) != (n_rows, seq_len) or not bool(valid_code(codes).all()):
        raise AssertionError(f"{path}: codes {tuple(codes.shape)} in [{codes.min()}, {codes.max()}]")
    if tuple(imgs.shape) != (n_rows, side, side, 3) or not torch.isfinite(imgs).all() \
            or imgs.min() < -1 or imgs.max() > 1:
        raise AssertionError(f"{path}: images {tuple(imgs.shape)} in [{imgs.min()}, {imgs.max()}]")
    pvals = np.array([r["pvalue"] for r in records])
    if len(pvals) != 2 * n_rows or not (np.isfinite(pvals).all() and (pvals >= 0).all() and (pvals <= 1).all()):
        raise AssertionError(f"{path}: p-values {pvals}")
    frac = green_fraction(spec, greenlist, codes).float().mean().item()
    if not frac > spec.gamma + margin:
        raise AssertionError(f"{path}: green fraction {frac} not above gamma {spec.gamma} + {margin}")
    raw_p = np.array([r["pvalue"] for r in records if r["param"] == 0])
    return {"green_fraction": frac, "median_raw_pvalue": float(np.median(raw_p))}


def _peak_gib(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 2**30 if torch.device(device).type == "cuda" else float("nan")


def phase_main_path(device, wrapper, classes: int = CLASSES) -> dict:
    """The RAR path: a warm-up batch on the int8 packed cache (kernel #2),
    then a timed one on the packed4 cache (kernel #1)."""
    from wmar_tpu_torch.models import GenParams

    cfg = wrapper.rar_cfg
    per_batch = (cfg.image_seq_len - 1) * cfg.depth
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    conds = [[(bi * classes + i) % cfg.num_classes for i in range(classes)] for bi in range(2)]
    records, seconds, counts, rec = _drive(device, wrapper, conds, GenParams(temperature=1.0, guidance_scale=4.0),
                                           ("packed", "packed4"), classes)
    _check_launches(device, counts, {"packed_decode_attention_q8": per_batch, "packed4_decode_attention": per_batch},
                    "RAR path")
    gates = _check_outputs("RAR path", rec.sampled[-1], rec.decoded[-2], records, classes, cfg.image_seq_len,
                           wrapper.image_size, lambda c: (c >= 0) & (c < cfg.codebook_size),
                           wrapper.watermark_spec, wrapper.greenlist, 0.15)
    peak = _peak_gib(device)
    out = {"launches": counts, "seconds": seconds, "imgs_per_s": classes / seconds[1], "peak_gib": peak, **gates}
    print(f"RAR path: RAR {cfg.embed_dim} wide x {cfg.depth} layers, int8 weights, {WATERMARK}, {classes} classes, "
          f"1 round trip: warm-up (packed cache) {seconds[0]:.2f} s, timed (packed4 cache) {seconds[1]:.2f} s "
          f"= {out['imgs_per_s']:.2f} imgs/s (generate_and_evaluate end to end, files included); kernel launches "
          f"{counts}, {per_batch} per batch; green fraction {gates['green_fraction']:.3f} (gamma "
          f"{wrapper.watermark_spec.gamma}); median raw p-value {gates['median_raw_pvalue']:.3e}; "
          f"peak memory {peak:.2f} GiB")
    return out


def build_chameleon(device, lcfg=None, vq_cfg=None, vocab=None):
    """CHAMELEON_7B and the CHAMELEON_F16 tokenizer unless other configs are
    given, with random weights from ``SEED`` (int8 linears, bf16 the rest),
    the synthetic full-size vocabulary and tokenizer of the JAX bench."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.generate import synthetic_tokenizer
    from wmar_tpu_torch.models import (
        CHAMELEON_7B, CHAMELEON_F16, ChameleonARMM, ChameleonVocab, init_llama_params, init_taming_vqgan,
        quantize_llama_params_int8)

    gen = torch.Generator(device=device).manual_seed(SEED)
    lcfg = lcfg or CHAMELEON_7B
    vq_cfg = vq_cfg or CHAMELEON_F16
    vocab = vocab or ChameleonVocab.synthetic(n_codes=vq_cfg.n_embed, n_text=lcfg.vocab_size - vq_cfg.n_embed - 6)
    params = quantize_llama_params_int8(init_llama_params(lcfg, gen, dtype=torch.bfloat16, device=device),
                                        compute_dtype=torch.bfloat16)
    vq = init_taming_vqgan(vq_cfg, gen, dtype=torch.bfloat16, device=device)
    wrapper = ChameleonARMM(params, lcfg, vocab, vq, tokenizer=synthetic_tokenizer(16),
                            image_seq_len=vq_cfg.codes_per_side**2, cache_dtype="packed4", device=device)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


CHAMELEON_SPECIALS = ("<s>", "</s>", "<racm3:break>", "<eoss>", "<pad>", "<reserved08706>")


def synthetic_text_tokenizer(n_vocab: int, n_codes: int, seed: int) -> dict:
    """A byte-level BPE ``text_tokenizer.json`` of ``n_vocab`` entries in
    Chameleon's id layout: the six specials of ``ChameleonVocab`` (ids 0-5,
    also added tokens), the 256 byte characters, text tokens made by merges
    drawn from ``seed`` (a token and a letter, digit or space joined; none
    starts with ``<``, which the vocabulary reads as a special), and the
    ``IMGIMG<digits as A-J>Z`` names of ``n_codes`` image codes at the top.
    The ``tokenizers`` package reads it too."""
    from wmar_tpu_torch.models.text_tokenizer import BYTE_CHARS as chars

    vocab = {name: i for i, name in enumerate(CHAMELEON_SPECIALS)}
    for b in range(256):
        vocab[chars[b]] = len(vocab)
    base = [chars[ord(c)] for c in "abcdefghijklmnopqrstuvwxyz0123456789 "]
    pool, merges = list(base), []
    rng = np.random.default_rng(seed)
    n_text = n_vocab - n_codes
    while len(vocab) < n_text:
        a, b = pool[rng.integers(len(pool))], base[rng.integers(len(base))]
        if a + b in vocab or len(a) >= 12:
            continue
        vocab[a + b] = len(vocab)
        merges.append([a, b])
        pool.append(a + b)
    for code in range(n_codes):
        vocab["IMGIMG" + "".join(chr(ord("A") + int(d)) for d in str(code)) + "Z"] = len(vocab)
    added = [{"id": i, "content": name, "single_word": False, "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, name in enumerate(CHAMELEON_SPECIALS)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added, "normalizer": None,
            "pre_tokenizer": byte_level, "post_processor": None, "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


def chameleon_reference_shards(lcfg, n_shards: int, device, seed: int) -> list:
    """A random Chameleon transformer as the reference's tensor-parallel
    ``consolidated.{rank:02}.pth`` state dicts (unfused ``wq/wk/wv`` and
    ``w1/w3``, q/k norms, bf16), drawn on ``device`` and returned on
    the host: matrices N(0, 1/n_in), embeddings N(0, 0.02^2), norms one,
    q/k-norm biases zero. Column-parallel weights are cut on dim 0,
    row-parallel ones (``wo``, ``w2``) on dim 1, norms replicated."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, v, hd = lcfg.dim, lcfg.vocab_size, lcfg.head_dim
    kvd, ffn = lcfg.kv_heads * hd, lcfg.ffn_hidden

    def rand(rows, cols, std):
        return (torch.randn((rows, cols), generator=gen, device=device) * std).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    shards = [{} for _ in range(n_shards)]
    for r in range(n_shards):
        shards[r]["tok_embeddings.weight"] = rand(v // n_shards, d, 0.02)
        shards[r]["output.weight"] = rand(v // n_shards, d, d**-0.5)
        shards[r]["norm.weight"] = ones(d)
    for i in range(lcfg.n_layers):
        p = f"layers.{i}."
        for r in range(n_shards):
            sh = shards[r]
            sh[p + "attention.wq.weight"] = rand(d // n_shards, d, d**-0.5)
            sh[p + "attention.wk.weight"] = rand(kvd // n_shards, d, d**-0.5)
            sh[p + "attention.wv.weight"] = rand(kvd // n_shards, d, d**-0.5)
            sh[p + "attention.wo.weight"] = rand(d, d // n_shards, d**-0.5)
            sh[p + "feed_forward.w1.weight"] = rand(ffn // n_shards, d, d**-0.5)
            sh[p + "feed_forward.w3.weight"] = rand(ffn // n_shards, d, d**-0.5)
            sh[p + "feed_forward.w2.weight"] = rand(d, ffn // n_shards, ffn**-0.5)
            sh[p + "attention_norm.weight"] = ones(d)
            sh[p + "ffn_norm.weight"] = ones(d)
            if lcfg.qk_normalization:
                for x in "qk":
                    sh[p + f"attention.{x}_normalization.weight"] = ones(hd)
                    sh[p + f"attention.{x}_normalization.bias"] = torch.zeros(hd, dtype=torch.bfloat16)
    return shards


def chameleon_reference_vqgan(vq_cfg, device, seed: int) -> dict:
    """A random ``vqgan.ckpt`` state dict (float32, taming's names) of
    ``vq_cfg``, from the port's random tokenizer."""
    from wmar_tpu_torch.models import init_taming_vqgan
    from wmar_tpu_torch.sync.wam_exact import taming_name

    vq = init_taming_vqgan(vq_cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    out = {}
    for k, t in vq.state_dict().items():
        part, rest = k.split(".", 1)
        key = f"{part}.{taming_name(rest)}" if part in ("encoder", "decoder") else k
        out["quantize.embedding.weight" if key == "quantize.embedding" else key] = t.detach().float().cpu()
    return out


def _peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # kB on Linux


def _rss_gib() -> float:
    """The process's resident set now (``/proc/self/statm``), GiB."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def rss_during(fn) -> tuple:
    """(``fn()``, the process's resident GiB just before it, the most seen
    while it ran): a thread reads the resident set every 5 ms, so a step's
    own peak shows even under a higher one earlier in the process."""
    import threading

    before, seen, done = _rss_gib(), [0.0], threading.Event()

    def watch():
        while not done.wait(0.005):
            seen[0] = max(seen[0], _rss_gib())

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    try:
        out = fn()
    finally:
        done.set()
        thread.join()
    return out, before, max(seen[0], _rss_gib())


@contextlib.contextmanager
def chameleon_depth(n_layers: int):
    """``CHAMELEON_7B`` at ``n_layers`` layers (the port's modules look it
    up when they convert and load), restored after."""
    import dataclasses

    from wmar_tpu_torch import models
    from wmar_tpu_torch.models import llama

    full = models.CHAMELEON_7B
    models.CHAMELEON_7B = llama.CHAMELEON_7B = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield models.CHAMELEON_7B
    finally:
        models.CHAMELEON_7B = llama.CHAMELEON_7B = full


def build_chameleon_from_files(device, workdir: str, n_layers: int = CHAMELEON_FILE_LAYERS) -> tuple:
    """Chameleon through the reference's files: a random ``CHAMELEON_7B``
    (its first ``n_layers`` layers, full width) written as two bf16
    tensor-parallel shards, a random ``CHAMELEON_F16`` ``vqgan.ckpt``
    and a synthetic 65,536-entry ``tokenizer/text_tokenizer.json``; the
    port's tool converts them (``convert_ckpt.main``: ``chameleon_llama``
    over the shards' glob, ``chameleon_vqgan``), and
    ``generate.load_wrapper`` loads the directory (``--modelpath``, bf16)
    on ``device``; int8 linears, the packed4 cache and the watermark as in
    :func:`build_chameleon`. Prints each file's bytes and seconds (the
    draw, each write, each conversion, the load), the prompts' ids, the
    host RSS in each conversion (:func:`rss_during`) and the process's
    peak host RSS. Returns (wrapper, report)."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.generate import get_parser, load_wrapper
    from wmar_tpu_torch.models import CHAMELEON_F16, quantize_llama_params_int8
    from wmar_tpu_torch.tools import convert_ckpt

    src, out = os.path.join(workdir, "anole"), os.path.join(workdir, "chameleon")
    os.makedirs(os.path.join(out, "tokenizer"), exist_ok=True)
    os.makedirs(src, exist_ok=True)
    report = {"files": {}, "seconds": {}, "convert_rss_gib": {}}

    def sizes(d, names):
        for name in names:
            report["files"][name] = os.path.getsize(os.path.join(d, name))

    def save(obj, path):
        t0 = time.perf_counter()
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            torch.save(obj, path)
        report["seconds"][f"write {os.path.basename(path)}"] = time.perf_counter() - t0

    with chameleon_depth(n_layers) as cfg:
        t0 = time.perf_counter()
        shards = chameleon_reference_shards(cfg, 2, device, SEED + 30)
        vq_sd = chameleon_reference_vqgan(CHAMELEON_F16, device, SEED + 31)
        tokenizer = synthetic_text_tokenizer(cfg.vocab_size, CHAMELEON_F16.n_embed, SEED)
        report["seconds"]["draw"] = time.perf_counter() - t0
        for r in range(len(shards)):
            save(shards.pop(0), os.path.join(src, f"consolidated.{r:02d}.pth"))
        save({"state_dict": vq_sd}, os.path.join(src, "vqgan.ckpt"))
        save(tokenizer, os.path.join(out, "tokenizer", "text_tokenizer.json"))
        del vq_sd, tokenizer
        sizes(src, sorted(os.listdir(src)))
        sizes(out, ["tokenizer/text_tokenizer.json"])
        for kind, ckpt, name in (("chameleon_llama", "consolidated.*.pth", "llama7b.msgpack"),
                                 ("chameleon_vqgan", "vqgan.ckpt", "vqgan.msgpack")):
            t0 = time.perf_counter()
            _, before, peak = rss_during(lambda: convert_ckpt.main([kind, "--ckpt", os.path.join(src, ckpt),
                                                                     "--outdir", out]))
            report["seconds"][f"convert {kind}"] = time.perf_counter() - t0
            report["convert_rss_gib"][kind] = {"before": before, "peak": peak}
            sizes(out, [name])
        for name in os.listdir(src):  # the sources are not needed any more: free the disk
            os.remove(os.path.join(src, name))
        t0 = time.perf_counter()
        args = get_parser().parse_args(["--model", "chameleon7b", "--modelpath", out, "--device", str(device),
                                        "--outdir", os.path.join(workdir, "unused")])
        wrapper = load_wrapper(args, torch.device(device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        report["seconds"]["load"] = time.perf_counter() - t0
    loaded = wrapper.llama_params["blocks"][0]["wq"]
    if wrapper.llama_cfg.n_layers != n_layers or loaded.dtype != torch.bfloat16 or len(wrapper.llama_params["blocks"]) \
            != n_layers:
        raise AssertionError(f"Chameleon files: loaded {len(wrapper.llama_params['blocks'])} layers of {loaded.dtype}")
    wrapper.llama_params = quantize_llama_params_int8(wrapper.llama_params, compute_dtype=torch.bfloat16)
    wrapper.cache_dtype = "packed4"
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    report["prompt_ids"] = wrapper.tokenize_prompts(PROMPTS)
    report["peak_rss_gib"] = _peak_rss_gib()
    if len({len(ids) for ids in report["prompt_ids"]}) < 2:
        raise AssertionError(f"Chameleon files: the prompts' ids are not ragged: {report['prompt_ids']}")
    print(f"Chameleon files: {n_layers} of 32 layers at width {wrapper.llama_cfg.dim}, 2 bf16 shards; "
          f"bytes {report['files']}; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in report["seconds"].items())
          + "; host RSS in the conversions (GiB before, peak) " + ", ".join(
              f"{k} {v['before']:.2f} -> {v['peak']:.2f}" for k, v in report["convert_rss_gib"].items())
          + f"; the process's peak host RSS {report['peak_rss_gib']:.1f} GiB after the load; "
          f"prompt ids {report['prompt_ids']}")
    return wrapper, report


def phase_chameleon(device, wrapper, prompts=PROMPTS) -> dict:
    """The Chameleon path: a warm-up batch on the int8 packed cache (kernel
    #3), then a timed one on the packed4 cache (kernel #4)."""
    from wmar_tpu_torch.models import GenParams

    per_batch = (wrapper.image_seq_len - 1) * wrapper.llama_cfg.n_layers
    n = len(prompts)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records, seconds, counts, rec = _drive(device, wrapper, [prompts, prompts],
                                           GenParams(temperature=0.9, top_k=None, top_p=0.9), ("packed", "packed4"), n)
    _check_launches(device, counts, {"packed_decode_attention_q8_chunked": per_batch,
                                     "packed4_decode_attention_chunked": per_batch}, "Chameleon path")
    mask = wrapper.vocab.image_token_mask
    gates = _check_outputs("Chameleon path", rec.sampled[-1], rec.decoded[-2], records, n, wrapper.image_seq_len,
                           wrapper.image_size, lambda c: mask.to(c.device)[c], wrapper.watermark_spec,
                           wrapper.greenlist, 0.10)
    peak = _peak_gib(device)
    out = {"launches": counts, "seconds": seconds, "imgs_per_s": n / seconds[1], "peak_gib": peak, **gates}
    cfg = wrapper.llama_cfg
    print(f"Chameleon path: Llama {cfg.dim} wide x {cfg.n_layers} layers, {cfg.n_heads} heads, vocab "
          f"{wrapper.vocab.vocab_size}, int8 weights, {WATERMARK}, {n} prompts ({3 * n} CFG rows), "
          f"{wrapper.image_seq_len} tokens, {wrapper.image_size} px, 1 round trip: warm-up (packed cache) "
          f"{seconds[0]:.2f} s, timed (packed4 cache) {seconds[1]:.2f} s = {out['imgs_per_s']:.3f} imgs/s "
          f"(generate_and_evaluate end to end, files included); kernel launches {counts}, {per_batch} per batch; "
          f"green fraction {gates['green_fraction']:.3f} (gamma {wrapper.watermark_spec.gamma}); median raw "
          f"p-value {gates['median_raw_pvalue']:.3e}; peak memory {peak:.2f} GiB")
    return out


def phase_interleaved(device, wrapper, prompt: str = "a cat", max_images: int = 2, text_gen_len: int = 64,
                      caches=(("bf16", torch.bfloat16, "flash_decode_attention"),
                              ("int8", torch.int8, "flash_decode_attention_q8"))) -> dict:
    """The interleaved path through its entry point, on the wrapper of the
    Chameleon phase: ``generate --interleaved <prompts file> --max_images 2``
    (``run_interleaved``) for one prompt, once per cache type. Two images and
    three text segments make a budget of 2244 tokens, so the cache the three
    CFG rows share passes 2048 slots by itself and every forward after the
    prefill is one launch per layer of that cache's kernel, whatever is
    drawn. Checked from what the run wrote: the ``p=0,idx=0/`` tree, each
    whole image segment's codes, PNG and p-values, and the green fraction."""
    import os

    from PIL import Image

    from wmar_tpu_torch.core import green_fraction
    from wmar_tpu_torch.generate import get_parser, run_interleaved

    cfg, vocab, n_img, side = wrapper.llama_cfg, wrapper.vocab, wrapper.image_seq_len, wrapper.image_size
    budget = max_images * (n_img + 2) + (max_images + 1) * text_gen_len
    per_run = (budget - 1) * cfg.n_layers
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    image_ok = vocab.image_token_mask.numpy()
    text_ok = np.zeros_like(image_ok)
    text_ok[list(vocab.text_tokens) + [vocab.eos_id]] = True
    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}, "seconds": [], "runs": {}}
    for tag, cache_dtype, kernel in caches:
        wrapper.cache_dtype = cache_dtype
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "prompts.txt"), "w") as f:
                f.write(prompt + "\n")
            args = get_parser().parse_args(
                ["--model", "chameleon7b", "--interleaved", os.path.join(tmp, "prompts.txt"), "--max_images",
                 str(max_images), "--text_gen_len", str(text_gen_len), "--seed", str(SEED), "--outdir",
                 os.path.join(tmp, "out")])
            reset_launches()
            if is_cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            records = run_interleaved(args, wrapper, True)
            if is_cuda:
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            counts = launches()
            _check_launches(device, counts, {kernel: per_run}, f"interleaved path, {tag} cache")
            d = os.path.join(tmp, "out", "p=0,idx=0")
            names = sorted(os.listdir(d))
            if "prompt.txt" not in names or open(os.path.join(d, "prompt.txt")).read() != prompt + "\n":
                raise AssertionError(f"interleaved path, {tag}: no prompt.txt in {names}")
            for name in names:
                if name.endswith("_text.npy") and not text_ok[np.load(os.path.join(d, name))].all():
                    raise AssertionError(f"interleaved path, {tag}: {name} holds tokens that are no text")
            if not records or len(records) != sum(n.endswith("_img.json") for n in names):
                raise AssertionError(f"interleaved path, {tag}: {len(records)} image records, files {names}")
            fracs = []
            for rec in records:
                stem = os.path.join(d, f"seg{rec['segment']}_img")
                with open(stem + ".json") as f:
                    if json.load(f) != rec:
                        raise AssertionError(f"interleaved path, {tag}: {stem}.json differs from the returned record")
                codes = np.load(stem + ".npy")
                if codes.shape != (1, n_img) or not image_ok[codes].all():
                    raise AssertionError(f"interleaved path, {tag}: image codes {codes.shape} or no image tokens")
                with Image.open(stem + ".png") as img:
                    extrema = img.convert("L").getextrema()
                    if img.size != (side, side) or extrema[0] == extrema[1]:
                        raise AssertionError(f"interleaved path, {tag}: PNG {img.size}, grey range {extrema}")
                pvals = [rec["pvalue_raw"], rec["pvalue_roundtrip"]]
                if not all(np.isfinite(p) and 0 <= p <= 1 for p in pvals):
                    raise AssertionError(f"interleaved path, {tag}: p-values {pvals}")
                frac = green_fraction(wrapper.watermark_spec, wrapper.greenlist,
                                      torch.as_tensor(codes, device=device)).float().mean().item()
                if not frac > wrapper.watermark_spec.gamma + 0.10:
                    raise AssertionError(f"interleaved path, {tag}: green fraction {frac} not above gamma + 0.10")
                fracs.append(frac)
        for name, n in counts.items():
            out["launches"][name] += n
        out["seconds"].append(seconds)
        out["runs"][tag] = {"seconds": seconds, "ms_per_token": seconds / budget * 1e3, "files": names,
                            "green_fractions": fracs, "records": records}
        print(f"interleaved path [{tag} cache], generate --interleaved --max_images {max_images}: {budget} tokens "
              f"({budget - 1} forwards of 3 rows after the prefill) in {seconds:.2f} s = {seconds / budget * 1e3:.2f} "
              f"ms per token, files included; wrote {names}; launches "
              f"{dict((k, v) for k, v in counts.items() if v)}, {per_run} expected; green fractions "
              f"{[round(x, 3) for x in fracs]}; p-values raw {[r['pvalue_raw'] for r in records]}, round trip "
              f"{[r['pvalue_roundtrip'] for r in records]}")
    out["peak_gib"] = _peak_gib(device)
    print(f"interleaved path: Llama {cfg.dim} wide x {cfg.n_layers} layers, int8 weights, {WATERMARK}, prompt "
          f"{prompt!r}, peak memory {out['peak_gib']:.2f} GiB")
    return out


def phase_interleaved_4k(device, wrapper, prompt: str = "a cat", cache_budget: int = 4096,
                         caches=(("bf16", torch.bfloat16, "flash_decode_attention"),
                                 ("int8", torch.int8, "flash_decode_attention_q8"),
                                 ("packed4", "packed4", "packed4_decode_attention_chunked")), text_opts=None) -> dict:
    """The fused sampler at the reference's cache geometry, which no flag of
    the entry point sets: one prompt, one image, ``TextGenOptions()``
    defaults and a ``cache_budget``-slot cache, once per cache type (the
    packed4 one takes kernel #4's ``key_mask`` route). Checks the exact
    launch count (``budget - 1`` forwards) and the segments' structure."""
    from wmar_tpu_torch.models import GenParams
    from wmar_tpu_torch.models.chameleon_interleaved import TextGenOptions, sample_interleaved_fused

    text_opts = text_opts or TextGenOptions()
    cfg, vocab, n_img = wrapper.llama_cfg, wrapper.vocab, wrapper.image_seq_len
    budget = (n_img + 2) + 2 * text_opts.max_gen_len
    per_run = (budget - 1) * cfg.n_layers
    is_cuda = torch.device(device).type == "cuda"
    text_ok = set(vocab.text_tokens) | {vocab.eos_id}
    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}, "seconds": [], "runs": {}}
    for ci, (tag, cache_dtype, kernel) in enumerate(caches):
        wrapper.cache_dtype = cache_dtype
        reset_launches()
        if is_cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        segs = sample_interleaved_fused(wrapper, prompt, GenParams(temperature=0.9, top_k=None, top_p=0.9),
                                        text_opts=text_opts, max_images=1, apply_watermark=True,
                                        generator=torch.Generator(device=device).manual_seed(SEED + ci),
                                        cache_budget=cache_budget)
        if is_cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        counts = launches()
        _check_launches(device, counts, {kernel: per_run}, f"interleaved sampler, {tag} cache")
        images = [toks for kind, toks in segs if kind == "image_seg"]
        if len(images) != 1 or images[0].shape != (1, n_img) or not vocab.image_token_mask.numpy()[images[0]].all():
            raise AssertionError(f"interleaved sampler, {tag}: segments {[(k, t.shape) for k, t in segs]}")
        if not all(int(t) in text_ok for kind, toks in segs if kind == "text_seg" for t in toks[0]):
            raise AssertionError(f"interleaved sampler, {tag}: a text segment holds tokens that are no text")
        for name, n in counts.items():
            out["launches"][name] += n
        out["seconds"].append(seconds)
        out["runs"][tag] = {"seconds": seconds, "ms_per_token": seconds / budget * 1e3,
                            "segments": [kind for kind, _ in segs]}
        print(f"interleaved sampler [{tag} cache, {cache_budget} slots]: {budget} tokens ({budget - 1} forwards of 3 "
              f"rows after the prefill) in {seconds:.2f} s = {seconds / budget * 1e3:.2f} ms per token; segments "
              f"{[(k, t.shape[1]) for k, t in segs]}; launches {dict((k, v) for k, v in counts.items() if v)}, "
              f"{per_run} expected")
    return out


def first_layers(wrapper, n_layers: int):
    """A view of a Chameleon wrapper that runs its first ``n_layers``
    decoder layers only (the same tensors): the Chameleon path runs
    ``CHAMELEON_RUN_LAYERS`` of the files' ``CHAMELEON_FILE_LAYERS``, so
    that the script keeps its time."""
    import copy
    import dataclasses

    view = copy.copy(wrapper)
    view.llama_params = {**wrapper.llama_params, "blocks": wrapper.llama_params["blocks"][:n_layers]}
    view.llama_cfg = dataclasses.replace(wrapper.llama_cfg, n_layers=n_layers)
    return view


def build_taming(device, gpt_cfg=None, vq_cfg=None):
    """The Taming-1.4B cin_transformer and the f16 ImageNet VQGAN unless
    other configs are given, with random weights from ``SEED``: grouped-int4
    linears and head, bf16 the rest, and ``pos_emb`` given std-0.02 values
    (the faithful zero init would let a wrong position index pass)."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.models import (
        TAMING_GPT_1_4B, TAMING_IMAGENET_F16, TamingARMM, init_gpt, init_taming_vqgan, quantize_gpt_params_int8)

    gen = torch.Generator(device=device).manual_seed(SEED)
    gpt = init_gpt(gpt_cfg or TAMING_GPT_1_4B, gen, dtype=torch.float32, device=device)
    with torch.no_grad():
        gpt.pos_emb.normal_(0.0, 0.02, generator=gen)
    quantize_gpt_params_int8(gpt, compute_dtype=torch.bfloat16, bits=4)
    vq = init_taming_vqgan(vq_cfg or TAMING_IMAGENET_F16, gen, dtype=torch.bfloat16, device=device)
    wrapper = TamingARMM(gpt, vq, cache_dtype="packed4", device=device)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


def _w4_products_per_forward(gpt) -> int:
    """How many of a forward's products take kernel #8: the int4 linears of
    every block and an int4 head."""
    n = sum("w_q4" in lin.params() for blk in gpt.blocks
            for lin in (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.proj, blk.mlp.fc, blk.mlp.proj))
    return n + int("q4" in gpt.head_weight())


def phase_taming(device, wrapper, classes: int = TAMING_CLASSES) -> dict:
    """The Taming path: a warm-up batch on the int8 packed cache (kernel
    #2), then a timed one on the packed4 cache (kernel #1), every linear and
    the head on kernel #8. Each batch runs ``codes_size**2`` forwards (the
    1-token prefill of the class id, then one per decode step but the
    last), so its launch counts are exact."""
    from wmar_tpu_torch.models import GenParams

    cfg = wrapper.gpt_cfg
    steps = wrapper.codes_size**2
    per_batch = {"attention": steps * cfg.n_layer, "matmul_w4": steps * _w4_products_per_forward(wrapper.gpt)}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_cls = min(1000, cfg.vocab_size)
    conds = [[(bi * classes + i) % n_cls for i in range(classes)] for bi in range(2)]
    records, seconds, counts, rec = _drive(device, wrapper, conds, GenParams(**TAMING_GEN), ("packed", "packed4"),
                                           classes)
    first, both = rec.launches_after
    second = {k: both[k] - first[k] for k in both}
    _check_launches(device, first, {"packed_decode_attention_q8": per_batch["attention"],
                                    "matmul_w4": per_batch["matmul_w4"]}, "Taming path, packed batch")
    _check_launches(device, second, {"packed4_decode_attention": per_batch["attention"],
                                     "matmul_w4": per_batch["matmul_w4"]}, "Taming path, packed4 batch")
    v = wrapper.vq_cfg.n_embed
    gates = _check_outputs("Taming path", rec.sampled[-1], rec.decoded[-2], records, classes, steps,
                           wrapper.image_size, lambda c: (c >= 0) & (c < v), wrapper.watermark_spec,
                           wrapper.greenlist, 0.15)
    peak = _peak_gib(device)
    out = {"launches": counts, "seconds": seconds, "imgs_per_s": classes / seconds[1], "peak_gib": peak, **gates}
    print(f"Taming path: GPT {cfg.n_embd} wide x {cfg.n_layer} layers, {cfg.n_head} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, grouped-int4 weights, {WATERMARK}, {classes} classes, {steps} tokens, "
          f"{wrapper.image_size} px, {TAMING_GEN}, 1 round trip: warm-up (packed cache) {seconds[0]:.2f} s, timed "
          f"(packed4 cache) {seconds[1]:.2f} s = {out['imgs_per_s']:.2f} imgs/s (generate_and_evaluate end to end, "
          f"files included); kernel launches {counts}, per batch {per_batch}; green fraction "
          f"{gates['green_fraction']:.3f} (gamma {wrapper.watermark_spec.gamma}); median raw p-value "
          f"{gates['median_raw_pvalue']:.3e}; peak memory {peak:.2f} GiB")
    return out


# The attack sweep: (attack, identity param) cells, whose images must be the original's
SWEEP_IDENTITY = {"gaussian-blur": 0, "gaussian-noise": 0, "brightness": 1, "rotation": 0, "flip-h": 0,
                  "upperleft-crop": 1.0}
SWEEP_ATTACKS = ("gaussian-blur", "gaussian-noise", "jpeg", "brightness", "rotation", "flip-h", "upperleft-crop")


class _Tee(io.StringIO):
    """Keeps what is printed and passes it on to ``stream``."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)


def _sweep_argv(tiny: bool, n_rar: int, n_taming: int, neural_compress: bool = False) -> list:
    """(label, generate argv, checks the torch-compat table) of the two runs;
    ``neural_compress`` adds the random 22-codec bank to the Taming run."""
    size = ["--tiny", "--device", "cpu"] if tiny else []
    codecs = ["--include_neural_compress", "true", "--nc_allow_random", "true"] if neural_compress else []
    return [
        ("RAR-XL", ["--model", "rar", *size, "--weight_dtype", "int8", "--cache_dtype", "packed4",
                    "--conditioning", ",".join(str(c) for c in range(n_rar)), "--batch_size", str(n_rar),
                    "--max_roundtrips", "1", "--seed", str(SEED)], False),
        ("Taming-1.4B", ["--model", "taming", *size, "--weight_dtype", "int4", "--cache_dtype", "packed4",
                         "--conditioning", ",".join(str(c) for c in range(n_taming)), "--batch_size", str(n_taming),
                         "--top_k", str(TAMING_GEN["top_k"]), "--top_p", str(TAMING_GEN["top_p"]),
                         "--exact_jpeg", "true", "--wm_torch_compat", "true", "--seed", str(SEED), *codecs], True),
    ]


# the nominal bpp of the diffusers codecs (neuralcompression.py:185-225); DC-AE's is 1 too
NOMINAL_BPP = {"diffusers-sd-vae-ft-ema": 2.0, "diffusers-sd-vae-fp16": 1.0, "diffusers-deep-compression": 1.0,
               "diffusers-flux": 2.0}


def _check_codec_records(label, records, codecs) -> dict:
    """Every neural-compress record carries ``random_weights: true`` and a
    finite ``bpp`` >= 0, the diffusers codecs their nominal one; returns
    each codec's bpp."""
    bpp = {}
    for r in records:
        if r["transform"] != "neural-compress":
            continue
        b = r.get("bpp")
        if r.get("random_weights") is not True or b is None or not np.isfinite(b) or b < 0:
            raise AssertionError(f"{label}: neural-compress {r['param']}: tags {r}")
        if r["param"] in NOMINAL_BPP and b != NOMINAL_BPP[r["param"]]:
            raise AssertionError(f"{label}: {r['param']} reports {b} bpp, not its nominal {NOMINAL_BPP[r['param']]}")
        bpp[r["param"]] = b
    if sorted(bpp) != sorted(codecs):
        raise AssertionError(f"{label}: neural-compress rows for {sorted(bpp)}, codecs {sorted(codecs)}")
    return bpp


def _sweep_checks(label, wrapper, log, records, outdir, n, codecs=(), diffpure=False) -> dict:
    """The gates of one sweep run on its log, records and tree: the 62
    classic cells, one neural-compress cell per name of ``codecs`` and,
    with ``diffpure``, the five diffpure cells."""
    import os

    from wmar_tpu_torch.core import green_fraction

    n_aug = sum(len(rows) for transform, rows in log.items() if transform != "roundtrips")
    want = n * (len(log["roundtrips"]) + n_aug)
    transforms = {"roundtrips", *SWEEP_ATTACKS, *(["neural-compress"] if codecs else []),
                  *(["diffpure"] if diffpure else [])}
    if n_aug != 62 + len(codecs) + 5 * diffpure or set(log) != transforms or len(records) != want:
        raise AssertionError(f"{label}: {len(records)} records, {n_aug} attack cells, transforms {sorted(log)}")
    files = [f for _, _, fs in os.walk(outdir) for f in fs]
    counts = {ext: sum(f.endswith(ext) for f in files) for ext in (".json", ".png", ".npy")}
    if set(counts.values()) != {want}:
        raise AssertionError(f"{label}: files {counts}, {want} records")
    v = wrapper.get_total_vocab_size()
    for transform, rows in log.items():
        for param, codes, imgs in rows:
            if not (np.isfinite(imgs).all() and imgs.min() >= -1 and imgs.max() <= 1):
                raise AssertionError(f"{label}: {transform} {param}: images in [{imgs.min()}, {imgs.max()}]")
            if codes.shape != (n, wrapper.codes_size**2) or codes.min() < 0 or codes.max() >= v:
                raise AssertionError(f"{label}: {transform} {param}: codes {codes.shape} in "
                                     f"[{codes.min()}, {codes.max()}]")
    pvals = np.array([r["pvalue"] for r in records])
    if not (np.isfinite(pvals).all() and (pvals >= 0).all() and (pvals <= 1).all()):
        raise AssertionError(f"{label}: p-values in [{pvals.min()}, {pvals.max()}]")
    orig, first_trip = log["roundtrips"][0][2], log["roundtrips"][1][1]
    agree = {}
    for name, param in SWEEP_IDENTITY.items():
        (codes, imgs), = [(c, i) for p, c, i in log[name] if p == param]
        err = float(np.abs(imgs - orig).max())
        agree[name] = float((codes == first_trip).mean())
        if not err <= 1e-6 or not agree[name] >= 0.99:
            raise AssertionError(f"{label}: identity cell {name} {param}: image err {err}, codes equal to the first "
                                 f"round trip's on {agree[name]:.4f}")
    raw = torch.as_tensor(log["roundtrips"][0][1], device=wrapper.device)
    frac = green_fraction(wrapper.watermark_spec, wrapper.greenlist, raw).float().mean().item()
    return {"records": len(records), "files": counts, "identity_agreement": agree, "green_fraction": frac}


def _check_table_rows(label, wrapper, n_keys: int = 64) -> None:
    """The torch-compat table the sampler used against the lazily built
    rows of the reference's split, for ``n_keys`` keys drawn from the seed."""
    from wmar_tpu_torch.core import LazyTorchCompatGreenlist, TableGreenlist

    table = wrapper.greenlist
    if not isinstance(table, TableGreenlist):
        raise AssertionError(f"{label}: --wm_torch_compat gave a {type(table).__name__}")
    keys = np.random.default_rng(SEED).integers(0, table.n_keys, n_keys)
    lazy = LazyTorchCompatGreenlist(wrapper.watermark_spec, alive_ids=wrapper.alive_ids)
    got = table.green_mask(torch.as_tensor(keys, device=wrapper.device)).cpu().numpy()
    if not (got == np.stack([lazy._row(int(k)) for k in keys])).all():
        raise AssertionError(f"{label}: table rows differ from the reference's split")


def _native_rescore(label, outdir, wrapper, records, device, classes: int = 2) -> dict:
    """The torch-compat tree's re-score through the C++ scorer (it must be
    built, and called) with the wrapper's alive ids: the stored p-values;
    then the scorer against the numpy branch on the same subtree of
    ``classes`` classes, their seconds and equal p-values."""
    import os
    import shutil

    from wmar_tpu_torch import native
    from wmar_tpu_torch.eval import analyzer

    if not native.available():
        raise AssertionError(f"attack sweep, {label}: the native scorer did not build")
    vocab = wrapper.get_total_vocab_size()
    before = native.calls
    t0 = time.perf_counter()
    rescored = analyzer.rescore(outdir, vocab, torch_compat=True, device=device, alive_ids=wrapper.alive_ids)
    full_s = time.perf_counter() - t0
    stored = {os.path.join(f"c={r['conditioning']},idx={r['idx']}",
                           f"{r['idx']:04}_{r['method']}_{r['transform']}_{r['param']}.npy"): r["pvalue"] for r in records}
    dev = max(abs(rescored[k] - p) for k, p in stored.items())
    if native.calls == before or len(rescored) != len(records) or not dev <= 1e-12:
        raise AssertionError(f"attack sweep, {label}: native re-score: {native.calls - before} calls, "
                             f"{len(rescored)} of {len(records)} records, max |dp| against the stored {dev}")
    sub = outdir + "_sub"
    for d in sorted(os.listdir(outdir))[:classes]:
        shutil.copytree(os.path.join(outdir, d), os.path.join(sub, d))
    t0 = time.perf_counter()
    with_native = analyzer.rescore(sub, vocab, torch_compat=True, device=device, alive_ids=wrapper.alive_ids)
    sub_native_s = time.perf_counter() - t0
    available, native.available = native.available, lambda: False
    try:
        t0 = time.perf_counter()
        with_numpy = analyzer.rescore(sub, vocab, torch_compat=True, device=device, alive_ids=wrapper.alive_ids)
        sub_numpy_s = time.perf_counter() - t0
    finally:
        native.available = available
    if with_numpy != with_native:
        raise AssertionError(f"attack sweep, {label}: native and numpy re-scores differ")
    out = {"native_calls": native.calls - before, "full_native_s": full_s, "files": len(rescored),
           "sub_files": len(with_native), "sub_native_s": sub_native_s, "sub_numpy_s": sub_numpy_s}
    print(f"attack sweep [{label}]: torch-compat re-score through the C++ scorer: {len(rescored)} files in "
          f"{full_s:.2f} s, the stored p-values within {dev:.1e}; on {len(with_native)} files of {classes} classes native "
          f"{sub_native_s:.2f} s against the numpy branch {sub_numpy_s:.2f} s, equal p-values")
    return out


def phase_attack_sweep(device, tiny: bool = False, n_rar: int = 16, n_taming: int = 8, taming_extra=(),
                       inspect=None, neural_compress: bool = False) -> dict:
    """The main path with the attack grid, through the entry point
    ``generate.main`` without ``--no_augs``, one batch each: (a) RAR-XL,
    int8 weights, packed4 cache (kernel #1), ``n_rar`` classes, the device
    JPEG; (b) Taming-1.4B, grouped-int4 weights (kernel #8), packed4 cache
    (kernel #1), ``n_taming`` classes, ``--exact_jpeg true
    --wm_torch_compat true``. Gates: records and files (n x 64), values,
    the identity cells, the torch-compat table (b), the exact launch
    counts, and the port's analyzer on each tree. ``tiny`` runs the CLI's
    tiny models on the CPU. ``taming_extra`` adds flags to run (b) (the RCC
    deltas), ``inspect(label, wrapper)`` checks each run's wrapper.
    ``neural_compress`` adds ``--include_neural_compress true
    --nc_allow_random true`` to run (b): the 22 random codecs at their
    published widths (DC-AE: the JAX package's random slot), all 22 in the
    bank and 62 + 22 = 84 attack cells,
    their records tagged ``random_weights`` with a finite ``bpp``, the
    diffusers codecs' the nominal one, and the analyzer's TPR-against-bpp
    table; the bank comes back as ``out["bank"]``."""
    import os

    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.augmentations import neural
    from wmar_tpu_torch.eval import analyzer, pipeline

    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}, "runs": {}}
    fill, load, build_bank = pipeline.fill_batch_log, tgen.load_wrapper, neural.build_codec_bank
    for label, argv, compat in _sweep_argv(tiny, n_rar, n_taming, neural_compress):
        if label == "Taming-1.4B":
            argv = [*argv, *taming_extra]
        seen = {"logs": []}

        def load_kept(args, dev):
            seen["wrapper"] = load(args, dev)
            return seen["wrapper"]

        def fill_kept(*a, **k):
            seen["logs"].append(fill(*a, **k))
            return seen["logs"][-1]

        def bank_kept(*a, **k):
            t = time.perf_counter()
            seen["bank"] = build_bank(*a, **k)
            seen["bank_s"] = time.perf_counter() - t
            return seen["bank"]

        with tempfile.TemporaryDirectory() as tmp:
            outdir = os.path.join(tmp, "out")
            tgen.load_wrapper, pipeline.fill_batch_log, neural.build_codec_bank = load_kept, fill_kept, bank_kept
            printed = _Tee(sys.stdout)
            try:
                reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    records = tgen.main([*argv, "--outdir", outdir])
                seconds = time.perf_counter() - t0
                counts = launches()
            finally:
                tgen.load_wrapper, pipeline.fill_batch_log, neural.build_codec_bank = load, fill, build_bank
            # the seconds of each batch, as generate_and_evaluate logs them
            sample_s = [float(x) for x in re.findall(r"sampling took ([\d.]+)s", printed.getvalue())]
            fill_save = re.findall(r"round trips and attacks took ([\d.]+)s, detection and files ([\d.]+)s",
                                   printed.getvalue())
            fill_s, save_s = [float(a) for a, _ in fill_save], [float(b) for _, b in fill_save]
            wrapper = seen.pop("wrapper")
            if inspect is not None:
                inspect(label, wrapper)
            n = n_rar if label == "RAR-XL" else n_taming
            if hasattr(wrapper, "rar_cfg"):
                want = {"packed4_decode_attention": (wrapper.rar_cfg.image_seq_len - 1) * wrapper.rar_cfg.depth}
            else:
                steps = wrapper.codes_size**2
                want = {"packed4_decode_attention": steps * wrapper.gpt_cfg.n_layer,
                        "matmul_w4": steps * _w4_products_per_forward(wrapper.gpt)}
            _check_launches(device, counts, want, f"attack sweep, {label}")
            bank = seen.pop("bank", {})
            codecs = tuple(neural.REFERENCE_CODEC_NAMES) if neural_compress and label == "Taming-1.4B" else ()
            if sorted(bank) != sorted(codecs):
                raise AssertionError(f"attack sweep, {label}: the bank holds {len(bank)} codecs {sorted(bank)}, "
                                     f"not the {len(codecs)} of the reference's grid")
            gates = _sweep_checks(label, wrapper, seen["logs"][0], records, outdir, n, codecs)
            if bank:
                out["bank"] = bank
                gates["bank_build_s"] = seen.pop("bank_s")
                gates["bpp"] = _check_codec_records(f"attack sweep, {label}", records, bank)
                points = analyzer.tpr_vs_bpp(analyzer.load_records(outdir, cache=False))
                if sorted(c for _, _, c in points) != sorted(bank):
                    raise AssertionError(f"attack sweep, {label}: the analyzer's bpp table has {points}")
                print(f"attack sweep [{label}]: {len(bank)} random codecs built in {gates['bank_build_s']:.1f} s; "
                      f"the analyzer's TPR@1%FPR against bpp (random codecs: destruction, not compression): " + "; ".join(f"{c} {b:.4f} bpp TPR {t:.2f}" for b, t, c in points))
            if compat:
                _check_table_rows(label, wrapper)
                gates["rescore"] = _native_rescore(label, outdir, wrapper, records, str(device))
                if not gates["green_fraction"] > wrapper.watermark_spec.gamma + 0.15:
                    raise AssertionError(f"attack sweep, {label}: green fraction {gates['green_fraction']} under the "
                                         f"torch-compat table not above gamma + 0.15")
            table = analyzer.robustness_table(analyzer.load_records(outdir, cache=False))
            missing = set(SWEEP_ATTACKS) - set(table["per_attack"])
            if missing:
                raise AssertionError(f"attack sweep, {label}: the analyzer's table lacks {sorted(missing)}")
            if not compat:  # the hash greenlist: its re-score on the device equals the stored p-values
                rescored = analyzer.rescore(outdir, wrapper.get_total_vocab_size(), device=str(device))
                dev = 0.0
                for rel, p in rescored.items():
                    with open(os.path.join(outdir, rel[:-4] + ".json")) as f:
                        dev = max(dev, abs(p - json.load(f)["pvalue"]))
                if len(rescored) != len(records) or not dev <= 1e-12:
                    raise AssertionError(f"attack sweep, {label}: re-scored {len(rescored)} of {len(records)} "
                                         f"records, max |dp| {dev}")
                gates["rescore_max_dp"] = dev
        for name, c in counts.items():
            out["launches"][name] += c
        if not len(sample_s) == len(fill_s) == 1:
            raise AssertionError(f"attack sweep, {label}: batch timings {sample_s} {fill_save} for one batch")
        grid_s = [a + b for a, b in zip(fill_s, save_s)]
        out["runs"][label] = {"seconds": seconds, "sample_s": sample_s, "grid_s": grid_s,
                              "fill_s": fill_s, "save_s": save_s, "table": table, **gates}
        print(f"attack sweep [{label}]: generate {' '.join(argv)}: {gates['records']} records, files "
              f"{gates['files']}; a batch: sampling {sample_s[0]:.2f} s, then the grid {grid_s[0]:.2f} s = "
              f"decode, round trip, {62 + len(gates.get('bpp', ()))} attacks and re-encodes {fill_s[0]:.2f} s + "
              f"detection, metrics and "
              f"files {save_s[0]:.2f} s; whole run {seconds:.2f} s (model build included); launches {dict((k, v) for k, v in counts.items() if v)}, expected {want}; green fraction "
              f"{gates['green_fraction']:.3f}; identity cells' codes equal to the first round trip's on "
              f"{min(gates['identity_agreement'].values()):.4f} or more of the tokens")
        print(f"attack sweep [{label}]: TPR@1%FPR per attack {json.dumps(table['per_attack'])}")
        print(analyzer.markdown_table(table))
    return out


# ---------------------------------------------------------------------------
# The neural codecs: the sweep's bank (and DC-AE at f64c128's widths), card against CPU
# ---------------------------------------------------------------------------

CODEC_REL_TOL = 1e-3  # card against CPU, float32 with TF32 off, relative to the output's largest value
CODEC_FLIP_SHARE = 1e-3  # quantized latents whose integer the two devices round apart at a .5 tie


def _codec_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double().cpu()
    return float((got.double().cpu() - want).abs().max() / max(1.0, float(want.abs().max())))


def _hold_codec_on_cpu(name, codec, cpu_model, x_check, generator) -> dict:
    """One codec's card output against the port's CPU output on the same
    weights and image. compressai: the latents ``y``, the share of quantized
    integers that differ, the synthesis fed the CPU's quantized latents, the
    bpp (1e-5 relative, 1e-3 where an integer flipped) and, without a flip,
    the whole reconstruction; KL-VAE: the moments and the decode of the same
    posterior draw; DC-AE: the round trip. Relative to the largest value of
    the CPU's output (random codecs blow theirs up)."""
    from wmar_tpu_torch.augmentations import compressai_models as cm
    from wmar_tpu_torch.augmentations import diffusers_vae as dv
    from wmar_tpu_torch.augmentations.dcae import DCAE

    device = next(codec.model.parameters()).device
    xc = x_check.permute(0, 3, 1, 2)
    xd = xc.to(device)
    row = {"tol": CODEC_REL_TOL}
    with torch.inference_mode():
        if isinstance(codec.model, DCAE):
            row["max_abs_err"] = _codec_rel(codec.model.roundtrip(xd), cpu_model.roundtrip(xc))
        elif isinstance(codec.model, dv.AutoencoderKL):
            moments = cpu_model.encode(xc)
            row["moments_err"] = _codec_rel(codec.model.encode(xd), moments)
            noise = torch.randn(moments[:, : moments.shape[1] // 2].shape, generator=generator)
            want = dv.kl_vae_roundtrip(cpu_model, xc, noise=noise)
            row["max_abs_err"] = max(row["moments_err"], _codec_rel(
                dv.kl_vae_roundtrip(codec.model, xd, noise=noise.to(device)), want))
        else:
            y_cpu, y = cpu_model.g_a(xc), codec.model.g_a(xd)
            row["latents_err"] = _codec_rel(y, y_cpu)
            yh_cpu, yh = cm.st_round(y_cpu), cm.st_round(y)
            row["flipped"] = float(((yh.cpu() - yh_cpu).abs() > 0.25).float().mean())
            row["synthesis_err"] = _codec_rel(codec.model.synthesis(yh_cpu.to(device)), cpu_model.synthesis(yh_cpu))
            rec_cpu, liks_cpu = cpu_model(xc)
            rec, liks = codec.model(xd)
            n_px = xc.shape[0] * xc.shape[2] * xc.shape[3]
            bpp_cpu = float(cm.bpp_from_likelihoods(liks_cpu, n_px))
            row["bpp_rel_err"] = abs(float(cm.bpp_from_likelihoods(liks, n_px)) - bpp_cpu) / max(1.0, abs(bpp_cpu))
            row["max_abs_err"] = max(row["latents_err"], row["synthesis_err"])
            if row["flipped"] == 0:
                row["max_abs_err"] = max(row["max_abs_err"], _codec_rel(rec, rec_cpu))
            if not (row["flipped"] <= CODEC_FLIP_SHARE
                    and row["bpp_rel_err"] <= (1e-5 if row["flipped"] == 0 else 1e-3)):
                raise AssertionError(f"neural codecs: {name}: the card against the CPU {row}")
    if not row["max_abs_err"] <= CODEC_REL_TOL:
        raise AssertionError(f"neural codecs: {name}: the card against the CPU {row}")
    return row


def phase_neural_codecs(device, bank: dict, dcae_cfg=None, batch: int = 8, size: int = 256, check_size: int = 64,
                        reps: int = 3) -> dict:
    """Every codec of ``bank`` (the attack sweep's: the 22 random codecs at
    their published widths) with the DC-AE slot rebuilt at ``dcae_cfg``
    (default: ``dc-ae-f64c128``'s stage widths, ``init_dcae_params(0)``),
    each on ``batch`` random images of ``size`` px on the card: its output
    finite, in [0, 1] and of the input's shape, its bpp finite and >= 0, its
    ms a batch by CUDA events (the median of ``reps`` after a warm-up), and
    its output on one ``check_size`` px image held against a CPU copy of the
    same weights (:func:`_hold_codec_on_cpu`). Prints the phase's peak GiB."""
    import copy

    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.augmentations import dcae as tdc
    from wmar_tpu_torch.augmentations import diffusers_vae as dv

    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = dcae_cfg or tdc.f64c128_config()
    t0 = time.perf_counter()
    codecs = dict(bank)
    codecs["diffusers-deep-compression"] = dv.DiffusersCompression(
        "diffusers-deep-compression", cfg, bridge.load_dcae(cfg, tdc.init_dcae_params(0, cfg), device),
        random_weights=True)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    x = torch.rand((batch, size, size, 3), generator=gen, device=device)
    x_check = torch.rand((1, check_size, check_size, 3), generator=torch.Generator().manual_seed(SEED + 13))
    out = {"codecs": {}, "dcae_params": sum(p.numel() for p in codecs["diffusers-deep-compression"].model.parameters()),
           "dcae_build_s": build_s}
    for name in sorted(codecs):
        codec = codecs[name]
        rec, bpp = codec(x, generator=gen, return_bpp=True)  # the warm-up
        bpp = float(bpp)
        if not (rec.shape == x.shape and torch.isfinite(rec).all() and rec.min() >= 0 and rec.max() <= 1
                and np.isfinite(bpp) and bpp >= 0):
            raise AssertionError(f"neural codecs: {name}: output {tuple(rec.shape)} in [{rec.min()}, {rec.max()}], "
                                 f"bpp {bpp}")
        times = []
        for _ in range(reps if is_cuda else 0):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            codec(x, generator=gen, return_bpp=True)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        row = _hold_codec_on_cpu(name, codec, copy.deepcopy(codec.model).cpu(), x_check,
                                 torch.Generator().manual_seed(SEED + 14))
        row.update(bpp=bpp, ms=float(np.median(times)) if times else None, random_weights=codec.random_weights)
        out["codecs"][name] = row
        print(f"neural codecs: {name}: {batch} x {size} px {row['ms'] if row['ms'] is None else round(row['ms'], 3)} "
              f"ms a batch, {bpp:.4f} bpp; card against CPU at {check_size} px "
              + ", ".join(f"{k} {v:.2e}" for k, v in row.items() if k.endswith("err") or k == "flipped"))
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if is_cuda else None
    times = [r["ms"] for r in out["codecs"].values() if r["ms"] is not None]
    print(f"neural codecs: {len(codecs)} codecs, the bank {sum(times):.1f} ms for {batch} x {size} px each"
          f"{'' if times else ' (not timed on the CPU)'}; DC-AE at {out['dcae_params'] / 1e6:.1f}M parameters "
          f"built in {build_s:.1f} s; peak {out['peak_gib']} GiB")
    return out


# ---------------------------------------------------------------------------
# Sync: SyncSealRef through the entry point, the Flax SyncSealModel, WAM
# ---------------------------------------------------------------------------

SYNC_CLASSES = 8
SYNC_CPU_TOL = 1e-3  # card against CPU, float32 with TF32 off: summation order over 12 SAM layers


class MockWamEmbedder:
    """A stand-in pixel watermark for ``WamSync`` (the twin of the tests'
    mock): the message id as a quantized blue level, detected exactly and
    locally, so a geometric attack moves the quadrant ids with the pixels.
    Random WAM weights never reach the fit; this does, on the card."""

    LEVELS = (0.15, 0.38, 0.62, 0.85)

    def embed(self, img01, msg):
        from wmar_tpu_torch.sync.wam_logic import quadrant_messages

        row = msg[0].cpu().numpy()
        mid = int(np.flatnonzero((quadrant_messages() == row).all(axis=1))[0])
        out = img01.clone()
        out[..., 2] = self.LEVELS[mid]
        return out

    def detect(self, img01):
        from wmar_tpu_torch.sync.wam_logic import quadrant_messages

        d = (img01[..., 2, None] - torch.tensor(self.LEVELS, device=img01.device)).abs()  # [B, H, W, 4]
        msgs = torch.as_tensor(quadrant_messages(), device=img01.device)
        bits = msgs[d.argmin(-1)].permute(0, 3, 1, 2).float() * 2 - 1
        mask = torch.where(d.min(-1).values < 0.05, 8.0, -8.0)[:, None]
        return torch.cat([mask, bits], dim=1)


def _timed_cuda(fn, *args, reps: int = 3):
    """(output, seconds a call) over ``reps`` calls after one warm-up, the
    card synchronized around them."""
    out = fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def _sync_bound(label, before, after, bound=None) -> float:
    """``add_sync``'s images are finite, in [-1, 1] and moved, by at most
    ``bound`` where one is given."""
    err = float((after.float() - before.float()).abs().max())
    if not (torch.isfinite(after).all() and after.min() >= -1 and after.max() <= 1 and 0 < err
            and (bound is None or err <= bound)):
        raise AssertionError(f"sync, {label}: add_sync moved the images by {err} (bound {bound})")
    return err


def _card_vs_cpu(label, card, cpu, tol) -> float:
    err = float((card.float().cpu() - cpu.float()).abs().max())
    scale = max(1.0, float(cpu.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"sync, {label}: the card and the CPU differ by {err} (bound {tol * scale})")
    return err


def phase_sync(device, workdir: str) -> dict:
    """Geometric sync at full width on random weights written in the
    released layouts. (a) ``generate.main --sync true --syncpath
    syncseal_random.pt`` (the released SyncSeal: UNet + ConvNeXt-tiny, its
    corner head well posed) with RAR-XL as ``load_wrapper`` builds it, int8
    weights, 8 classes: a warm-up batch on the packed cache (kernel #2,
    ``--no_augs``), then a batch on the packed4 cache (kernel #1) through the
    62-cell grid, every re-tokenize after ``remove_sync``; (b) the Flax
    ``SyncSealModel`` from a port-written ``syncseal_random.msgpack``; (c)
    WAM (SAM-base + vae_small, 256 px) from ``wam_random.pth``, held against
    the CPU on 2 images, and ``WamSync`` over a mock pixel watermark after a
    flip, a rotation and a crop, its estimates equal to the CPU's."""
    import os

    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.eval import pipeline
    from wmar_tpu_torch.sync import manager as sman
    from wmar_tpu_torch.sync import syncseal as tss
    from wmar_tpu_torch.sync import wam_exact as twx
    from wmar_tpu_torch.sync import wam_logic as twl
    from wmar_tpu_torch.augmentations import geometric as G

    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}}
    # (a) the released SyncSeal through the entry point
    ref = tss.init_syncseal_ref(SEED)  # on the CPU: also the reference of the card's numbers
    pt = os.path.join(workdir, "syncseal_random.pt")
    torch.save(ref.state_dict(), pt)
    argv = ["--model", "rar", "--weight_dtype", "int8", "--conditioning", ",".join(map(str, range(SYNC_CLASSES))),
            "--batch_size", str(SYNC_CLASSES), "--seed", str(SEED), "--sync", "true", "--syncpath", pt]
    seen = {"logs": [], "calls": {"add_sync": 0, "remove_sync": 0}}
    load, fill = tgen.load_wrapper, pipeline.fill_batch_log
    add, remove = sman.SyncManager.add_sync, sman.SyncManager.remove_sync

    def load_kept(args, dev):
        seen["wrapper"] = load(args, dev)
        return seen["wrapper"]

    def fill_kept(*a, **k):
        seen["logs"].append(fill(*a, **k))
        return seen["logs"][-1]

    def counted(name, fn):
        def call(self, imgs):
            seen["calls"][name] += 1
            return fn(self, imgs)
        return call

    per_batch = None
    runs = {}
    tgen.load_wrapper, pipeline.fill_batch_log = load_kept, fill_kept
    sman.SyncManager.add_sync, sman.SyncManager.remove_sync = counted("add_sync", add), counted("remove_sync", remove)
    try:
        for cache, extra in (("packed", ["--no_augs"]), ("packed4", [])):
            with tempfile.TemporaryDirectory() as tmp:
                seen["calls"] = {"add_sync": 0, "remove_sync": 0}
                reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(_Tee(sys.stdout)):
                    records = tgen.main([*argv, "--cache_dtype", cache, *extra, "--outdir", os.path.join(tmp, "o")])
                seconds = time.perf_counter() - t0
                counts = launches()
                cfg = seen["wrapper"].rar_cfg
                per_batch = (cfg.image_seq_len - 1) * cfg.depth
                kernel = "packed_decode_attention_q8" if cache == "packed" else "packed4_decode_attention"
                _check_launches(device, counts, {kernel: per_batch}, f"sync, SyncSealRef, {cache} cache")
                cells = 2 if extra else 64
                calls = dict(seen["calls"])
                if len(records) != SYNC_CLASSES * cells or calls != {"add_sync": 1, "remove_sync": cells - 1}:
                    raise AssertionError(f"sync, SyncSealRef, {cache}: {len(records)} records, sync calls {calls}")
                pvals = np.array([r["pvalue"] for r in records])
                if not (np.isfinite(pvals).all() and (pvals >= 0).all() and (pvals <= 1).all()):
                    raise AssertionError(f"sync, SyncSealRef: p-values in [{pvals.min()}, {pvals.max()}]")
                for transform, rows in seen["logs"][-1].items():
                    for param, codes, imgs in rows:
                        if not (np.isfinite(imgs).all() and imgs.min() >= -1 and imgs.max() <= 1):
                            raise AssertionError(f"sync, SyncSealRef: {transform} {param}: images out of range")
                for name, c in counts.items():
                    out["launches"][name] += c
                runs[cache] = {"seconds": seconds, "records": len(records), "launches": counts, "sync_calls": calls}
    finally:
        tgen.load_wrapper, pipeline.fill_batch_log = load, fill
        sman.SyncManager.add_sync, sman.SyncManager.remove_sync = add, remove
    wrapper, log = seen.pop("wrapper"), seen["logs"][-1]
    codes = torch.as_tensor(log["roundtrips"][0][1], device=device)
    with torch.no_grad():
        plain = wrapper.codes_to_images(codes).float()
    synced = torch.as_tensor(log["roundtrips"][0][2], device=device)
    # the released design's delta is a tanh times a heatmap of at most 1: the SyncSeal scale bounds the
    # move, in [-1, 1] twice scaling_w, plus the 8-bit rounding
    moved = _sync_bound("SyncSealRef", plain, synced, 2 * ref.cfg.scaling_w + 2 / 255)
    mgr = sman.SyncManager.from_path(pt, device=device)
    again, add_s = _timed_cuda(mgr.add_sync, plain)
    unsynced, remove_s = _timed_cuda(mgr.remove_sync, synced)
    with torch.no_grad():
        cpu_add = ref.add_sync(plain[:2].cpu())
        cpu_remove = ref.remove_sync(synced[:2].cpu())
    # the 8-bit rounding may flip at a float32 tie: count, don't bound, those pixels
    flips = int(((again[:2].cpu() - cpu_add).abs() > 1e-4).sum())
    if flips > 1e-3 * cpu_add.numel() or float((again[:2].cpu() - cpu_add).abs().max()) > 2 / 255 + 1e-4:
        raise AssertionError(f"sync, SyncSealRef: add_sync on the card and the CPU differ at {flips} values")
    err_remove = _card_vs_cpu("SyncSealRef remove_sync", unsynced[:2], cpu_remove, SYNC_CPU_TOL)
    out["syncseal_ref"] = {"runs": runs, "add_s": add_s, "remove_s": remove_s, "max_move": moved,
                           "add_flips_vs_cpu": flips, "remove_err_vs_cpu": err_remove}
    print(f"sync (a) SyncSealRef: generate --sync true --syncpath syncseal_random.pt, RAR-XL int8, {SYNC_CLASSES} "
          f"classes: warm-up (packed, no grid) {runs['packed']['seconds']:.2f} s, grid (packed4) "
          f"{runs['packed4']['seconds']:.2f} s, {runs['packed4']['records']} records, sync calls "
          f"{runs['packed4']['sync_calls']}, launches {per_batch} per batch on #2 then #1; add_sync moves <= "
          f"{moved:.4f}; a batch of {SYNC_CLASSES}: add_sync {add_s * 1e3:.2f} ms, remove_sync {remove_s * 1e3:.2f} ms; "
          f"card vs CPU: add_sync {flips} rounding flips, remove_sync {err_remove:.2e}")

    # (b) the Flax design from a port-written msgpack
    flax = tss.SyncSealModel.init(SEED)
    with torch.no_grad():  # Flax zero-inits the output conv: give the signal a random one
        flax.embedder.out.weight.normal_(0, 0.02, generator=torch.Generator().manual_seed(SEED))
    mp = os.path.join(workdir, "syncseal_random.msgpack")
    flax.save(mp)
    mgr_b = sman.SyncManager.from_path(mp, device=device)
    if not isinstance(mgr_b.impl, tss.SyncSealModel):
        raise AssertionError(f"sync, {mp}: dispatched to {type(mgr_b.impl).__name__}")
    synced_b, add_b = _timed_cuda(mgr_b.add_sync, plain)
    moved_b = _sync_bound("SyncSealModel", plain, synced_b)  # the Flax design's delta has no tanh: no bound
    unsynced_b, remove_b = _timed_cuda(mgr_b.remove_sync, synced_b)
    with torch.no_grad():
        err_b = _card_vs_cpu("SyncSealModel remove_sync", unsynced_b[:2], flax.remove_sync(synced_b[:2].cpu()),
                             SYNC_CPU_TOL)
    if not torch.isfinite(unsynced_b).all() or unsynced_b.shape != plain.shape:
        raise AssertionError("sync, SyncSealModel: remove_sync output")
    out["syncseal_model"] = {"add_s": add_b, "remove_s": remove_b, "max_move": moved_b, "remove_err_vs_cpu": err_b}
    print(f"sync (b) SyncSealModel (syncseal_random.msgpack): add_sync {add_b * 1e3:.2f} ms, remove_sync "
          f"{remove_b * 1e3:.2f} ms a batch of {SYNC_CLASSES}; moves <= {moved_b:.4f}; remove_sync card vs CPU "
          f"{err_b:.2e}")

    # (c) WAM at full width
    wam = twx.init_wam(SEED)
    wp = os.path.join(workdir, "wam_random.pth")
    torch.save(twx.to_wam_state_dict(wam), wp)
    mgr_c = sman.SyncManager.from_path(wp, image_size=wrapper.image_size, device=device)
    synced_c, add_c = _timed_cuda(mgr_c.add_sync, plain, reps=1)
    unsynced_c, remove_c = _timed_cuda(mgr_c.remove_sync, synced_c, reps=1)
    if not (torch.isfinite(synced_c).all() and torch.isfinite(unsynced_c).all()):
        raise AssertionError("sync, WAM: non-finite images")
    x01 = (plain[:2] + 1) / 2
    msgs = torch.as_tensor(np.random.default_rng(SEED).integers(0, 2, (2, twx.NBITS)), device=device)
    emb = mgr_c.impl.embedder
    err_embed = _card_vs_cpu("WAM embed", emb.embed(x01, msgs), wam.embed(x01.cpu(), msgs.cpu()), SYNC_CPU_TOL)
    err_detect = _card_vs_cpu("WAM detect", emb.detect(x01), wam.detect(x01.cpu()), SYNC_CPU_TOL)
    # WamSync over the mock: the fit runs (coverage ~0.86 at 256 px), card and CPU agree
    gen = np.random.default_rng(SEED)
    img = gen.uniform(-1, 1, (1, wrapper.image_size, wrapper.image_size, 3)).astype(np.float32)
    img[..., 2] = 0.0
    mock = {d: twl.WamSync(MockWamEmbedder(), image_size=wrapper.image_size) for d in ("cuda", "cpu")}
    estimates = {}
    for name, attack in (("identity", lambda x: x), ("flip", G.hflip), ("rotation", lambda x: G.rotate(x, 10.0)),
                         ("crop", lambda x: G.upper_left_crop_resize_back(x, 0.75))):
        got = {}
        for d, sync in mock.items():
            s01 = (sync.add_sync(torch.as_tensor(img, device=d)) + 1) / 2
            attacked = attack(s01)
            got[d] = tuple(int(v) for v in sync.estimate(attacked[0])[0])
            sync.remove_sync(attacked * 2 - 1)
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"sync, mock WamSync, {name}: the card estimates {got['cuda']}, the CPU {got['cpu']}")
        estimates[name] = got["cuda"]
    if not estimates["flip"][3]:
        raise AssertionError(f"sync, mock WamSync: the flip was not found: {estimates}")
    out["wam"] = {"add_s": add_c, "remove_s": remove_c, "remove_per_image_s": remove_c / plain.shape[0],
                  "embed_err_vs_cpu": err_embed, "detect_err_vs_cpu": err_detect, "mock_estimates": estimates}
    print(f"sync (c) WAM (wam_random.pth, SAM-base + vae_small, {wrapper.image_size} px): add_sync {add_c:.3f} s, "
          f"remove_sync {remove_c:.3f} s for {plain.shape[0]} images = {remove_c / plain.shape[0] * 1e3:.1f} ms an "
          f"image (host loop, one copy each); card vs CPU (TF32 off): embed {err_embed:.2e}, detect {err_detect:.2e}; "
          f"mock WamSync estimates (angle, cut_i, cut_j, flipped) {estimates}, equal on the CPU")
    return out


# sync training (phase 12): the trainer's flags at full width; 8 steps an epoch, detector-only from epoch 1, an
# eval at epochs 1 and 2
SYNC_TRAIN_FLAGS = ("--synthetic", "true", "--img_size", "256", "--batch_size", "8", "--lr", "1e-4",
                    "--steps_per_epoch", "8", "--finetune_detector_start", "1", "--eval_freq", "2",
                    "--sift_baseline", "false", "--seed", str(SEED), "--deterministic", "true")
QUANT_EMBEDDER_YAML = ("model: unet_small2_yuv_quantizable\nunet_small2_yuv_quantizable:\n  z_channels: 16\n"
                       "  num_blocks: 8\n  z_channels_mults: [1, 2, 4, 8]\n  activation: relu\n"
                       "  normalization: batch\n  last_tanh: True\n")
EVAL_CELLS = {"identity": [0], "rotate": [10], "crop": [0.5]}  # held against the CPU (no perspective: no draws)


def _timing_medians(rows) -> dict:
    keys = ("wm_embed_time", "sync_embed_time", "sync_detect_time", "unwrap_time", "wm_detect_time")
    return {k: float(np.median([r[k] for r in rows])) for k in keys}


def phase_sync_training(device, workdir: str) -> dict:
    """Sync's training half and the watermark-through-sync evaluation.
    (a) ``python -m wmar_tpu_torch.train_syncseal`` (``train_syncseal.main``)
    at full width (UNet-small2-YUV + ConvNeXt-tiny, 256 px, batch 8, lr 1e-4,
    the pyramid perceptual loss, deterministic kernels): one epoch with an
    embedder.yaml that selects the quantizable UNet; 3 epochs straight (the
    2nd and 3rd detector-only), a copy of the run after 2 of them resumed to
    3 against them; one model step on the
    card against the CPU; the written ``syncmodel.msgpack`` through
    ``SyncSealRef.load``. (b) WAM from scratch at ``WAMConfig()``'s width
    (``examples/train_wam_sync``), its quadrant estimate and revert. (c)
    ``python -m wmar_tpu_torch.sync.eval_wm``: the 21 x 21 grid through (a)'s
    model on 8 synthetic 256 px images (``--baseline ss``), HiDDeN through
    WAM (``--tiny``, valuemetric identity) and ``ss`` without sync; three
    cells of the grid held against the CPU."""
    import math
    import os

    from wmar_tpu_torch import train_syncseal
    from wmar_tpu_torch.examples import train_wam_sync
    from wmar_tpu_torch.finetune.perceptual import PerceptualLoss
    from wmar_tpu_torch.augmentations.valuemetric import clip01
    from wmar_tpu_torch.sync import baselines, eval_wm
    from wmar_tpu_torch.sync import syncseal as tss

    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}}
    flags = [*SYNC_TRAIN_FLAGS, "--device", str(device)]
    run_a, run_b = os.path.join(workdir, "sync_train_a"), os.path.join(workdir, "sync_train_b")

    def train(outdir, epochs, *extra, on_epoch_end=None):
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = train_syncseal.main(["--output_dir", outdir, "--epochs", str(epochs), *flags, *extra],
                                  on_epoch_end=on_epoch_end)
        rows = res["log"]
        numbers = [v for r in rows for v in r.values() if isinstance(v, float)]
        numbers += [v for e in res["evals"].values() for row in e["grid"] for v in row.values()
                    if isinstance(v, float)] + [v for e in res["evals"].values() for v in e["quality"].values()]
        if not numbers or not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"sync training {outdir}: a logged number is not finite")
        res["seconds"] = time.perf_counter() - t0
        res["peak_gib"] = _peak_gib(device)
        return res

    # (a) the trainer: the quantizable UNet (the card's warm-up), 3 epochs straight, a copy of them after 2 resumed
    import shutil
    import warnings

    # the trainer's --deterministic also fixes cuBLAS's workspace, which slows the host-paced decode loops
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    nondet = set()  # ops the deterministic mode warns of: a reason for the resume gate to fail
    unets = {}  # the UNet after each epoch of the straight run

    def after(epoch):
        model = torch.load(os.path.join(run_b, "checkpoint.pt"), map_location="cpu", weights_only=True)["model"]
        unets[epoch] = {k: v for k, v in model.items() if k.startswith("embedder.")}
        if epoch == 1:  # the run as one stopped after 2 epochs leaves it
            shutil.copytree(run_b, run_a)

    try:
        quant_yaml = os.path.join(workdir, "embedder_quantizable.yaml")
        with open(quant_yaml, "w") as f:
            f.write(QUANT_EMBEDDER_YAML)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            quant = train(os.path.join(workdir, "sync_train_q"), 1, "--embedder_config", quant_yaml)
            straight = train(run_b, 3, on_epoch_end=after)
        nondet.update(str(w.message).split(",")[0] for w in caught if "deterministic" in str(w.message))
        if not all(torch.equal(v, unets[0][k]) for e in (1, 2) for k, v in unets[e].items()):
            raise AssertionError("sync training: the UNet moved in a detector-only epoch")
        third = train(run_a, 3)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:3]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[3]
    if quant["state"].model.unet_cfg.normalization != "batch":
        raise AssertionError("sync training: the quantizable embedder.yaml was not applied")
    ulps = _f32_ulps(4)
    resume_err = 0.0
    for part in ("model", "disc"):
        got, want = third["state"].state_dict()[part], straight["state"].state_dict()[part]
        for k, w in want.items():
            err = float((got[k].float() - w.float()).abs().max()) if w.numel() else 0.0
            if not err <= ulps(w):
                raise AssertionError(f"sync training: resumed {part}.{k} off the straight run by {err} (ops without "
                                     f"a deterministic kernel: {sorted(nondet)})")
            resume_err = max(resume_err, err)
    steps = int(flags[flags.index("--steps_per_epoch") + 1])
    batch = int(flags[flags.index("--batch_size") + 1])
    # the straight run's first epoch (the quantizable run's carries the warm-up)
    step_s = straight["log"][0]["secs"] / steps
    warm_s = quant["log"][0]["secs"] / steps
    det_s = float(np.median([r["secs"] for res in (third, straight) for r in res["log"]
                             if r["detector_only"]])) / steps

    # one model step, the card against the CPU (float32, TF32 off)
    imgs = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(SEED))
    draws = tss.sample_ref_draws(imgs.shape, torch.Generator().manual_seed(SEED + 1))
    grads, terms = {}, {}
    for dev in ("cpu", device):
        state = tss.init_ref_train_state(tss.SyncSealRef.init(SEED, device=dev), 1e-4, 24, seed=SEED)
        state.disc.requires_grad_(False)
        total, metrics = tss.ref_model_loss(state, imgs.to(dev), draws, 0.2, 1.0, False, tss.RefTrainConfig(),
                                            PerceptualLoss())
        total.backward()
        terms[str(dev)] = {k: float(v.detach()) for k, v in metrics.items()}
        grads[str(dev)] = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    cpu_terms, card_terms = terms["cpu"], terms[str(device)]
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    step_err = {"terms": max(abs(card_terms[k] - v) / max(abs(v), 1e-6) for k, v in cpu_terms.items()),
                "grads": max(float((grads[str(device)][k] - g).abs().max()) for k, g in grads["cpu"].items()) / gmax}
    if not (step_err["terms"] <= SYNC_CPU_TOL and step_err["grads"] <= SYNC_CPU_TOL):
        raise AssertionError(f"sync training: one model step, the card against the CPU: {step_err}")

    # the written model serves add_sync / remove_sync
    syncpath = os.path.join(run_a, "syncmodel.msgpack")
    served = tss.SyncSealRef.load(syncpath, device=device)
    x = torch.rand(8, 256, 256, 3, generator=torch.Generator().manual_seed(SEED)).to(device) * 2 - 1
    synced = served.add_sync(x)
    moved = _sync_bound("trained SyncSealRef", x, synced, 2 * served.cfg.scaling_w + 2 / 255)
    unsynced = served.remove_sync(synced)
    if not (unsynced.shape == x.shape and torch.isfinite(unsynced).all()):
        raise AssertionError("sync training: remove_sync of the trained model")
    out["train"] = {"step_s": step_s, "first_epoch_step_s": warm_s, "detector_only_step_s": det_s, "imgs_per_s": batch / step_s,
                    "peak_gib": max(r["peak_gib"] for r in (third, straight)), "quant_peak_gib": quant["peak_gib"],
                    "seconds": {k: r["seconds"] for k, r in (("quantizable", quant), ("straight", straight),
                                                               ("resumed", third))},
                    "resume_max_err": resume_err, "card_vs_cpu_step": step_err, "max_move": moved,
                    "nondeterministic_ops": sorted(nondet),
                    "eval_s": [e["secs"] for e in third["evals"].values()],
                    "log": third["log"], "eval": third["evals"]}
    print(f"sync training (a) train_syncseal UNet-small2-YUV + ConvNeXt-tiny, 256 px, "
          f"batch {batch}: {step_s:.4f} s a step ({batch / step_s:.2f} images/s; {warm_s:.4f} in the quantizable "
          f"UNet's epoch, the first), "
          f"detector-only {det_s:.4f} s, deterministic mode warned of {sorted(nondet) or 'no op'}, peak "
          f"{out['train']['peak_gib']} GiB (quantizable {quant['peak_gib']}); quantizable 1 epoch / 3 straight / "
          f"resumed from 2 to 3 {quant['seconds']:.1f} / {straight['seconds']:.1f} / {third['seconds']:.1f} s with "
          f"evals; UNet bit-equal over the detector-only epochs; resumed epoch 3 within {resume_err:.3e} of 3 straight "
          f"(4 ulps); one step card vs CPU {step_err}; "
          f"syncmodel.msgpack serves add_sync (moves <= {moved:.4f}) and remove_sync; epoch-2 eval corner_mae "
          f"{[round(r['corner_mae'], 4) for r in third['evals'][max(third['evals'])]['grid'][:4]]}")

    # (b) WAM from scratch at WAMConfig()'s width
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    wam = train_wam_sync.main(["--steps", "16", "--size", "256", "--batch", "8", "--hidden", "64", "--latent", "128",
                               "--device", str(device)])
    wam_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for row in wam["losses"] for v in row.values()):
        raise AssertionError("sync training (b): a WAM loss is not finite")
    if not (torch.isfinite(wam["reverted"]).all() and len(wam["aug_info"]) == 4):
        raise AssertionError("sync training (b): the quadrant estimate and revert")
    out["wam"] = {"seconds": wam_s, "train_s": wam["train_s"], "step_s": wam["train_s"] / len(wam["losses"]),
                  "loss": [wam["losses"][0]["loss"], wam["losses"][-1]["loss"]], "coverage": wam["coverage"],
                  "aug_info": [float(v) for v in wam["aug_info"]], "peak_gib": _peak_gib(device)}
    print(f"sync training (b) WAM from scratch (WAMConfig() width, 256 px, batch 8): "
          f"{len(wam['losses'])} steps, {out['wam']['step_s']:.4f} s a step, loss {out['wam']['loss'][0]:.4f} -> "
          f"{out['wam']['loss'][1]:.4f}; coverage after the rotation {wam['coverage']:.3f}, estimate "
          f"{out['wam']['aug_info']}, reverted; {wam_s:.1f} s")

    # (c) eval_wm: the full grid through the trained model, HiDDeN through WAM, ss without sync
    n_img, size = 8, 256
    common = ["--num_samples", str(n_img), "--img_size", str(size), "--seed", str(SEED), "--device", str(device)]
    evals = {}
    for label, argv, n_rows in (
            ("ss+syncseal", ["--baseline", "ss", "--sync_model", "syncseal", "--sync_path", syncpath], 441),
            ("hidden+wam", ["--baseline", "hidden", "--sync_model", "wam", "--tiny", "--only_identity", "true"], 21),
            ("ss+none", ["--baseline", "ss", "--sync_model", "none", "--only_identity", "true"], 21)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rows = eval_wm.main([*argv, *common, "--output_dir", os.path.join(workdir, f"eval_{label}")])
        seconds = time.perf_counter() - t0
        if len(rows) != n_rows:
            raise AssertionError(f"eval_wm {label}: {len(rows)} rows, not {n_rows}")
        for r in rows:
            vals = [r["bit_accuracy"], r["log_pvalue"]] + ([] if label == "ss+none" else [r["corner_error"]])
            if not all(math.isfinite(v) for v in vals) or (label == "ss+none" and not math.isnan(r["corner_error"])):
                raise AssertionError(f"eval_wm {label}: {r}")
        evals[label] = {"seconds": seconds, "rows": len(rows), "medians": _timing_medians(rows),
                        "mean_bit_accuracy": float(np.mean([r["bit_accuracy"] for r in rows])), "table": rows}
    plain = evals["ss+none"]["table"][0]
    # at 256 px a carrier's correlation is ~7 widths of the image's noise
    if (plain["geom_aug"], plain["val_aug"]) != ("identity_0", "identity_0") or plain["bit_accuracy"] < 0.99:
        raise AssertionError(f"eval_wm ss+none: the identity cell decodes at {plain['bit_accuracy']}")
    # three cells of the card's grid against the CPU. The sync embed ends in an 8-bit rounding whose ties the
    # card and the CPU break apart; each such pixel moves every ss score a little, and a random bit near zero
    # then decodes the other way (one bit of 384 did in a run). So that stage is held by its flips, and the
    # CPU's cells start from the card's synced images.
    imgs = eval_wm._synthetic_images(n_img, size, SEED)
    base = {d: baselines.build_baseline("ss", img_size=size, seed=SEED, device=d) for d in ("cpu", device)}
    msgs = base["cpu"].get_random_msg(torch.Generator().manual_seed(SEED), n_img)  # what the card's run drew
    syncs = {d: eval_wm.load_sync("syncseal", syncpath, device=d) for d in ("cpu", device)}
    synced = {}
    with torch.no_grad():
        for d in ("cpu", device):
            synced[d] = clip01(syncs[d].model.embed01(base[d].embed(imgs.to(d), msgs)["imgs_w"])).cpu()
    embed_gap = (synced[device] - synced["cpu"]).abs()
    embed_flips = int((embed_gap > 1e-4).sum())
    if embed_flips > 1e-3 * embed_gap.numel() or float(embed_gap.max()) > 2 / 255 + 1e-4:
        raise AssertionError(f"eval_wm: the sync embed on the card and the CPU differ at {embed_flips} values")
    syncs["cpu"].model.embed01 = lambda imgs_wm: synced[device]
    cpu_rows = eval_wm.evaluate_watermark_with_sync(base["cpu"], syncs["cpu"], imgs, os.path.join(workdir, "eval_cpu"),
                                                    only_identity=True, seed=SEED, geoms=EVAL_CELLS, msgs=msgs)
    card = {(r["geom_aug"], r["val_aug"]): r for r in evals["ss+syncseal"]["table"]}
    cell_err = {"log_pvalue": 0.0, "corner_error": 0.0}
    for r in cpu_rows:
        c = card[(r["geom_aug"], r["val_aug"])]
        if c["bit_accuracy"] != r["bit_accuracy"] or abs(c["log_pvalue"] - r["log_pvalue"]) > 1e-4 or \
                abs(c["corner_error"] - r["corner_error"]) > 1e-3:
            raise AssertionError(f"eval_wm: the card's cell {c} is not the CPU's {r}")
        for k in cell_err:
            cell_err[k] = max(cell_err[k], abs(c[k] - r[k]))
    for e in evals.values():
        del e["table"]
    out["eval_wm"] = {**evals, "cells_vs_cpu": cell_err, "sync_embed_flips_vs_cpu": embed_flips}
    for label, e in evals.items():
        print(f"sync training (c) eval_wm {label}: {e['rows']} rows in {e['seconds']:.2f} s, mean bit accuracy "
              f"{e['mean_bit_accuracy']:.4f}, per-cell medians (s) {json.dumps({k: round(v, 6) for k, v in e['medians'].items()})}")
    print(f"sync training (c): ss without sync decodes identity/identity at {plain['bit_accuracy']:.4f}; the sync "
          f"embed card vs CPU {embed_flips} rounding flips of {embed_gap.numel()}; cells {list(EVAL_CELLS)} x identity "
          f"from the card's synced images equal to the CPU's (log_pvalue within {cell_err['log_pvalue']:.2e}, corner "
          f"error within {cell_err['corner_error']:.2e} px)")
    return out


# ---------------------------------------------------------------------------
# Audio: Moshi-7B with the fused watermark, Mimi, the audio grid, detection
# ---------------------------------------------------------------------------

AUDIO_BATCH = 8
AUDIO_STEPS = 64  # wmar_audio_eval.py's default: 5.1 s of audio at 12.5 fps
AUDIO_FLAGS = ("--batch_size", str(AUDIO_BATCH), "--steps", str(AUDIO_STEPS), "--device", "cuda",
               "--mimi_compression", "--wm_method", "maryland", "--wm_delta", "4.0", "--wm_gamma", "0.25")
AUDIO_P_MAX = 1e-6  # Maryland p-value of every watermarked stream's own tokens
AUDIO_CONTROL_MEDIAN_P = 0.01  # the unwatermarked control's median p-value must lie above this


def moshi_decode_shape():
    """``(L, B, T, H, D)`` of the temporal decode attention of MOSHI_V01 at
    the audio phase's batch and frame count: a cache of ``n_frames +
    max_delay + 1`` slots."""
    from wmar_tpu_torch.audio.lm import MOSHI_V01

    tcfg = MOSHI_V01.temporal_cfg()
    return tcfg.n_layers, AUDIO_BATCH, MOSHI_V01.total_steps(AUDIO_STEPS) + 1, tcfg.n_heads, tcfg.head_dim


def _moshi_frame_profile(params, cfg, wm, frames: int = 8) -> dict:
    """Host and device time of the frame loop over ``frames`` frames on the
    packed4 cache: host ms a frame by the clock, device ms a frame from
    ``torch.profiler``'s CUDA kernel times (None if it recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    from wmar_tpu_torch.audio.lm import MoshiGen

    gen = MoshiGen(params, cfg, wm, cache_dtype="packed4")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(frames - cfg.total_steps(0), SEED, batch=AUDIO_BATCH)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        if device_us > 0 and str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, evt.count, device_us))
    kernels.sort(key=lambda k: -k[2])
    device_ms = sum(k[2] for k in kernels) / 1e3 / frames if kernels else None
    return {"frames": frames, "host_ms_per_frame_profiled": host_s * 1e3 / frames, "device_ms_per_frame": device_ms,
            "launches_per_frame": sum(k[1] for k in kernels) / frames if kernels else None,
            "top": [{"name": k[0][:80], "calls_per_frame": k[1] / frames, "device_ms_per_frame": k[2] / 1e3 / frames}
                    for k in kernels[:8]]}


def _stream_pvalues(audio, gamma: float, wm_seed: int = 0) -> np.ndarray:
    """Maryland p-value of every (row, audio stream) of generated tokens
    ``[B, K, T]``, scored with the fixed hash and first-occurrence dedup."""
    from wmar_tpu_torch.audio import wm as audio_wm

    audio = audio.cpu()
    hashes = audio_wm.window_hash(torch.zeros((audio.shape[2], 0), dtype=torch.int64), wm_seed)
    out = np.zeros(audio.shape[:2])
    for b in range(audio.shape[0]):
        for s in range(audio.shape[1]):
            ng, ns = audio_wm.score_stream_maryland(audio[b, s], hashes, gamma)
            out[b, s] = float(audio_wm.pvalue_maryland(ng, ns, gamma))
    return out


def phase_audio(device, workdir: str) -> dict:
    """The audio case study at full width: MOSHI_V01 with random bf16
    weights (7.7B parameters, drawn on the card) and a random MIMI_V0_1,
    batch 8, 64 frames, Maryland at the default streams (text + 8 audio),
    delta 4, gamma 0.25. (a) a generation on the packed cache (kernel #2);
    (b) the entry point's path, ``audio_eval.evaluate`` with the flags of
    ``python -m wmar_tpu_torch.audio_eval --cache_dtype packed4
    --mimi_compression``: generation on the packed4 cache (kernel #1), Mimi
    decode, the whole audio grid (MP3 where libmp3lame loads, the Mimi
    round trip), re-encode, scoring, results.json; (c) a ``--wm_method
    none`` control on the packed cache. Gates: exactly 32 layers x 65 loop
    frames launches of the cache's kernel in each generation and none of any
    other; every watermarked audio stream's own tokens at Maryland p <
    1e-6 in (a) and (b), the control's median p above 0.01; every record
    finite. Then host and device time of a frame (``torch.profiler``), and
    ``python -m wmar_tpu_torch.audio_eval --tiny`` once on the card."""
    from wmar_tpu_torch import audio_eval, bridge
    from wmar_tpu_torch.audio import lm as audio_lm
    from wmar_tpu_torch.audio import mimi as audio_mimi

    cfg = audio_lm.MOSHI_V01
    t0 = time.perf_counter()
    params = audio_lm.init_moshi_params(cfg, torch.Generator(device=device).manual_seed(SEED), dtype=torch.bfloat16,
                                        device=device)
    mimi = audio_mimi.init_mimi(audio_mimi.MIMI_V0_1, torch.Generator(device=device).manual_seed(SEED + 1),
                                device=device)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in bridge.flatten(params))
    build_s = time.perf_counter() - t0
    per_gen = cfg.temporal_cfg().n_layers * cfg.total_steps(AUDIO_STEPS)
    wm = audio_lm.WMConfig(method="maryland", streams=tuple(range(1 + cfg.n_audio_streams)), ngram=0, delta=4.0,
                           gamma=0.25, seed=0, temp=0.8, top_k=250)
    total = {name: 0 for name in launches()}

    def generation(label, cache, wm_cfg, seed):
        gen = audio_lm.MoshiGen(params, cfg, wm_cfg, cache_dtype=cache)
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        text, audio = gen.generate(AUDIO_STEPS, seed, batch=AUDIO_BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = launches()
        kernel = "packed4_decode_attention" if cache == "packed4" else "packed_decode_attention_q8"
        _check_launches(device, counts, {kernel: per_gen}, f"audio {label}")
        for k, n in counts.items():
            total[k] += n
        return text, audio, seconds

    runs = {}
    _, audio_a, runs["packed"] = generation("packed", "packed", wm, 42)
    t = time.perf_counter()
    codec_files = write_codec_files(device, workdir)
    files_s = time.perf_counter() - t
    args = audio_eval.get_parser().parse_args(["--output_dir", f"{workdir}/audio_eval", "--cache_dtype", "packed4",
                                               "--encodec_weight", codec_files["encodec"][1], "--dac_weight",
                                               codec_files["dac"][1], "--save_audio", *AUDIO_FLAGS])
    reset_launches()
    ev = audio_eval.evaluate(args, cfg, params, mimi)
    counts = launches()
    _check_launches(device, counts, {"packed4_decode_attention": per_gen}, "audio eval path")
    for k, n in counts.items():
        total[k] += n
    runs["packed4"] = ev["generate_s"]
    _, audio_c, runs["control"] = generation("control", "packed", None, 43)
    for label, audio in (("packed", audio_a), ("packed4", ev["audio"]), ("control", audio_c)):
        if tuple(audio.shape) != (AUDIO_BATCH, cfg.n_audio_streams, AUDIO_STEPS) or \
                not bool(((audio >= 0) & (audio < cfg.audio_vocab)).all()):
            raise AssertionError(f"audio {label}: tokens {tuple(audio.shape)} in [{audio.min()}, {audio.max()}]")
    p_a, p_b, p_c = (_stream_pvalues(a, 0.25) for a in (audio_a, ev["audio"], audio_c))
    if not (p_a.max() < AUDIO_P_MAX and p_b.max() < AUDIO_P_MAX):
        raise AssertionError(f"audio: watermarked streams' largest p-values {p_a.max()} / {p_b.max()} "
                             f"not below {AUDIO_P_MAX}")
    if not np.median(p_c) > AUDIO_CONTROL_MEDIAN_P:
        raise AssertionError(f"audio control: median p-value {np.median(p_c)} not above {AUDIO_CONTROL_MEDIAN_P}")
    records = ev["records"]
    n_cells = ev["cells"]
    if len(records) != n_cells * AUDIO_BATCH * cfg.n_audio_streams or ev["augs"][-2:] != ["encodec-compression",
                                                                                        "dac-compression"]:
        raise AssertionError(f"audio eval: {len(records)} records for {n_cells} cells of {ev['augs']}")
    wavs = sorted(n for n in os.listdir(f"{workdir}/audio_eval") if n.endswith(".wav"))
    if wavs != [f"gen_{b:03d}.wav" for b in range(AUDIO_BATCH)]:
        raise AssertionError(f"audio eval --save_audio wrote {wavs}")
    for r in records:
        vals = [r["token_match"], r["sisnr"], r["stoi"]] + ([r["pvalue"]] if r["pvalue"] is not None else [])
        if r["pvalue"] is None or not (np.isfinite(vals).all() and 0 <= r["pvalue"] <= 1):
            raise AssertionError(f"audio eval: record {r}")
    with open(f"{workdir}/audio_eval/results.json") as f:
        if len(json.load(f)) != len(records):
            raise AssertionError("audio eval: results.json differs from the records returned")
    mp3 = "mp3-compression" in ev["augs"]
    profile = _moshi_frame_profile(params, cfg, wm)
    frames = cfg.total_steps(AUDIO_STEPS)
    out = {"launches": total, "per_generation": per_gen, "build_s": build_s, "params": n_params,
           "generate_s": runs, "frames_per_s": {k: frames / v for k, v in runs.items()},
           "host_ms_per_frame": {k: v * 1e3 / frames for k, v in runs.items()}, "grid_s": ev["grid_s"],
           "records": len(records), "mp3": mp3, "max_p": {"packed": float(p_a.max()), "packed4": float(p_b.max())},
           "control_median_p": float(np.median(p_c)), "profile": profile,
           "median_identity_token_match": float(np.median([r["token_match"] for r in records
                                                           if r["aug"] == "identity"])),
           "cells": n_cells, "codec_files_s": files_s,
           "models": {"moshi": params, "mimi": mimi, **{k: m for k, (m, _) in codec_files.items()}}}
    t = time.perf_counter()
    tiny = audio_eval.main(["--tiny", "--output_dir", f"{workdir}/audio_eval_tiny"])
    if not tiny or not all(r["pvalue"] is None or 0 <= r["pvalue"] <= 1 for r in tiny):
        raise AssertionError(f"audio_eval --tiny on the card: {len(tiny)} records")
    out["tiny_cli_s"] = time.perf_counter() - t
    dev_ms = profile["device_ms_per_frame"]
    print(f"audio: MOSHI_V01 random bf16 ({n_params / 1e9:.2f}B parameters, built on the card in {build_s:.1f} s), "
          f"MIMI_V0_1 random, batch {AUDIO_BATCH}, {AUDIO_STEPS} frames ({frames} loop frames), Maryland delta 4 "
          f"gamma 0.25 on streams 0-8; generation s: " + ", ".join(f"{k} {v:.2f}" for k, v in runs.items())
          + "; frames/s: " + ", ".join(f"{k} {v:.2f}" for k, v in out["frames_per_s"].items())
          + f"; host ms a frame (packed4) {out['host_ms_per_frame']['packed4']:.2f}; device ms a frame (profiler, "
          f"packed4, {profile['frames']} frames) " + (f"{dev_ms:.3f}" if dev_ms is not None else "not measured")
          + (f", {profile['launches_per_frame']:.0f} launches a frame" if dev_ms is not None else "")
          + f"; kernel launches {total} ({per_gen} a generation); largest p-value of the watermarked streams "
          f"{out['max_p']}; control median p {out['control_median_p']:.3f}; grid + decode {ev['grid_s']:.1f} s, "
          f"{n_cells} cells with EnCodec and DAC (random files written in {files_s:.1f} s), {len(records)} records, "
          f"mp3 {'ran' if mp3 else 'did not run (libmp3lame did not load)'}; identity "
          f"token match median {out['median_identity_token_match']:.3f} (random Mimi); --tiny CLI on the card "
          f"{out['tiny_cli_s']:.1f} s, {len(tiny)} records")
    for k in profile["top"]:
        print(f"  {k['device_ms_per_frame']:8.3f} ms  {k['calls_per_frame']:7.1f} calls  {k['name']}")
    return out


def write_codec_files(device, workdir: str) -> dict:
    """Random EnCodec (``ENCODEC_24K``, 14.8M parameters) and DAC
    (``DAC_24K``, 76.6M) drawn on the card and written by the port's writers
    in the published layouts: HF's ``facebook/encodec_24khz`` (weight norm in
    torch's ``parametrizations`` naming) and descript's (``weight_g`` /
    ``weight_v``). ``{kind: (module, path)}``."""
    from wmar_tpu_torch.audio import codecs

    g = torch.Generator(device=device).manual_seed(SEED + 20)
    enc = codecs.random_codec(lambda: codecs.Encodec(codecs.ENCODEC_24K), g, device)
    dac = codecs.random_codec(lambda: codecs.DAC(codecs.DAC_24K), g, device)
    paths = {"encodec": f"{workdir}/encodec_24khz_random.pth", "dac": f"{workdir}/dac_24khz_random.pth"}
    torch.save(codecs.encodec_state_dict(enc, "hf", "parametrizations"), paths["encodec"])
    torch.save(codecs.dac_state_dict(dac, "weight_norm"), paths["dac"])
    return {"encodec": (enc, paths["encodec"]), "dac": (dac, paths["dac"])}


AUDIO_SYNC_ALPHA = "0.5"  # wmar_audio_eval.py's default --sync_alpha
AUDIO_CLIP = 24000  # (c): one 1 s clip at 24 kHz


def _events_ms(fn, x, reps: int = 3) -> float:
    """Median CUDA-event ms of ``fn(x)`` over ``reps`` calls after a warm-up."""
    with torch.no_grad():
        fn(x)
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_audio_sync(device, workdir: str, models: dict) -> dict:
    """The audio eval's sync and codec layer on the audio phase's models
    (MOSHI_V01 random bf16, MIMI_V0_1, the random EnCodec and DAC), with a
    random ``AUDIOSEAL_16B`` written as the two ``.pth`` files of the
    audioseal layout. (a) ``audio_eval.evaluate`` with ``--wm_sync
    --sync_generator_ckpt G --sync_detector_ckpt D --sync_alpha 0.5
    --eval_aug speed`` on the packed cache (kernel #2): exactly 32 x 65
    launches, every record's ``sync_score`` finite in [0, 1], the inverted
    rows and their (speed-up, shift) printed; (b) ``python -m
    wmar_tpu_torch.audio.eval_audioseal`` (``main``) over the 8 WAVs the
    audio phase saved, the whole grid: 8 CSV rows a cell, scores and TPRs in
    [0, 1]; (c) on a 1 s clip, AudioSeal's watermark and presence and the
    codecs' round trips on the card against CPU copies (TF32 off): within
    1e-3 of the output's scale, at most 1e-3 of the codes flipped, the
    decoders fed the CPU's codes; (d) CUDA-event ms at 8 x 5.12 s of
    ``get_watermark``, ``detect`` and each round trip, the host search's
    seconds a row, the phase's peak GiB."""
    import copy
    import csv

    from wmar_tpu_torch import audio_eval
    from wmar_tpu_torch.audio import audioseal, codecs, eval_audioseal
    from wmar_tpu_torch.audio import lm as audio_lm

    torch.cuda.reset_peak_memory_stats(device)
    cfg = audio_lm.MOSHI_V01
    g = torch.Generator(device=device).manual_seed(SEED + 21)
    seal = codecs.random_codec(lambda: audioseal.AudioSealModel(audioseal.AUDIOSEAL_16B), g, device)
    gpath, dpath = f"{workdir}/audioseal_wm_16bits_random.pth", f"{workdir}/audioseal_detector_16bits_random.pth"
    for sd, path in zip(audioseal.audioseal_state_dicts(seal), (gpath, dpath)):
        torch.save(sd, path)
    out = {}

    # (a) the sync watermark through the audio eval, on the packed cache
    args = audio_eval.get_parser().parse_args(
        ["--output_dir", f"{workdir}/audio_sync", "--cache_dtype", "packed", "--wm_sync", "--sync_generator_ckpt",
         gpath, "--sync_detector_ckpt", dpath, "--sync_alpha", AUDIO_SYNC_ALPHA, "--eval_aug", "speed",
         *AUDIO_FLAGS])
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:  # a line per inverted row
        ev = audio_eval.evaluate(args, cfg, models["moshi"], models["mimi"])
    out["eval_s"] = time.perf_counter() - t
    out["launches"] = counts = launches()
    per_gen = cfg.temporal_cfg().n_layers * cfg.total_steps(AUDIO_STEPS)
    _check_launches(device, counts, {"packed_decode_attention_q8": per_gen}, "audio sync eval")
    records, inverted = ev["records"], ev["sync_inverted"]
    if ev["augs"] != ["identity", "speed"] or len(records) != ev["cells"] * AUDIO_BATCH * cfg.n_audio_streams:
        raise AssertionError(f"audio sync eval: {len(records)} records of {ev['augs']}")
    for r in records:
        if not (np.isfinite(r["sync_score"]) and 0 <= r["sync_score"] <= 1 and 0 <= r["pvalue"] <= 1):
            raise AssertionError(f"audio sync eval: record {r}")
    if len(inverted) != sum(line.startswith("sync:") for line in log.getvalue().splitlines()):
        raise AssertionError("audio sync eval: the inverted rows and the printed ones differ")
    out.update(records=len(records), inverted=len(inverted), rows=ev["cells"] * AUDIO_BATCH,
               search_s_per_row=ev["sync_search_s"] / max(1, len(inverted)),
               sync_scores=sorted({round(r["sync_score"], 4) for r in records}))
    print(f"audio sync: evaluate --wm_sync --eval_aug speed on the packed cache in {out['eval_s']:.1f} s "
          f"(generation {ev['generate_s']:.1f} s, grid {ev['grid_s']:.1f} s), {len(records)} records; inverted "
          f"{len(inverted)} of {out['rows']} rows, host search {out['search_s_per_row']:.3f} s a row; (speed-up, "
          f"shift): {sorted({(round(v[3], 3), v[4]) for v in inverted})}; sync scores {out['sync_scores'][:8]}")

    # (b) eval_audioseal over the audio phase's 8 generated clips, the whole grid
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows, summary = eval_audioseal.main(
            ["--audio_dir", f"{workdir}/audio_eval", "--output_dir", f"{workdir}/audioseal_eval", "--generator_ckpt",
             gpath, "--detector_ckpt", dpath, "--batch_size", str(AUDIO_BATCH)])
    out["eval_audioseal_s"] = time.perf_counter() - t
    with open(f"{workdir}/audioseal_eval/audioseal_eval_results.csv") as f:
        csv_rows = list(csv.DictReader(f))
    cells = {(r["aug_name"], r["strength"]) for r in csv_rows}
    if not (len(csv_rows) == len(rows) == AUDIO_BATCH * len(cells) == AUDIO_BATCH * len(summary)
            and len(cells) in (40, 43)
            and all(0 <= float(r[k]) <= 1 for r in csv_rows for k in ("score_wm", "score_orig"))
            and all(0 <= v <= 1 for v in summary.values())):
        raise AssertionError(f"eval_audioseal: {len(csv_rows)} CSV rows, {len(cells)} cells, TPRs {summary}")
    out["eval_audioseal_cells"] = len(cells)
    print(f"audio sync: eval_audioseal over {AUDIO_BATCH} clips, {len(cells)} cells, {len(csv_rows)} rows in "
          f"{out['eval_audioseal_s']:.1f} s; TPR@1%FPR identity {summary['identity/0']:.3f}, median "
          f"{float(np.median(list(summary.values()))):.3f}")

    # (c) card against CPU on a 1 s clip
    x = torch.rand((1, AUDIO_CLIP, 1), generator=torch.Generator().manual_seed(SEED + 22)) * 1.6 - 0.8
    xd = x.to(device)
    errs = {}
    cpu_seal = copy.deepcopy(seal).cpu()
    errs["audioseal watermark"] = _codec_rel(seal.get_watermark(xd), cpu_seal.get_watermark(x))
    errs["audioseal presence"] = _codec_rel(seal.detect(xd), cpu_seal.detect(x))
    flips = {}
    with torch.no_grad():
        for kind in ("encodec", "dac"):
            model = models[kind]
            cpu = copy.deepcopy(model).cpu()
            codes_cpu = cpu.encode(x)
            flips[kind] = float((model.encode(xd).cpu() != codes_cpu).float().mean())
            errs[f"{kind} decode"] = _codec_rel(model.decode(codes_cpu.to(device)), cpu.decode(codes_cpu))
            if flips[kind] == 0:
                errs[f"{kind} round trip"] = _codec_rel(model(xd), cpu(x))
    if not (max(errs.values()) <= CODEC_REL_TOL and max(flips.values()) <= CODEC_FLIP_SHARE):
        raise AssertionError(f"audio sync: the card against the CPU {errs}, flipped codes {flips}")
    out.update(card_vs_cpu=errs, flipped=flips)
    print("audio sync: card against CPU on a 1 s clip: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; flipped codes {flips}")

    # (d) times at the eval's batch, 8 x 5.12 s
    xb = torch.rand((AUDIO_BATCH, AUDIO_STEPS * 1920, 1), generator=g, device=device) * 1.6 - 0.8
    out["ms"] = {"audioseal get_watermark": _events_ms(seal.get_watermark, xb),
                 "audioseal detect": _events_ms(seal.detect, xb),
                 "encodec round trip": _events_ms(models["encodec"], xb),
                 "dac round trip": _events_ms(models["dac"], xb)}
    out["peak_gib"] = _peak_gib(device)
    print(f"audio sync: ms at {AUDIO_BATCH} x {AUDIO_STEPS * 1920} samples (CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["ms"].items()) + f"; peak {out['peak_gib']:.2f} GiB")
    return out


# Mimi RCC finetune: the entry point's flags at full width (8 x 10 s clips)
MIMI_FT_FLAGS = ("--synthetic", "24", "--batch_size", "8", "--target_duration", "10.0", "--steps_per_epoch", "3",
                 "--warmup_epochs", "0", "--num_valid", "8", "--augmentation_start", "1", "--augs",
                 "{'identity': 1, 'noise_injection': 1, 'lowpass_filter': 1, 'smooth': 1, 'echo': 1}")
MIMI_FT_LR = 1e-5  # the entry point's default --learning_rate
MIMI_CLIP = 23040  # (e): 0.96 s, 12 Mimi frames
MIMI_LOSS_REL_TOL = 1e-4  # a loss on the card against the CPU's
MIMI_GRAD_REL_TOL = 1e-3  # a gradient tensor on the card against the CPU's, relative to its largest entry


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max()) for k in a)


def _adam_state(opt) -> list:
    """A copy of each parameter's Adam state (step, moments), in order."""
    return [{k: v.detach().clone() for k, v in opt.state[p].items()} for p in opt.param_groups[0]["params"]]


def _same_adam(got: list, want: list) -> bool:
    return len(got) == len(want) and all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                                         for a, b in zip(got, want))


def phase_mimi_rcc(device, workdir: str, models: dict) -> dict:
    """Audio's training half on phase 13's models (MOSHI_V01 random bf16,
    the random MIMI_V0_1): (a) the Mimi written as a Flax-layout
    ``.msgpack``; (b) the entry point ``python -m
    wmar_tpu_torch.finetune_mimi`` (``main``) at full width: ``--mimi_weights
    FILE`` and ``MIMI_FT_FLAGS`` (24 synthetic 10 s clips, 8 held out, batch
    8, 2 epochs of 3 steps, warmup 0, the augmenter of identity, noise,
    lowpass, smooth and echo from epoch 1) with ``--val_token_match subset``:
    every logged number finite, each ``idemp_k`` in [0, 1], both log lines
    with ``eval_token_match_*``, the four parts' epoch-1 deltas present and
    non-zero; seconds a step (``log.txt``'s synchronised ``train_s``), peak
    GiB; (c) the same run as 1 epoch, then resumed to 2 (evals off): the
    resumed run's loop draws (b)'s six batch-index sets (JAX's resumed
    epoch draws epoch 0's: fault (m)), its Adam state carries on from the
    checkpoint (the state its ``load_resume`` leaves is the first leg's
    final one, bit for bit: step counts 3 and both moments; at the end
    every step count is 6), and its weights lie within
    ``2 x sum |lr_b(k) - lr_c(k)| + 2 lr`` of (b)'s: the first leg's cosine
    spans its own 3 steps (the schedule follows ``--epochs``, as in JAX),
    so its updates run at other rates, and one more Adam step of ``lr`` a
    side where near-zero gradient entries take other signs (cuDNN's
    backward convolutions are not deterministic); (d)
    ``--finetune_encoder false``: the encoder parts' deltas exactly zero,
    the decoder's not; (e) one RCC step at full width on 2 x 0.96 s, TF32
    off, on the card and on a CPU copy, from the same perturbed trainable
    parts: loss within 1e-4, each ``idemp_k`` within one code, each
    gradient tensor within 1e-3 of its largest entry, the updated
    parameters within lr / 10 (Adam's first step moves each by about lr);
    (f) ``python -m
    wmar_tpu_torch.audio.token_match --mode mimi`` on 8 wavs of 4 s written
    by ``prompts.write_wav``, the original Mimi to encode and (b)'s
    finetuned one to decode and re-encode, the whole validation grid: 8
    rows a cell, every rate in [0, 1]; (g) ``--mode moshi`` on MOSHI_V01,
    64 steps, batch 8 (plain sampling, the float32 cache: the plain
    attention, as in JAX): tokens ``[8, 8, 64]``, 8 rows a cell. No kernel
    is launched. cuDNN TF32 follows the entry point's
    (``finetune.cli.set_precision``) in (b)-(d) and the script's switches
    are restored after."""
    import copy
    import csv

    from wmar_tpu_torch import bridge, finetune_mimi
    from wmar_tpu_torch.audio import finetune as mimi_ft
    from wmar_tpu_torch.audio import lm as audio_lm
    from wmar_tpu_torch.audio import token_match
    from wmar_tpu_torch.audio.augmentations import get_validation_augs
    from wmar_tpu_torch.audio.dataloader import train_valid_split
    from wmar_tpu_torch.audio.losses import get_audio_loss, get_code_loss
    from wmar_tpu_torch.audio.prompts import write_wav
    from wmar_tpu_torch.finetune import cli as ft_cli
    from wmar_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    mimi, moshi_cfg, out, times = models["mimi"], models.get("moshi_cfg", audio_lm.MOSHI_V01), {}, {}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    reset_launches()
    try:
        # (a) the weights
        t = time.perf_counter()
        path = f"{workdir}/mimi_v0_1_random.msgpack"
        save_pytree(path, {"params": bridge.mimi_tree(mimi)})
        times["write"] = time.perf_counter() - t

        # (b) train through the entry point
        def run(outdir, *flags):
            with contextlib.redirect_stdout(io.StringIO()):
                state = finetune_mimi.main(["--mimi_weights", path, "--device", str(device), *MIMI_FT_FLAGS, *flags,
                                            "--output_dir", outdir])
            with open(f"{outdir}/log.txt") as f:
                return state, [json.loads(line) for line in f]

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        state, logs = run(f"{workdir}/mimi_ft", "--epochs", "2", "--val_token_match", "subset")
        times["train"] = time.perf_counter() - t
        out["peak_gib"] = _peak_gib(device)
        straight = {k: v.detach().clone() for k, v in state.wrapper.trainable.state_dict().items()}
        tuned = bridge.mimi_tree(mimi)
        for part, module in state.wrapper.trainable.items():
            tuned[part] = bridge.mimi_tree(module)
        del state
        torch.cuda.empty_cache()
        if len(logs) != 2 or sum(any(k.startswith("eval_token_match_") for k in lg) for lg in logs) != 2:
            raise AssertionError(f"finetune_mimi: log.txt {[sorted(lg) for lg in logs]}")
        for lg in logs:
            if not all(np.isfinite(v) for v in lg.values()) or not all(
                    0.0 <= lg[k] <= 1.0 for k in lg if k.startswith(("idemp_", "eval_idemp_"))):
                raise AssertionError(f"finetune_mimi: log line {lg}")
        deltas = {}
        for part in mimi_ft.PARTS:
            delta = load_pytree(f"{workdir}/mimi_ft/epoch1_{part}_delta.msgpack")
            deltas[part] = max(float(v.abs().max()) for _, v in bridge.flatten(delta))
            if not deltas[part] > 0:
                raise AssertionError(f"finetune_mimi: the epoch-1 {part} delta is zero")
        out["s_per_step"] = [lg["train_s"] / lg["train_steps"] for lg in logs]
        out.update(logs=logs, max_delta=deltas)

        # (c) resumed: one epoch, then two; every batch-index draw of the loop recorded
        quiet = ("--val_token_match", "none", "--eval_freq", "1000")
        draws, real_rng = [], np.random.default_rng

        class Recorder:
            def __init__(self, *a, **k):
                self.g = real_rng(*a, **k)

            def choice(self, *a, **k):
                draws.append(self.g.choice(*a, **k))
                return draws[-1]

            def __getattr__(self, name):
                return getattr(self.g, name)

        t = time.perf_counter()
        state = run(f"{workdir}/mimi_ft_resume", "--epochs", "1", *quiet)[0]
        first_adam = _adam_state(state.optimizer)
        del state
        loaded, real_load = [], ft_cli.load_resume

        def recording_load(path, st):
            real_load(path, st)
            loaded.append(_adam_state(st.optimizer))

        np.random.default_rng, ft_cli.load_resume = Recorder, recording_load
        try:
            state, rlogs = run(f"{workdir}/mimi_ft_resume", "--epochs", "2", *quiet)
        finally:
            np.random.default_rng, ft_cli.load_resume = real_rng, real_load
        times["resume"] = time.perf_counter() - t
        out["resume_max_abs"] = _max_abs(state.wrapper.trainable.state_dict(), straight)
        adam_steps = sorted({float(a["step"]) for a in _adam_state(state.optimizer)})
        if not (len(loaded) == 1 and _same_adam(loaded[0], first_adam) and adam_steps == [6.0]
                and {float(a["step"]) for a in first_adam} == {3.0}):
            raise AssertionError(f"finetune_mimi resumed: {len(loaded)} loads, the loaded Adam state the first "
                                 f"leg's: {bool(loaded) and _same_adam(loaded[0], first_adam)}, step counts at "
                                 f"the end {adam_steps}")
        del loaded, first_adam
        # the first leg's cosine spans its 3 steps where (b)'s spans 6: the rates of its updates differ by
        sched = [mimi_ft.warmup_cosine_decay(0.0, MIMI_FT_LR, 1, n, MIMI_FT_LR * 1e-2) for n in (6, 3)]
        rate_gap = sum(abs(sched[0](k) - sched[1](k)) for k in range(3))
        bound = 2 * rate_gap + 2 * MIMI_FT_LR  # plus one flipped Adam step (cuDNN's backward is not deterministic)
        if state.step != 6 or len(rlogs) != 2 or out["resume_max_abs"] > bound:
            raise AssertionError(f"finetune_mimi resumed: step {state.step}, {len(rlogs)} log lines, weights "
                                 f"{out['resume_max_abs']:.3e} from the straight run's (bound {bound:.3e})")
        rng = real_rng(int(finetune_mimi.get_parser().get_default("seed")))
        tr_idx = train_valid_split(24, 8, int(finetune_mimi.get_parser().get_default("seed")))[0]
        want = [rng.choice(tr_idx, size=8, replace=False) for _ in range(6)]
        if len(draws) != 6 or not all(np.array_equal(a, b) for a, b in zip(draws, want)):
            raise AssertionError("finetune_mimi resumed: the loop's batch indices are not the straight run's")
        out["resume_bound"] = bound
        del state
        torch.cuda.empty_cache()

        # (d) the decoder alone
        t = time.perf_counter()
        run(f"{workdir}/mimi_ft_dec", "--epochs", "1", "--finetune_encoder", "false", *quiet)
        times["decoder_only"] = time.perf_counter() - t
        for part in mimi_ft.PARTS:
            top = max(float(v.abs().max()) for _, v in bridge.flatten(
                load_pytree(f"{workdir}/mimi_ft_dec/epoch0_{part}_delta.msgpack")))
            if (top == 0.0) != part.startswith("enc"):
                raise AssertionError(f"finetune_mimi --finetune_encoder false: the {part} delta's largest entry {top}")
        torch.cuda.empty_cache()

        # (e) one step on the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        t = time.perf_counter()
        x = torch.from_numpy(finetune_mimi.synthetic_clips(2, MIMI_CLIP, SEED + 30))
        gen = torch.Generator().manual_seed(SEED + 31)
        # the trainable parts moved off the frozen ones (at equal decoders the MR-STFT's L1 sits at its kink)
        noise = [torch.randn(p.shape, generator=gen) * 1e-3 for part in mimi_ft.PARTS
                 for p in getattr(mimi, part).parameters()]
        res = {}
        for name, model in (("card", mimi), ("cpu", copy.deepcopy(mimi).cpu())):
            wrapper = mimi_ft.MimiFTWrapper(model)
            with torch.no_grad():
                for p, z in zip(wrapper.trainable.parameters(), noise, strict=True):
                    p.add_(z.to(p.device))
            st = mimi_ft.init_state(wrapper, MIMI_FT_LR)
            metrics = mimi_ft.make_rcc_train_step(st, get_audio_loss("mrstft"), get_code_loss("mse"), 1e-3, 1.0)(
                x.to(next(model.parameters()).device))
            named = dict(wrapper.trainable.named_parameters())
            res[name] = ({k: float(v) for k, v in metrics.items()}, {k: p.grad.cpu() for k, p in named.items()},
                         {k: p.detach().cpu() for k, p in named.items()})
            del wrapper, st
        times["card_vs_cpu"] = time.perf_counter() - t
        (m_card, g_card, p_card), (m_cpu, g_cpu, p_cpu) = res["card"], res["cpu"]
        one_code = 1.0 / (2 * MIMI_CLIP // mimi.cfg.hop_length)
        errs = {"loss": abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"]),
                "idemp": max(abs(m_card[k] - m_cpu[k]) for k in m_cpu if k.startswith("idemp_")),
                "grad": max(float((g_card[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30)
                            for k in g_cpu),
                "params": _max_abs(p_card, p_cpu)}
        if not (errs["loss"] <= MIMI_LOSS_REL_TOL and errs["idemp"] <= one_code + 1e-9
                and errs["grad"] <= MIMI_GRAD_REL_TOL and errs["params"] <= MIMI_FT_LR / 10):
            raise AssertionError(f"Mimi RCC step, card against CPU: {errs}")
        out["card_vs_cpu"] = errs
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

        # (f) token match, mimi mode: the original Mimi encodes, the finetuned one decodes and re-encodes
        t = time.perf_counter()
        wavs = f"{workdir}/tm_wavs"
        os.makedirs(wavs, exist_ok=True)
        clips = finetune_mimi.synthetic_clips(AUDIO_BATCH, 4 * 24000, SEED + 32)
        for i in range(AUDIO_BATCH):
            write_wav(f"{wavs}/clip{i:02d}.wav", clips[i, :, 0], 24000)
        tuned_path = f"{workdir}/mimi_v0_1_tuned.msgpack"
        save_pytree(tuned_path, {"params": tuned})
        cells = sum(len(p) for _, _, p in get_validation_augs())
        with contextlib.redirect_stdout(io.StringIO()):
            rows = token_match.main(["--mode", "mimi", "--audio_dir", wavs, "--output_dir", f"{workdir}/tm_mimi",
                                     "--mimi_weight", tuned_path, "--mimi_weight_ori", path, "--batch_size",
                                     str(AUDIO_BATCH), "--save_audio", "0", "--device", str(device)])
        times["token_match_mimi"] = time.perf_counter() - t
        with open(f"{workdir}/tm_mimi/token_match_results.csv") as f:
            csv_rows = list(csv.DictReader(f))
        if not (len(rows) == len(csv_rows) == AUDIO_BATCH * cells
                and all(0.0 <= r[k] <= 1.0 for r in rows for k in r if k.startswith("tm_rate"))):
            raise AssertionError(f"token_match mimi: {len(rows)} rows for {cells} cells")
        identity = [r["tm_rate"] for r in rows if r["aug"] == "identity"]

        # (g) token match, moshi mode on MOSHI_V01
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            mrows = token_match.main(["--mode", "moshi", "--output_dir", f"{workdir}/tm_moshi", "--steps",
                                      str(AUDIO_STEPS), "--batch_size", str(AUDIO_BATCH), "--save_audio", "0",
                                      "--save_tokens", "1", "--device", str(device)],
                                     models={"moshi": (moshi_cfg, models["moshi"]), "mimi": mimi})
        times["token_match_moshi"] = time.perf_counter() - t
        tokens = np.load(f"{workdir}/tm_moshi/identity_0_000.npz")["original"]
        k = moshi_cfg.n_audio_streams
        if not (tokens.shape == (k, AUDIO_STEPS) and len(mrows) == AUDIO_BATCH * cells
                and sorted({r["global_index"] for r in mrows}) == list(range(AUDIO_BATCH))
                and all(f"tm_rate_{k - 1}" in r and 0.0 <= r["tm_rate"] <= 1.0 for r in mrows)):
            raise AssertionError(f"token_match moshi: tokens {tokens.shape}, {len(mrows)} rows for {cells} cells")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    out["launches"] = counts = launches()
    if any(counts.values()):
        raise AssertionError(f"Mimi RCC and token match launched kernels: {counts}")
    out.update(times=times, cells=cells, token_match_rows={"mimi": len(rows), "moshi": len(mrows)},
               identity_tm=float(np.median(identity)))
    print(f"Mimi RCC: finetune_mimi at MIMI_V0_1, batch 8 x 10 s, s a step (synchronised) "
          + ", ".join(f"epoch {e} {v:.3f}" for e, v in enumerate(out["s_per_step"]))
          + f"; peak {out['peak_gib']:.2f} GiB; epoch losses {[round(lg['loss'], 6) for lg in logs]}, eval "
          f"idemp_0 {[round(lg['eval_idemp_0'], 4) for lg in logs]}, eval token match (identity) "
          f"{[round(lg['eval_token_match_identity_0'], 4) for lg in logs]}; resumed run {out['resume_max_abs']:.3e} "
          f"from the straight one (bound {bound:.3e}), its batches the straight run's, its Adam state the "
          f"checkpoint's; card against CPU: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; token match mimi {len(rows)} rows ({cells} cells, identity median {out['identity_tm']:.3f}), moshi "
          f"{len(mrows)} rows, tokens [{AUDIO_BATCH}, {k}, {AUDIO_STEPS}]; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return out


# RCC finetune: (label, --model, tokenizer file, flags of the run)
RCC_RUNS = (("Taming", "taming", "vqgan.msgpack", ("--disc_init", "random")),
            ("MaskGit", "rar", "maskgit_vqgan.msgpack", ("--disable_gan",)))
RCC_FLAGS = ("--lr", "1e-4", "--idempotence_loss_weight", "1.0", "--nb_epochs", "4", "--augs_schedule", "1,1,1,1",
             "--log_every", "2")  # configs/taming_ft.json's rates; every level and validation cell in four epochs


def _leaves_close(label, got, want, tol_of) -> float:
    """Max |got - want| over the leaves of two Flax trees, each within
    ``tol_of(want leaf)``."""
    from wmar_tpu_torch import bridge

    worst = 0.0
    g, w = dict(bridge.flatten(got)), dict(bridge.flatten(want))
    if set(g) != set(w):
        raise AssertionError(f"{label}: trees differ: {sorted(set(g) ^ set(w))[:5]}")
    for k, want_t in w.items():
        err = float((g[k].float().cpu() - want_t.float().cpu()).abs().max()) if want_t.numel() else 0.0
        if not err <= tol_of(want_t):
            raise AssertionError(f"{label}: {k} off by {err} (tolerance {tol_of(want_t)})")
        worst = max(worst, err)
    return worst


def _f32_ulps(n: int):
    return lambda w: n * torch.finfo(torch.float32).eps * max(float(w.float().abs().max()), 1e-30)


def phase_rcc_finetune(device, workdir: str, tiny: bool = False, rows: int = 72, batch: int = 8,
                       bench_batches=(4, 8), bench_iters: int = 10, runs=RCC_RUNS) -> dict:
    """RCC finetuning through the entry point ``python -m
    wmar_tpu_torch.finetune`` (``finetune.cli.main``), for each of
    ``runs`` (of ``RCC_RUNS``): the tokenizer of the wrapper ``generate.load_wrapper``
    builds (seed ``SEED``, full size: Taming-1.4B's f16 VQGAN, RAR-XL's
    MaskGit-VQGAN, bf16) written in float32 as ``<modelpath>/<file>``, then
    four epochs (warmup, weak, medium, strong) on ``rows`` synthetic code
    rows at batch ``batch``, validation first in each epoch and a final one;
    Taming with a random discriminator (the GAN branch), MaskGit without.
    Gates: every logged loss and validation number finite; the final
    Identity idem loss below epoch 0's; epoch 3's delta files re-applied to
    the base equal ``epoch3_trainable.msgpack`` within 4 float32 ulps of a
    leaf's largest weight. Then ``tools/bench_rcc.py``'s train step at the
    Taming geometry, level ``strong``, each of ``bench_batches``. Returns
    the numbers, and for the attack sweep the Taming base tree and epoch 3's
    delta paths. ``tiny`` runs the CLI's tiny models on the CPU. The phase
    runs at the entry point's precision (``finetune.cli.set_precision``:
    cuDNN convolutions may use TF32, matmuls not) and then puts back the
    script's (TF32 off) for the phases after it."""
    from wmar_tpu_torch.finetune.cli import set_precision

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)  # the context exists before the peak-memory resets
    saved = set_precision()
    try:
        return _rcc_runs(device, workdir, tiny, rows, batch, bench_batches, bench_iters, cuda, runs)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _rcc_runs(device, workdir, tiny, rows, batch, bench_batches, bench_iters, cuda, runs) -> dict:
    import math
    import os
    from argparse import Namespace

    from wmar_tpu_torch import bridge
    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.finetune import cli as ft
    from wmar_tpu_torch.tools import bench_rcc
    from wmar_tpu_torch.utils import checkpoint as ckpt

    print(f"RCC finetune: tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    out = {"launches": {name: 0 for name, _, _, _ in _kernels()}, "runs": {},
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32}}
    for label, model, fname, flags in runs:
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        gargs = tgen.get_parser().parse_args(["--model", model, "--seed", str(SEED), "--outdir", workdir,
                                              *(["--tiny"] if tiny else [])])
        wrapper = tgen.load_wrapper(gargs, torch.device(device))
        vq_cls, vq_cfg = type(wrapper.vq), wrapper.vq.cfg
        base = _as_f32_cpu(bridge.flax_tree(wrapper.vq))  # bf16 -> float32 is exact
        del wrapper
        modelpath = os.path.join(workdir, model)
        ckpt.save_pytree(os.path.join(modelpath, fname), base)
        outdir = os.path.join(workdir, f"finetune_{model}")
        argv = ["--model", model, "--device", str(device), "--synthetic", str(rows), "--batch_size_per_device",
                str(batch), *RCC_FLAGS, *flags, "--outdir", outdir]
        if cuda:
            torch.cuda.empty_cache()
        if tiny:  # the CLI's --tiny draws its own tokenizer: hand it the one written above
            adapter_cls = ft.tokenizer_spec(model, False)[2]
            state = ft.main(argv, adapter=adapter_cls(bridge.load_flax_file(vq_cls, vq_cfg, os.path.join(modelpath, fname),
                                                                             device)))
        else:
            state = ft.main([*argv, "--modelpath", modelpath])
        steps = state.step
        del state
        with open(os.path.join(outdir, "history.json")) as f:
            hist = json.load(f)["epochs"]
        numbers = [v for e in hist for m in e["metrics"] for v in m.values()]
        numbers += [v for e in hist for cell in e["validation"].values() for v in cell.values()]
        if not numbers or not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"RCC finetune [{label}]: a logged number is not finite")
        ident = [e["validation"]["Identity_0"] for e in (hist[0], hist[-1])]
        if not ident[1]["idem_loss"] < ident[0]["idem_loss"]:
            raise AssertionError(f"RCC finetune [{label}]: Identity idem loss {ident[0]['idem_loss']} at epoch 0, "
                                 f"{ident[1]['idem_loss']} at the end")
        trained = ckpt.load_pytree(os.path.join(outdir, "epoch3_trainable.msgpack"))
        deltas = {part: os.path.join(outdir, f"epoch3_{part}_delta.msgpack") for part in ("encoder", "decoder")}
        delta_err = max(_leaves_close(f"RCC finetune [{label}] epoch 3 {part}",
                                      ckpt.load_and_apply_delta(deltas[part], base[part]),
                                      trained["watermark_encoder" if part == "encoder" else "decoder"], _f32_ulps(4))
                        for part in ("encoder", "decoder"))
        epochs = [e for e in hist if "train_s" in e]
        step_s = sum(e["train_s"] for e in epochs) / sum(e["train_steps"] for e in epochs)
        per_level = {e["level"]: e["train_steps"] * batch / e["train_s"] for e in epochs}
        peak = _peak_gib(device)
        run = {"seconds": time.perf_counter() - t0, "steps": steps, "step_s": step_s, "imgs_per_s": per_level,
               "identity_idem": [ident[0]["idem_loss"], ident[1]["idem_loss"]],
               "identity_l0": [ident[0]["l0"], ident[1]["l0"]], "delta_max_err": delta_err, "peak_gib": peak,
               "gan": "vqgan_gan_loss" in hist[0]["metrics"][0], "deltas": deltas, "base": base}
        out["runs"][label] = run
        print(f"RCC finetune [{label}]: {vq_cfg.resolution} px tokenizer, {rows} synthetic rows, batch {batch}, "
              f"{steps} steps over warmup/weak/medium/strong, GAN {'on' if run['gan'] else 'off'}: "
              f"{step_s:.4f} s a train step; imgs/s per level {json.dumps({k: round(v, 3) for k, v in per_level.items()})}; "
              f"Identity idem {ident[0]['idem_loss']:.5f} -> {ident[1]['idem_loss']:.5f}, L0 {ident[0]['l0']:.4f} -> "
              f"{ident[1]['l0']:.4f}; epoch-3 deltas re-applied within {delta_err:.3e} of the trainable; peak "
              f"{peak:.2f} GiB; {run['seconds']:.1f} s with the tokenizer file")
        if cuda:
            torch.cuda.empty_cache()
    adapter = ft.build_adapter(Namespace(model="taming", tiny=False, modelpath=os.path.join(workdir, "taming")),
                               torch.device(device)) if not tiny else bench_rcc.taming_adapter(device, tiny=True)
    out["bench"] = []
    for b in bench_batches:
        r = bench_rcc.bench(adapter, b, "strong", bench_iters)
        out["bench"].append(r)
        print(f"RCC finetune [bench_rcc]: Taming {'tiny' if tiny else 'f16 256 px'}, level strong, batch {b}: "
              f"{r['imgs_per_s']:.3f} imgs/s, {r['step_ms']:.2f} ms a step, peak "
              f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 2)} GiB")
    del adapter
    if cuda:
        torch.cuda.empty_cache()
    return out


def _as_f32_cpu(tree):
    return {k: _as_f32_cpu(v) if isinstance(v, dict) else v.float().cpu() for k, v in tree.items()}


def check_tuned_tokenizer(rcc: dict):
    """``inspect`` for the sweep: the Taming wrapper's tokenizer is the base
    plus epoch 3's deltas, within bf16 rounding of each weight."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.utils import checkpoint as ckpt

    run = rcc["runs"]["Taming"]

    def inspect(label, wrapper):
        if label != "Taming-1.4B":
            return
        for part, mod in (("encoder", wrapper.vq.encoder), ("decoder", wrapper.vq.decoder)):
            want = ckpt.apply_delta(run["base"][part], ckpt.load_pytree(run["deltas"][part]))
            want = {k: v.to(mod.conv_in.weight.dtype) for k, v in bridge.flatten(want)}
            bf16 = lambda w: 2.0**-8 * max(float(w.float().abs().max()), 1e-30)  # noqa: E731
            run[f"generate_{part}_err"] = _leaves_close(f"generate with the RCC deltas, {part}",
                                                        dict(bridge.flatten(bridge.flax_tree(mod))), want, bf16)
        print(f"attack sweep [{label}]: tokenizer = base + epoch-3 RCC deltas within "
              f"{max(run['generate_encoder_err'], run['generate_decoder_err']):.3e} (bf16 rounding)")

    return inspect


# ---------------------------------------------------------------------------
# DiffPure through the entry point, and FID
# ---------------------------------------------------------------------------

DIFFPURE_STEPS = (0.01, 0.05, 0.1, 0.2, 0.3)
DIFFPURE_CALLS = sum(max(1, int(s * 1000)) for s in DIFFPURE_STEPS)  # 10 + 50 + 100 + 200 + 300 = 660 a batch
DIFFPURE_CLASSES = 1  # 2 planned; 1 for the script's time (660 UNet calls a batch, ~30 ms each at 1, ~47 at 2)
# card (TF32 off) against the CPU, relative to the output's largest value, as the codecs' bound
DIFFPURE_REL_TOL = 1e-3
FID_REL_TOL = 1e-3  # pool3 features, card (TF32 off) against the CPU, relative to the largest feature
FID_SELF_REL = 1e-5  # FID(dir, its own statistics) against 2 Tr(sigma): the matrix root's rounding


def random_adm_unet(cfg, device, seed: int):
    """An ``ADMUNet`` of ``cfg`` on ``device`` with every weight drawn from
    a generator on the device, the layers that guided-diffusion and Flax
    start at zero included (each ResBlock's ``conv2``, the attention's
    ``proj``, ``conv_out``; with them at zero the output is exactly 0):
    weights N(0, 1/fan_in), which keeps the activations bounded, GroupNorm
    scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    from wmar_tpu_torch.augmentations.diffpure import ADMUNet

    with torch.device("meta"):
        model = ADMUNet(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1, generator=gen)
    return model.eval()


def write_adm_files(model, cfg, workdir: str) -> tuple:
    """``model``'s weights as ``adm_random.pt`` (guided-diffusion's layout,
    what ``256x256_diffusion_uncond.pt`` holds) and ``adm_random.msgpack``
    (the converted Flax tree, as the JAX package writes it)."""
    import os

    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.augmentations import diffpure as tdp
    from wmar_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    tree = {"params": _np_tree(bridge.adm_unet_tree(model))}
    pt, mp = os.path.join(workdir, "adm_random.pt"), os.path.join(workdir, "adm_random.msgpack")
    t1 = time.perf_counter()
    torch.save({k: torch.from_numpy(v) for k, v in tdp.to_guided_diffusion(tree, cfg).items()}, pt)
    t2 = time.perf_counter()
    ckpt.save_pytree(mp, tree)
    print(f"DiffPure: weights to the host {t1 - t0:.1f} s, adm_random.pt {t2 - t1:.1f} s, adm_random.msgpack "
          f"{time.perf_counter() - t2:.1f} s")
    return pt, mp


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.float().cpu().numpy() for k, v in tree.items()}


def _call_ms(fn, batch: int, size: int, reps: int = 3) -> float:
    """CUDA-event ms of one ``fn(x, t)`` (a UNet forward) at ``batch`` x
    ``size`` px, the mean over ``reps`` calls after a warm-up."""
    x = torch.randn((batch, 3, size, size), generator=torch.Generator(device="cuda").manual_seed(SEED + 16),
                    device="cuda")
    t = torch.full((batch,), 500, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        fn(x, t)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x, t)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _unet_launches(unet, batch: int, size: int):
    """CUDA kernels one UNet call launches (``torch.profiler``; None if it
    recorded no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros((batch, 3, size, size), device="cuda")
    t = torch.full((batch,), 500, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        unet(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            unet(x, t)
            torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return n or None


def phase_diffpure(device, workdir: str, tiny: bool = False, time_batches=(1, 2, 8), check_size: int = 64,
                   chain_steps: float = 0.002) -> dict:
    """DiffPure through the entry point at the entry point's precision
    (cuDNN TF32 on, matmuls float32: PyTorch's defaults, restored after).
    A random ADM UNet of ``GUIDED_DIFFUSION_256_UNCOND`` (552.8M parameters)
    is written as ``adm_random.pt`` in guided-diffusion's layout and as
    ``adm_random.msgpack``; then ``generate.main`` runs RAR-XL with int8
    weights, the packed4 cache (kernel #1), ``DIFFPURE_CLASSES`` classes in
    one batch, the 62-cell grid and ``--include_diffpure true
    --diffpure_weights adm_random.pt``. Gates: 62 + 5 cells and their
    records and files (``_sweep_checks``); the five diffpure cells' images
    finite, in [0, 1], different from the input and from each other;
    exactly ``DIFFPURE_CALLS`` UNet calls; kernel #1's exact launches; the
    analyzer's "Adversarial Purification" column. Then: ms a UNet call at
    each of ``time_batches`` (CUDA events), launches a call
    (``torch.profiler``), seconds a cell, peak GiB; the ``.msgpack`` route's
    UNet equal bit for bit; with TF32 off, one UNet call and a
    ``chain_steps`` chain at ``check_size`` px, fed the same noise, within
    ``DIFFPURE_REL_TOL`` of a CPU copy. ``tiny`` runs the CLI's tiny RAR on
    the CPU (the caller patches the ADM config). The tree stays in
    ``workdir/diffpure`` for the FID phase."""
    from wmar_tpu_torch.finetune.cli import set_precision

    saved = set_precision()
    try:
        return _diffpure_run(device, workdir, tiny, time_batches, check_size, chain_steps)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _diffpure_run(device, workdir, tiny, time_batches, check_size, chain_steps) -> dict:
    import copy
    import os

    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.augmentations import diffpure as tdp
    from wmar_tpu_torch.eval import analyzer, pipeline

    cuda = torch.device(device).type == "cuda"
    cfg = tdp.GUIDED_DIFFUSION_256_UNCOND
    print(f"DiffPure: tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = random_adm_unet(cfg, device, SEED + 15)
    n_params = sum(p.numel() for p in model.parameters())
    pt, mp = write_adm_files(model, cfg, workdir)
    del model
    files_s = time.perf_counter() - t0
    seen = {"logs": [], "purifiers": [], "cells": [], "load_s": 0.0}
    fill, load, purifier_cls, load_adm = pipeline.fill_batch_log, tgen.load_wrapper, tdp.DiffPure, tdp.load_adm_weights

    class Timed(purifier_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["purifiers"].append(self)

        def __call__(self, imgs01, steps_override=None, generator=None, noise=None):
            if cuda:
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = super().__call__(imgs01, steps_override, generator=generator, noise=noise)
            if cuda:
                torch.cuda.synchronize(device)
            seen["cells"].append((steps_override, time.perf_counter() - t))
            return out

    def load_kept(args, dev):
        seen["wrapper"] = load(args, dev)
        return seen["wrapper"]

    def load_adm_timed(*a, **k):
        t = time.perf_counter()
        unet = load_adm(*a, **k)
        seen["load_s"] += time.perf_counter() - t
        return unet

    def fill_kept(*a, **k):
        seen["logs"].append(fill(*a, **k))
        return seen["logs"][-1]

    outdir = os.path.join(workdir, "diffpure")
    where = ["--tiny", "--device", "cpu"] if tiny else []
    argv = ["--model", "rar", *where, "--weight_dtype", "int8", "--cache_dtype", "packed4", "--conditioning",
            ",".join(str(c) for c in range(DIFFPURE_CLASSES)), "--batch_size", str(DIFFPURE_CLASSES),
            "--max_roundtrips", "1", "--seed", str(SEED), "--include_diffpure", "true", "--diffpure_weights", pt,
            "--outdir", outdir]
    tgen.load_wrapper, pipeline.fill_batch_log, tdp.DiffPure, tdp.load_adm_weights = (load_kept, fill_kept, Timed,
                                                                                      load_adm_timed)
    printed = _Tee(sys.stdout)
    try:
        reset_launches()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            records = tgen.main(argv)
        run_s = time.perf_counter() - t1
        counts = launches()
    finally:
        tgen.load_wrapper, pipeline.fill_batch_log, tdp.DiffPure, tdp.load_adm_weights = (load, fill, purifier_cls,
                                                                                          load_adm)
    wrapper = seen.pop("wrapper")
    want = {"packed4_decode_attention": (wrapper.rar_cfg.image_seq_len - 1) * wrapper.rar_cfg.depth}
    _check_launches(device, counts, want, "DiffPure")
    log = seen["logs"][0]
    gates = _sweep_checks("DiffPure", wrapper, log, records, outdir, DIFFPURE_CLASSES, diffpure=True)
    (purifier,) = seen["purifiers"]
    if purifier.unet_calls != DIFFPURE_CALLS:
        raise AssertionError(f"DiffPure: {purifier.unet_calls} UNet calls a batch, not {DIFFPURE_CALLS}")
    orig = log["roundtrips"][0][2]
    cells = [imgs for _, _, imgs in log["diffpure"]]
    if [p for p, _, _ in log["diffpure"]] != list(DIFFPURE_STEPS) or len(seen["cells"]) != len(DIFFPURE_STEPS):
        raise AssertionError(f"DiffPure: cells {[p for p, _, _ in log['diffpure']]}, {len(seen['cells'])} calls")
    moved = [float(np.abs(c - orig).max()) for c in cells]
    apart = min(float(np.abs(a - b).max()) for i, a in enumerate(cells) for b in cells[i + 1:])
    if not (all(np.isfinite(c).all() and c.min() >= -1 and c.max() <= 1 for c in cells) and min(moved) > 1e-3
            and apart > 1e-3):
        raise AssertionError(f"DiffPure: cells moved the input by {moved}, differ by at least {apart}")
    table = analyzer.robustness_table(analyzer.load_records(outdir, cache=False))
    if "diffpure" not in table["per_attack"] or "Adversarial Purification" not in analyzer.markdown_table(table):
        raise AssertionError(f"DiffPure: the analyzer's table {table}")
    print(analyzer.markdown_table(table))
    out = {"launches": counts, "params": n_params, "files_s": files_s, "run_s": run_s, "pt_load_s": seen["load_s"],
           "unet_calls": purifier.unet_calls,
           "cell_s": {str(s): sec for s, sec in seen["cells"]}, "table": table, "moved": moved, "apart": apart,
           "outdir": outdir, **gates}
    sample_s = re.findall(r"sampling took ([\d.]+)s", printed.getvalue())
    out["sample_s"] = float(sample_s[0]) if sample_s else None
    unet = purifier.unet
    size = orig.shape[1]
    t1 = time.perf_counter()
    out["ms_per_call"] = {b: _call_ms(unet, b, size) for b in time_batches} if cuda else {}
    # the purifier's own forwards: replayed from its CUDA graph of the run's shape
    out["graph_ms_per_call"] = {DIFFPURE_CLASSES: _call_ms(purifier._eps, DIFFPURE_CLASSES, size)} if cuda else {}
    out["launches_per_call"] = _unet_launches(unet, time_batches[0], size) if cuda else None
    out["peak_gib"] = _peak_gib(device)
    out["timing_s"] = time.perf_counter() - t1
    # the .msgpack route: the same weights, the same bits
    x = torch.rand((1, 3, size, size), generator=torch.Generator().manual_seed(SEED + 17)).to(device) * 2 - 1
    t = torch.full((1,), 321, dtype=torch.int32, device=device)
    t1 = time.perf_counter()
    other = tdp.load_adm_weights(mp, cfg, device)
    out["msgpack_load_s"] = time.perf_counter() - t1
    with torch.inference_mode():
        if not torch.equal(other(x, t), unet(x, t)):
            raise AssertionError("DiffPure: the .msgpack route's UNet differs from the .pt route's")
    del other
    # card against the CPU, float32
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    cpu = copy.deepcopy(unet).cpu()
    gen = torch.Generator().manual_seed(SEED + 18)
    xc = torch.rand((1, check_size, check_size, 3), generator=gen)
    tc = torch.full((1,), 500, dtype=torch.int32)
    with torch.inference_mode():
        want_out = cpu(xc.permute(0, 3, 1, 2) * 2 - 1, tc)
        got_out = unet(xc.permute(0, 3, 1, 2).to(device) * 2 - 1, tc.to(device))
    out["unet_err"] = _codec_rel(got_out, want_out)
    t_star = max(1, int(chain_steps * cfg.diffusion_steps))
    noise = torch.randn((t_star, *xc.shape), generator=gen)
    want_chain = tdp.DiffPure(cpu)(xc, chain_steps, noise=noise)
    got_chain = tdp.DiffPure(unet)(xc.to(device), chain_steps, noise=noise)
    out["chain_err"] = _codec_rel(got_chain, want_chain)
    out["unet_scale"] = float(want_out.abs().max())
    out["cpu_check_s"] = time.perf_counter() - t1
    if not (out["unet_err"] <= DIFFPURE_REL_TOL and out["chain_err"] <= DIFFPURE_REL_TOL):
        raise AssertionError(f"DiffPure: the card against the CPU: UNet {out['unet_err']}, chain {out['chain_err']}")
    del cpu, purifier, unet
    print(f"DiffPure: ADM UNet {n_params / 1e6:.1f}M parameters, files written in {files_s:.1f} s; generate "
          f"{' '.join(argv[:-2])}: {gates['records']} records, files {gates['files']}, run {run_s:.1f} s (sampling "
          f"{out['sample_s']} s); {out['unet_calls']} UNet calls; seconds a cell "
          f"{json.dumps({k: round(v, 3) for k, v in out['cell_s'].items()})}; ms a UNet call at {size} px "
          f"{json.dumps({b: round(v, 3) for b, v in out['ms_per_call'].items()})} eager, "
          f"{json.dumps({b: round(v, 3) for b, v in out['graph_ms_per_call'].items()})} from the CUDA graph; launches a call "
          f"{out['launches_per_call']}; peak {out['peak_gib']:.2f} GiB; kernel launches "
          f"{dict((k, v) for k, v in counts.items() if v)}, expected {want}; seconds: .pt read and built "
          f"{out['pt_load_s']:.1f}, timing {out['timing_s']:.1f}, .msgpack read and built {out['msgpack_load_s']:.1f}, "
          f"CPU check {out['cpu_check_s']:.1f}; cells moved the input by "
          f"{min(moved):.3f}-{max(moved):.3f}, differ by >= {apart:.3f}; .msgpack route bit-equal; card against "
          f"CPU at {check_size} px (TF32 off): UNet {out['unet_err']:.2e} of {out['unet_scale']:.3g}, "
          f"{t_star}-step chain {out['chain_err']:.2e}")
    return out


def random_inception_file(path: str, seed: int, div: int = 1) -> None:
    """Random FID-Inception weights in torchvision's layout at ``path``:
    convolutions N(0, 2/fan_in), BatchNorm weights and variances U(0.8,
    1.2) (positive), biases and means U(-0.1, 0.1)."""
    from wmar_tpu_torch.eval import fid

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, s in fid.inception_state_dict_shapes(div).items():
        if k.endswith("conv.weight"):
            sd[k] = torch.randn(s, generator=gen) * (2.0 / float(np.prod(s[1:]))) ** 0.5
        elif k.endswith(("running_var", "bn.weight")):
            sd[k] = torch.rand(s, generator=gen) * 0.4 + 0.8
        else:
            sd[k] = torch.rand(s, generator=gen) * 0.2 - 0.1
    torch.save(sd, path)


def synthetic_images(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` smooth ``size`` px images in [0, 1] that differ from one another
    (colour ramps and a blob each)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        a, b, c = rng.uniform(-1, 1, (3, 3, 1, 1)).astype(np.float32)
        cy, cx, r = rng.uniform(0.2, 0.8, 3)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (0.05 + 0.2 * r))
        out[i] = np.clip(0.5 + 0.25 * (a * xx + b * yy + c * blob), 0, 1).transpose(1, 2, 0)
    return out


def phase_fid(device, workdir: str, image_dir: str, div: int = 1, n_synth: int = 64, synth_size: int = 512,
              batch: int = 32, check_images: int = 4, min_images: int = 64) -> dict:
    """The FID CLI (``python -m wmar_tpu_torch.eval.fid``) on the card with
    random FID-Inception weights at ``div`` of the published widths
    (``inception_fid.pth``, torchvision's layout), TF32 off: ``image_dir``
    (the DiffPure phase's tree, every PNG) against ``n_synth`` synthetic
    ``synth_size`` px PNGs, so the resize shrinks there; then
    ``--save_stats`` of ``image_dir`` and that ``.npz`` against
    ``image_dir`` itself. Gates: the FID finite and >= 0; FID(dir, its own
    statistics) within ``FID_SELF_REL`` of 2 Tr(sigma) of 0; the ``.npz``
    equal to the statistics computed here; ``min_images`` or more images a
    directory; pool3 features of
    ``check_images`` images of each directory on the card within
    ``FID_REL_TOL`` of a CPU copy. Prints images/s (feature extraction,
    the PNGs already read)."""
    import os

    from PIL import Image

    from wmar_tpu_torch.augmentations.neural import read_state_dict
    from wmar_tpu_torch.eval import fid

    cuda = torch.device(device).type == "cuda"
    weights = os.path.join(workdir, "inception_fid.pth")
    random_inception_file(weights, SEED + 19, div)
    synth_dir = os.path.join(workdir, "fid_synthetic")
    os.makedirs(synth_dir, exist_ok=True)
    for i, img in enumerate(synthetic_images(n_synth, synth_size, SEED + 20)):
        Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(os.path.join(synth_dir, f"{i:03}.png"),
                                                                 compress_level=1)
    stats = os.path.join(workdir, "fid_stats.npz")
    base = ["--weights", weights, "--device", str(device), "--batch_size", str(batch)]
    printed = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        for argv in ([image_dir, synth_dir], [image_dir, synth_dir, "--save_stats", stats], [stats, image_dir]):
            if fid.main([*argv, *base]) != 0:
                raise AssertionError(f"FID: the CLI on {argv} failed")
    cli_s = time.perf_counter() - t0
    values = [float(v) for v in re.findall(r"FID: (-?[\d.]+)", printed.getvalue())]
    model = fid.FIDInceptionV3.from_state_dict(read_state_dict(weights), device)
    imgs = {"dir": fid._load_images(image_dir), "synthetic": fid._load_images(synth_dir)}
    rates = {}
    for name, x in imgs.items():
        fid.compute_activations(model, x[:batch], batch)
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        acts = fid.compute_activations(model, x, batch)
        if cuda:
            torch.cuda.synchronize(device)
        rates[name] = len(x) / (time.perf_counter() - t)
        if name == "dir":
            mu, sigma = acts.mean(axis=0), np.cov(acts, rowvar=False)
    z = np.load(stats)
    stats_err = max(_codec_rel(torch.from_numpy(z["mu"]), torch.from_numpy(mu)),
                    _codec_rel(torch.from_numpy(z["sigma"]), torch.from_numpy(sigma)))
    self_bound = FID_SELF_REL * 2 * float(np.trace(sigma)) + 1e-4  # + the print's rounding
    cpu = fid.FIDInceptionV3.from_state_dict(read_state_dict(weights), "cpu")
    feat_err = max(_codec_rel(torch.from_numpy(fid.compute_activations(model, x[:check_images], batch)),
                              torch.from_numpy(fid.compute_activations(cpu, x[:check_images], batch)))
                   for x in imgs.values())
    out = {"fid": values[0] if values else None, "fid_self": values[1] if len(values) > 1 else None,
           "self_bound": self_bound, "stats_err": stats_err, "features_err": feat_err, "imgs_per_s": rates,
           "cli_s": cli_s, "images": {k: tuple(v.shape) for k, v in imgs.items()},
           "params": sum(p.numel() for p in model.parameters())}
    if not (len(values) == 2 and np.isfinite(values[0]) and values[0] >= 0 and abs(values[1]) <= self_bound
            and stats_err <= 1e-5 and feat_err <= FID_REL_TOL and min(len(x) for x in imgs.values()) >= min_images):
        raise AssertionError(f"FID: {out}")
    print(f"FID: Inception {out['params'] / 1e6:.2f}M parameters; {len(imgs['dir'])} images of {image_dir} "
          f"({imgs['dir'].shape[1]} px) against {n_synth} synthetic {synth_size} px: FID {values[0]:.4f}; FID against "
          f"its own saved statistics {values[1]:.4f} (bound {self_bound:.2e}); the .npz within {stats_err:.1e} of "
          f"the statistics; three CLI runs {cli_s:.1f} s; images/s "
          f"{json.dumps({k: round(v, 1) for k, v in rates.items()})} at batch {batch}; features card against CPU "
          f"{feat_err:.2e} (TF32 off)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from wmar_tpu_torch.tools import bench_attention

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    phases = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        print(f"phase {name}: {phases[name]:.1f} s")
        return out

    timed("build", phase_build)
    numbers = {"packed4_decode_attention": timed("kernel #1", phase_kernels, device)}
    numbers.update(timed("kernels #2-#4", phase_packed_kernels, device))
    for label, shape, lens, seed, layouts in (
            ("Taming-1.4B", TAMING_DECODE_SHAPE, (1, 2, 129, 257), SEED + 2, False),
            ("Moshi-7B temporal", moshi_decode_shape(), (1, 2, 33, 65, 66), SEED + 7, True)):
        for name, res in timed(f"kernels #1, #2 at {label}", short_cache_attention, device, label, shape, lens, seed,
                               layouts).items():
            numbers[name]["max_abs_err"] = max(numbers[name]["max_abs_err"], res["max_abs_err"])
            numbers[name].setdefault("shapes", []).append(res)
    numbers["matmul_w4"] = timed("kernel #8", phase_w4, device)
    errs = timed("kernels #5, #6", phase_flash_kernels, device)
    errs.update(timed("kernels #7, #9", phase_probes, device))
    torch.cuda.empty_cache()
    micro = timed("microbench", phase_microbench, device)
    for name, err in errs.items():
        numbers[name] = {**micro[name], "max_abs_err": err}
    torch.cuda.empty_cache()
    paths = [{"launches": micro["launches"]}, timed("RAR path", lambda: phase_main_path(device, build_rar(device)))]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as files:
        chameleon, files_report = timed("Chameleon files", build_chameleon_from_files, device, files)
        run = first_layers(chameleon, CHAMELEON_RUN_LAYERS)
        paths.append(timed("Chameleon path", phase_chameleon, device, run))
        paths.append(timed("interleaved path", phase_interleaved, device, run))
        paths.append(timed("interleaved sampler, 4096 slots", phase_interleaved_4k, device, run))
    del chameleon, run
    torch.cuda.empty_cache()
    paths.append(timed("Taming path", lambda: phase_taming(device, build_taming(device))))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        # the script's time: past ~1,100 s on slow hosts, the MaskGit run (~5 s) goes, then half the
        # sweep's RAR-XL classes (~25 s); the CPU tests run both tokenizers and any class count
        rcc = timed("RCC finetune", lambda: phase_rcc_finetune(device, workdir, runs=RCC_RUNS[:1]))
        paths.append(rcc)
        tuned = [f"--{part}_ft_ckpt={rcc['runs']['Taming']['deltas'][part]}" for part in ("encoder", "decoder")]
        paths.append(timed("attack sweep", lambda: phase_attack_sweep(device, n_rar=8, taming_extra=tuned,
                                                                      inspect=check_tuned_tokenizer(rcc),
                                                                      neural_compress=True)))
        timed("neural codecs", phase_neural_codecs, device, paths[-1].pop("bank"))
        torch.cuda.empty_cache()
        paths.append(timed("sync", phase_sync, device, workdir))
        torch.cuda.empty_cache()
        paths.append(timed("sync training", phase_sync_training, device, workdir))
        torch.cuda.empty_cache()
        paths.append(timed("audio", phase_audio, device, workdir))
        audio_models = paths[-1].pop("models")
        paths.append(timed("audio sync and codecs", phase_audio_sync, device, workdir, audio_models))
        torch.cuda.empty_cache()
        paths.append(timed("Mimi RCC and token match", phase_mimi_rcc, device, workdir, audio_models))
        del audio_models
        torch.cuda.empty_cache()
        paths.append(timed("DiffPure", phase_diffpure, device, workdir))
        torch.cuda.empty_cache()
        timed("FID", phase_fid, device, workdir, paths[-1]["outdir"])
    counts = {name: sum(p["launches"][name] for p in paths) for name, _, _, _ in _kernels()}
    never = [name for name, n in counts.items() if n == 0]
    if never:
        raise AssertionError(f"kernels never launched on a main path: {never}")
    print(f"card: {bench_attention.card_line()}; phases {json.dumps({k: round(v, 1) for k, v in phases.items()})}; "
          f"total {time.perf_counter() - t0:.1f} s; Chameleon files: seconds "
          f"{json.dumps({k: round(v, 1) for k, v in files_report['seconds'].items()})}, bytes "
          f"{json.dumps(files_report['files'])}, host RSS in the conversions (GiB) "
          f"{json.dumps(files_report['convert_rss_gib'])}, the process's peak {files_report['peak_rss_gib']:.1f} GiB")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": counts[name],
        "max_abs_err": numbers[name]["max_abs_err"],
        "ms": numbers[name]["ms"],
        "graph_ms": numbers[name].get("graph_ms"),
        "plain_ms": numbers[name]["plain_ms"],
        "bound_ms": numbers[name]["bound_ms"],
        "bound_by": numbers[name]["bound_by"],
        "library_ms": numbers[name]["library_ms"],
        "library_graph_ms": numbers[name].get("library_graph_ms"),
        **({"shapes": numbers[name]["shapes"]} if "shapes" in numbers[name] else {}),
    } for name, _, source, replaces in _kernels()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
