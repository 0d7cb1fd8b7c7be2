"""Watermarked generation + evaluation on a CUDA card (PyTorch port of
``generate.py`` for ``--model taming``, ``--model rar`` and ``--model
chameleon7b``).

    python -m wmar_tpu_torch.generate --model taming \\
        --weight_dtype int4 --cache_dtype packed4 --conditioning 0,1,2 \\
        --top_k 250 --top_p 0.92 --batch_size 3 --outdir out/
    python -m wmar_tpu_torch.generate --model rar --tiny --device cpu \\
        --conditioning 0,1 --num_samples_per_conditioning 2 --batch_size 4 \\
        --cache_dtype packed4 --exact_jpeg true --outdir out/
    python -m wmar_tpu_torch.generate --model chameleon7b --no_augs \\
        --weight_dtype int8 --cache_dtype packed4 --conditioning prompts.txt \\
        --batch_size 8 --outdir out/

    python -m wmar_tpu_torch.generate --model chameleon7b \\
        --weight_dtype int8 --interleaved assets/interleaved_prompts.txt \\
        --outdir out/

Each sample is decoded, round-tripped through the tokenizer and attacked
with the reference's 62 classic (attack, param) cells, and every version
is re-tokenized and scored, as ``generate.py`` does; ``--no_augs`` keeps
the round trips only, ``--exact_jpeg true`` takes PIL's JPEG instead of the
device one. ``--include_neural_compress true`` adds the reference's 22
neural codecs (the compressai zoo, three KL-VAEs, DC-AE; one
"neural-compress" cell each, its records tagged with the codec's ``bpp``)
from ``--nc_weights_dir``; their published weights are not in the
repository, so without them the bank is refused unless ``--nc_allow_random
true`` builds random codecs at the published widths (rows tagged
``random_weights``). ``--include_diffpure true --diffpure_weights FILE``
adds DiffPure's five cells (steps 0.01 to 0.3) with the ADM UNet at
``GUIDED_DIFFUSION_256_UNCOND``'s width, on ``--device``: FILE is
``256x256_diffusion_uncond.pt`` (``.pt``/``.pth``, guided-diffusion's
layout) or a converted ``.msgpack``; without a file the run is refused, as
in JAX. ``--wm_torch_compat true`` draws the reference's greenlists bit
for bit from a table; ``--wm_seed_strategy fixed --wm_split_strategy
clustering`` takes the clustering split. ``--tiny`` models have 128 codes
(the JAX CLI's have 64), all alive, so both of these run on them too.
``--sync true --syncpath <file>`` adds a geometric sync signal to the
decoded images and removes it before every re-tokenize; the file name picks
the model as in JAX ("wam" -> WAM, a "sync" ``.pt``/``.pth``/``.safetensors``
-> the released SyncSeal, another "sync" file -> the Flax SyncSeal's
msgpack), and ``--sync true`` without a file is refused.

``--conditioning`` is a comma-separated list of class ids, or the path of a
file with one prompt per line (Chameleon). ``--interleaved <prompts file>``
(Chameleon) writes interleaved text and image output per prompt instead:
one decode loop over one KV cache shared by the three CFG rows. The cache
holds the prompt and the generation budget, so from ``--max_images 2`` on
(2244 tokens at full size) it has 2048 slots or more and a bf16 or int8
cache is read by the flash-decode kernels; with one image (about 1,160
slots) the plain attention runs.

The flags keep ``generate.py``'s names. ``--device`` (default ``cuda``)
names the device outright: without a CUDA card the default fails rather
than moving to the CPU, and the tests pass ``--device cpu``.

Multi-GPU runs take one process a rank, launched by ``torchrun`` or SLURM,
NCCL with one card a rank (``cuda:LOCAL_RANK``)::

    torchrun --nproc_per_node 2 -m wmar_tpu_torch.generate --model rar \
        --weight_dtype int8 --cache_dtype packed4 --conditioning 0,1,2 --dp 2 --outdir out/
    torchrun --nproc_per_node 2 -m wmar_tpu_torch.generate --model chameleon7b \
        --weight_dtype int8 --cache_dtype packed4 --conditioning prompts.txt --tp 2 --outdir out/
    torchrun --nproc_per_node 2 -m wmar_tpu_torch.generate --model chameleon7b \
        --weight_dtype int4 --cache_dtype packed4 --conditioning prompts.txt --tp 2 --outdir out/
    torchrun --nproc_per_node 4 -m wmar_tpu_torch.generate --model chameleon7b \
        --weight_dtype int8 --conditioning prompts.txt --sp 2 --tp 2 --outdir out/
    torchrun --nproc_per_node 2 -m wmar_tpu_torch.generate --model chameleon7b \
        --weight_dtype int8 --conditioning prompts.txt --pp 2 --outdir out/

``--dp N`` shards each batch's rows over N ranks (``--dp 0``: the world
size over ``--tp x --sp x --pp``; integer conditionings only) and gives the
codes, and so the records, of ``--dp 1``: every rank draws the whole
batch's noise and keeps its rows. ``--tp N`` (chameleon7b) runs the Llama as
Megatron shards over N ranks, each with a cache of its heads; with
``--weight_dtype int4`` kernel #8 runs on each rank's slices of the grouped
weights. ``--sp N`` runs the prompt's prefill as ring attention over N
ranks, ``--pp N`` as a GPipe pipeline of N stages; the decode after it runs
on every rank. Both compose with ``--dp`` and ``--tp``, not with each other.
The ranks' packed caches run the unchanged decode kernels on their rows and
heads. Rank 0 decodes, attacks and scores the gathered codes and alone
writes files. A process group that is up already (``torch.distributed``) is
used as it is. ``--interleaved`` takes none of the multi-rank flags.
Without ``--tiny`` or ``--modelpath`` the model runs at its published widths
with random weights drawn from ``--seed``. For Taming that means the 1.4B
cin_transformer (48 layers, width 1664) and the f16 ImageNet VQGAN; for
Chameleon CHAMELEON_7B with the synthetic full-size vocabulary (8192 image
codes in a 65536-entry table) and a synthetic tokenizer, as the JAX bench
runs it. ``--weight_dtype int8|int4`` quantizes the generator's linears for
every model; int4 linears run the w4a16 kernel.

``--modelpath`` reads the files that ``python -m
wmar_tpu_torch.tools.convert_ckpt`` (or the JAX tool) writes, flax msgpack,
through the port's own reader: ``config.json``'s meta (``gpt`` geometry,
``alive_ids``), then ``maskgit_vqgan.msgpack`` and ``<rar_size>.msgpack``
(``rar``), ``vqgan.msgpack`` and ``gpt.msgpack`` (``taming``), or
``llama7b.msgpack``, ``vqgan.msgpack`` and ``tokenizer/text_tokenizer.json``
(``chameleon7b``: the vocabulary, and the prompts' ids from the port's BPE
reader; a directory without the JSON is refused). RAR and Taming keep the
files' dtype, Chameleon's Llama is cast to bf16; the tokenizer is float32;
the KV cache takes the wrapper's default dtype (bf16 for RAR and Chameleon,
float32 for Taming), as in JAX, whatever the files hold.
``--encoder_ft_ckpt`` / ``--decoder_ft_ckpt`` add RCC deltas (as
``python -m wmar_tpu_torch.finetune`` writes them) to the tokenizer's
encoder / decoder, in float32, cast back to its dtype, whatever built the
wrapper (``--tiny``, random or ``--modelpath``); the JAX CLI's ``--tiny``
branch returns before its delta block and ignores them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from wmar_tpu_torch import bridge

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--model", type=str, choices=["taming", "rar", "chameleon7b"], default="taming")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--modelpath", type=str, default=None)
    p.add_argument("--rar_size", type=str, default="rar_xl", choices=["rar_b", "rar_l", "rar_xl", "rar_xxl"])
    p.add_argument("--encoder_ft_ckpt", type=str, default=None)
    p.add_argument("--decoder_ft_ckpt", type=str, default=None)
    p.add_argument("--tiny", action="store_true", help="random tiny model (smoke test)")
    p.add_argument("--cache_dtype", type=str, default=None, choices=["bf16", "f32", "int8", "packed", "packed4"],
                   help="KV cache; packed and packed4 are read by the hand-written CUDA decode-attention kernels")
    p.add_argument("--weight_dtype", type=str, default=None, choices=["int8", "int4"],
                   help="weight-only int8, or grouped int4 (the w4a16 kernel), for the generator's linears")
    p.add_argument("--num_samples_per_conditioning", type=int, default=1)
    p.add_argument("--conditioning", type=str, default="0",
                   help="comma-separated class ids, or a file of prompts, one per line")
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--top_k", type=int, default=600)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=0.92)
    p.add_argument("--guidance_scale", type=float, default=4.0)
    p.add_argument("--chunk_id", type=int, default=0)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--dp", type=int, default=1,
                   help="shard each batch over this many ranks (0: the world size over --tp x --sp x --pp); the "
                        "codes of --dp 1; integer conditionings only")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (chameleon7b: Megatron sharding of the Llama, any --weight_dtype; "
                        "composes with --dp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks for the prompt's prefill (chameleon7b: ring attention over an sp "
                        "axis, parallel/ring.py; composes with --dp/--tp); the codes of --sp 1")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel ranks for the prompt's prefill (chameleon7b: GPipe over a pp axis, "
                        "parallel/pipeline.py; composes with --dp/--tp); the codes of --pp 1")
    p.add_argument("--orig_only", type=str2bool, default=False)
    p.add_argument("--include_neural_compress", type=str2bool, default=False)
    p.add_argument("--nc_weights_dir", type=str, default=None)
    p.add_argument("--nc_allow_random", type=str2bool, default=False)
    p.add_argument("--include_diffpure", type=str2bool, default=False)
    p.add_argument("--diffpure_weights", type=str, default=None)
    p.add_argument("--max_roundtrips", type=int, default=1)
    p.add_argument("--exact_jpeg", type=str2bool, default=False)
    p.add_argument("--wm_method", type=str, default="gentime", choices=["none", "gentime"])
    p.add_argument("--wm_seed_strategy", type=str, default="linear", choices=["fixed", "linear", "spatial"])
    p.add_argument("--wm_split_strategy", type=str, default="stratifiedrand",
                   choices=["rand", "stratifiedrand", "clustering"])
    p.add_argument("--wm_context_size", type=int, default=1)
    p.add_argument("--wm_delta", type=float, default=2.0)
    p.add_argument("--wm_gamma", type=float, default=0.25)
    p.add_argument("--wm_torch_compat", type=str2bool, default=False)
    p.add_argument("--sync", type=str2bool, default=False)
    p.add_argument("--syncpath", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_augs", action="store_true")
    p.add_argument("--interleaved", type=str, default=None,
                   help="prompts file (e.g. assets/interleaved_prompts.txt): interleaved text and image "
                        "output per prompt instead of text-to-image (chameleon7b only)")
    p.add_argument("--max_images", type=int, default=1, help="max image segments per interleaved generation")
    p.add_argument("--text_gen_len", type=int, default=64, help="max tokens per interleaved text segment")
    return p


def run_interleaved(args, wrapper, apply_wm: bool):
    """Interleaved text and image generation over a prompts file, through
    the fused one-loop sampler. Per prompt, writes ``p=<idx>,idx=<s>/``:
    ``prompt.txt``, ``seg<k>_text.{txt,npy}`` for text segments and
    ``seg<k>_img.{png,npy,json}`` for image segments; the json carries the
    watermark p-values of the raw generated codes and of the re-tokenized
    (decode -> encode round trip) codes."""
    import json


    from wmar_tpu_torch.core.detect import detect
    from wmar_tpu_torch.eval.pipeline import to_pillow
    from wmar_tpu_torch.models import GenParams
    from wmar_tpu_torch.models.chameleon_interleaved import TextGenOptions, sample_interleaved_fused

    if not hasattr(wrapper, "llama_params"):
        raise SystemExit("--interleaved is the chameleon7b path")
    with open(args.interleaved) as f:
        prompts = [ln.strip() for ln in f if ln.strip()]
    prompts = prompts[args.chunk_id::args.num_chunks]
    text_opts = TextGenOptions(max_gen_len=args.text_gen_len, temp=args.temperature, top_p=args.top_p)
    gen = GenParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                    guidance_scale=args.guidance_scale, guidance_scale_pow=0.0)
    records = []
    for pi, prompt in enumerate(prompts):
        for si in range(args.num_samples_per_conditioning):
            generator = torch.Generator(device=wrapper.device).manual_seed(args.seed * 1000003 + pi * 131071 + si)
            segs = sample_interleaved_fused(wrapper, prompt, gen, text_opts=text_opts, max_images=args.max_images,
                                            apply_watermark=apply_wm, generator=generator)
            d = os.path.join(args.outdir, f"p={pi},idx={si}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "prompt.txt"), "w") as f:
                f.write(prompt + "\n")
            for k, (kind, toks) in enumerate(segs):
                if kind == "text_seg":
                    np.save(os.path.join(d, f"seg{k}_text.npy"), toks)
                    with open(os.path.join(d, f"seg{k}_text.txt"), "w") as f:
                        f.write(" ".join(str(t) for t in toks[0]) + "\n")
                    continue
                if toks.shape[1] != wrapper.image_seq_len:
                    # the generation budget ran out inside the image: not decodable
                    print(f"skipping truncated image segment {k} ({toks.shape[1]}/{wrapper.image_seq_len} tokens)")
                    continue
                codes = torch.as_tensor(toks, device=wrapper.device)
                imgs = wrapper.codes_to_images(codes)
                to_pillow(imgs[0].float().cpu().numpy()).save(os.path.join(d, f"seg{k}_img.png"))
                np.save(os.path.join(d, f"seg{k}_img.npy"), toks)
                rec = {"prompt": prompt, "segment": k}
                if apply_wm:
                    recodes = wrapper.images_to_codes(imgs).reshape(codes.shape[0], -1)
                    rec["pvalue_raw"] = float(detect(wrapper.watermark_spec, wrapper.greenlist, codes)[0])
                    rec["pvalue_roundtrip"] = float(detect(wrapper.watermark_spec, wrapper.greenlist, recodes)[0])
                with open(os.path.join(d, f"seg{k}_img.json"), "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
    print(f"wrote {len(records)} interleaved image segments to {args.outdir}")
    return records


def _refuse(args) -> None:
    """Exit, before anything is built, on flags that do not go together.
    Two are JAX's faults, which the port does not copy: ``--interleaved``
    with a multi-rank flag (JAX runs the interleaved path before its mesh
    block and ignores them) and ``--sp`` with ``--pp`` (JAX's prefill takes
    the pipeline and drops the ring)."""
    from wmar_tpu_torch.models.chameleon import SP_WITH_PP, TP_INTERLEAVED

    if args.interleaved and _multi_rank(args):
        raise SystemExit(TP_INTERLEAVED)
    if args.sp > 1 and args.pp > 1:
        raise SystemExit(SP_WITH_PP)
    if args.model != "chameleon7b":
        if args.tp > 1:
            raise SystemExit("--tp > 1 is the chameleon7b TP path")
        if args.sp > 1 or args.pp > 1:
            raise SystemExit("--sp/--pp > 1 is the chameleon7b prefill path")


def _multi_rank(args) -> bool:
    return args.dp != 1 or args.tp > 1 or args.sp > 1 or args.pp > 1


def make_run_mesh(args, wrapper):
    """The ``(dp, tp[, sp][, pp])`` grid of a multi-rank run over the
    process group, with the wrapper made ready for it: a packed cache dtype
    wrapped in a :class:`~wmar_tpu_torch.engine.kvcache.CacheSpec` (the
    kernels on this rank's rows and heads) and, for Chameleon, the grid
    handed over by ``wrapper.shard`` (under ``--tp`` the Llama cut to this
    rank's shard; ``--sp``/``--pp`` pick the prefill)."""
    import torch.distributed as dist

    from wmar_tpu_torch.engine.kvcache import CacheSpec
    from wmar_tpu_torch.parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    rest = args.tp * args.sp * args.pp
    dp = max(1, world // rest) if args.dp == 0 else args.dp
    if dp * rest != world:
        raise SystemExit(f"--dp {dp} x --tp {args.tp} x --sp {args.sp} x --pp {args.pp} needs {dp * rest} ranks, "
                         f"this run has {world}: launch it with torchrun --nproc_per_node {dp * rest}")
    mesh = make_mesh(dp=dp, tp=args.tp, sp=args.sp, pp=args.pp)
    print(f"sharded generation: dp={dp} tp={args.tp} sp={args.sp} pp={args.pp}, rank {mesh.rank} of {world}")
    if str(wrapper.cache_dtype).startswith("packed"):
        wrapper.cache_dtype = CacheSpec(wrapper.cache_dtype, mesh, "dp" if dp > 1 else None,
                                        "tp" if args.tp > 1 else None)
    if hasattr(wrapper, "shard"):
        wrapper.shard(mesh)
    return mesh


def synthetic_tokenizer(n_chars: int):
    """The synthetic tokenizer of the JAX CLI and bench: one text id per
    character of the first ``n_chars``."""
    return lambda text: [6 + (ord(c) % 20) for c in text[:n_chars]]


def _load_alive_ids(path):
    """The codebook ids a generator uses, from a file of comma-separated
    ints (relative paths from the repository root); None without the file."""
    path = os.path.join(REPO_ROOT, path)
    if not os.path.exists(path):
        return None
    ids = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                ids.extend(int(x) for x in line.split(","))
    return np.asarray(ids)


def load_chameleon_files(modelpath: str, device: torch.device):
    """Chameleon-7B from a ``--modelpath`` directory: ``tokenizer/
    text_tokenizer.json`` (the vocabulary and the prompts' BPE encoder,
    :class:`~wmar_tpu_torch.models.text_tokenizer.TextTokenizer`),
    ``llama7b.msgpack`` at ``CHAMELEON_7B`` (bf16 on ``device``),
    ``vqgan.msgpack`` at ``CHAMELEON_F16`` (float32) and the alive ids of
    ``config.json``'s ``alive_ids`` file (``assets/chameleon_all_ids.txt``
    by default). A directory without the tokenizer JSON is refused."""
    from wmar_tpu_torch.models import (
        CHAMELEON_7B,
        CHAMELEON_F16,
        ChameleonARMM,
        ChameleonVocab,
        TamingVQGAN,
        init_llama_params,
    )
    from wmar_tpu_torch.models.text_tokenizer import TextTokenizer
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    tok_path = os.path.join(modelpath, "tokenizer", "text_tokenizer.json")
    if not os.path.exists(tok_path):
        raise SystemExit(f"--modelpath for chameleon7b: {tok_path} not found (the vocabulary and the prompts' "
                         "tokenizer come from it)")
    vocab = ChameleonVocab.from_tokenizer_json(tok_path)
    tokenizer = TextTokenizer.from_file(tok_path)
    like = init_llama_params(CHAMELEON_7B, None, device="meta")
    params = bridge.load_llama(load_pytree(os.path.join(modelpath, "llama7b.msgpack"), like=like, dtypes=False),
                               dtype=torch.bfloat16, device=device)
    vq = bridge.load_flax_file(TamingVQGAN, CHAMELEON_F16, os.path.join(modelpath, "vqgan.msgpack"), device)
    alive = _load_alive_ids(_read_meta(modelpath).get("alive_ids", "assets/chameleon_all_ids.txt"))
    return ChameleonARMM(params, CHAMELEON_7B, vocab, vq, tokenizer=tokenizer.encode, alive_ids=alive,
                         image_seq_len=CHAMELEON_F16.codes_per_side**2, device=device)


# The --tiny Chameleon's Llama (JAX's tiny CLI's); tests widen it where a split needs whole int4 groups
TINY_CHAMELEON = dict(dim=32, n_layers=2, n_heads=4, multiple_of=16)


def load_chameleon(args, device: torch.device):
    if getattr(args, "modelpath", None) and not args.tiny:
        return load_chameleon_files(args.modelpath, device)
    from wmar_tpu_torch.models import (
        CHAMELEON_7B,
        CHAMELEON_F16,
        ChameleonARMM,
        ChameleonVocab,
        LlamaConfig,
        VQGANConfig,
        init_llama_params,
        init_taming_vqgan,
    )

    if args.tiny:
        vocab = ChameleonVocab.synthetic(n_codes=16, n_text=20)
        lcfg = LlamaConfig(**TINY_CHAMELEON, vocab_size=vocab.vocab_size, qk_normalization=True)
        vq_cfg = VQGANConfig(resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                             z_channels=32, n_embed=16, embed_dim=8)
        dtype, image_seq_len, tok, cache_dtype = torch.float32, 16, synthetic_tokenizer(5), torch.float32
    else:
        lcfg, vq_cfg = CHAMELEON_7B, CHAMELEON_F16
        vocab = ChameleonVocab.synthetic(n_codes=8192, n_text=lcfg.vocab_size - 8192 - 6)
        dtype, image_seq_len, tok, cache_dtype = torch.bfloat16, 1024, synthetic_tokenizer(16), torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_llama_params(lcfg, gen, dtype=dtype, device=device)
    vq = init_taming_vqgan(vq_cfg, gen, dtype=dtype, device=device)
    return ChameleonARMM(params, lcfg, vocab, vq, tokenizer=tok, image_seq_len=image_seq_len,
                         cache_dtype=cache_dtype, device=device)


def _read_meta(modelpath: str) -> dict:
    import json

    path = os.path.join(modelpath, "config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _read(modelpath: str, name: str):
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    return load_pytree(os.path.join(modelpath, name))


def apply_ft_deltas(args, wrapper) -> None:
    """Add the RCC deltas of ``--encoder_ft_ckpt`` / ``--decoder_ft_ckpt``
    to the wrapper's tokenizer, whatever built it."""
    from wmar_tpu_torch.utils import checkpoint as ckpt

    for path, part in ((args.encoder_ft_ckpt, wrapper.vq.encoder), (args.decoder_ft_ckpt, wrapper.vq.decoder)):
        if path:
            bridge.load_flax(part, ckpt.load_and_apply_delta(path, bridge.flax_tree(part)))
            print(f"applied the RCC delta {path}")


# A random tiny model has no alive-ids file: all its codes count as alive,
# and there are enough of them for the clustering split's 100 clusters.
_TINY_CODES = 128


def load_taming(args, device: torch.device):
    from wmar_tpu_torch.models import (
        TAMING_GPT_1_4B,
        TAMING_IMAGENET_F16,
        GPTConfig,
        TamingARMM,
        VQGANConfig,
        init_gpt,
        init_taming_vqgan,
    )

    if getattr(args, "modelpath", None) and not args.tiny:
        from wmar_tpu_torch.models import GPT, TamingVQGAN

        meta = _read_meta(args.modelpath)
        # the published cin_transformer geometry; taming's net2net GPTs use 16 heads
        gpt_cfg = GPTConfig(**meta.get("gpt", dict(vocab_size=16384, block_size=512, n_layer=48, n_head=16,
                                                   n_embd=1664)))
        gpt = bridge.load_gpt(GPT(gpt_cfg, device=device), _read(args.modelpath, "gpt.msgpack"))
        vq = bridge.load_flax_file(TamingVQGAN, TAMING_IMAGENET_F16, os.path.join(args.modelpath, "vqgan.msgpack"),
                                   device)
        alive = _load_alive_ids(meta.get("alive_ids", "assets/vqgan_alive_ids.txt"))
        return TamingARMM(gpt, vq, alive_ids=alive, device=device)
    if args.tiny:
        gpt_cfg = GPTConfig(vocab_size=_TINY_CODES, block_size=300, n_layer=2, n_head=2, n_embd=32)
        vq_cfg = VQGANConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                             z_channels=32, n_embed=_TINY_CODES, embed_dim=16)
        dtype, cache_dtype, alive = torch.float32, torch.float32, np.arange(_TINY_CODES)
    else:
        gpt_cfg, vq_cfg = TAMING_GPT_1_4B, TAMING_IMAGENET_F16
        dtype, cache_dtype, alive = torch.bfloat16, torch.bfloat16, _load_alive_ids("assets/vqgan_alive_ids.txt")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    gpt = init_gpt(gpt_cfg, gen, dtype=dtype, device=device)
    vq = init_taming_vqgan(vq_cfg, gen, dtype=dtype, device=device)
    return TamingARMM(gpt, vq, alive_ids=alive, cache_dtype=cache_dtype, device=device)


def load_wrapper(args, device: torch.device):
    """The model of ``--model`` (tiny, random or from ``--modelpath``) with
    the RCC deltas applied to its tokenizer."""
    loader = {"chameleon7b": load_chameleon, "taming": load_taming}.get(args.model, load_rar)
    wrapper = loader(args, device)
    if getattr(args, "encoder_ft_ckpt", None) or getattr(args, "decoder_ft_ckpt", None):
        apply_ft_deltas(args, wrapper)
    return wrapper


def load_rar(args, device: torch.device):
    from wmar_tpu_torch.models import (
        MASKGIT_IMAGENET_F16,
        MaskGitVQConfig,
        RARConfig,
        RarARMM,
        init_maskgit,
        init_rar,
        rar_config,
    )

    if getattr(args, "modelpath", None) and not args.tiny:
        from wmar_tpu_torch.models import RAR, MaskGitVQGAN

        meta = _read_meta(args.modelpath)
        rar_cfg = rar_config(args.rar_size)
        rar = bridge.load_rar(RAR(rar_cfg, device=device), _read(args.modelpath, f"{args.rar_size}.msgpack"))
        vq = bridge.load_flax_file(MaskGitVQGAN, MASKGIT_IMAGENET_F16,
                                   os.path.join(args.modelpath, "maskgit_vqgan.msgpack"), device)
        alive = _load_alive_ids(meta.get("alive_ids", "assets/rar_all_ids.txt"))
        return RarARMM(rar, vq, alive_ids=alive, device=device)
    if args.tiny:
        rar_cfg = RARConfig(embed_dim=64, depth=2, num_heads=2, intermediate_size=128,
                            image_seq_len=16, codebook_size=_TINY_CODES, num_classes=10)
        vq_cfg = MaskGitVQConfig(resolution=8, hidden_channels=32, channel_mult=(1, 2),
                                 num_res_blocks=1, z_channels=16, n_embed=_TINY_CODES, embed_dim=16)
        dtype, cache_dtype, alive = torch.float32, torch.float32, np.arange(_TINY_CODES)
    else:
        rar_cfg, vq_cfg = rar_config(args.rar_size), MASKGIT_IMAGENET_F16
        dtype, cache_dtype, alive = torch.bfloat16, torch.bfloat16, _load_alive_ids("assets/rar_all_ids.txt")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rar = init_rar(rar_cfg, gen, dtype=dtype, device=device)
    vq = init_maskgit(vq_cfg, gen, dtype=dtype, device=device)
    return RarARMM(rar, vq, alive_ids=alive, cache_dtype=cache_dtype, device=device)


def main(argv=None):
    args = get_parser().parse_args(argv)
    for attr in ("encoder_ft_ckpt", "decoder_ft_ckpt", "syncpath", "modelpath"):
        if getattr(args, attr, None) == "none":
            setattr(args, attr, None)
    _refuse(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    if _multi_rank(args):
        from wmar_tpu_torch.parallel import init_distributed

        init_distributed("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # the rank's card

    from wmar_tpu_torch.augmentations import AugmentationManager
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.eval import EvalParams, generate_and_evaluate
    from wmar_tpu_torch.models import (
        GenParams,
        quantize_gpt_params_int8,
        quantize_llama_params_int8,
        quantize_rar_params_int8,
    )

    wrapper = load_wrapper(args, device)
    if args.cache_dtype:
        wrapper.cache_dtype = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
                               "packed": "packed", "packed4": "packed4"}[args.cache_dtype]
    if args.weight_dtype:
        bits = {"int8": 8, "int4": 4}[args.weight_dtype]
        if args.model == "chameleon7b":
            wrapper.llama_params = quantize_llama_params_int8(wrapper.llama_params, compute_dtype=torch.bfloat16,
                                                              bits=bits)
        elif args.model == "taming":
            quantize_gpt_params_int8(wrapper.gpt, compute_dtype=torch.bfloat16, bits=bits)
        else:
            quantize_rar_params_int8(wrapper.rar, compute_dtype=torch.bfloat16, bits=bits)

    mesh = make_run_mesh(args, wrapper) if _multi_rank(args) else None

    apply_wm = args.wm_method == "gentime"
    if apply_wm:
        method = (f"{args.wm_seed_strategy}-{args.wm_split_strategy}-"
                  f"h={args.wm_context_size}-d={args.wm_delta:.1f}-g={args.wm_gamma:.2f}")
        spec = WatermarkSpec.from_string(method, vocab_size=wrapper.get_total_vocab_size(),
                                         spatial_dim=wrapper.codes_size)
        wrapper.set_watermarker(spec, torch_compat=args.wm_torch_compat)

    if args.interleaved:
        return run_interleaved(args, wrapper, apply_wm)

    if os.path.exists(args.conditioning):
        with open(args.conditioning) as f:
            conds = [line.strip() for line in f if line.strip()]
    else:
        conds = [int(c) for c in args.conditioning.split(",")]
    all_inputs = [c for c in conds for _ in range(args.num_samples_per_conditioning)]
    gen = GenParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                    guidance_scale=args.guidance_scale, guidance_scale_pow=0.0)
    eval_params = EvalParams(max_roundtrips=args.max_roundtrips, orig_only=args.orig_only)
    aug_manager = None
    lead = mesh is None or mesh.rank == 0  # the other ranks only sample
    if lead and not (args.orig_only or args.no_augs):
        nc_models = None
        if args.include_neural_compress:
            from wmar_tpu_torch.augmentations.neural import build_codec_bank

            nc_models = build_codec_bank(weights_dir=args.nc_weights_dir, allow_random=args.nc_allow_random,
                                         device=device)
            if not nc_models:
                raise SystemExit(
                    "--include_neural_compress was set but no codec could be built; provide --nc_weights_dir with "
                    "converted checkpoints or pass --nc_allow_random true to acknowledge random-weight destruction "
                    "slots.")
        diffpure = None
        if args.include_diffpure:
            if not args.diffpure_weights:
                raise SystemExit(
                    "--include_diffpure requires --diffpure_weights (256x256_diffusion_uncond.pt or a converted "
                    "msgpack); a random-weight purifier is not DiffPure.")
            from wmar_tpu_torch.augmentations.diffpure import GUIDED_DIFFUSION_256_UNCOND, DiffPure, load_adm_weights

            diffpure = DiffPure(load_adm_weights(args.diffpure_weights, GUIDED_DIFFUSION_256_UNCOND, device))
        aug_manager = AugmentationManager(exact_jpeg=args.exact_jpeg, nc_models=nc_models, diffpure=diffpure)
    sync_manager = None
    if lead and args.sync:
        from wmar_tpu_torch.sync.manager import SyncManager

        sync_manager = SyncManager.from_path(args.syncpath, image_size=wrapper.image_size, device=device)
    records = generate_and_evaluate(
        args.outdir, wrapper, all_inputs, gen, eval_params, aug_manager,
        batch_size=args.batch_size, seed=args.seed, chunk_id=args.chunk_id,
        num_chunks=args.num_chunks, apply_watermark=apply_wm, sync_manager=sync_manager, mesh=mesh,
    )
    if lead:
        print(f"wrote {len(records)} records to {args.outdir}")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
