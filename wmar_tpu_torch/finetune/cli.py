"""RCC tokenizer finetuning on one CUDA card (PyTorch port of the root
``finetune.py``).

    python -m wmar_tpu_torch.finetune --model taming --modelpath ckpts/taming \\
        --datapath codes/ --nb_epochs 10 --augs_schedule 1,1,4,4 --outdir out/
    python -m wmar_tpu_torch.finetune --model rar --tiny --synthetic 64 \\
        --device cpu --nb_epochs 2 --augs_schedule 1,1,0,0 --outdir out/

Trains a clone of the tokenizer's encoder (``watermark_encoder``) and its
decoder so that decode -> attack -> encode keeps the tokens. The flags and
their defaults are ``finetune.py``'s, plus ``--device`` (default ``cuda``;
without a card it exits rather than moving to the CPU). The data is
handled as there: ``--synthetic N`` codes from ``np.random.default_rng
(seed)``, the 5% validation split from ``default_rng(1)``, the epoch
permutations from ``default_rng(seed)``, so the port sees JAX's batches.
Each epoch validates first (Identity and every (aug, param) cell of its
level at p = 1), then trains; a final validation follows the last epoch.

Files in ``--outdir``: ``epoch{e}_trainable.msgpack`` and
``epoch{e}_{encoder,decoder}_delta.msgpack`` in the JAX package's Flax
layout (its ``load_and_apply_delta`` reads them), ``checkpoint.msgpack``
plus ``checkpoint_meta.json`` for ``--resume`` (the port's own layout:
state dicts of the trainable parts, Adam and the schedule, msgpack without
pickle; the next epoch and the history so far) and ``history.json``. A
resumed run sees the batches and ends at the weights of an uninterrupted
one, and its ``history.json`` holds every epoch (JAX's resume reshuffles
the resumed epochs as the first ones and drops the earlier history).
``--modelpath`` reads ``vqgan.msgpack`` (``taming``: TAMING_IMAGENET_F16;
``chameleon7b``: CHAMELEON_F16, Anole's 512 px 8192-code tokenizer) or
``maskgit_vqgan.msgpack`` (``rar``). The GAN branch is Taming's only. One
device: data parallelism is not ported. Precision: :func:`set_precision`.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, choices=["taming", "rar", "chameleon7b"], default="taming")
    p.add_argument("--modelpath", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--datapath", type=str, default=None)
    p.add_argument("--dataset_size", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0, help="train on N random code rows (smoke)")
    p.add_argument("--tiny", action="store_true", help="random tiny tokenizer (smoke)")
    p.add_argument("--mode", type=str, default="newenc-dec")
    p.add_argument("--nb_epochs", type=int, default=10)
    p.add_argument("--augs", type=str, choices=["none", "all+geom"], default="all+geom")
    p.add_argument("--augs_schedule", type=str, default="1,1,4,4")
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--batch_size_per_device", type=int, default=4)
    p.add_argument("--dataset", type=str, default="codes-imagenet",
                   help="dataset kind; only codes-imagenet exists, like the reference (finetune.py:198-203)")
    p.add_argument("--idempotence_loss_weight", type=float, default=2.0)
    p.add_argument("--idempotence_loss_weight_factor", type=float, default=1.0,
                   help="geometric per-epoch schedule: the idem weight is multiplied by this after every epoch")
    p.add_argument("--loss", type=str, default="hard-to-soft-with-ae")
    p.add_argument("--disable_gan", action="store_true",
                   help="skip the generator-side GAN branch (all six published reference sweeps pass this)")
    p.add_argument("--disc_ckpt", type=str, default=None,
                   help="discriminator.msgpack; default: <modelpath>/discriminator.msgpack")
    p.add_argument("--disc_init", type=str, choices=["ckpt", "random"], default="ckpt",
                   help="'random': a fresh weights_init discriminator when no checkpoint is available (smoke)")
    p.add_argument("--disc_start", type=int, default=0)
    p.add_argument("--disc_factor", type=float, default=1.0)
    p.add_argument("--disc_weight", type=float, default=1.0)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--resume", action="store_true", help="auto-resume from <outdir>/checkpoint.msgpack")
    p.add_argument("--val_percent", type=float, default=0.05,
                   help="held-out fraction for the per-epoch validation (reference finetune.py:196)")
    p.add_argument("--val_batches", type=int, default=0,
                   help="cap validation batches per (aug,param) cell (0 = all)")
    p.add_argument("--no_validate", action="store_true", help="skip the per-epoch validation sweep")
    return p


def load_codes(args, vocab: int, tokens: int) -> np.ndarray:
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        return rng.integers(0, vocab, size=(args.synthetic, tokens)).astype(np.int32)
    assert args.datapath, "--datapath or --synthetic required"
    if os.path.isdir(args.datapath):
        files = sorted(glob.glob(os.path.join(args.datapath, "**/*.npy"), recursive=True))
        if args.dataset_size:
            files = files[: args.dataset_size]
        return np.stack([np.load(f).reshape(-1) for f in files]).astype(np.int32)
    data = np.load(args.datapath).astype(np.int32)
    return data[: args.dataset_size] if args.dataset_size else data


# The JAX CLI's --tiny tokenizers (finetune.py:110-121)
TINY_TAMING = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                   z_channels=32, n_embed=64, embed_dim=16)
TINY_MASKGIT = dict(resolution=16, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                    z_channels=16, n_embed=64, embed_dim=16)
# the port's tiny Chameleon tokenizer (generate.py's)
TINY_CHAMELEON = dict(resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                      z_channels=32, n_embed=16, embed_dim=8)


def tokenizer_spec(model: str, tiny: bool):
    """(module class, config, adapter class, file name) of a model's
    tokenizer. ``chameleon7b`` is Anole's CHAMELEON_F16 (512 px, 8192
    codes); the JAX CLI builds TAMING_IMAGENET_F16 for it, which that
    tokenizer's file cannot load into."""
    from wmar_tpu_torch.finetune.rcc import MaskGitRCCAdapter, TamingRCCAdapter
    from wmar_tpu_torch.models import (
        CHAMELEON_F16,
        MASKGIT_IMAGENET_F16,
        TAMING_IMAGENET_F16,
        MaskGitVQConfig,
        MaskGitVQGAN,
        TamingVQGAN,
        VQGANConfig,
    )

    if model == "rar":
        return MaskGitVQGAN, MaskGitVQConfig(**TINY_MASKGIT) if tiny else MASKGIT_IMAGENET_F16, \
            MaskGitRCCAdapter, "maskgit_vqgan.msgpack"
    if model == "chameleon7b":
        return TamingVQGAN, VQGANConfig(**TINY_CHAMELEON) if tiny else CHAMELEON_F16, TamingRCCAdapter, "vqgan.msgpack"
    return TamingVQGAN, VQGANConfig(**TINY_TAMING) if tiny else TAMING_IMAGENET_F16, TamingRCCAdapter, "vqgan.msgpack"


def build_adapter(args, device: torch.device):
    """The RCC adapter over the tokenizer: ``--tiny`` random weights from
    ``Generator().manual_seed(0)``, else the float32 weights of the
    ``--modelpath`` file."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.models import init_maskgit, init_taming_vqgan

    cls, cfg, adapter_cls, fname = tokenizer_spec(args.model, args.tiny)
    if args.tiny:
        init = init_maskgit if args.model == "rar" else init_taming_vqgan
        model = init(cfg, torch.Generator().manual_seed(0), device=device)
    else:
        assert args.modelpath, "--modelpath required without --tiny"
        model = bridge.load_flax_file(cls, cfg, os.path.join(args.modelpath, fname), device)
    return adapter_cls(model)


def set_precision() -> tuple:
    """The finetune's precision, set here once for the entry point, its
    bench and the card check: cuDNN convolutions may use TF32 (PyTorch's
    default), cuBLAS matmuls stay float32 (also its default). Returns the
    (cudnn, matmul) switches it replaced, for a caller that runs other work
    in the same process."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    return prev


def save_resume(path: str, state) -> None:
    """The whole training state: trainable parts, Adam, schedule, step
    (Adam's per-parameter state keyed by the index as a string, so any
    msgpack reader takes the file)."""
    from wmar_tpu_torch.utils import msgpack_codec

    opt = state.optimizer.state_dict()
    opt["state"] = {str(k): v for k, v in opt["state"].items()}
    tree = {"step": state.step, "trainable": state.trainable.state_dict(), "optimizer": opt,
            "scheduler": state.scheduler.state_dict()}
    with open(path, "wb") as f:
        msgpack_codec.dump(tree, f, sort_keys=False)


def load_resume(path: str, state) -> None:
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    tree = load_pytree(path)
    state.trainable.load_state_dict(tree["trainable"])
    opt = tree["optimizer"]
    state.optimizer.load_state_dict(dict(opt, state={int(k): v for k, v in opt["state"].items()}))
    state.scheduler.load_state_dict(tree["scheduler"])
    state.step = int(tree["step"])


def _build_gan(args, device):
    from wmar_tpu_torch.finetune.gan import GanConfig, discriminator_from_flax, init_taming_discriminator
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    disc_path = args.disc_ckpt or (os.path.join(args.modelpath, "discriminator.msgpack") if args.modelpath else "")
    if disc_path and os.path.exists(disc_path):
        disc = discriminator_from_flax(load_pytree(disc_path), device=device)
        print(f"GAN branch on: discriminator from {disc_path}")
    elif args.disc_init == "random":
        disc = init_taming_discriminator(torch.Generator().manual_seed(args.seed), device=device)
        print("GAN branch on: RANDOM-INIT discriminator (smoke mode; convert the checkpoint's discriminator "
              "for real runs)")
    else:
        print("GAN branch requested but no discriminator checkpoint found; proceeding GAN-off "
              "(pass --disc_init random or --disc_ckpt to enable)")
        return None
    return GanConfig(disc, disc_factor=args.disc_factor, disc_weight=args.disc_weight, disc_start=args.disc_start)


def main(argv=None, adapter=None):
    """Run the finetune; returns the final :class:`RCCState`. ``adapter``
    (already built, for example from the JAX package's tiny weights through
    the bridge) replaces the one ``--tiny``/``--modelpath`` would build."""
    args = get_parser().parse_args(argv)
    if args.dataset != "codes-imagenet":
        raise ValueError(f"Dataset {args.dataset} not supported")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    set_precision()

    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.finetune.perceptual import PerceptualLoss, load_lpips
    from wmar_tpu_torch.finetune.rcc import RCCConfig, expand_level, init_state, make_train_step, make_val_step
    from wmar_tpu_torch.utils import checkpoint as ckpt
    from wmar_tpu_torch.utils.logging import encoder_drift

    os.makedirs(args.outdir, exist_ok=True)
    if adapter is None:
        adapter = build_adapter(args, device)
    else:
        adapter.model.to(device)
    vocab, tokens = adapter.model.cfg.n_embed, adapter.latent_side**2
    codes = load_codes(args, vocab, tokens)
    # Train/val split (the reference holds out 5% with a fixed seed, finetune.py:195-205)
    val_rows = int(round(codes.shape[0] * args.val_percent)) if not args.no_validate else 0
    if val_rows > 0:
        perm0 = np.random.default_rng(1).permutation(codes.shape[0])
        codes_val = codes[perm0[:val_rows]]
        codes = codes[perm0[val_rows:]]
    else:
        codes_val = codes[:0]
    print(f"dataset: {codes.shape[0]} train / {codes_val.shape[0]} val rows of {codes.shape[1]} tokens")

    global_bs = args.batch_size_per_device
    steps_per_epoch = max(1, codes.shape[0] // global_bs)
    cfg = RCCConfig(lr=args.lr, idem_weight=args.idempotence_loss_weight)
    state = init_state(adapter, cfg, steps_per_epoch)
    originals = adapter.frozen_parts()
    orig_flax = {name: bridge.flax_tree(m) for name, m in originals.items()}

    start_epoch, history = 0, []
    resume_path = os.path.join(args.outdir, "checkpoint.msgpack")
    meta_path = os.path.join(args.outdir, "checkpoint_meta.json")
    if args.resume and os.path.exists(resume_path):
        load_resume(resume_path, state)
        with open(meta_path) as f:
            meta = json.load(f)
        start_epoch, history = meta["next_epoch"], meta["history"]
        print(f"resumed from {resume_path} at epoch {start_epoch}")

    lpips = load_lpips(args.lpips_weights, device) if args.lpips_weights and os.path.exists(args.lpips_weights) \
        else None
    perceptual = PerceptualLoss(lpips)
    gan = _build_gan(args, device) if not args.disable_gan and args.model == "taming" else None

    if args.augs == "none":
        levels = ["warmup"] * args.nb_epochs
    else:
        schedule = [int(x) for x in args.augs_schedule.split(",")]
        assert sum(schedule) == args.nb_epochs, "augs_schedule must sum to nb_epochs"
        names = ["warmup", "weak", "medium", "strong"]
        levels = [n for n, e in zip(names, schedule) for _ in range(e)]

    steps, val_steps = {}, {}

    def run_validation(epoch, level, idem_w, trainable):
        """Identity and each (aug, param) of the level at p = 1
        (reference finetune.py:73-128)."""
        if codes_val.shape[0] == 0:
            return {}
        cfg_e = dataclasses.replace(cfg, idem_weight=idem_w)
        n_val = max(1, codes_val.shape[0] // global_bs) if codes_val.shape[0] >= global_bs else 1
        if args.val_batches:
            n_val = min(n_val, args.val_batches)
        out = {}
        for branch in [None] + expand_level(level):
            key_name = "Identity_0" if branch is None else f"{branch.name}_{branch.param}"
            if (key_name, idem_w) not in val_steps:
                val_steps[(key_name, idem_w)] = make_val_step(adapter, cfg_e, branch, perceptual)
            vfn = val_steps[(key_name, idem_w)]
            acc, cnt = {}, 0
            for bi in range(n_val):
                vb = codes_val[bi * global_bs: (bi + 1) * global_bs]
                if vb.shape[0] == 0:
                    break
                rows = vb.shape[0]
                if rows < global_bs:  # tiled up to a full batch and weighted by true rows, as JAX does
                    vb = np.concatenate([vb] * -(-global_bs // rows))[:global_bs]
                gen = torch.Generator(device=device).manual_seed(args.seed + 777 + epoch)
                m = vfn(trainable, torch.as_tensor(vb, device=device).long(), gen)
                for k, v in zip(m, torch.stack(list(m.values())).tolist()):
                    acc[k] = acc.get(k, 0.0) + v * rows
                cnt += rows
            stats = {k: v / max(cnt, 1) for k, v in acc.items()}
            out[key_name] = stats
            print(f"Validation {key_name}| Loss: {stats['loss']:.5f}| IdemLoss: {stats['idem_loss']:.5f}"
                  f"| VQGANLoss: {stats['vqgan_loss']:.5f}| L0: {stats['l0']:.5f}")
        enc_d = encoder_drift(trainable["watermark_encoder"], originals["watermark_encoder"])
        dec_d = encoder_drift(trainable["decoder"], originals["decoder"])
        print(f"[Val] ENC L2 Distance: {enc_d:.5f}, DEC L2 Distance: {dec_d:.5f}")
        out["drift"] = {"enc": enc_d, "dec": dec_d}
        return out

    rng = np.random.default_rng(args.seed)
    t_start = time.time()
    for epoch, level in enumerate(levels):
        # drawn for the epochs a resume skips too, so that each epoch gets the uninterrupted run's batches
        # (JAX's loop draws after the skip: a resumed epoch e shuffles as epoch e - start_epoch)
        perm = rng.permutation(codes.shape[0])
        if epoch < start_epoch:
            continue
        idem_w = args.idempotence_loss_weight * (args.idempotence_loss_weight_factor ** epoch)
        if (level, idem_w) not in steps:
            cfg_e = dataclasses.replace(cfg, idem_weight=idem_w)
            steps[(level, idem_w)] = make_train_step(adapter, cfg_e, level, perceptual, gan=gan)
        step_fn = steps[(level, idem_w)]
        val_stats = run_validation(epoch, level, idem_w, state.trainable)  # validation first (finetune.py:388-392)
        epoch_metrics = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_train = time.perf_counter()
        for bi in range(steps_per_epoch):
            idx = perm[bi * global_bs: (bi + 1) * global_bs]
            batch = torch.as_tensor(codes[idx], device=device).long()
            seed = args.seed + epoch * 100000 + bi
            metrics = step_fn(state, batch, torch.Generator().manual_seed(seed),
                              torch.Generator(device=device).manual_seed(seed))
            if bi % args.log_every == 0:
                m = dict(zip(metrics, torch.stack([v.to(device).float() for v in metrics.values()]).tolist()))
                m["enc_dist"] = encoder_drift(state.trainable["watermark_encoder"], originals["watermark_encoder"])
                m["dec_dist"] = encoder_drift(state.trainable["decoder"], originals["decoder"])
                epoch_metrics.append(m)
                print(f"epoch {epoch} [{level}] step {bi}/{steps_per_epoch}: {m}")
                print(f"ENC L2 Distance: {m['enc_dist']:.5f}, DEC L2 Distance: {m['dec_dist']:.5f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t_train
        # Per-epoch checkpoints: full weights + deltas (the published format, Flax layout)
        trained = {name: bridge.flax_tree(state.trainable[name]) for name in ("decoder", "watermark_encoder")}
        ckpt.save_pytree(os.path.join(args.outdir, f"epoch{epoch}_trainable.msgpack"), trained)
        ckpt.save_delta(os.path.join(args.outdir, f"epoch{epoch}_encoder_delta.msgpack"),
                        trained["watermark_encoder"], orig_flax["watermark_encoder"])
        ckpt.save_delta(os.path.join(args.outdir, f"epoch{epoch}_decoder_delta.msgpack"),
                        trained["decoder"], orig_flax["decoder"])
        history.append({"epoch": epoch, "level": level, "metrics": epoch_metrics, "validation": val_stats,
                        "train_s": train_s, "train_steps": steps_per_epoch})
        save_resume(resume_path, state)
        with open(meta_path, "w") as f:
            json.dump({"next_epoch": epoch + 1, "history": history}, f)
    if levels and codes_val.shape[0]:  # final validation (reference finetune.py:509-515)
        print("Done! Doing final validation.")
        final_idem = args.idempotence_loss_weight * (args.idempotence_loss_weight_factor ** (len(levels) - 1))
        final_val = run_validation(len(levels), levels[-1], final_idem, state.trainable)
        history.append({"epoch": len(levels), "level": "final", "metrics": [], "validation": final_val})
    with open(os.path.join(args.outdir, "history.json"), "w") as f:
        json.dump({"wall_s": time.time() - t_start, "epochs": history}, f, indent=1)
    print(f"done in {time.time() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
