"""Mimi RCC finetuning on CUDA cards (PyTorch port of the root
``finetune_mimi.py``).

    python -m wmar_tpu_torch.finetune_mimi --mimi_weights mimi.msgpack \\
        --audio_dir wavs/ --batch_size 8 --output_dir out/
    torchrun --nproc_per_node 2 -m wmar_tpu_torch.finetune_mimi \\
        --mimi_weights mimi.msgpack --audio_dir wavs/ --output_dir out/
    python -m wmar_tpu_torch.finetune_mimi --tiny --synthetic 24 --device cpu \\
        --batch_size 8 --epochs 2 --steps_per_epoch 2 --output_dir out/

Finetunes Mimi's encoder and decoder so that decode -> (augment) ->
re-encode gives back the original tokens (:mod:`wmar_tpu_torch.audio.
finetune`). The flags and their defaults are ``finetune_mimi.py``'s, plus
``--device`` (default ``cuda``; without a card it exits rather than moving
to the CPU). The weights: ``--mimi_weights`` (a ``.msgpack`` the JAX
package wrote, read by the port's own flax reader, or a released
``.safetensors``) at ``MIMI_V0_1``; ``--tiny`` takes the JAX CLI's tiny
config, with random weights from ``Generator().manual_seed(0)`` or the
``--mimi_weights`` file at that config. The data: ``--audio_dir`` (``.wav``
/ ``.npy``) or ``--synthetic N`` band-limited clips from
``np.random.default_rng(seed)``, split by :func:`train_valid_split`; the
batch indices come from ``default_rng(seed)`` as in JAX, and each step's
augmenter generator is seeded with ``seed + epoch * 100000 + step``.

AdamW (optax's defaults) under ``optax.warmup_cosine_decay_schedule(0,
lr, max(warmup, 1), total, lr / 100)``, so the first update has rate 0.
``--finetune_encoder false`` leaves the encoder parts out of the optimizer.
The augmenter (``--augs`` JSON, single quotes allowed) applies from epoch
``--augmentation_start``. Each eval: the losses, ``idemp_k``, SI-SNR, SNR,
STOI (PESQ where the package exists), the sample wavs ``{epoch:03d}_
{target,pred}.wav`` and the ``--val_token_match`` sweep
(``eval_token_match_<aug>_<param>``).

Files in ``--output_dir``: ``log.txt`` (a JSON line an epoch, with the
train seconds and steps), ``epoch{e}_{part}_delta.msgpack`` for the four
trainable parts in the JAX package's Flax layout (its ``load_pytree``
reads them), ``checkpoint.msgpack`` (the port's own layout, as
``python -m wmar_tpu_torch.finetune`` writes it: the parts' state dicts,
AdamW, the schedule) and ``checkpoint_meta.json`` for the
auto-resume, ``checkpoint{epoch:03d}.msgpack`` every ``--save_freq``
epochs. A resumed run draws and discards the skipped epochs' batch
indices, so it sees the uninterrupted run's batches (JAX's draws epoch 0's
indices again); restarted with the same flags it ends at that run's
weights. The schedule follows ``--epochs``, as in JAX, so a resume with a
larger ``--epochs`` trains its earlier epochs at other rates.

Data parallelism, as JAX's ``(dp, 1)`` mesh: under a launcher (``torchrun``,
or SLURM) the dp size is the world size, NCCL with one card a rank (gloo
with ``--device cpu``, or in a process group the caller made); without a
launcher, one process. The batch is rounded as in JAX, to ``max(dp,
(batch_size // dp) * dp)``; every rank draws the same indices and loads
and trains its rows (:mod:`wmar_tpu_torch.audio.finetune` makes the step
the global batch's). In an eval each rank scores its rows, the device
metrics are the ranks' means, and the reconstructions are gathered onto
the first rank, which alone computes the host metrics, runs the
token-match sweep, and writes files and logs. Every rank reads the
auto-resume file from its ``--output_dir``.
Precision: cuDNN convolutions may use TF32, matmuls stay float32
(:func:`wmar_tpu_torch.finetune.cli.set_precision`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from wmar_tpu_torch.train_syncseal import str2bool

# The JAX CLI's --tiny Mimi (finetune_mimi.py's build_mimi)
TINY_FT_MIMI = dict(dimension=32, n_filters=8, ratios=(4, 2), n_residual_layers=1, n_q=4, n_q_semantic=1,
                    cardinality=32, codebook_dim=8, transformer_layers=1, transformer_heads=2, downsample=1)


def get_parser():
    p = argparse.ArgumentParser(description="Fine-tune the Mimi encoder-decoder model")
    p.add_argument("--mimi_weights", type=str, default=None,
                   help="Mimi weights: a JAX-written .msgpack or a released .safetensors; omit with --tiny")
    p.add_argument("--tiny", action="store_true", help="tiny Mimi (smoke): random, or --mimi_weights at its config")
    p.add_argument("--device", type=str, default="cuda", help="torch device; never falls back to the CPU")
    p.add_argument("--output_dir", type=str, default="output")
    # Dataset
    p.add_argument("--audio_dir", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0, help="train on N synthetic clips instead of --audio_dir")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--target_sr", type=int, default=24000)
    p.add_argument("--target_duration", type=float, default=10.0,
                   help="clip seconds; must be a multiple of the Mimi frame (80 ms)")
    p.add_argument("--num_valid", type=int, default=100)
    # Training
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    # Losses
    p.add_argument("--code_loss_type", type=str, default="mse")
    p.add_argument("--audio_loss_type", type=str, default="mrstft")
    p.add_argument("--audio_loss_weight", type=float, default=1e-3)
    p.add_argument("--code_loss_weight", type=float, default=1.0)
    p.add_argument("--audio_target_type", type=str, default="replica", choices=["replica", "original"])
    p.add_argument("--code_target_type", type=str, default="pre_q",
                   help="'pre_q', 'post_q', or layer indices ('0-2,5')")
    # Finetuning-specific
    p.add_argument("--resume_from", type=str, default=None,
                   help="a trainable tree (.msgpack, JAX's layout) to initialize the trainable parts from")
    p.add_argument("--finetune_encoder", type=str2bool, default=True)
    # Misc
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--seed", type=int, default=42424242)
    p.add_argument("--val_token_match", type=str, default="subset", choices=["none", "subset", "full"],
                   help="per-eval decode->aug->encode token-match sweep")
    # Augmentations
    p.add_argument("--augmentation_start", type=int, default=-1,
                   help="epoch to start applying augmentations; -1 = never")
    p.add_argument("--augs", type=str, default="{}", help="JSON dict of augmentation weights")
    p.add_argument("--augs_params", type=str, default="{}", help="JSON dict of augmentation parameters")
    p.add_argument("--num_augmentations", type=int, default=1)
    return p


def build_mimi(args, device):
    """The Mimi the flags name, float32 on ``device``."""
    from wmar_tpu_torch.audio.mimi import MIMI_V0_1, MimiConfig, init_mimi
    from wmar_tpu_torch.audio_eval import load_mimi_model

    cfg = MimiConfig(**TINY_FT_MIMI) if args.tiny else MIMI_V0_1
    if args.mimi_weights:
        return load_mimi_model(args.mimi_weights, cfg, device)
    if not args.tiny:
        raise SystemExit("--mimi_weights or --tiny required")
    return init_mimi(cfg, torch.Generator(device).manual_seed(0), device=device)


def synthetic_clips(n: int, length: int, seed: int) -> np.ndarray:
    """Band-limited random audio ``[N, T, 1]`` in [-1, 1] (the lowest sixth
    of the spectrum, peak 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length)).astype(np.float32)
    spec = np.fft.rfft(x, axis=-1)
    spec[:, spec.shape[1] // 6:] = 0.0
    x = np.fft.irfft(spec, n=length, axis=-1).astype(np.float32)
    x /= np.abs(x).max(axis=-1, keepdims=True) + 1e-9
    return (0.5 * x)[..., None]


def token_match_augs(mode: str, sample_rate: int) -> list:
    """The eval's sweep: none, the first strength of identity / noise /
    lowpass / smooth (``subset``), or the whole validation grid."""
    from wmar_tpu_torch.audio.augmentations import get_validation_augs

    if mode == "none":
        return []
    names = {"identity", "noise", "lowpass", "smooth"} if mode == "subset" else None
    return [(name, fn, params if names is None else params[:1])
            for name, fn, params in get_validation_augs(sample_rate) if names is None or name in names]


def main(argv=None):
    """Run the finetune; returns the final
    :class:`~wmar_tpu_torch.audio.finetune.MimiFTState`."""
    args = get_parser().parse_args(argv)
    from wmar_tpu_torch.finetune.cli import _quiet, load_resume, run_mesh, save_resume, set_precision

    device, mesh = run_mesh(args.device)
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.audio.augmenter import Augmenter
    from wmar_tpu_torch.audio.dataloader import AudioDataset, train_valid_split
    from wmar_tpu_torch.audio.finetune import (
        PARTS,
        MimiFTWrapper,
        init_state,
        make_rcc_eval_step,
        make_rcc_train_step,
        validation_token_match,
        warmup_cosine_decay,
    )
    from wmar_tpu_torch.audio.losses import get_audio_loss, get_code_loss
    from wmar_tpu_torch.audio.prompts import write_wav
    from wmar_tpu_torch.parallel import dp_size, gather_rows, is_lead, rows_of, same_on_all
    from wmar_tpu_torch.utils import checkpoint as ckpt
    from wmar_tpu_torch.utils.metrics import pesq_metric, sisnr, snr, stoi

    set_precision()
    augs = json.loads(args.augs.replace("'", '"'))
    augs_params = json.loads(args.augs_params.replace("'", '"'))
    if (args.target_duration * 1000) % 80 != 0:
        raise SystemExit("Target duration should be a multiple of 80ms (s/frame of mimi).")
    lead = is_lead(mesh)
    log = print if lead else _quiet
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
    mimi = build_mimi(args, device)
    wrapper = MimiFTWrapper(mimi)
    clip_len = int(args.target_sr * args.target_duration) if not args.tiny else mimi.cfg.hop_length * 8

    # ----- data ------------------------------------------------------------
    if args.synthetic:
        clips = synthetic_clips(args.synthetic, clip_len, args.seed)
        tr_idx, va_idx = train_valid_split(len(clips), min(args.num_valid, len(clips) - 1), args.seed)

        def get_batch(idx):
            return clips[np.asarray(idx)]
    else:
        if not args.audio_dir:
            raise SystemExit("--audio_dir or --synthetic required")
        ds = AudioDataset(args.audio_dir, args.target_sr, clip_len / args.target_sr)
        tr_idx, va_idx = train_valid_split(len(ds), min(args.num_valid, len(ds) - 1), args.seed)

        def get_batch(idx):
            return np.stack([ds[int(i)] for i in idx])
    log(f"Dataset split: Train={len(tr_idx)}, Valid={len(va_idx)}")
    n_dp = dp_size(mesh)
    bs = max(n_dp, (args.batch_size // n_dp) * n_dp)
    if bs != args.batch_size:
        log(f"batch_size {args.batch_size} -> {bs} (divisible by {n_dp} devices)")

    # ----- optimizer: AdamW + warmup-cosine to lr / 100 ----------------------
    warmup_steps = args.warmup_epochs * args.steps_per_epoch
    total_steps = max(args.epochs * args.steps_per_epoch, warmup_steps + 1)
    schedule = warmup_cosine_decay(0.0, args.learning_rate, max(warmup_steps, 1), total_steps,
                                   args.learning_rate * 1e-2)
    orig = bridge.mimi_ft_tree(wrapper)  # the frozen weights the deltas are taken against
    if args.resume_from:
        tree = ckpt.load_pytree(args.resume_from)
        for part, module in wrapper.trainable.items():
            bridge.load_mimi(module, tree[part])
    parts = PARTS if args.finetune_encoder else tuple(p for p in PARTS if p.startswith("dec"))
    state = init_state(wrapper, schedule=schedule, parts=parts)

    start_epoch = 0
    resume_path = os.path.join(args.output_dir, "checkpoint.msgpack")
    meta_path = os.path.join(args.output_dir, "checkpoint_meta.json")
    if os.path.exists(resume_path) and os.path.exists(meta_path):
        load_resume(resume_path, state)
        with open(meta_path) as f:
            start_epoch = json.load(f)["epoch"]
        log(f"resumed from {resume_path} at epoch {start_epoch}")
    same_on_all(mesh, start_epoch, "the epoch to resume at")

    # ----- augmenter + losses ----------------------------------------------
    augmenter = Augmenter(augs, augs_params, args.num_augmentations, args.target_sr, mesh=mesh) if augs else None
    audio_loss_fn = get_audio_loss(args.audio_loss_type, args.target_sr, mesh)
    code_loss_fn = get_code_loss(args.code_loss_type)
    step_kw = dict(audio_target_type=args.audio_target_type, code_target_type=args.code_target_type, mesh=mesh)
    step_plain = make_rcc_train_step(state, audio_loss_fn, code_loss_fn, args.audio_loss_weight,
                                     args.code_loss_weight, None, **step_kw)
    step_aug = make_rcc_train_step(state, audio_loss_fn, code_loss_fn, args.audio_loss_weight,
                                   args.code_loss_weight, augmenter, **step_kw) if augmenter else step_plain
    eval_step = make_rcc_eval_step(wrapper, audio_loss_fn, code_loss_fn, None, **step_kw)
    tm_augs = token_match_augs(args.val_token_match, args.target_sr)

    def tiled(vb):
        return np.concatenate([vb] * (-(-bs // vb.shape[0])))[:bs] if vb.shape[0] < bs else vb

    def run_eval(epoch):
        """The eval's numbers (on the first rank; the others return none)."""
        stats, cnt = {}, 0
        for s in range(0, len(va_idx), bs):
            idx = va_idx[s:s + bs]
            rows = len(idx)
            m, recon, pred = eval_step(torch.from_numpy(get_batch(rows_of(mesh, tiled(idx)))).to(device))
            recon, pred = gather_rows(recon, mesh), gather_rows(pred, mesh)
            if not lead:
                continue
            m = dict(zip(m, torch.stack(list(m.values())).tolist()))
            recon, pred = recon.cpu().numpy(), pred.cpu().numpy()
            m["sisnr"] = sisnr(pred[:rows], recon[:rows])
            m["snr"] = snr(pred[:rows], recon[:rows])
            m["stoi"] = float(np.mean([stoi(pred[i, :, 0], recon[i, :, 0], args.target_sr) for i in range(rows)]))
            pq = pesq_metric(pred[0, :, 0], recon[0, :, 0], args.target_sr)
            if pq is not None:
                m["pesq"] = float(pq)
            for k, v in m.items():
                stats[k] = stats.get(k, 0.0) + v * rows
            if cnt == 0:  # sample wavs
                write_wav(os.path.join(args.output_dir, f"{epoch:03d}_target.wav"), recon[0, :, 0], args.target_sr)
                write_wav(os.path.join(args.output_dir, f"{epoch:03d}_pred.wav"), pred[0, :, 0], args.target_sr)
            cnt += rows
        stats = {k: v / max(cnt, 1) for k, v in stats.items()}
        if lead and tm_augs:
            vb = torch.from_numpy(tiled(get_batch(va_idx[:max(1, min(bs, len(va_idx)))]))).to(device)
            codes = mimi.encode(vb)
            for name, fn, params in tm_augs:
                for prm in params:
                    gen = torch.Generator(device).manual_seed(args.seed)
                    tm = validation_token_match(wrapper, codes, aug_fn=lambda x, g, fn=fn, prm=prm: fn(x, prm, g),
                                                generator=gen)
                    stats[f"token_match_{name}_{prm}"] = float(tm.mean())
        return stats

    def synced() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    # ----- training loop ----------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for epoch in range(args.epochs):
        # drawn for the epochs a resume skips too, so that each epoch gets the uninterrupted run's batches
        # (JAX's loop draws after the skip: a resumed epoch draws epoch 0's indices)
        idxs = [rng.choice(tr_idx, size=bs, replace=len(tr_idx) < bs) for _ in range(args.steps_per_epoch)]
        if epoch < start_epoch:
            continue
        log(f"Epoch {epoch}/{args.epochs}")
        use_aug = augmenter is not None and 0 <= args.augmentation_start <= epoch
        step_fn = step_aug if use_aug else step_plain
        rows = []
        t_train = synced()
        for bi, idx in enumerate(idxs):
            batch = torch.from_numpy(get_batch(rows_of(mesh, idx))).to(device)
            gen = torch.Generator(device).manual_seed(args.seed + epoch * 100000 + bi)
            metrics = step_fn(batch, gen)
            rows.append(torch.stack(list(metrics.values())))
            if lead and (bi % 10 == 0 or bi == args.steps_per_epoch - 1):
                m = {k: round(v, 6) for k, v in zip(metrics, rows[-1].tolist())}
                m["lr"] = schedule(state.step)
                print(f"Epoch: [{epoch}] [{bi}/{args.steps_per_epoch}] {m}")
        train_s = synced() - t_train
        means = torch.stack(rows).cpu().double().sum(0) / len(rows)
        train_logs = dict(zip(metrics, means.tolist()))
        train_logs.update(epoch=epoch, train_s=train_s, train_steps=len(rows))

        if (epoch + 1) % args.eval_freq == 0:
            eval_logs = run_eval(epoch)
            log(f"Eval Epoch: [{epoch}] " + json.dumps({k: round(v, 5) for k, v in eval_logs.items()}))
            train_logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
        if not lead:
            continue
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(train_logs) + "\n")

        save_resume(resume_path, state)
        with open(meta_path, "w") as f:
            json.dump({"epoch": epoch + 1}, f)
        for part, module in wrapper.trainable.items():
            ckpt.save_delta(os.path.join(args.output_dir, f"epoch{epoch}_{part}_delta.msgpack"),
                            bridge.mimi_tree(module), orig[part])
        if (epoch + 1) % args.save_freq == 0:
            save_resume(os.path.join(args.output_dir, f"checkpoint{epoch:03d}.msgpack"), state)
    log(f"Training completed. Elapsed time: {(time.time() - t0) / 3600:.2f} hours.")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
