"""SyncSeal training entry point (PyTorch port of ``train_syncseal.py``,
the counterpart of the reference's ``syncseal/train_sync.py``).

Trains the reference-spec sync model, the UNet-yuv embedder and the
ConvNeXtV2 corner extractor, with the full objective (perceptual + hinge-GAN
+ detection BCE + corner MSE), two AdamW optimizers with optax's defaults
and cosine schedule, an optional linear scaling_w schedule and a
detector-only phase (train_sync.py:250-405). Writes ``log.jsonl``, copies of
the YAML configs under ``configs/``, ``syncmodel.msgpack`` in JAX's
``{"unet", "convnext"}`` layout (JAX's ``SyncSealRef.load`` reads it), the
resume checkpoint ``checkpoint.pt`` and ``eval_XXXX.json``.

Two faults of the JAX trainer are not copied: in a detector-only epoch no
optimizer step touches the UNet (JAX's adamw goes on decaying it and moving
it by its moments), and a resumed run ends where an uninterrupted one ends
(JAX's first resumed epoch draws the keys and batches of epoch 0). Every
draw of a step (the batch, the attacks, an eval's corners and noise) comes
from a generator seeded by ``(--seed, the step)``, so a run resumed at any
epoch draws what an uninterrupted run draws there.

    python -m wmar_tpu_torch.train_syncseal --output_dir out/ --synthetic true
    python -m wmar_tpu_torch.train_syncseal --output_dir out/ --synthetic true --tiny --device cpu

Data: a directory of images (png/jpg) or .npy arrays in [0, 1]; with
``--synthetic true`` procedural images. Runs on ``--device`` (default
``cuda``; there is no fallback).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

_DATA, _DRAWS, _EVAL = 0, 1, 2  # the streams of step_generator


def str2bool(v):
    return str(v).lower() in ("1", "true", "yes")


def get_parser():
    p = argparse.ArgumentParser(description="Train the reference-spec SyncSeal model")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_dir", default=None, help="dir of images or .npy in [0,1]")
    p.add_argument("--synthetic", type=str2bool, default=False, help="train on procedural images (smoke test)")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--scaling_w", type=float, default=0.2)
    p.add_argument("--scaling_w_min", type=float, default=None,
                   help="linear schedule target (train_sync.py scaling_w_schedule)")
    p.add_argument("--lambda_i", type=float, default=1.0)
    p.add_argument("--lambda_d", type=float, default=1.0)
    p.add_argument("--lambda_det", type=float, default=1.0)
    p.add_argument("--lambda_sync", type=float, default=10.0)
    p.add_argument("--disc_start", type=int, default=0)
    p.add_argument("--finetune_detector_start", type=int, default=10**9)
    p.add_argument("--tiny", action="store_true", help="tiny configs (smoke test)")
    p.add_argument("--dataset_config", default=None,
                   help="reference-grammar datasets yaml: train_dir/val_dir (train_sync.py:59)")
    p.add_argument("--embedder_config", default=None, help="reference-grammar embedder.yaml (train_sync.py:69)")
    p.add_argument("--extractor_config", default=None, help="reference-grammar extractor.yaml (train_sync.py:71)")
    p.add_argument("--attenuation_config", default=None,
                   help="reference-grammar attenuation.yaml (train_sync.py:73)")
    p.add_argument("--augmentation_config", default=None,
                   help="reference-grammar all_augs.yaml aug weights (train_sync.py:81)")
    p.add_argument("--resume", type=str2bool, default=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--eval_freq", type=int, default=5)
    p.add_argument("--sift_baseline", type=str2bool, default=None,
                   help="run the SIFT+RANSAC baseline in the evals (needs OpenCV); default: on unless --tiny")
    p.add_argument("--deterministic", type=str2bool, default=False,
                   help="deterministic CUDA algorithms (torch.use_deterministic_algorithms), so two runs "
                        "give equal bits")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; there is no fallback")
    return p


def step_generator(seed: int, stream: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws of one stream."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class BatchSource:
    """The batch of each global step, a function of (seed, step): smooth
    random fields (uniform 16 x 16 upsampled bilinearly) with
    ``--synthetic``, else images drawn from ``--data_dir``."""

    def __init__(self, args):
        self.args = args
        self.paths = None
        if not (args.synthetic or not args.data_dir):
            self.paths = sorted(glob.glob(os.path.join(args.data_dir, "*.npy"))
                                + glob.glob(os.path.join(args.data_dir, "*.png"))
                                + glob.glob(os.path.join(args.data_dir, "*.jpg")))
            if not self.paths:
                raise SystemExit(f"no images found in {args.data_dir}")

    def _load(self, path):
        from wmar_tpu_torch.augmentations.geometric import resize_linear

        if path.endswith(".npy"):
            arr = np.load(path)
        else:
            from PIL import Image

            arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        x = torch.as_tensor(arr, dtype=torch.float32)
        if tuple(x.shape[:2]) != (self.args.img_size,) * 2:
            x = resize_linear(x[None], (self.args.img_size, self.args.img_size))[0]
        return x

    def batch(self, stream: int, step: int) -> torch.Tensor:
        from wmar_tpu_torch.augmentations.geometric import resize_linear

        a = self.args
        gen = step_generator(a.seed, stream, step)
        if self.paths is None:
            small = torch.rand(a.batch_size, 16, 16, 3, generator=gen)
            return resize_linear(small, (a.img_size, a.img_size))
        idx = torch.randint(0, len(self.paths), (a.batch_size,), generator=gen)
        return torch.stack([self._load(self.paths[i]) for i in idx.tolist()])


def _sift_available() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def set_deterministic() -> None:
    """Deterministic kernels: cuDNN's deterministic convolutions, PyTorch's
    deterministic index and scatter backward, a fixed cuBLAS workspace. An
    op without a deterministic kernel warns (``warn_only``) rather than
    stopping the run."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def main(argv=None, on_epoch_end=None) -> dict:
    """Train; returns ``{"log": [rows], "evals": {epoch: report}, "state":
    RefTrainState}``. ``on_epoch_end(epoch)``, where given, is called once
    an epoch's checkpoint and eval are written (a caller keeps a copy of
    the run there, to resume it as a stopped run)."""
    from wmar_tpu_torch.sync import configs as sync_configs
    from wmar_tpu_torch.sync import syncseal_models as sm
    from wmar_tpu_torch.sync.syncseal import (
        RefTrainConfig,
        SyncSealRef,
        evaluate_sync_ref,
        init_ref_train_state,
        make_ref_train_steps,
        scaling_w_at,
    )

    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_syncseal: --device cuda but no CUDA card is visible; pass --device cpu to run on "
                         "the CPU")
    sift = (not args.tiny) if args.sift_baseline is None else args.sift_baseline
    if sift and not _sift_available():
        raise SystemExit("train_syncseal: the evals' SIFT+RANSAC baseline needs OpenCV (cv2), which is not "
                         "installed: pass --sift_baseline false to train without it")
    if args.deterministic:
        set_deterministic()
    os.makedirs(args.output_dir, exist_ok=True)

    if args.tiny:
        unet_cfg = sm.UNetConfig(z_channels=8, num_blocks=1, z_channels_mults=(1, 2), norm_groups=4)
        cn_cfg = sm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16))
    else:
        unet_cfg, cn_cfg = sm.UNET_SMALL2_YUV, sm.CONVNEXT_TINY

    # reference-grammar yaml configs override the defaults (train_sync.py:59-82) and are
    # copied into the run's directory (train_sync.py:197-201)
    if args.dataset_config:
        ds = sync_configs.load_dataset_config(args.dataset_config)
        if not args.data_dir:
            args.data_dir = ds["train_dir"]
    aug_weights = None
    cfg_out = os.path.join(args.output_dir, "configs")
    for flag, loader, saved in (
        ("embedder_config", sync_configs.load_embedder_config, "embedder.yaml"),
        ("extractor_config", sync_configs.load_extractor_config, "extractor.yaml"),
        ("attenuation_config", sync_configs.load_attenuation_config, "attenuation.yaml"),
        ("augmentation_config", sync_configs.load_augs_config, "augs.yaml"),
    ):
        path = getattr(args, flag)
        if path is None:
            continue
        val = loader(path)
        if flag == "embedder_config":
            unet_cfg = val
        elif flag == "extractor_config":
            cn_cfg = val
        elif flag == "augmentation_config":
            aug_weights = val
        if not isinstance(unet_cfg, sm.UNetConfig) or not isinstance(cn_cfg, sm.ConvNeXtConfig):
            raise NotImplementedError(f"{path}: the trainer trains the UNet embedder and the ConvNeXt extractor; "
                                      "the zoo's VAE and SAM variants are not wired into SyncSealRef")
        os.makedirs(cfg_out, exist_ok=True)
        shutil.copyfile(path, os.path.join(cfg_out, saved))

    model = SyncSealRef.init(args.seed, unet_cfg=unet_cfg, convnext_cfg=cn_cfg, device=device)
    cfg = RefTrainConfig(scaling_w=args.scaling_w, scaling_w_min=args.scaling_w_min, schedule_epochs=args.epochs,
                         lambda_i=args.lambda_i, lambda_d=args.lambda_d, lambda_det=args.lambda_det,
                         lambda_sync=args.lambda_sync, disc_start=args.disc_start,
                         finetune_detector_start=args.finetune_detector_start)
    state = init_ref_train_state(model, args.lr, args.epochs * args.steps_per_epoch, seed=args.seed)
    perceptual = None
    if args.lambda_i > 0 and not args.tiny:
        from wmar_tpu_torch.finetune.perceptual import PerceptualLoss

        perceptual = PerceptualLoss()  # the weight-free pyramid: no LPIPS weights in the repository
    model_step, disc_step = make_ref_train_steps(
        state, cfg, perceptual=perceptual or (lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))),
        aug_weights=aug_weights)

    ckpt_path = os.path.join(args.output_dir, "checkpoint.pt")
    start_epoch = 0
    if args.resume and os.path.exists(ckpt_path):
        with open(ckpt_path + ".json") as f:
            start_epoch = json.load(f)["epoch"] + 1
        state.load_state_dict(torch.load(ckpt_path, map_location=device, weights_only=True))
        print(f"resumed from epoch {start_epoch - 1}")

    source = BatchSource(args)
    log_path = os.path.join(args.output_dir, "log.jsonl")
    log, evals = [], {}
    for epoch in range(start_epoch, args.epochs):
        sw = scaling_w_at(cfg, epoch)
        detector_only = epoch >= cfg.finetune_detector_start
        t0 = time.perf_counter()
        metrics = {}
        for step in range(args.steps_per_epoch):
            gstep = epoch * args.steps_per_epoch + step
            imgs = source.batch(_DATA, gstep).to(device)
            disc_factor = 1.0 if gstep >= cfg.disc_start else 0.0
            metrics = model_step(imgs, sw, disc_factor, detector_only,
                                 generator=step_generator(args.seed, _DRAWS, gstep))
            if not detector_only:
                metrics.update(disc_step(imgs, sw, disc_factor))
        row = {"epoch": epoch, "scaling_w": float(sw), "detector_only": detector_only,
               **{k: float(v) for k, v in metrics.items()}}
        row["secs"] = time.perf_counter() - t0  # the float() reads above wait for the device
        print(json.dumps(row))
        log.append(row)
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")

        torch.save(state.state_dict(), ckpt_path)
        with open(ckpt_path + ".json", "w") as f:
            json.dump({"epoch": epoch}, f)
        model.save(os.path.join(args.output_dir, "syncmodel.msgpack"))

        if (epoch + 1) % args.eval_freq == 0 or epoch == args.epochs - 1:
            t0 = time.perf_counter()
            report = evaluate_sync_ref(model, source.batch(_EVAL, epoch).to(device),
                                       step_generator(args.seed, _EVAL, epoch), with_sift_baseline=sift)
            report["secs"] = time.perf_counter() - t0
            print("eval:", json.dumps(report["quality"]), "corner_mae[0]:", report["grid"][0]["corner_mae"])
            with open(os.path.join(args.output_dir, f"eval_{epoch:04}.json"), "w") as f:
                json.dump(report, f, indent=1)
            evals[epoch] = report
        if on_epoch_end is not None:
            on_epoch_end(epoch)
    return {"log": log, "evals": evals, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
