"""Generation -> round trip -> detect evaluation pipeline (PyTorch).

Port of ``wmar_tpu.eval.pipeline`` without the attack grid and sync
(ROADMAP queue 1, items 8, 11 and 12): sample a batch of watermarked codes,
decode to images, round-trip them through the tokenizer, re-tokenize, and
compute p-value / L0 token mismatch / PSNR per (transform, param, sample).

Results go to the same on-disk tree as the JAX package's, so
``wmar_tpu/eval/analyzer.py`` reads them as they are:

    outdir/c={cond},idx={k}/{k:04}_{method}_{transform}_{param}.{png,npy,json}
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from wmar_tpu_torch.core.detect import detect
from wmar_tpu_torch.utils.metrics import l0_token_mismatch, psnr_pm1

_NO_AUGS = "the attack grid is not ported yet (ROADMAP queue 1, items 8 and 12): pass aug_manager=None"
_NO_SYNC = "sync is not ported yet (ROADMAP queue 1, item 11): pass sync_manager=None"

Log = Dict[str, List[Tuple[Any, np.ndarray, np.ndarray]]]


@dataclasses.dataclass
class EvalParams:
    max_roundtrips: int = 1
    metric_names: Sequence[str] = ("pvalue", "l0", "psnr")
    orig_only: bool = False
    save_images: bool = True


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    return (x.float() if x.is_floating_point() else x).cpu().numpy()


def to_pillow(img_pm1: np.ndarray):
    """HWC [-1, 1] float -> PIL image."""
    from PIL import Image

    arr = np.clip((np.asarray(img_pm1) + 1.0) / 2.0 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def fill_batch_log(wrapper, codes: torch.Tensor, aug_manager, eval_params: EvalParams, sync_manager=None) -> Log:
    """The ``{transform: [(param, codes, imgs)]}`` log of one batch: entry 0
    of "roundtrips" is the original (codes, image), entry t its t-th trip
    through the tokenizer."""
    if aug_manager is not None:
        raise NotImplementedError(_NO_AUGS)
    if sync_manager is not None:
        raise NotImplementedError(_NO_SYNC)
    imgs = wrapper.codes_to_images(codes)  # [-1, 1] NHWC
    log: Log = {"roundtrips": [(0, _host(codes), _host(imgs))]}
    cur = imgs
    for t in range(1, eval_params.max_roundtrips + 1):
        cur_codes = wrapper.images_to_codes(cur)
        cur = wrapper.codes_to_images(cur_codes)
        log["roundtrips"].append((t, _host(cur_codes), _host(cur)))
    return log


def compute_and_save_batch(
    log: Log,
    outdir: str,
    method: str,
    conditionings: Sequence[Any],
    cond_indices: Sequence[int],
    spec,
    greenlist,
    eval_params: EvalParams,
) -> List[dict]:
    """Metrics for every (transform, param, sample), saved in the reference's
    result tree. Returns the flat list of metric records."""
    orig_codes = log["roundtrips"][0][1]
    orig_imgs = log["roundtrips"][0][2]
    device = greenlist.device if greenlist is not None else torch.device("cpu")
    records = []
    for transform, rows in log.items():
        for param, codes, imgs in rows:
            pvals = None
            if spec is not None and "pvalue" in eval_params.metric_names:
                pvals = detect(spec, greenlist, torch.as_tensor(codes, device=device))
            l0 = l0_token_mismatch(codes, orig_codes).numpy()
            for i in range(codes.shape[0]):
                metrics = {}
                if pvals is not None:
                    metrics["pvalue"] = float(pvals[i])
                if "l0" in eval_params.metric_names:
                    metrics["l0"] = float(l0[i])
                if "psnr" in eval_params.metric_names:
                    metrics["psnr"] = psnr_pm1(imgs[i], orig_imgs[i])
                records.append({
                    "conditioning": conditionings[i],
                    "idx": cond_indices[i],
                    "method": method,
                    "transform": transform,
                    "param": param,
                    **metrics,
                })
                if outdir and eval_params.orig_only:
                    if transform == "roundtrips" and param == 0:
                        os.makedirs(os.path.join(outdir, "images"), exist_ok=True)
                        os.makedirs(os.path.join(outdir, "codes"), exist_ok=True)
                        stem = f"{conditionings[i]}:{cond_indices[i]:04}"
                        to_pillow(imgs[i]).save(os.path.join(outdir, "images", stem + ".png"))
                        np.save(os.path.join(outdir, "codes", stem + ".npy"), codes[i])
                elif outdir:
                    cdir = os.path.join(outdir, f"c={conditionings[i]},idx={cond_indices[i]}")
                    os.makedirs(cdir, exist_ok=True)
                    stem = f"{cond_indices[i]:04}_{method}_{transform}_{param}"
                    if eval_params.save_images:
                        to_pillow(imgs[i]).save(os.path.join(cdir, stem + ".png"))
                    np.save(os.path.join(cdir, stem + ".npy"), codes[i])
                    with open(os.path.join(cdir, stem + ".json"), "w") as f:
                        json.dump(metrics, f)
    return records


def batch_seed(seed: int, chunk_id: int, batch_index: int) -> int:
    """The generator seed of one batch: a function of (seed, chunk, batch)
    only, so a batch samples the same codes however the run is chunked."""
    return int(np.random.SeedSequence([seed + 1000 * chunk_id, batch_index]).generate_state(1)[0])


def generate_and_evaluate(
    outdir: str,
    wrapper,
    all_conditionings: Sequence[Any],
    gen_params,
    eval_params: EvalParams,
    aug_manager,
    batch_size: int,
    seed: int = 42,
    chunk_id: int = 0,
    num_chunks: int = 1,
    apply_watermark: bool = True,
    sync_manager=None,
    log_fn=print,
) -> List[dict]:
    """The reference's ``generate()`` driver: batch striping for chunk
    parallelism, a seed per batch, and per batch sample -> log -> metrics ->
    save."""
    if aug_manager is not None:
        raise NotImplementedError(_NO_AUGS)
    if sync_manager is not None:
        raise NotImplementedError(_NO_SYNC)
    batches = [all_conditionings[i: i + batch_size] for i in range(0, len(all_conditionings), batch_size)]
    method = str(wrapper.watermark_spec) if (apply_watermark and wrapper.watermark_spec) else "none"

    counts: Dict[Any, int] = {}
    records = []
    for bi, batch in enumerate(batches):
        cond_indices = []
        for c in batch:
            counts[c] = counts.get(c, 0) + 1
            cond_indices.append(counts[c])
        if bi % num_chunks != chunk_id:
            continue
        gen = torch.Generator(device=wrapper.device).manual_seed(batch_seed(seed, chunk_id, bi))
        t0 = time.perf_counter()
        codes = wrapper.sample(list(batch), gen_params, apply_watermark=apply_watermark, generator=gen)
        if codes.is_cuda:
            torch.cuda.synchronize(codes.device)
        log_fn(f"batch {bi}: sampling took {time.perf_counter() - t0:.2f}s")
        log = fill_batch_log(wrapper, codes, None, eval_params)
        records += compute_and_save_batch(
            log, outdir, method, list(batch), cond_indices,
            wrapper.watermark_spec, wrapper.greenlist, eval_params,
        )
    return records
