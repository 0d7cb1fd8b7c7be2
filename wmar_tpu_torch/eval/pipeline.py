"""Generation -> attack -> detect evaluation pipeline (PyTorch).

Port of ``wmar_tpu.eval.pipeline``: sample a batch of watermarked codes,
decode to images, add the sync signal (with a ``sync_manager``), round-trip
them through the tokenizer, sweep the attack grid, re-tokenize (removing
the sync first), and compute p-value / L0 token mismatch / PSNR per
(transform, param, sample). The attacks run eagerly on the wrapper's
device (PIL's JPEG under ``exact_jpeg`` on the host), each (attack, param)
cell with a generator of its own.

Conditionings are class ids (RAR) or prompt strings (Chameleon); either
names its result directory. On a multi-GPU grid (``mesh``) every rank
samples: under dp its rows of the batch (:func:`sample_maybe_sharded`),
under tp its shard of the model; rank 0 gathers the codes, runs the round
trips, attacks and detection over the whole batch and alone writes files,
so the records equal a one-rank run's. Results go to the same on-disk tree as the JAX
package's, so either package's ``eval/analyzer.py`` reads them:

    outdir/c={cond},idx={k}/{k:04}_{method}_{transform}_{param}.{png,npy,json}
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wmar_tpu_torch.core.detect import detect
from wmar_tpu_torch.utils.metrics import l0_token_mismatch, psnr_pm1

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


def cell_seed(seed: int, attack_index: int, param_index: int) -> int:
    """The generator seed of one (attack, param) cell of a batch: JAX folds
    ``ai * 1000 + pi`` into the batch key after folding in 999."""
    return int(np.random.SeedSequence([seed, 999, attack_index * 1000 + param_index]).generate_state(1)[0])


def fill_batch_log(wrapper, codes: torch.Tensor, aug_manager, eval_params: EvalParams, seed: int = 0,
                   sync_manager=None) -> Log:
    """The ``{transform: [(param, codes, imgs)]}`` log of one batch: entry 0
    of "roundtrips" is the original (codes, image), entry t its t-th trip
    through the tokenizer; each attack of ``aug_manager`` re-tokenizes the
    attacked original. ``seed`` (the batch's) seeds every cell's generator.
    With a ``sync_manager`` the decoded images carry the sync signal (the
    logged and attacked original is the synced one) and every re-tokenize
    removes it first (``generate.py:111-164``)."""
    imgs = wrapper.codes_to_images(codes)  # [-1, 1] NHWC
    if sync_manager is not None:
        imgs = sync_manager.add_sync(imgs)
    unsync = sync_manager.remove_sync if sync_manager is not None else (lambda x: x)
    log: Log = {"roundtrips": [(0, _host(codes), _host(imgs))]}
    cur = imgs
    for t in range(1, eval_params.max_roundtrips + 1):
        cur_codes = wrapper.images_to_codes(unsync(cur))
        cur = wrapper.codes_to_images(cur_codes)
        log["roundtrips"].append((t, _host(cur_codes), _host(cur)))
    if aug_manager is None:
        return log
    imgs01 = imgs.float() / 2.0 + 0.5  # the attacks run in float32
    for ai, (name, fn, params) in enumerate(aug_manager.augs):
        rows = []
        for pi, param in enumerate(params):
            gen = torch.Generator(device=imgs01.device).manual_seed(cell_seed(seed, ai, pi))
            a = torch.clamp(fn(imgs01, param, gen), 0.0, 1.0) * 2.0 - 1.0
            rows.append((param, _host(wrapper.images_to_codes(unsync(a))), _host(a)))
        log[name] = rows
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
    row_tags: Optional[Dict] = None,
) -> List[dict]:
    """Metrics for every (transform, param, sample), saved in the reference's
    result tree. ``row_tags`` maps (transform, param) to extra fields of
    those records. Returns the flat list of metric records."""
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
            extra = (row_tags or {}).get((transform, param), {})
            for i in range(codes.shape[0]):
                metrics = dict(extra)
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


def sample_maybe_sharded(wrapper, batch, gen_params, apply_watermark: bool, generator, mesh=None) -> torch.Tensor:
    """Sample one batch; with a dp axis in ``mesh`` each rank samples its
    rows and the codes are gathered, JAX's ``_sample_maybe_sharded``.

    Integer (class) conditionings only. The rows are padded to a multiple
    of the dp size by repeating the last one, then trimmed. Every rank draws
    the unpadded batch's noise each step and keeps its rows
    (:func:`~wmar_tpu_torch.engine.decode.batch_rows`), so the codes equal
    the one-rank run's."""
    if mesh is None or mesh.dp == 1:
        return wrapper.sample(list(batch), gen_params, apply_watermark=apply_watermark, generator=generator)
    if not all(isinstance(c, (int, np.integer)) for c in batch):
        raise ValueError("--dp sharding requires integer (class) conditionings")
    from wmar_tpu_torch.engine.decode import batch_rows
    from wmar_tpu_torch.parallel import all_gather

    dp, n = mesh.dp, len(batch)
    ids = list(batch) + [batch[-1]] * ((-n) % dp)
    per = len(ids) // dp
    mine = range(mesh.axis_index("dp") * per, (mesh.axis_index("dp") + 1) * per)
    with batch_rows(n, [min(i, n - 1) for i in mine]):  # a padded row repeats the last row, noise and all
        codes = wrapper.sample([ids[i] for i in mine], gen_params, apply_watermark=apply_watermark,
                               generator=generator)
    return all_gather(codes, mesh, "dp", dim=0)[:n]


def batch_seed(seed: int, chunk_id: int, batch_index: int) -> int:
    """The generator seed of one batch, from (seed, chunk, batch): the chunk
    id enters as ``seed + 1000 * chunk_id``, as in JAX, so one batch draws
    other codes under another ``--num_chunks``."""
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
    mesh=None,
) -> List[dict]:
    """The reference's ``generate()`` driver: batch striping for chunk
    parallelism, a seed per batch, and per batch sample -> log (round trips
    and attacks) -> metrics -> save. On a multi-GPU ``mesh`` every rank
    samples and rank 0 alone does the rest; the other ranks return no
    records."""
    lead = mesh is None or mesh.rank == 0
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
        bseed = batch_seed(seed, chunk_id, bi)
        gen = torch.Generator(device=wrapper.device).manual_seed(bseed)
        t0 = time.perf_counter()
        codes = sample_maybe_sharded(wrapper, batch, gen_params, apply_watermark, gen, mesh)
        if codes.is_cuda:
            torch.cuda.synchronize(codes.device)
        t1 = time.perf_counter()
        if not lead:
            continue
        log_fn(f"batch {bi}: sampling took {t1 - t0:.2f}s")
        log = fill_batch_log(wrapper, codes, aug_manager, eval_params, bseed,
                             sync_manager)  # host copies: waits for the card
        t2 = time.perf_counter()
        records += compute_and_save_batch(
            log, outdir, method, list(batch), cond_indices,
            wrapper.watermark_spec, wrapper.greenlist, eval_params,
            row_tags=getattr(aug_manager, "row_tags", None),
        )
        log_fn(f"batch {bi}: round trips and attacks took {t2 - t1:.2f}s, "
               f"detection and files {time.perf_counter() - t2:.2f}s")
    return records
