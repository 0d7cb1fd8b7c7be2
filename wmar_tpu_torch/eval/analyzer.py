"""Post-hoc results analysis: the reference Analyzer's numeric core.

The port's own copy of ``wmar_tpu.eval.analyzer`` (numpy; matplotlib is
imported inside the plots only), so it runs where JAX is not installed;
``rescore`` goes through the port's detection.

Walks the per-sample result tree written by the eval pipeline
(``c={cond},idx={k}/NNNN_{method}_{transform}_{param}.json``), aggregates
p-values / L0 / PSNR, and emits the robustness summaries the reference
prints from ``notebooks/analyze.ipynb`` (``wmar/utils/analyzer.py``):

* token-match stats after T round-trips (mean / median / frac > 0.8),
* TPR@1%FPR per attack at the canonical parameter points and per category
  (Valuemetric / Geometric / Adversarial Purification / Neural Compression),
* markdown + LaTeX tables.

TPR@alpha is ``mean(pvalue < alpha)`` — exact p-values are uniform under
H0, which is precisely how the reference thresholds (``analyzer.py:378``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

# (category, canonical param) per attack — ``analyzer.py:95-112``.
SUMMARY_METRICS = {
    "gaussian-blur": ("Valuemetric", 9),
    "gaussian-noise": ("Valuemetric", 0.1),
    "jpeg": ("Valuemetric", 25),
    "brightness": ("Valuemetric", 2),
    "rotation": ("Geometric", 10),
    "flip-h": ("Geometric", 1),
    "upperleft-crop": ("Geometric", 0.75),
    "diffpure": ("Adversarial Purification", 0.1),
    "neural-compress": ("Neural Compression", "q=3"),
}


@dataclasses.dataclass
class Record:
    conditioning: str
    idx: int
    method: str
    transform: str
    param: str
    metrics: dict


_FNAME = re.compile(r"^(\d+)_(.+?)_([^_]+)_([^_]+)\.json$")


def _read_one(path: str):
    dirname = os.path.basename(os.path.dirname(path))
    cond = dirname.split(",")[0][2:]
    m = _FNAME.match(os.path.basename(path))
    if not m:
        return None
    idx, method, transform, param = m.groups()
    with open(path) as f:
        metrics = json.load(f)
    return Record(cond, int(idx), method, transform, param, metrics)


def load_records(outdir: str, cache: bool = True, workers: int = 20) -> List[Record]:
    """Walk the result tree (same layout as the reference's Analyzer) with a
    thread pool and a JSON cache keyed on file count+mtime — the reference's
    20-thread cached walk (``wmar/utils/analyzer.py:45-86,177-235``)."""
    paths = sorted(glob.glob(os.path.join(outdir, "c=*,idx=*", "*.json")))
    cache_path = os.path.join(outdir, ".analyzer_cache.json")
    sig = [len(paths), max((os.path.getmtime(p) for p in paths), default=0.0)]
    if cache and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                blob = json.load(f)
            if blob.get("sig") == sig:
                return [Record(**r) for r in blob["records"]]
        except (json.JSONDecodeError, TypeError, KeyError):
            pass
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        records = [r for r in pool.map(_read_one, paths) if r is not None]
    if cache:
        try:
            with open(cache_path, "w") as f:
                json.dump({"sig": sig,
                           "records": [dataclasses.asdict(r) for r in records]}, f)
        except OSError:
            pass
    return records


def records_from_list(records: Sequence[dict]) -> List[Record]:
    """Adapt the in-memory record dicts returned by the eval pipeline."""
    out = []
    for r in records:
        metrics = {k: v for k, v in r.items()
                   if k not in ("conditioning", "idx", "method", "transform", "param")}
        out.append(Record(str(r["conditioning"]), r["idx"], r["method"],
                          r["transform"], str(r["param"]), metrics))
    return out


def tpr_at_fpr(pvals: np.ndarray, alpha: float = 0.01) -> float:
    pvals = np.asarray(pvals, dtype=np.float64)
    if len(pvals) == 0:
        return float("nan")
    return float((pvals < alpha).mean())


def token_match_stats(records: List[Record], roundtrip: int = 1) -> Dict[str, float]:
    """Token-match (1 - L0) distribution after ``roundtrip`` round-trips —
    the reference's ``plot_l0_hist`` numbers (mean / median / frac > 0.8)."""
    matches = [
        1.0 - r.metrics["l0"]
        for r in records
        if r.transform == "roundtrips" and str(r.param) == str(roundtrip) and "l0" in r.metrics
    ]
    if not matches:
        return {}
    arr = np.asarray(matches)
    return {
        "mean": float(arr.mean()),
        "median": float(np.median(arr)),
        "frac_above_0.8": float((arr > 0.8).mean()),
        "n": len(arr),
    }


def robustness_table(records: List[Record], alpha: float = 0.01) -> Dict[str, dict]:
    """Per-attack and per-category TPR@alpha at the canonical params."""
    by_key = defaultdict(list)
    for r in records:
        if "pvalue" in r.metrics and r.metrics["pvalue"] is not None:
            by_key[(r.transform, str(r.param))].append(r.metrics["pvalue"])

    per_attack = {}
    # No-attack = roundtrip 0.
    if ("roundtrips", "0") in by_key:
        per_attack["None"] = tpr_at_fpr(by_key[("roundtrips", "0")], alpha)
    for attack, (cat, param) in SUMMARY_METRICS.items():
        if attack == "neural-compress":
            # average all q=3-tier codecs
            vals = [
                tpr_at_fpr(v, alpha)
                for (t, p), v in by_key.items()
                if t == attack and "q=3" in p
            ]
            if vals:
                per_attack[attack] = float(np.mean(vals))
        elif (attack, str(param)) in by_key:
            per_attack[attack] = tpr_at_fpr(by_key[(attack, str(param))], alpha)

    cats = defaultdict(list)
    if "None" in per_attack:
        cats["None"].append(per_attack["None"])
    for attack, v in per_attack.items():
        if attack in SUMMARY_METRICS:
            cats[SUMMARY_METRICS[attack][0]].append(v)
    per_category = {c: float(np.mean(v)) for c, v in cats.items()}
    return {"per_attack": per_attack, "per_category": per_category}


def full_attack_grid(records: List[Record], alpha: float = 0.01) -> Dict[str, Dict[str, dict]]:
    """TPR@alpha + mean L0/PSNR for every (transform, param) cell."""
    cells = defaultdict(lambda: defaultdict(list))
    for r in records:
        cells[(r.transform, str(r.param))]["pvalue"].append(r.metrics.get("pvalue"))
        cells[(r.transform, str(r.param))]["l0"].append(r.metrics.get("l0"))
        cells[(r.transform, str(r.param))]["psnr"].append(r.metrics.get("psnr"))
    out: Dict[str, Dict[str, dict]] = defaultdict(dict)
    for (t, p), vals in cells.items():
        pv = [v for v in vals["pvalue"] if v is not None]
        l0 = [v for v in vals["l0"] if v is not None]
        ps = [v for v in vals["psnr"] if v is not None and np.isfinite(v)]
        out[t][p] = {
            "tpr": tpr_at_fpr(pv, alpha) if pv else None,
            "l0": float(np.mean(l0)) if l0 else None,
            "psnr": float(np.mean(ps)) if ps else None,
            "n": len(vals["pvalue"]),
        }
    return dict(out)


def markdown_table(table: Dict[str, dict], title: str = "TPR@1%FPR") -> str:
    """Github-style summary table like the reference's analyzer emit."""
    cats = table["per_category"]
    cols = ["None", "Valuemetric", "Geometric", "Adversarial Purification", "Neural Compression"]
    present = [c for c in cols if c in cats]
    lines = [
        f"| {title} | " + " | ".join(present) + " |",
        "|" + "---|" * (len(present) + 1),
        "| TPR | " + " | ".join(f"{cats[c]:.2f}" for c in present) + " |",
    ]
    return "\n".join(lines)


def latex_table(table: Dict[str, dict]) -> str:
    cats = table["per_category"]
    cols = ["None", "Valuemetric", "Geometric", "Adversarial Purification", "Neural Compression"]
    present = [c for c in cols if c in cats]
    header = " & ".join(present) + r" \\"
    row = " & ".join(f"{cats[c]:.2f}" for c in present) + r" \\"
    return "\n".join([r"\begin{tabular}{" + "c" * len(present) + "}", header, r"\midrule", row, r"\end{tabular}"])


def roc_points(pvals_watermarked, pvals_null):
    """ROC curve (FPR, TPR) + AUC from watermarked vs null p-values —
    the numeric core of the reference's ``plot_roc`` (``analyzer.py:241``).
    Thresholding p-values sweeps the operating point."""
    wm = np.sort(np.asarray(pvals_watermarked, dtype=np.float64))
    null = np.sort(np.asarray(pvals_null, dtype=np.float64))
    thresholds = np.unique(np.concatenate([[0.0], wm, null, [1.0]]))
    tpr = np.searchsorted(wm, thresholds, side="right") / max(len(wm), 1)
    fpr = np.searchsorted(null, thresholds, side="right") / max(len(null), 1)
    auc = float(np.trapezoid(tpr, fpr))
    return fpr, tpr, auc


# ---------------------------------------------------------------------------
# Plots + one-command report (the reference's presentation layer:
# plot_auc / plot_l0_hist / plot_robustness, ``wmar/utils/analyzer.py:
# 241,300,361-560``)
# ---------------------------------------------------------------------------


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc(pvals_by_method: Dict[str, np.ndarray], save_to: str,
             null_draws: int = 100000, seed: int = 0):
    """ROC per method. Exact p-values are U(0,1) under H0, so the null
    distribution is simulated (exactly what thresholding uniform p-values
    yields); AUC in the legend (analyzer.py:241-298)."""
    plt = _mpl()
    null = np.random.default_rng(seed).uniform(size=null_draws)
    fig, ax = plt.subplots(figsize=(6, 5))
    for method, pvals in pvals_by_method.items():
        fpr, tpr, auc = roc_points(pvals, null)
        ax.plot(fpr, tpr, label=f"{method} (AUC {auc:.3f})", linewidth=2)
    ax.plot([0, 1], [0, 1], "k--", linewidth=0.8, alpha=0.5)
    ax.set_xscale("log")
    ax.set_xlim(1e-4, 1)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def plot_token_match_hist(records: List[Record], save_to: str, roundtrip: int = 1,
                          bins: int = 40):
    """Histogram of token-match (1 - l0) after one round trip per method
    (analyzer.py plot_l0_hist:300-334)."""
    plt = _mpl()
    by_method = defaultdict(list)
    for r in records:
        if r.transform == "roundtrips" and str(r.param) == str(roundtrip) and "l0" in r.metrics:
            by_method[r.method].append(1.0 - r.metrics["l0"])
    fig, ax = plt.subplots(figsize=(6, 4))
    for method, vals in by_method.items():
        ax.hist(vals, bins=bins, range=(0, 1), alpha=0.55,
                label=f"{method} (mean {np.mean(vals):.3f})")
    ax.set_xlabel("token match after 1 round trip")
    ax.set_ylabel("count")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def plot_robustness(records: List[Record], save_to: str, alpha: float = 0.01):
    """Per-attack TPR@alpha curves over the parameter sweep
    (analyzer.py plot_robustness:361-560)."""
    plt = _mpl()
    by_attack = defaultdict(lambda: defaultdict(list))
    for r in records:
        if r.transform in ("roundtrips",) or "pvalue" not in r.metrics:
            continue
        by_attack[r.transform][r.param].append(r.metrics["pvalue"])
    attacks = sorted(by_attack)
    if not attacks:
        return
    ncols = min(4, len(attacks))
    nrows = -(-len(attacks) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.6 * nrows),
                             squeeze=False)
    for ai, attack in enumerate(attacks):
        ax = axes[ai // ncols][ai % ncols]
        items = list(by_attack[attack].items())
        try:
            items.sort(key=lambda kv: float(kv[0]))
            xs = [float(k) for k, _ in items]
            numeric = True
        except ValueError:
            xs = list(range(len(items)))
            numeric = False
        ys = [tpr_at_fpr(np.asarray(v), alpha) for _, v in items]
        ax.plot(xs, ys, "o-", markersize=3)
        ax.set_ylim(-0.03, 1.03)
        ax.set_title(attack, fontsize=9)
        if not numeric:
            ax.set_xticks(xs)
            ax.set_xticklabels([k for k, _ in items], rotation=90, fontsize=5)
    for ai in range(len(attacks), nrows * ncols):
        axes[ai // ncols][ai % ncols].axis("off")
    fig.suptitle(f"TPR@{alpha:g}", fontsize=11)
    fig.tight_layout()
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def plot_tpr_vs_bpp(records: List[Record], save_to: str, alpha: float = 0.01):
    """Neural-compression TPR as a function of the codec's exact bpp —
    the reference's bpp x-axis grid (analyzer.py:237-239,361-560). Needs
    ``bpp`` in the neural-compress rows (row_tags from the manager)."""
    plt = _mpl()
    per_codec = defaultdict(lambda: {"pvals": [], "bpp": []})
    for r in records:
        if r.transform != "neural-compress" or "pvalue" not in r.metrics:
            continue
        if "bpp" in r.metrics:
            per_codec[r.param]["bpp"].append(r.metrics["bpp"])
        per_codec[r.param]["pvals"].append(r.metrics["pvalue"])
    pts = []
    for codec, d in per_codec.items():
        if d["bpp"]:
            pts.append((float(np.mean(d["bpp"])),
                        tpr_at_fpr(np.asarray(d["pvals"]), alpha), codec))
    if not pts:
        return
    pts.sort()
    fig, ax = plt.subplots(figsize=(6, 4))
    fams = sorted({c.rsplit("-q=", 1)[0] for _, _, c in pts})
    for fam in fams:
        sel = [(b, t) for b, t, c in pts if c.startswith(fam)]
        ax.plot([b for b, _ in sel], [t for _, t in sel], "o-", label=fam)
    ax.set_xlabel("bits per pixel")
    ax.set_ylabel(f"TPR@{alpha:g}")
    ax.set_ylim(-0.03, 1.03)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(save_to, dpi=150)
    plt.close(fig)


def _figures(records: List[Record], report_dir: str, alpha: float) -> List[str]:
    """Every figure of the report; the markdown lines that show them."""
    lines = []
    by_method = defaultdict(list)
    for r in records:
        if r.transform == "roundtrips" and str(r.param) == "0" and "pvalue" in r.metrics:
            by_method[r.method].append(r.metrics["pvalue"])
    if by_method:
        plot_roc({m: np.asarray(v) for m, v in by_method.items()},
                 os.path.join(report_dir, "roc.png"))
        lines.append("![roc](roc.png)")
    plot_token_match_hist(records, os.path.join(report_dir, "token_match_hist.png"))
    lines.append("![token match](token_match_hist.png)")
    plot_robustness(records, os.path.join(report_dir, "robustness.png"), alpha)
    lines.append("![robustness](robustness.png)")
    if any(r.transform == "neural-compress" and "bpp" in r.metrics for r in records):
        plot_tpr_vs_bpp(records, os.path.join(report_dir, "tpr_vs_bpp.png"), alpha)
        lines.append("![tpr vs bpp](tpr_vs_bpp.png)")
    return lines


def write_report(outdir: str, report_dir: str = None, alpha: float = 0.01) -> str:
    """One-command report: tables + all figures from a result tree
    (the analyze.ipynb workflow as a function). Without matplotlib the
    report holds the tables alone and says so."""
    report_dir = report_dir or os.path.join(outdir, "report")
    os.makedirs(report_dir, exist_ok=True)
    records = load_records(outdir)
    if not records:
        raise SystemExit(f"no records under {outdir}")
    lines = [f"# Analysis of {outdir}", ""]
    table = robustness_table(records, alpha)
    lines += [markdown_table(table), "", "```latex", latex_table(table), "```", ""]
    tm = token_match_stats(records)
    lines += ["## Token match (1 round trip)",
              json.dumps(tm, indent=1), ""]
    try:
        _mpl()
    except ImportError:
        lines.append("(no figures: matplotlib is not installed)")
    else:
        lines += _figures(records, report_dir, alpha)
    path = os.path.join(report_dir, "report.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


_FNAME_NPY = re.compile(r"^(\d+)_(.+?)_([^_]+)_([^_]+)\.npy$")


def rescore(
    outdir: str,
    vocab_size: int,
    torch_compat: bool = False,
    update: bool = False,
    device: str = "cuda",
) -> dict:
    """Bulk re-score every saved ``.npy`` code file in a result tree.

    The detection counterpart of the reference's analyzer re-walk: parse
    the watermark spec out of each filename's method string, score the codes
    (the port's ``detect`` over the hash greenlist on ``device``, or the
    torch-compat greenlists' detection, which runs on the host as the
    reference's does) and return ``{relpath: pvalue}``. With ``update=True`` the sidecar ``.json`` records are
    rewritten in place. Prints the max deviation from the stored p-values,
    so drift between generation-time and re-scored detection is visible.
    """
    import torch

    from wmar_tpu_torch.core.detect import detect
    from wmar_tpu_torch.core.greenlist import HashGreenlist, LazyTorchCompatGreenlist
    from wmar_tpu_torch.core.spec import WatermarkSpec

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA card is visible; pass --device cpu to run on the CPU")
    groups: Dict[tuple, list] = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(outdir, "c=*", "*.npy"))):
        m = _FNAME_NPY.match(os.path.basename(path))
        if not m:
            continue
        codes = np.load(path).ravel()
        groups[(m.group(2), codes.shape[0])].append((path, codes))

    out, max_dev, n_dev = {}, 0.0, 0
    for (method, t), items in groups.items():
        side = int(round(t ** 0.5))
        spatial_dim = side if side * side == t else 16
        spec = WatermarkSpec.from_string(method, vocab_size, spatial_dim=spatial_dim)
        codes = np.stack([c for _, c in items]).astype(np.int64)
        if torch_compat:
            pvals = LazyTorchCompatGreenlist(spec).detect_host(codes)
        else:
            pvals = detect(spec, HashGreenlist(spec, device=device), torch.as_tensor(codes, device=device))
        for (path, _), p in zip(items, pvals):
            rel = os.path.relpath(path, outdir)
            out[rel] = float(p)
            side_json = path[:-4] + ".json"
            if os.path.exists(side_json):
                with open(side_json) as f:
                    rec = json.load(f)
                if rec.get("pvalue") is not None:
                    max_dev = max(max_dev, abs(rec["pvalue"] - float(p)))
                    n_dev += 1
                if update:
                    rec["pvalue"] = float(p)
                    with open(side_json, "w") as f:
                        json.dump(rec, f)
    print(f"rescored {len(out)} code files (torch_compat={torch_compat}); "
          f"max |dp| vs {n_dev} stored records = {max_dev:.3e}")
    return out


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Analyze a wmar result tree")
    p.add_argument("outdir")
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--report_dir", default=None)
    p.add_argument("--rescore", action="store_true",
                   help="re-score the saved .npy codes")
    p.add_argument("--vocab_size", type=int, default=1024,
                   help="vocab for --rescore (taming 1024/16384, rar 1024, chameleon 65536)")
    p.add_argument("--torch_compat", action="store_true",
                   help="--rescore with torch-compat greenlists (detected on the host, whatever --device says)")
    p.add_argument("--device", default="cuda",
                   help="torch device of --rescore's hash-greenlist detection; never falls back to the CPU")
    p.add_argument("--update", action="store_true",
                   help="--rescore rewrites pvalues into the .json records")
    args = p.parse_args(argv)
    if args.rescore:
        rescore(args.outdir, args.vocab_size, args.torch_compat, args.update, args.device)
        return
    path = write_report(args.outdir, args.report_dir, args.alpha)
    print(f"report written to {path}")


if __name__ == "__main__":
    _main()
