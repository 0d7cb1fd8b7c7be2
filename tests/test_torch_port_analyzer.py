"""Port parity, the result analyzer: ``wmar_tpu_torch.eval.analyzer``
against ``wmar_tpu.eval.analyzer`` on the same trees.

Three trees: one the port's entry point writes (the tiny RAR through the
attack grid), one the JAX package's writer makes from a log of random
codes and images, and one of hand-written records with neural-compression
and DiffPure rows. On each, JAX's analyzer and the port's give equal
records, tables and report text; re-scoring the saved codes gives equal
p-values (within 1e-12; both are float64 ``betainc`` of equal counts).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wmar_tpu import native
from wmar_tpu.core.greenlist import HashGreenlist as JHashGreenlist
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.eval import analyzer as jan
from wmar_tpu.eval import pipeline as jpipe
from wmar_tpu_torch.eval import analyzer as tan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHOD = "linear-stratifiedrand-h=1-d=2.0-g=0.25"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test: the fast tier runs six workers on
    the machine's cores, where torch's default of a thread per core
    oversubscribes them and the many tiny ops of a grid wait on each other
    (a tiny grid run: 96 s against 3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tree(root, *extra):
    from wmar_tpu_torch import generate as tgen

    return tgen.main(["--model", "rar", "--tiny", "--device", "cpu", "--conditioning", "0,1,2",
                      "--batch_size", "3", "--max_roundtrips", "2", "--outdir", str(root), *extra])


def _jax_tree(root):
    """JAX's writer on a log of random codes and images (4 samples, the
    round trips and three attacks)."""
    rng = np.random.default_rng(0)
    spec = JSpec.from_string(METHOD, vocab_size=64, spatial_dim=4)

    def row(param):
        return (param, rng.integers(0, 64, (4, 16)).astype(np.int32),
                rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32))

    log = {"roundtrips": [row(0), row(1)], "jpeg": [row(100), row(25)], "rotation": [row(-5), row(10)],
           "brightness": [row(1), row(2)]}
    log["roundtrips"][1][1][:2] = log["roundtrips"][0][1][:2]  # two rows survive the round trip
    return jpipe.compute_and_save_batch(log, str(root), METHOD, [5, 5, 7, 9], [1, 2, 1, 1], spec,
                                        JHashGreenlist(spec), jpipe.EvalParams())


def _records_tree(root):
    """Hand-written records: every category of the summary, neural codecs
    at two rates with their bpp, DiffPure and a missing p-value."""
    rng = np.random.default_rng(1)
    for idx in range(1, 7):
        d = root / f"c=3,idx={idx}"
        d.mkdir(parents=True)
        rows = {
            f"{idx:04}_wm_roundtrips_0.json": {"pvalue": float(rng.uniform(0, 1e-3)), "l0": 0.0, "psnr": float("inf")},
            f"{idx:04}_wm_roundtrips_1.json": {"pvalue": float(rng.uniform(0, 0.05)), "l0": 0.2, "psnr": 31.5},
            f"{idx:04}_wm_gaussian-blur_9.json": {"pvalue": float(rng.uniform(0, 0.3)), "l0": 0.3, "psnr": 27.0},
            f"{idx:04}_wm_upperleft-crop_0.75.json": {"pvalue": float(rng.uniform(0, 0.5)), "l0": 0.6},
            f"{idx:04}_wm_diffpure_0.1.json": {"pvalue": float(rng.uniform(0, 0.9)), "l0": 0.7},
            f"{idx:04}_wm_neural-compress_bmshj2018-factorized-q=3.json": {
                "pvalue": float(rng.uniform(0, 0.3)), "l0": 0.4, "bpp": 0.5 + 0.01 * idx},
            f"{idx:04}_wm_neural-compress_cheng2020-anchor-q=3.json": {"pvalue": float(rng.uniform(0, 0.1)),
                                                                     "bpp": 0.4},
            f"{idx:04}_wm_neural-compress_bmshj2018-factorized-q=6.json": {"pvalue": None, "l0": 0.2, "bpp": 1.2},
            f"{idx:04}_other_flip-h_1.json": {"pvalue": float(rng.uniform(0, 1)), "l0": 0.5},
        }
        for name, metrics in rows.items():
            with open(d / name, "w") as f:
                json.dump(metrics, f)


def _same(a, b):
    """Equal, NaN equal to NaN (``json`` spells both alike)."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


@pytest.mark.parametrize("source", ["port", "jax", "records"])
def test_analyzers_agree_on_a_tree(source, tmp_path):
    """Records, robustness table, full grid, token-match stats and the
    markdown and LaTeX tables: the port's analyzer equals JAX's on a tree
    either package wrote."""
    root = tmp_path / "tree"
    {"port": _port_tree, "jax": _jax_tree, "records": _records_tree}[source](root)
    jrec, trec = jan.load_records(str(root), cache=False), tan.load_records(str(root), cache=False)
    assert len(trec) == len(jrec) > 0
    assert [dataclasses.asdict(r) for r in trec] == [dataclasses.asdict(r) for r in jrec]
    for alpha in (0.01, 0.1):
        table = tan.robustness_table(trec, alpha)
        assert _same(table, jan.robustness_table(jrec, alpha))
        assert _same(tan.full_attack_grid(trec, alpha), jan.full_attack_grid(jrec, alpha))
        assert tan.markdown_table(table) == jan.markdown_table(table)
        assert tan.latex_table(table) == jan.latex_table(table)
    for trip in (1, 2):
        assert _same(tan.token_match_stats(trec, trip), jan.token_match_stats(jrec, trip))
    if source == "port":
        table = tan.robustness_table(trec)
        assert set(table["per_attack"]) == {"None", "gaussian-blur", "gaussian-noise", "jpeg", "brightness",
                                            "rotation", "flip-h", "upperleft-crop"}
        assert len(trec) == 3 * (2 + 1 + 62)
    if source == "records":
        assert set(tan.robustness_table(trec)["per_category"]) == {
            "None", "Valuemetric", "Geometric", "Adversarial Purification", "Neural Compression"}


def test_records_from_list_and_the_cache_equal_jax(tmp_path):
    """The pipeline's returned records adapt alike; a cache the port writes
    is the one JAX reads back, and the reverse."""
    records = _port_tree(tmp_path / "tree")
    assert [dataclasses.asdict(r) for r in tan.records_from_list(records)] == \
           [dataclasses.asdict(r) for r in jan.records_from_list(records)]
    first = tan.load_records(str(tmp_path / "tree"))
    assert os.path.exists(tmp_path / "tree" / ".analyzer_cache.json")
    assert [dataclasses.asdict(r) for r in jan.load_records(str(tmp_path / "tree"))] == \
           [dataclasses.asdict(r) for r in first]


def test_tpr_and_roc_equal_jax():
    rng = np.random.default_rng(2)
    wm, null = rng.uniform(0, 0.02, 300) ** 2, rng.uniform(0, 1, 500)
    fpr, tpr, auc = tan.roc_points(wm, null)
    jfpr, jtpr, jauc = jan.roc_points(wm, null)
    np.testing.assert_array_equal(fpr, jfpr)
    np.testing.assert_array_equal(tpr, jtpr)
    assert auc == jauc and 0.9 < auc <= 1.0
    for alpha in (0.001, 0.01, 0.5):
        assert tan.tpr_at_fpr(wm, alpha) == jan.tpr_at_fpr(wm, alpha)
    assert np.isnan(tan.tpr_at_fpr([])) and np.isnan(jan.tpr_at_fpr([]))


def test_report_cli_with_and_without_matplotlib(tmp_path, monkeypatch):
    """``python -m wmar_tpu_torch.eval.analyzer <tree>`` writes JAX's report
    with its figures; where matplotlib cannot be imported the report holds
    the tables and says it has no figures."""
    root = tmp_path / "tree"
    _records_tree(root)
    run = subprocess.run([sys.executable, "-m", "wmar_tpu_torch.eval.analyzer", str(root), "--report_dir",
                          str(tmp_path / "port")], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    want = open(jan.write_report(str(root), str(tmp_path / "jax"))).read()
    assert open(tmp_path / "port" / "report.md").read() == want
    for fig in ("roc.png", "token_match_hist.png", "robustness.png", "tpr_vs_bpp.png"):
        assert (tmp_path / "port" / fig).exists(), fig
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    text = open(tan.write_report(str(root), str(tmp_path / "bare"))).read()
    assert "(no figures: matplotlib is not installed)" in text and "\\begin{tabular}" in text
    assert text.split("## Token match")[0] == want.split("## Token match")[0]
    assert not (tmp_path / "bare" / "roc.png").exists()


@pytest.mark.parametrize("compat", [False, True], ids=["hash", "torch_compat"])
def test_rescore_equals_jax(compat, tmp_path, monkeypatch):
    """Re-scoring the port's tree: the hash greenlist through the port's
    ``detect``, the torch-compat one through ``LazyTorchCompatGreenlist``
    (a ``rand`` split: the re-score knows no alive ids). Equal to the
    p-values the run stored and to JAX's re-score (its C++ scorer where
    built, and its other branch: within 1e-12, or 1e-4 relative where JAX
    detects with a float32 ``betainc``); the CLI with ``--update`` runs."""
    extra = ["--wm_split_strategy", "rand", "--wm_torch_compat", "true"] if compat else []
    _port_tree(tmp_path / "tree", "--no_augs", *extra)
    root = str(tmp_path / "tree")
    got = tan.rescore(root, vocab_size=128, torch_compat=compat, device="cpu")
    assert len(got) == 3 * 3
    for rel, p in got.items():
        with open(os.path.join(root, rel[:-4] + ".json")) as f:
            assert abs(json.load(f)["pvalue"] - p) <= 1e-12, rel
    for available in (native.available(), False):
        monkeypatch.setattr(native, "available", lambda a=available: a)
        want = jan.rescore(root, vocab_size=128, torch_compat=compat)
        assert got.keys() == want.keys()
        exact = compat or available  # else JAX's device detect: a float32 betainc
        np.testing.assert_allclose([got[k] for k in got], [want[k] for k in got], rtol=0 if exact else 1e-4,
                                   atol=1e-12 if exact else 0)
    run = subprocess.run([sys.executable, "-m", "wmar_tpu_torch.eval.analyzer", root, "--rescore", "--vocab_size",
                          "128", "--update", "--device", "cpu", *(["--torch_compat"] if compat else [])],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "rescored 9 code files" in run.stdout, run.stderr


def test_rescore_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """``rescore`` and its CLI default to ``--device cuda`` and exit, with no
    result, where no card is visible rather than moving to the CPU."""
    _port_tree(tmp_path / "tree", "--no_augs")
    root = str(tmp_path / "tree")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        tan.rescore(root, vocab_size=128)
    with pytest.raises(SystemExit, match="no CUDA card"):
        tan._main([root, "--rescore", "--vocab_size", "128"])
