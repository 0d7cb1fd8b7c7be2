"""Port parity, the native ngram scorer: the port's own build of
``ngram_scorer.cpp`` (``wmar_tpu_torch.native``) against its numpy / device
branch and against the JAX package's ``native.detect_native``, for the hash
greenlist (LINEAR, SPATIAL h = 1 and 3, FIXED), the torch-compat table, the
lazily built torch-compat rows (the key map) and FIXED seeding there.

Counts are integers and equal; p-values come from the same float64
``betainc`` of the same counts and are equal bit for bit. The port builds
into ``build/wmar_tpu_torch/native/`` and never into ``wmar_tpu/``.
"""

import numpy as np
import pytest
import torch

from wmar_tpu import native as jnative
from wmar_tpu.core import greenlist as jgl
from wmar_tpu.core.spec import SeedStrategy as JSeed
from wmar_tpu.core.spec import SplitStrategy as JSplit
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu_torch import native
from wmar_tpu_torch.core import greenlist as tgl
from wmar_tpu_torch.core.detect import pvalue_from_counts, score_codes
from wmar_tpu_torch.core.spec import SeedStrategy as TSeed
from wmar_tpu_torch.core.spec import SplitStrategy as TSplit
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the fast tier runs six workers on the
    machine's cores, where torch's default of a thread per core
    oversubscribes them and the tiny models' many small ops wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(seed, h, vocab=256, split="RANDOM", dim=8):
    kw = dict(vocab_size=vocab, context_size=h, delta=2.0, gamma=0.25, spatial_dim=dim)
    return (TSpec(seed_strategy=getattr(TSeed, seed), split_strategy=getattr(TSplit, split), **kw),
            JSpec(seed_strategy=getattr(JSeed, seed), split_strategy=getattr(JSplit, split), **kw))


def _codes(seed, b, t, vocab):
    codes = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)
    codes[0, t // 2:] = codes[0, : t - t // 2]  # repeated ngrams, so the dedup counts
    return codes


def test_builds_into_the_port_tree():
    path = native.library_path()
    assert path.exists() and "build/wmar_tpu_torch/native" in path.as_posix()
    assert "wmar_tpu/" not in path.as_posix().split("/build/")[-1] and native.SRC.parent.name == "native"


@pytest.mark.parametrize("seed,h", [("LINEAR", 1), ("LINEAR", 2), ("SPATIAL", 1), ("SPATIAL", 3), ("FIXED", 1)])
def test_hash_greenlist_counts_and_pvalues(seed, h):
    """Hash thresholds (and FIXED's one exact-size mask): the native counts
    equal the port's device ``score_codes`` on the CPU, and the p-values
    equal those and JAX's native ones bit for bit."""
    tspec, jspec = _specs(seed, h)
    codes = _codes(1, 5, 64, 256)
    tg = tgl.HashGreenlist(tspec)
    ng, ns = native.score_codes_native(tspec, tg, codes)
    want_g, want_s = score_codes(tspec, tg, torch.as_tensor(codes, dtype=torch.int64))
    np.testing.assert_array_equal(ng, want_g.numpy())
    np.testing.assert_array_equal(ns, want_s.numpy())
    got = native.detect_native(tspec, tg, codes)
    np.testing.assert_array_equal(got, pvalue_from_counts(want_g, want_s, tspec.gamma))
    np.testing.assert_array_equal(got, jnative.detect_native(jspec, jgl.HashGreenlist(jspec), codes))


def test_table_greenlist_counts_and_pvalues():
    """The torch-compat table (``--wm_torch_compat`` at a small vocabulary):
    int32-held words read as uint32, as JAX's table."""
    tspec, jspec = _specs("LINEAR", 1, vocab=64)
    codes = _codes(2, 3, 32, 64)
    tg = tgl.build_table_torch_compat(tspec)
    ng, ns = native.score_codes_native(tspec, tg, codes)
    want_g, want_s = score_codes(tspec, tg, torch.as_tensor(codes, dtype=torch.int64))
    np.testing.assert_array_equal(ng, want_g.numpy())
    np.testing.assert_array_equal(ns, want_s.numpy())
    np.testing.assert_array_equal(native.detect_native(tspec, tg, codes),
                                  jnative.detect_native(jspec, jgl.build_table_torch_compat(jspec), codes))


@pytest.mark.parametrize("seed,h,split", [("LINEAR", 1, "RANDOM"), ("SPATIAL", 1, "RANDOM_STRATIFIED"),
                                          ("FIXED", 1, "RANDOM")])
def test_lazy_torch_compat_detect_host_native_equals_numpy_and_jax(seed, h, split, monkeypatch):
    """``LazyTorchCompatGreenlist.detect_host``: the key-map kernel over rows
    built for exactly the batch's keys (FIXED: the one-row table) gives the
    numpy branch's p-values and JAX's bit for bit, and counts its calls;
    without a compiler the numpy branch runs."""
    tspec, jspec = _specs(seed, h, vocab=512, split=split)
    alive = np.arange(0, 512, 3)
    codes = _codes(3, 4, 64, 512)
    before = native.calls
    got = tgl.LazyTorchCompatGreenlist(tspec, alive_ids=alive).detect_host(codes)
    assert native.calls == before + 1
    want = jgl.LazyTorchCompatGreenlist(jspec, alive_ids=alive).detect_host(codes)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(native, "available", lambda: False)
    numpy_branch = tgl.LazyTorchCompatGreenlist(tspec, alive_ids=alive).detect_host(codes)
    assert native.calls == before + 1
    np.testing.assert_array_equal(got, numpy_branch)


def test_no_compiler_falls_back(monkeypatch):
    """A failed build leaves ``available()`` false and the scorer refusing;
    the analyzer's ``rescore`` then takes the device path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    assert not native.available()
    tspec, _ = _specs("LINEAR", 1)
    with pytest.raises(RuntimeError):
        native.score_codes_native(tspec, tgl.HashGreenlist(tspec), _codes(4, 1, 16, 256))


@pytest.mark.parametrize("torch_compat", [False, True])
def test_rescore_native_equals_device_and_jax(torch_compat, tmp_path, monkeypatch):
    """``analyzer.rescore`` over a small result tree: native, the port's
    other branch (the device path, or the numpy rows) and JAX's rescore give
    the same p-values bit for bit."""
    from wmar_tpu.eval import analyzer as janalyzer
    from wmar_tpu_torch.eval import analyzer as tanalyzer

    method = "linear-rand-h=1-d=2.0-g=0.25"
    rng = np.random.default_rng(5)
    for c in range(3):
        d = tmp_path / f"c={c},idx=1"
        d.mkdir()
        for t in ("roundtrips_0", "jpeg_50"):
            np.save(d / f"0001_{method}_{t}.npy", rng.integers(0, 128, 16).astype(np.int32))
    before = native.calls
    got = tanalyzer.rescore(str(tmp_path), 128, torch_compat=torch_compat, device="cpu")
    assert native.calls > before and len(got) == 6
    want = janalyzer.rescore(str(tmp_path), 128, torch_compat=torch_compat)
    assert got == {k: float(v) for k, v in want.items()}
    monkeypatch.setattr(native, "available", lambda: False)
    assert tanalyzer.rescore(str(tmp_path), 128, torch_compat=torch_compat, device="cpu") == got


def test_rescore_stratified_torch_compat_tree_with_alive_ids(tmp_path):
    """A ``generate --wm_torch_compat true`` tree under the default
    stratified split: ``rescore`` with the run's alive ids gives the stored
    p-values through the C++ scorer; without them the rows refuse the split,
    as JAX's ``rescore`` does on the same tree."""
    from wmar_tpu.eval import analyzer as janalyzer
    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.eval import analyzer as tanalyzer

    out = str(tmp_path / "tree")
    records = tgen.main(["--model", "taming", "--tiny", "--device", "cpu", "--no_augs", "--conditioning", "0,1",
                         "--batch_size", "2", "--wm_torch_compat", "true", "--outdir", out])
    before = native.calls
    got = tanalyzer.rescore(out, 128, torch_compat=True, device="cpu", alive_ids=np.arange(128))
    assert native.calls == before + 1 and len(got) == len(records) == 4
    stored = {f"c={r['conditioning']},idx={r['idx']}/{r['idx']:04}_{r['method']}_{r['transform']}_{r['param']}.npy":
              r["pvalue"] for r in records}
    assert got == stored
    with pytest.raises(ValueError, match="needs alive_ids"):
        tanalyzer.rescore(out, 128, torch_compat=True, device="cpu")
    with pytest.raises(ValueError, match="needs alive_ids"):
        janalyzer.rescore(out, 128, torch_compat=True)
