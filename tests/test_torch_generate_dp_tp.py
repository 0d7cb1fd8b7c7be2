"""Port parity, ``python -m wmar_tpu_torch.generate --dp/--tp/--sp/--pp`` on the CPU.

Two gloo ranks (``parallel.launch.spawn_ranks``, a ``file://`` rendezvous
under the test's directory, spawned once for the file) run ``generate.main``
for every case, and each case's tree must equal the one-rank run's: the
same codes and ``l0`` and p-values to rtol 1e-6, as
``tests/test_generate_dp.py`` asks of JAX. ``--dp 2`` runs tiny RAR on 3
rows (not a multiple of dp: the pad-and-trim path and the whole-batch noise
draw) with the packed and packed4 caches; ``--tp 2`` runs tiny Chameleon
text-to-image with the bf16 and packed caches, and with int4 weights at a
width whose int4 groups split over two ranks (``WIDE_TINY``); ``--sp 2``
and ``--pp 2`` run it with the ring's and the pipeline's prefill.
(``--sp 2 --tp 2`` over four ranks: ``tests/test_torch_parallel_sp_pp.py``.)
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from wmar_tpu_torch import generate
from wmar_tpu_torch.models import chameleon, chameleon_interleaved
from wmar_tpu_torch.parallel import make_mesh
from wmar_tpu_torch.parallel.launch import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402

RAR = ["--tiny", "--model", "rar", "--conditioning", "0,1,2", "--batch_size", "3", "--wm_delta", "4.0",
       "--seed", "7", "--no_augs", "--device", "cpu"]


def _chameleon(prompts):
    return ["--tiny", "--model", "chameleon7b", "--conditioning", prompts, "--batch_size", "2", "--wm_delta", "4.0",
            "--seed", "7", "--no_augs", "--device", "cpu"]


# The --tiny Chameleon at dim 256, 2 heads of 64 a rank of tp 2: wo's 2 groups of 128 and w2's 6 split over 2
WIDE_TINY = dict(dim=256, n_layers=2, n_heads=4, multiple_of=128)


def _cases(workdir):
    """``{name: (argv of both runs, the ranks' flags, the tiny Chameleon's Llama or None)}``."""
    prompts = os.path.join(workdir, "prompts.txt")
    return {
        "dp_packed": (RAR + ["--cache_dtype", "packed"], ["--dp", "2"], None),
        "dp_packed4": (RAR + ["--cache_dtype", "packed4"], ["--dp", "2"], None),
        "tp_bf16": (_chameleon(prompts) + ["--cache_dtype", "bf16"], ["--tp", "2"], None),
        "tp_packed": (_chameleon(prompts) + ["--cache_dtype", "packed"], ["--tp", "2"], None),
        "tp_int4": (_chameleon(prompts) + ["--weight_dtype", "int4"], ["--tp", "2"], WIDE_TINY),
        "sp": (_chameleon(prompts), ["--sp", "2"], None),
        "pp": (_chameleon(prompts), ["--pp", "2"], None),
    }


def _collect(outdir):
    recs = {os.path.relpath(p, outdir): json.load(open(p)) for p in sorted(glob.glob(os.path.join(outdir, "c=*", "*.json")))}
    codes = {os.path.relpath(p, outdir): np.load(p).ravel().tolist()
             for p in sorted(glob.glob(os.path.join(outdir, "c=*", "*.npy")))}
    return recs, codes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp_tp"))
    with open(os.path.join(workdir, "prompts.txt"), "w") as f:
        f.write("a red car\nthe sea\n")
    cases = _cases(workdir)
    spawn_ranks(ranks.generate_rank, 2, "gloo", f"file://{workdir}/rendezvous",
                args=(os.path.join(workdir, "ranks"),
                      {name: (base + flags, tiny) for name, (base, flags, tiny) in cases.items()}))
    torch.set_num_threads(1)
    for name, (base, _, tiny) in cases.items():
        ranks.run_generate(base + ["--outdir", os.path.join(workdir, "one", name)], tiny)
    return workdir


@pytest.mark.parametrize("case", ["dp_packed", "dp_packed4", "tp_bf16", "tp_packed", "tp_int4", "sp", "pp"])
def test_two_ranks_equal_one(runs, case):
    recs1, codes1 = _collect(os.path.join(runs, "one", case))
    recs2, codes2 = _collect(os.path.join(runs, "ranks", case))
    assert codes1 and recs1.keys() == recs2.keys()
    assert codes1 == codes2
    for rel, rec in recs1.items():
        assert rec["l0"] == recs2[rel]["l0"]
        assert np.isclose(rec["pvalue"], recs2[rel]["pvalue"], rtol=1e-6)


@pytest.mark.parametrize("extra,match", [
    (["--sp", "2", "--model", "chameleon7b"], "needs 2 ranks, this run has 1"),
    (["--pp", "2", "--model", "chameleon7b"], "needs 2 ranks, this run has 1"),
    (["--tp", "2"], "chameleon7b TP path"),
    (["--dp", "2"], "needs 2 ranks, this run has 1"),
    (["--dp", "0", "--tp", "2", "--model", "chameleon7b"], "needs 2 ranks, this run has 1"),
], ids=["sp", "pp", "tp_rar", "dp_one_process", "tp_one_process"])
def test_refusals(tmp_path, extra, match):
    """A multi-rank run in one process exits naming the ranks it needs;
    ``--tp`` on a model without a Llama exits as in JAX."""
    with pytest.raises(SystemExit, match=match):
        generate.main(RAR + extra + ["--outdir", str(tmp_path)])


@pytest.mark.parametrize("extra", [["--sp", "2", "--pp", "2"], ["--interleaved", "PROMPTS", "--sp", "2"]],
                         ids=["int4", "interleaved"])
def test_tp_refusals_name_their_item(tmp_path, extra):
    """The two flag sets JAX runs wrongly exit before anything is built,
    each naming its fault of ROADMAP section 3: ``--sp`` with ``--pp``
    (JAX's prefill drops the ring, fault (r)) and ``--interleaved`` with a
    multi-rank flag (JAX ignores it, fault (q)). (The ids are those of the
    refusals that stood here before ``--tp`` took int4 weights.)"""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a cat\n")
    argv = _chameleon(str(prompts)) + [str(prompts) if a == "PROMPTS" else a for a in extra]
    fault = "r" if "--pp" in extra else "q"
    with pytest.raises(SystemExit, match=rf"fault \({fault}\)"):
        generate.main(argv + ["--outdir", str(tmp_path)])


def test_wrapper_refuses_what_tp_does_not_take():
    """The wrapper shards int4 weights where their groups line up with the
    rank's heads (a ``ValueError`` naming the shape at the tiny width, whose
    ``wo`` is one group), and both interleaved samplers refuse a tp shard."""
    from wmar_tpu_torch.models import quantize_llama_params_int8

    args = generate.get_parser().parse_args(_chameleon("x") + ["--outdir", "unused"])
    wrapper = generate.load_chameleon(args, torch.device("cpu"))
    int4 = quantize_llama_params_int8(wrapper.llama_params, bits=4)
    wrapper.llama_params, plain = int4, wrapper.llama_params
    with pytest.raises(ValueError, match=r"\(1, 16, 32\) does not split over tp=2"):
        wrapper.shard(make_mesh(dp=1, tp=2, rank=0))
    wrapper.llama_params = plain
    wrapper.shard(make_mesh(dp=1, tp=2, rank=1))
    assert wrapper.llama_params["blocks"][0]["wq"].shape[1] == plain["blocks"][0]["wq"].shape[1] // 2
    from wmar_tpu_torch.models import GenParams

    for sampler in (chameleon_interleaved.sample_interleaved_fused, chameleon_interleaved.sample_interleaved):
        with pytest.raises(NotImplementedError, match=chameleon.TP_INTERLEAVED.replace("(", r"\(").replace(")", r"\)")):
            sampler(wrapper, "x", GenParams(greedy=True))


def test_chip_smoke_multirank_phase_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke``'s multi-rank phase at a tiny width on the CPU: the
    sharded kernels' checks (plain versions), then two gloo ranks running
    ``generate.main --dp 2`` on tiny RAR and Chameleon t2i at ``--tp 2``
    from files (rebuilt in each rank from the parent's tensors), beside the
    parent's ``--dp 1``: equal RAR trees, and the ``--tp 2`` float32
    teacher-forced logits within the phase's bound of one rank's; then part
    (d): ``--tp 2`` with int4 weights (its gate, and the gate failing with
    one rank's part of ``w2`` dropped), ``--sp 2`` and ``--pp 2``."""
    import chip_smoke
    from wmar_tpu_torch import models as tmodels
    from wmar_tpu_torch.models import llama as tllama

    # 2 heads of 64 a rank: wo's 2 int4 groups of 128 and w2's 6 split over (d1)'s two ranks
    tiny = tmodels.LlamaConfig(dim=256, n_layers=2, n_heads=4, vocab_size=65536, multiple_of=128)
    for module in (tmodels, tllama):  # the file route sets and restores both
        monkeypatch.setattr(module, "CHAMELEON_7B", tiny)
    monkeypatch.setattr(tmodels, "CHAMELEON_F16", tmodels.VQGANConfig(
        resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32, n_embed=8192,
        embed_dim=8))
    wrapper, _ = chip_smoke.build_chameleon_from_files("cpu", str(tmp_path), n_layers=2)
    out = chip_smoke.phase_multirank("cpu", wrapper, str(tmp_path / "chameleon"), str(tmp_path / "ranks"),
                                     n_classes=3, shapes=(("RAR-XL", 4, 40, 8, 16), ("Chameleon-7B", 6, 1030, 8, 16)))
    assert out["backend"] == "gloo" and len(out["ranks"]) == 2
    assert out["rar"] == {"records": 6, "tokens_equal": True}
    cham = out["chameleon"]
    assert cham["records"] == 2 and cham["forced_f32_rel"] <= chip_smoke.SHARDED_F32_REL
    assert cham["forced_f32_rel"] < cham["bf16_vs_f32_rel"] / 100  # float32 leaves bf16's rounding far behind
    assert set(out["sharded_kernels"]) == {"RAR-XL packed4", "RAR-XL packed", "Chameleon-7B packed4",
                                           "Chameleon-7B packed"}
    par = out["parallel"]  # (d): int4 --tp 2, its gate refusing the mutation, --sp 2 and --pp 2
    assert par["int4"]["forced_f32_rel"] <= chip_smoke.SHARDED_F32_REL < par["int4"]["mutated_f32_rel"]
    for name in ("sp2", "pp2"):
        assert max(par[name].values()) <= chip_smoke.PARALLEL_F32_REL


def _tree(codes, l0=5, p=0.25):
    return {"c=0/a_roundtrips_0.json": (p, l0, np.asarray(codes))}


@pytest.mark.parametrize("got,match", [
    (_tree([1, 2, 3]), None),
    (_tree([1, 2, 4]), "from step 2"),
    (_tree([1, 2, 3], l0=6), "l0"),
    (_tree([1, 2, 3], p=0.25 * (1 + 1e-5)), "p-value"),
    ({"c=1/a_roundtrips_0.json": (0.25, 5, np.asarray([1, 2, 3]))}, "differ in files"),
], ids=["equal", "codes", "l0", "pvalue", "files"])
def test_chip_smoke_dp_tree_gate_raises_on_any_difference(got, match):
    """The multi-rank phase holds ``--dp 2``'s tree to ``--dp 1``'s with no
    fallback: other codes (named by their first diverging step), another
    ``l0``, a p-value off by more than rtol 1e-6, or other files raise."""
    import chip_smoke

    ref = _tree([1, 2, 3])
    if match is None:
        assert chip_smoke._compare_trees("t", ref, got) == {"records": 1, "tokens_equal": True}
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke._compare_trees("t", ref, got)


@pytest.mark.parametrize("moved", [0.0, 2e-5, 1e-3], ids=["same", "within", "past"])
def test_chip_smoke_tp_logit_gate(moved):
    """``sharded_logit_gate`` passes float32 logits within ``SHARDED_F32_REL``
    of the largest |logit| and raises past it; the bf16 numbers are reported
    (the first step whose argmax parts among them)."""
    import chip_smoke

    g = torch.Generator().manual_seed(3)
    want = {"f32": torch.randn((6, 40), generator=g) * 10}
    want["bf16"] = want["f32"].bfloat16().float()
    scale = float(want["f32"].abs().max())
    got = {"f32": want["f32"].clone(), "bf16": want["bf16"].clone()}
    got["f32"][4, 7] += moved * scale
    got["bf16"][3] = -got["bf16"][3]  # step 3's argmax moves
    if moved > chip_smoke.SHARDED_F32_REL:
        with pytest.raises(AssertionError, match="float32 teacher-forced logits"):
            chip_smoke.sharded_logit_gate("t", got, want)
        return
    out = chip_smoke.sharded_logit_gate("t", got, want)
    assert out["forced_f32_rel"] == pytest.approx(moved, abs=1e-7)
    assert out["bf16_argmax_first_parts"] == 3 and out["bf16_argmax_agree"] == pytest.approx(5 / 6)
