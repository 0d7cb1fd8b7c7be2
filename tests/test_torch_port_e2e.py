"""Port parity, end to end: the tiny RarARMM through sample -> decode ->
re-encode -> detect against the JAX package, and the generate entry point.

Weights come from JAX PRNG keys (adaLN gates randomized, so attention
reaches the logits) and are bridged into the port. Tokens must be equal
with an f32 cache, both greedy and when the port is fed JAX's Gumbel noise;
with the packed4 cache, greedy tokens must agree on at least 95% of the
positions, the bound JAX's own packed-vs-int8 test sets.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.core.detect import detect as jax_detect
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.models import GenParams as JGenParams
from wmar_tpu.models import RarARMM as JRarARMM
from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import rar as jrar
from wmar_tpu_torch import bridge
from wmar_tpu_torch.core.detect import detect as port_detect
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.models import GenParams as TGenParams
from wmar_tpu_torch.models import RarARMM as TRarARMM
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import rar as trar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(embed_dim=32, depth=2, num_heads=2, intermediate_size=64, image_seq_len=16,
           codebook_size=32, num_classes=4)
VQ = dict(resolution=8, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
          z_channels=16, n_embed=32, embed_dim=16)
METHOD = "linear-rand-h=1-d=2.0-g=0.25"
CLASSES = np.array([0, 1, 2, 3, 1, 2])


def _pair(jax_cache, port_cache):
    cfg = jrar.RARConfig(**CFG)
    params = jrar.init_rar_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(9)
    params["blocks"] = [
        {**blk, "adaln": {"w": jnp.asarray(rng.standard_normal(blk["adaln"]["w"].shape) * 0.05, jnp.float32),
                          "b": blk["adaln"]["b"]}}
        for blk in params["blocks"]
    ]
    vq_cfg = jmg.MaskGitVQConfig(**VQ)
    vq_params = jmg.MaskGitVQGAN(vq_cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    jw = JRarARMM(params, cfg, vq_params, vq_cfg, cache_dtype=jax_cache)
    jw.set_watermarker(JSpec.from_string(METHOD, vocab_size=32, spatial_dim=4))

    rar = bridge.load_rar(trar.RAR(trar.RARConfig(**CFG)), jax.tree.map(np.asarray, params))
    vq = bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**VQ)), jax.tree.map(np.asarray, vq_params))
    tw = TRarARMM(rar, vq, cache_dtype=port_cache, device="cpu")
    tw.set_watermarker(TSpec.from_string(METHOD, vocab_size=32, spatial_dim=4))
    return jw, tw


def _gen(cls, **kw):
    return cls(guidance_scale=4.0, **kw)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (10, 0.9)])
def test_sample_decode_detect_fed_noise(top_k, top_p):
    """f32 cache, watermarked draws fed JAX's per-step noise
    (``gumbel(fold_in(rng, step))``): tokens equal; then decode (atol 1e-4),
    re-encode (codes equal) and detect (p-values at rtol 1e-4)."""
    jw, tw = _pair(jnp.float32, torch.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jw.sample(CLASSES, _gen(JGenParams, top_k=top_k, top_p=top_p), apply_watermark=True, rng=key))
    k = top_k or 32
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (len(CLASSES), k), jnp.float32))
                      for s in range(16)])
    got = tw.sample(CLASSES, _gen(TGenParams, top_k=top_k, top_p=top_p), apply_watermark=True,
                    noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), want)

    jimgs = jw.codes_to_images(jnp.asarray(want))
    timgs = tw.codes_to_images(got)
    np.testing.assert_allclose(timgs.numpy(), np.asarray(jimgs), atol=1e-4, rtol=0)
    jre = np.asarray(jw.images_to_codes(jimgs))
    tre = tw.images_to_codes(timgs)
    np.testing.assert_array_equal(tre.numpy(), jre)
    for codes_j, codes_t in ((want, got), (jre, tre)):
        pj = np.asarray(jax_detect(jw.watermark_spec, jw.greenlist, jnp.asarray(codes_j)), np.float64)
        pt = port_detect(tw.watermark_spec, tw.greenlist, codes_t)
        np.testing.assert_allclose(pt, pj, rtol=1e-4)


def test_sample_greedy_f32_tokens_equal():
    jw, tw = _pair(jnp.float32, torch.float32)
    want = np.asarray(jw.sample(CLASSES, _gen(JGenParams, greedy=True), apply_watermark=True,
                                rng=jax.random.PRNGKey(0)))
    got = tw.sample(CLASSES, _gen(TGenParams, greedy=True), apply_watermark=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_greedy_packed4_agreement():
    """packed4 cache: JAX runs its Pallas kernel in interpret mode (bf16
    dots), the port the kernel's plain float32 version; greedy tokens agree
    on >= 95% of the positions."""
    jw, tw = _pair("packed4", "packed4")
    want = np.asarray(jw.sample(CLASSES, _gen(JGenParams, greedy=True), apply_watermark=True,
                                rng=jax.random.PRNGKey(0)))
    got = tw.sample(CLASSES, _gen(TGenParams, greedy=True), apply_watermark=True).numpy()
    agree = float((got == want).mean())
    assert agree >= 0.95, f"greedy agreement {agree}"


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread for a test that runs the attack grid: the
    fast tier runs six workers on the machine's cores, where torch's default
    of a thread per core oversubscribes them and the grid's many tiny ops
    wait on each other (96 s against 3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generate_entry_point_result_tree(tmp_path):
    """``python -m wmar_tpu_torch.generate`` writes the same file names as
    JAX ``generate.py`` with the same flags, records and all."""
    argv = ["--model", "rar", "--tiny", "--no_augs", "--conditioning", "0,3",
            "--num_samples_per_conditioning", "2", "--batch_size", "3", "--max_roundtrips", "2",
            "--cache_dtype", "packed4"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    run = subprocess.run([sys.executable, "-m", "wmar_tpu_torch.generate", *argv, "--device", "cpu",
                          "--outdir", str(port_out)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "wrote 12 records" in run.stdout
    sys.path.insert(0, REPO)
    try:
        import generate
    finally:
        sys.path.remove(REPO)
    generate.main(argv + ["--outdir", str(jax_out)])
    assert _tree(port_out) == _tree(jax_out)
    assert len(_tree(port_out)) == 4 * 3 * 3


def test_chip_smoke_phases_on_cpu():
    """``chip_smoke.py``'s kernel and main-path phases at a tiny size on the
    CPU, where the kernel wrapper takes its plain version: every check of
    theirs passes, so the script's own logic is tested before the card."""
    import chip_smoke

    kern = chip_smoke.phase_kernels("cpu", b=4, t=10, h=2, shapes=(("tiny", 3, 20),), valid_lens=(1, 2, 5, 10))
    assert 0 < kern["max_abs_err"] < 2e-2
    wrapper = chip_smoke.build_rar(
        "cpu", trar.RARConfig(embed_dim=64, depth=2, num_heads=2, intermediate_size=128, image_seq_len=16,
                              codebook_size=64, num_classes=10),
        tmg.MaskGitVQConfig(**{**VQ, "n_embed": 64}))
    assert "w_q" in wrapper.rar.blocks[0].attn.qkv.params() and wrapper.cache_dtype == "packed4"
    out = chip_smoke.phase_main_path("cpu", wrapper, classes=8)
    # plain versions on the CPU: no kernel launches; the batches ran on both packed caches
    assert len(out["seconds"]) == 2 and set(out["launches"].values()) == {0}
    assert wrapper.cache_dtype == "packed4"
    assert out["green_fraction"] > 0.4 and 0 <= out["median_raw_pvalue"] <= 1


def _grid_tree_ok(root, n_samples, per_sample):
    """The tree holds ``n_samples x per_sample`` records, each a png, npy and json."""
    files = _tree(root)
    stems = {f.rsplit(".", 1)[0] for f in files}
    assert len(stems) == n_samples * per_sample and len(files) == 3 * len(stems)
    return files


def test_chip_smoke_attack_sweep_on_cpu(one_torch_thread):
    """``chip_smoke.py``'s attack-sweep phase with the CLI's tiny RAR and
    Taming on the CPU: both entry-point runs pass every gate of theirs
    (records and files, values, identity cells, the torch-compat table, the
    analyzer and its re-score) with no kernel launch."""
    import chip_smoke

    out = chip_smoke.phase_attack_sweep("cpu", tiny=True, n_rar=2, n_taming=2)
    assert set(out["runs"]) == {"RAR-XL", "Taming-1.4B"} and set(out["launches"].values()) == {0}
    for run in out["runs"].values():
        assert run["records"] == 2 * 64 and set(run["files"].values()) == {2 * 64}
        assert len(run["sample_s"]) == len(run["grid_s"]) == 1
        assert set(chip_smoke.SWEEP_ATTACKS) <= set(run["table"]["per_attack"])
    assert out["runs"]["Taming-1.4B"]["green_fraction"] > 0.4
    assert out["runs"]["RAR-XL"]["rescore_max_dp"] <= 1e-12


def test_generate_refuses_what_is_not_ported(tmp_path, one_torch_thread):
    """``--sp`` on a model without a Llama exits as JAX's entry point does
    (the sequence-parallel prefill, ported since, is the chameleon7b path); the
    clustering split, a run with the attack grid (no ``--no_augs``), the
    neural-compression and the DiffPure flags, which this test once saw
    refused, now run: with ``--no_augs`` those flags are accepted and
    ignored, as in JAX, and without it ``--include_diffpure`` without
    weights is refused in JAX's words."""
    from wmar_tpu_torch import generate as tgen

    base = ["--model", "rar", "--tiny", "--no_augs", "--outdir", str(tmp_path)]
    with pytest.raises(SystemExit, match="chameleon7b prefill path"):
        tgen.main(base + ["--device", "cpu", "--sp", "2"])
    for extra in (["--include_diffpure", "true"], ["--diffpure_weights", "w.pt"]):
        assert len(tgen.main(base + ["--device", "cpu"] + extra)) == 2
    with pytest.raises(SystemExit, match="--include_diffpure requires --diffpure_weights"):
        tgen.main([a for a in base if a != "--no_augs"] + ["--device", "cpu", "--include_diffpure", "true"])
    records = tgen.main(["--model", "rar", "--tiny", "--no_augs", "--device", "cpu", "--outdir", str(tmp_path / "nc"),
                         "--include_neural_compress", "true", "--nc_allow_random", "true"])
    assert len(records) == 2 and {r["transform"] for r in records} == {"roundtrips"}
    # sync is ported: without a checkpoint it is refused as JAX's SyncManager refuses it
    with pytest.raises(ValueError, match="WAM sync needs the wam_mit.pth checkpoint"):
        tgen.main(base + ["--device", "cpu", "--sync", "true"])
    with pytest.raises(SystemExit, match="text_tokenizer.json not found"):  # Chameleon's --modelpath is ported:
        # a directory without the tokenizer JSON is refused by name
        tgen.main(["--model", "chameleon7b", "--modelpath", "ckpt", "--device", "cpu", "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit, match="chameleon7b"):  # ported, but a Chameleon path, as in generate.py
        tgen.main(base + ["--device", "cpu", "--interleaved", "prompts.txt"])
    clus = tmp_path / "clustering"
    records = tgen.main(["--model", "rar", "--tiny", "--no_augs", "--device", "cpu", "--outdir", str(clus),
                         "--wm_seed_strategy", "fixed", "--wm_split_strategy", "clustering"])
    assert len(records) == 2 and all(0 <= r["pvalue"] <= 1 for r in records)
    assert all("fixed-clustering-h=1" in f for f in _grid_tree_ok(clus, 1, 2))
    grid = tmp_path / "grid"
    records = tgen.main(["--model", "rar", "--tiny", "--outdir", str(grid), "--device", "cpu"])
    assert len(records) == 64 and {r["transform"] for r in records} >= {"roundtrips", "jpeg", "rotation"}
    _grid_tree_ok(grid, 1, 64)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA"):
            tgen.main(base)


def test_parser_takes_every_flag_of_generate_py():
    """The five flags of ``generate.py`` that the port's parser lacked parse
    with its types and defaults."""
    from wmar_tpu_torch import generate as tgen

    sys.path.insert(0, REPO)
    try:
        import generate as jgen
    finally:
        sys.path.remove(REPO)
    flags = ("syncpath", "exact_jpeg", "nc_weights_dir", "nc_allow_random", "diffpure_weights")
    given = ["--syncpath", "s.ckpt", "--exact_jpeg", "true", "--nc_weights_dir", "w", "--nc_allow_random", "yes",
             "--diffpure_weights", "adm.msgpack"]
    for argv in ([], given):
        port = tgen.get_parser().parse_args(["--outdir", "o", *argv])
        ref = jgen.get_parser().parse_args(["--outdir", "o", *argv])
        assert {f: getattr(port, f) for f in flags} == {f: getattr(ref, f) for f in flags}


def test_generate_takes_syncpath_none_and_refuses_the_rest(tmp_path, one_torch_thread):
    """``--syncpath none --sync false`` (what the sweep configs pass) runs,
    and so does a ``--syncpath`` without ``--sync true`` (ignored, as in
    JAX), and so do ``--nc_weights_dir`` and ``--nc_allow_random`` under
    ``--no_augs`` (ported; ignored there, as in JAX), and so does
    ``--diffpure_weights``, which this test once saw refused (ported;
    ignored under ``--no_augs``, as in JAX). ``--exact_jpeg true``, which
    this test once saw refused, runs the grid with PIL's JPEG."""
    from wmar_tpu_torch import generate as tgen

    base = ["--model", "taming", "--tiny", "--device", "cpu", "--no_augs", "--conditioning", "0,1",
            "--batch_size", "2", "--outdir", str(tmp_path)]
    records = tgen.main(base + ["--syncpath", "none", "--sync", "false", "--exact_jpeg", "false",
                                "--nc_allow_random", "false"])
    assert len(records) == 4
    assert len(tgen.main(base + ["--syncpath", "sync.ckpt"])) == 4
    for extra in (["--nc_weights_dir", "w"], ["--nc_allow_random", "true"]):
        assert len(tgen.main(base + extra)) == 4
    assert len(tgen.main(base + ["--diffpure_weights", "adm.msgpack"])) == 4
    out = tmp_path / "exact_jpeg"
    records = tgen.main([a for a in base if a != "--no_augs"][:-1] + [str(out), "--exact_jpeg", "true"])
    assert len(records) == 2 * 64 and sum(r["transform"] == "jpeg" for r in records) == 2 * 11
    _grid_tree_ok(out, 2, 64)


@pytest.mark.parametrize("model,asset,cls", [("taming", "assets/vqgan_alive_ids.txt", "TamingARMM"),
                                             ("rar", "assets/rar_all_ids.txt", "RarARMM")])
def test_full_size_loaders_pass_the_alive_ids(monkeypatch, model, asset, cls):
    """At full size the loaders hand the wrapper the alive ids of the
    model's asset file, as ``generate.py`` does; for ``--tiny``, which has no
    such file, every code of its codebook (128: enough for the clustering
    split's 100 clusters). The
    full-size networks are not built here: their constructors are stubbed."""
    import wmar_tpu_torch.models as tmodels
    from wmar_tpu_torch import generate as tgen

    seen = {}
    for name in ("init_gpt", "init_taming_vqgan", "init_rar", "init_maskgit"):
        monkeypatch.setattr(tmodels, name, lambda *a, **k: None)
    monkeypatch.setattr(tmodels, cls, lambda *a, **k: seen.update(k) or "wrapper")
    args = tgen.get_parser().parse_args(["--model", model, "--outdir", "o", "--device", "cpu"])
    assert tgen.load_wrapper(args, torch.device("cpu")) == "wrapper"
    np.testing.assert_array_equal(seen["alive_ids"], tgen._load_alive_ids(asset))
    assert len(seen["alive_ids"]) in (971, 1024)
    args.tiny = True
    seen.clear()
    tgen.load_wrapper(args, torch.device("cpu"))
    np.testing.assert_array_equal(seen["alive_ids"], np.arange(128))


def test_set_watermarker_none_keeps_the_greenlist():
    """``set_watermarker(None)`` clears the spec and keeps the last
    greenlist, as the JAX wrapper does."""
    from wmar_tpu.models.armm import ARMMWrapper as JWrapper
    from wmar_tpu_torch.models.armm import ARMMWrapper as TWrapper

    kept = []
    for base, spec_cls, kwargs in ((JWrapper, JSpec, {}), (TWrapper, TSpec, {"device": "cpu"})):
        class Bare(base):
            def get_vq(self):
                return None

        w = Bare(**kwargs)
        w.set_watermarker(spec_cls.from_string("linear-rand-h=1-d=2.0-g=0.25", vocab_size=64))
        first = w.greenlist
        w.set_watermarker(None)
        assert w.watermark_spec is None and w.watermark_runtime() is None
        kept.append(w.greenlist is first)
    assert kept == [True, True]
