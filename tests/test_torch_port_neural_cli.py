"""The neural-compression bank through ``generate`` in both packages.

``generate.main`` of the JAX package and ``wmar_tpu_torch.generate.main``
run the tiny RAR model with ``--include_neural_compress true
--nc_allow_random true``. Both packages' ``REFERENCE_CODEC_NAMES`` are
patched to two compressai names at their published widths (the same numpy
draws in both), the classic grid is left out of both managers, and both
wrappers decode any codes to the same fixed images, so the two codecs see
equal inputs: the records must have the same keys and tags, and each cell's
bpp must agree within 1e-3 relative (the parity file's bound where a
latent integer flips; the port's resize to 64 px and JAX's differ by
float32 rounding).
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import wmar_tpu.augmentations as jaug  # noqa: E402
from wmar_tpu.augmentations import neural as jneural  # noqa: E402
from wmar_tpu.models import armm as jarmm  # noqa: E402
import wmar_tpu_torch.augmentations as taug  # noqa: E402
from wmar_tpu_torch import generate as tgen  # noqa: E402
from wmar_tpu_torch.augmentations import neural as tneural  # noqa: E402
from wmar_tpu_torch.models import armm as tarmm  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the fast tier runs six test workers at once, and a
    thread per core in each oversubscribes the cores, so the codecs' many
    small convolutions wait on each other (a cheng2020 oracle case took
    21.6 s against 0.3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["bmshj2018-factorized-q=1", "mbt2018-mean-q=1"]
BPP_REL = 1e-3


def _fixed_images(b, size):
    return np.random.default_rng(0).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _codec_only(cls):
    """``cls`` with only its neural-compress cells."""

    class CodecOnly(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.augs = [a for a in self.augs if a[0] == "neural-compress"]

    return CodecOnly


@pytest.fixture
def jax_generate():
    sys.path.insert(0, REPO)
    try:
        import generate
    finally:
        sys.path.remove(REPO)
    return generate


def test_generate_neural_compress_matches_jax(tmp_path, monkeypatch, jax_generate, capsys):
    monkeypatch.setattr(jneural, "REFERENCE_CODEC_NAMES", NAMES)
    monkeypatch.setattr(tneural, "REFERENCE_CODEC_NAMES", NAMES)
    monkeypatch.setattr(jaug, "AugmentationManager", _codec_only(jaug.AugmentationManager))
    monkeypatch.setattr(taug, "AugmentationManager", _codec_only(taug.AugmentationManager))
    monkeypatch.setattr(jarmm.RarARMM, "codes_to_images",
                        lambda self, codes: jnp.asarray(_fixed_images(codes.shape[0], self.image_size)))
    monkeypatch.setattr(tarmm.RarARMM, "codes_to_images",
                        lambda self, codes: torch.from_numpy(_fixed_images(codes.shape[0], self.image_size)))
    argv = ["--model", "rar", "--tiny", "--conditioning", "0,1", "--batch_size", "2",
            "--include_neural_compress", "true", "--nc_allow_random", "true"]
    want = jax_generate.main(argv + ["--outdir", str(tmp_path / "jax")])
    got = tgen.main(argv + ["--device", "cpu", "--outdir", str(tmp_path / "port")])
    assert capsys.readouterr().out.count("RANDOM weights") == 4  # each package warns for each codec

    def by_cell(records):
        return {(r["conditioning"], r["idx"], r["transform"], str(r["param"])): r for r in records}

    got, want = by_cell(got), by_cell(want)
    assert set(got) == set(want) and len(got) == 2 * (1 + 1 + len(NAMES))
    for cell, r in got.items():
        assert set(r) == set(want[cell]), cell
        if cell[2] != "neural-compress":
            continue
        assert r["random_weights"] is True and want[cell]["random_weights"] is True
        assert np.isfinite(r["bpp"]) and r["bpp"] >= 0
        assert abs(r["bpp"] - want[cell]["bpp"]) <= BPP_REL * abs(want[cell]["bpp"]), (cell, r["bpp"],
                                                                                       want[cell]["bpp"])


def test_generate_refuses_a_random_bank_as_jax_does(tmp_path, capsys):
    """Without weights and without ``--nc_allow_random`` every codec is
    skipped and the run exits with JAX's message; ``--include_diffpure``
    without ``--diffpure_weights`` is refused in JAX's words (this test once
    saw it refused as unported, ROADMAP item 12b)."""
    base = ["--model", "rar", "--tiny", "--device", "cpu", "--outdir", str(tmp_path)]
    with pytest.raises(SystemExit, match="no codec could be built; provide --nc_weights_dir with converted "
                                         "checkpoints or pass --nc_allow_random true"):
        tgen.main(base + ["--include_neural_compress", "true", "--nc_weights_dir", str(tmp_path)])
    assert capsys.readouterr().out.count("skipping codec") == 22
    with pytest.raises(SystemExit, match="--include_diffpure requires --diffpure_weights"):
        tgen.main(base + ["--include_diffpure", "true"])


def test_chip_smoke_neural_phase_on_cpu():
    """``chip_smoke.py``'s "neural codecs" phase on the CPU with a bank of
    one published-width compressai codec, one small KL-VAE and DC-AE at
    the small random slot's geometry: its checks (the "card" against the
    CPU, finite bpp, shapes and range) pass, so the script's logic is tested
    before the card."""
    import chip_smoke
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.augmentations import dcae as tdc
    from wmar_tpu_torch.augmentations import diffusers_vae as tdv

    cfg = tdv.KLVAEConfig((8, 16), 1, 4, 4)
    bank = tneural.build_codec_bank(names=["mbt2018-q=1"], allow_random=True)
    bank["diffusers-flux"] = tdv.DiffusersCompression("diffusers-flux", cfg,
                                                      bridge.load_kl_vae(cfg, tdv.init_kl_vae_params(0, cfg)), True)
    out = chip_smoke.phase_neural_codecs("cpu", bank, dcae_cfg=tdc.DCAEConfig.tiny(deep_stem=True), batch=2, size=64,
                                         check_size=64)
    assert set(out["codecs"]) == {"mbt2018-q=1", "diffusers-flux", "diffusers-deep-compression"}
    for row in out["codecs"].values():
        assert row["max_abs_err"] <= row["tol"] and np.isfinite(row["bpp"]) and row["bpp"] >= 0
