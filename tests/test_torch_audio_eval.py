"""Port parity, the audio eval entry point (``python -m
wmar_tpu_torch.audio_eval``) against ``wmar_audio_eval.main`` on the CPU.

Both runs take the JAX ``--tiny`` weights (``init_moshi_params`` from key 0,
Mimi's init from key 1): JAX builds them itself, the port reads them from
the msgpack files the JAX package writes (``--moshi_weight`` /
``--mimi_weight``). Under ``--wm_method gumbel --no_augs`` the run is
deterministic: the token matches are equal and the p-values agree within
5e-4 relative (JAX's float32 ``gammaincc`` against the port's float64 one;
see ``tests/test_torch_audio_wm.py``). A default ``--tiny`` run (Maryland,
the whole grid, the port's own random weights) writes JAX's records, key
for key. The refused flags exit naming ROADMAP item 13, and no module of
the port imports JAX or the JAX package.
"""

import ast
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import wmar_audio_eval
from wmar_tpu.audio import lm as jlm
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import audio_eval

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS = "8"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's ``--tiny`` weights as msgpack files."""
    d = tmp_path_factory.mktemp("weights")
    jckpt.save_pytree(str(d / "moshi.msgpack"), jlm.init_moshi_params(jax.random.PRNGKey(0),
                                                                      jlm.MoshiConfig(**audio_eval.TINY_MOSHI)))
    cfg = jmimi.MimiConfig(**audio_eval.TINY_MIMI)
    variables = jax.jit(jmimi.Mimi(cfg).init)(jax.random.PRNGKey(1), jax.numpy.zeros((1, cfg.hop_length * 4, 1)))
    jckpt.save_pytree(str(d / "mimi.msgpack"), variables)
    return str(d / "moshi.msgpack"), str(d / "mimi.msgpack")


def _key(r):
    return (r["aug"], json.dumps(r["param"]), r["batch"], r["stream"])


def test_gumbel_no_augs_matches_jax(weights, tmp_path):
    flags = ["--tiny", "--wm_method", "gumbel", "--no_augs", "--steps", STEPS]
    want = wmar_audio_eval.main(["--output_dir", str(tmp_path / "jax")] + flags)
    got = audio_eval.main(["--output_dir", str(tmp_path / "port"), "--device", "cpu", "--moshi_weight", weights[0],
                           "--mimi_weight", weights[1]] + flags)
    with open(tmp_path / "port" / "results.json") as f:
        assert json.load(f) == got
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert [r["token_match"] for r in got] == [r["token_match"] for r in want]
    p_got = np.array([r["pvalue"] for r in got])
    p_want = np.array([r["pvalue"] for r in want])
    normal = p_want >= np.finfo(np.float32).tiny
    np.testing.assert_allclose(p_got[normal], p_want[normal], rtol=5e-4)
    assert (p_got[~normal] < np.finfo(np.float32).tiny).all()
    for r, w in zip(got, want):
        np.testing.assert_allclose([r["sisnr"], r["stoi"]], [w["sisnr"], w["stoi"]], rtol=1e-5, atol=1e-5)


def test_default_tiny_records_by_key(tmp_path):
    want = wmar_audio_eval.main(["--output_dir", str(tmp_path / "jax"), "--tiny", "--steps", STEPS])
    got = audio_eval.main(["--output_dir", str(tmp_path / "port"), "--tiny", "--device", "cpu", "--steps", STEPS])
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert all(set(r) == set(w) for r, w in zip(got, want))
    for r in got:
        assert r["pvalue"] is None or 0.0 <= r["pvalue"] <= 1.0
        assert 0.0 <= r["token_match"] <= 1.0 and np.isfinite(r["stoi"])


def test_audio_prompts_teacher_force(tmp_path):
    """``--use_prompts --audio_dir``: a 16 kHz int16 .wav (resampled to 24
    kHz, cropped to ``--duration_sec``: 48 samples, 3 frames) is Mimi-encoded
    and forces the first frames; the semantic stream (delay 0) emits those
    codes."""
    from scipy.io import wavfile

    from wmar_tpu_torch.audio import mimi as tmimi

    d = tmp_path / "wavs"
    d.mkdir()
    wav = (np.random.default_rng(0).standard_normal(16000) * 3000).astype(np.int16)
    wavfile.write(str(d / "a.wav"), 16000, wav)
    out = tmp_path / "out"
    audio_eval.main(["--output_dir", str(out), "--tiny", "--device", "cpu", "--no_augs", "--steps", STEPS,
                     "--use_prompts", "--audio_dir", str(d), "--duration_sec", "0.002", "--save_tokens"])
    audio = np.load(out / "audio_tokens.npy")
    data = np.interp(np.linspace(0, 15999, 24000), np.arange(16000), wav.astype(np.float32) / 32768.0)[:48]
    batch = torch.from_numpy(np.stack([data, np.zeros(48)]).astype(np.float32))[:, :, None]
    mimi = tmimi.init_mimi(tmimi.MimiConfig(**audio_eval.TINY_MIMI), torch.Generator().manual_seed(1))
    codes = mimi.encode(batch).numpy()
    assert codes.shape[2] == 3 and audio.shape == (2, 4, int(STEPS))
    np.testing.assert_array_equal(audio[:, 0, : codes.shape[2]], codes[:, 0])


@pytest.mark.parametrize("flag", [["--wm_sync"], ["--sync_generator_ckpt", "g.pth"], ["--sync_detector_ckpt", "d.pth"],
                                  ["--sync_alpha", "0.3"], ["--encodec_weight", "e.th"], ["--dac_weight", "d.pth"]])
def test_refused_flags(flag, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP queue 1, item 13"):
        audio_eval.main(["--output_dir", str(tmp_path), "--tiny", "--device", "cpu"] + flag)
    assert not os.path.exists(tmp_path / "results.json")


def test_full_size_needs_weights_and_cuda_needs_a_card(tmp_path):
    with pytest.raises(SystemExit, match="--moshi_weight"):
        audio_eval.main(["--output_dir", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            audio_eval.main(["--output_dir", str(tmp_path), "--tiny"])


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "wmar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(p.name == "audio_eval.py" for p in files) and any(p.parent.name == "audio" for p in files)
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "wmar_tpu"), f"{path} imports {mod}"
