"""Port parity, the audio eval entry point (``python -m
wmar_tpu_torch.audio_eval``) against ``wmar_audio_eval.main`` on the CPU.

Both runs take the JAX ``--tiny`` weights (``init_moshi_params`` from key 0,
Mimi's init from key 1): JAX builds them itself, the port reads them from
the msgpack files the JAX package writes (``--moshi_weight`` /
``--mimi_weight``). Under ``--wm_method gumbel --no_augs`` the run is
deterministic: the token matches are equal and the p-values agree within
5e-4 relative (JAX's float32 ``gammaincc`` against the port's float64 one;
see ``tests/test_torch_audio_wm.py``). So is a ``--wm_sync --eval_aug
speed`` run over JAX's tiny AudioSeal (the same numpy draws): the same
records, ``sync_score`` within 1e-5 (float32 convolutions summed in
another order) and the same inverted rows with the same speed-up and
shift. A default ``--tiny`` run (Maryland, the whole grid with the EnCodec
and DAC cells from random files at the JAX tests' small geometries,
patched into both packages, the port's own random weights) writes JAX's
records, key for key. The port's parser takes every flag of JAX's; a
missing or misshapen sync or codec file stops ``evaluate`` before the
generation, and no module of the port imports JAX or the JAX package.
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
from tests import test_audio_codecs_parity as codec_oracle
from wmar_tpu.audio import codecs as jcodecs
from wmar_tpu.audio import lm as jlm
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import audio_eval
from wmar_tpu_torch.audio import codecs as tcodecs

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


def _small_codecs(monkeypatch):
    """The JAX tests' small EnCodec and DAC geometries as both packages'
    defaults, and the port's configs of them."""
    enc = tcodecs.EncodecConfig(**codec_oracle.TINY_ENC.__dict__)
    dac = tcodecs.DACConfig(**codec_oracle.TINY_DAC.__dict__)
    for mod, e, d in ((jcodecs, codec_oracle.TINY_ENC, codec_oracle.TINY_DAC), (tcodecs, enc, dac)):
        monkeypatch.setattr(mod, "ENCODEC_24K", e)
        monkeypatch.setattr(mod, "DAC_24K", d)
    return enc, dac


def _codec_files(d, enc, dac):
    """Random codecs written by the port's writers: EnCodec in HF's layout,
    DAC in descript's (weight_g / weight_v)."""
    e = tcodecs.random_codec(lambda: tcodecs.Encodec(enc), torch.Generator().manual_seed(0))
    torch.save(tcodecs.encodec_state_dict(e, "hf"), d / "encodec.pth")
    torch.save(tcodecs.dac_state_dict(tcodecs.random_codec(lambda: tcodecs.DAC(dac), torch.Generator().manual_seed(1))
                                      ), d / "dac.pth")
    return str(d / "encodec.pth"), str(d / "dac.pth")


def test_default_tiny_records_by_key(tmp_path, monkeypatch):
    enc, dac = _codec_files(tmp_path, *_small_codecs(monkeypatch))
    flags = ["--tiny", "--steps", STEPS, "--encodec_weight", enc, "--dac_weight", dac]
    want = wmar_audio_eval.main(["--output_dir", str(tmp_path / "jax")] + flags)
    got = audio_eval.main(["--output_dir", str(tmp_path / "port"), "--device", "cpu"] + flags)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert {r["aug"] for r in got} >= {"encodec-compression", "dac-compression"}
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


def test_gumbel_sync_speed_matches_jax(weights, tmp_path, capsys):
    """``--wm_sync`` with ``--tiny``'s AudioSeal (half period 2 Mimi frames)
    over the speed cells: every record JAX's, each row's ``sync_score``
    within 1e-5 of JAX's, and the same rows inverted with the same speed-up
    and shift (the ``sync:`` lines both print)."""
    flags = ["--tiny", "--wm_method", "gumbel", "--wm_sync", "--eval_aug", "speed", "--steps", STEPS]
    want = wmar_audio_eval.main(["--output_dir", str(tmp_path / "jax")] + flags)
    jax_sync = [line for line in capsys.readouterr().out.splitlines() if line.startswith("sync:")]
    got = audio_eval.main(["--output_dir", str(tmp_path / "port"), "--device", "cpu", "--moshi_weight", weights[0],
                           "--mimi_weight", weights[1]] + flags)
    port_sync = [line for line in capsys.readouterr().out.splitlines() if line.startswith("sync:")]
    assert [_key(r) for r in got] == [_key(r) for r in want] and {r["aug"] for r in got} == {"identity", "speed"}
    assert [r["token_match"] for r in got] == [r["token_match"] for r in want]
    np.testing.assert_allclose([r["sync_score"] for r in got], [r["sync_score"] for r in want], rtol=0, atol=1e-5)
    p_got = np.array([r["pvalue"] for r in got])
    p_want = np.array([r["pvalue"] for r in want])
    normal = p_want >= np.finfo(np.float32).tiny
    np.testing.assert_allclose(p_got[normal], p_want[normal], rtol=5e-4)
    assert jax_sync and port_sync == jax_sync


def test_parser_takes_every_jax_flag():
    jax_flags = {s for a in wmar_audio_eval.get_parser()._actions for s in a.option_strings}
    port = audio_eval.get_parser()
    assert jax_flags <= {s for a in port._actions for s in a.option_strings}
    for a in wmar_audio_eval.get_parser()._actions:
        if a.dest != "help":
            assert port.get_default(a.dest) == a.default, a.dest


@pytest.fixture(scope="module")
def tiny_models():
    args = audio_eval.get_parser().parse_args(["--output_dir", "unused", "--tiny", "--device", "cpu"])
    return audio_eval.build_models(args, torch.device("cpu"))


def _other_strides_dac(d):
    """A DAC file whose strided kernels are 4 wide where the small
    geometry's first encoder stride (2) needs 4, and 8 where it needs 4."""
    cfg = tcodecs.DACConfig(**{**codec_oracle.TINY_DAC.__dict__, "encoder_rates": (4, 2), "decoder_rates": (2, 4)})
    model = tcodecs.random_codec(lambda: tcodecs.DAC(cfg), torch.Generator().manual_seed(2))
    torch.save(tcodecs.dac_state_dict(model), d / "dac_other.pth")
    return str(d / "dac_other.pth")


@pytest.mark.parametrize("case", ["sync_no_ckpt", "sync_one_ckpt", "sync_missing_ckpt", "encodec_missing",
                                  "dac_missing", "dac_other_strides", "encodec_given_a_dac_file"])
def test_sync_and_codec_files_stop_the_run_first(case, tiny_models, tmp_path, monkeypatch):
    """What ``--wm_sync`` and the codec flags refuse: sync without both
    checkpoints and without ``--tiny`` (JAX's message), a missing sync or
    codec file, a DAC file of other strides, a file of the other codec's
    layout. ``evaluate`` stops before it generates or writes anything."""
    enc, dac = _small_codecs(monkeypatch)
    missing = str(tmp_path / "missing.pth")
    flags, error, match = {
        "sync_no_ckpt": (["--wm_sync"], SystemExit, "--wm_sync needs --sync_generator_ckpt"),
        "sync_one_ckpt": (["--wm_sync", "--sync_generator_ckpt", missing], SystemExit, "--sync_detector_ckpt"),
        "sync_missing_ckpt": (["--tiny", "--wm_sync", "--sync_generator_ckpt", missing, "--sync_detector_ckpt",
                               missing], FileNotFoundError, "missing.pth"),
        "encodec_missing": (["--tiny", "--encodec_weight", missing], FileNotFoundError, "missing.pth"),
        "dac_missing": (["--tiny", "--dac_weight", missing], FileNotFoundError, "missing.pth"),
        "dac_other_strides": (["--tiny", "--dac_weight", _other_strides_dac(tmp_path)], ValueError,
                              "kernel width 8, but the config's stride 2 needs 4"),
        "encodec_given_a_dac_file": (["--tiny", "--encodec_weight", _codec_files(tmp_path, enc, dac)[1]], KeyError,
                                     "encoder.model.0.conv.conv"),
    }[case]
    args = audio_eval.get_parser().parse_args(["--output_dir", str(tmp_path / "out"), "--device", "cpu"] + flags)
    moshi_cfg, moshi_params, mimi, _ = tiny_models
    with pytest.raises(error, match=match):
        audio_eval.evaluate(args, moshi_cfg, moshi_params, mimi)
    assert not os.path.exists(tmp_path / "out")


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
