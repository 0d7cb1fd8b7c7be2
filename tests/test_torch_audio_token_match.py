"""Port parity, the decode -> encode token-match CLI (``python -m
wmar_tpu_torch.audio.token_match``) against ``wmar_tpu.audio.token_match``
on the CPU, and faults (j), (k) and (l) of the JAX CLI.

Both packages take the JAX ``--tiny`` weights (Mimi from key 1, Moshi from
key 0), the port through ``--mimi_weight`` / ``--moshi_weight`` files the
JAX package writes. ``compute_tm`` is JAX's bit for bit. Mimi mode over a
slice of the validation grid (patched into both packages alike) writes
JAX's CSV rows (both speeds of the grid, the strongest strength of the
other families); the cells that draw noise (noise, pink noise, temporal
crop) and time-shift (fault (g), ``tests/test_torch_audio_augs.py``) are
held to their keys and ranges, the others to JAX's rates exactly. Moshi
mode, fed JAX's Gumbel draws, writes JAX's rows for the files JAX scores.

Faults: (j) JAX's state-dict branch of ``--mimi_weight`` raises
``UnboundLocalError``, the port reads a synthetic state dict in the
released layout; (k) JAX's moshi mode scores only the first batch of
prompts, the port every file; (l) JAX's cells reuse one key for every
strength of an aug, the port seeds each (aug, strength) apart.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_audio_lm import _jax_noise
from tests.test_torch_audio_mimi import _mimi_sd
from wmar_tpu.audio import augmentations as jaugs
from wmar_tpu.audio import lm as jlm
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.audio import token_match as jtm
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import audio_eval
from wmar_tpu_torch.audio import augmentations as taugs
from wmar_tpu_torch.audio import mimi as tmimi
from wmar_tpu_torch.audio import token_match as ttm
from wmar_tpu_torch.audio.prompts import write_wav

torch.set_num_threads(1)
GRID = {"identity", "speed", "echo", "noise", "lowpass", "bandpass", "smooth", "duck", "updown-resample",
        "time-shift", "temporal-crop", "mp3-compression"}  # a slice of the validation grid
DRAWN = {"noise", "pink-noise", "temporal-crop", "time-shift"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three 0.5 s wavs and JAX's tiny weights as msgpack files."""
    d = tmp_path_factory.mktemp("tm")
    os.makedirs(d / "wavs")
    rng = np.random.default_rng(0)
    for i in range(3):
        write_wav(str(d / "wavs" / f"clip{i}.wav"), rng.standard_normal(12000) * 0.1, 24000)
    cfg = jmimi.MimiConfig(**audio_eval.TINY_MIMI)
    jckpt.save_pytree(str(d / "mimi.msgpack"), jax.jit(jmimi.Mimi(cfg).init)(jax.random.PRNGKey(1),
                                                                              jnp.zeros((1, cfg.hop_length * 4, 1))))
    jckpt.save_pytree(str(d / "moshi.msgpack"), jlm.init_moshi_params(jax.random.PRNGKey(0),
                                                                      jlm.MoshiConfig(**audio_eval.TINY_MOSHI)))
    return str(d / "wavs"), str(d / "mimi.msgpack"), str(d / "moshi.msgpack")


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("shapes", [((2, 3, 5), (2, 3, 5)), ((2, 3, 5), (2, 3, 7)), ((1, 2, 9), (1, 2, 4))])
def test_compute_tm(shapes):
    rng = np.random.default_rng(sum(shapes[1]))
    a, b = rng.integers(0, 3, shapes[0]), rng.integers(0, 3, shapes[1])
    for per_channel in (False, True):
        assert ttm.compute_tm(a, b, per_channel) == jtm.compute_tm(a, b, per_channel)


def test_mimi_mode_rows(files, tmp_path, monkeypatch):
    wavs, mimi_path, _ = files
    for module in (jaugs, taugs):
        monkeypatch.setattr(module, "get_validation_augs", lambda grid=module.get_validation_augs, **kw: [
            (n, f, p if n == "speed" else p[-1:]) for n, f, p in grid(**kw) if n in GRID])
    common = ["--mode", "mimi", "--tiny", "--audio_dir", wavs, "--duration_sec", "0.5", "--batch_size", "3",
              "--save_tokens", "1"]
    want = jtm.main(common + ["--output_dir", str(tmp_path / "j")])
    got = ttm.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu", "--mimi_weight", mimi_path])
    jrows, trows = _rows(tmp_path / "j" / "token_match_results.csv"), _rows(tmp_path / "t" / "token_match_results.csv")
    assert len(trows) == len(jrows) == len(got) == len(want) == 3 * sum(
        len(p) for n, _, p in taugs.get_validation_augs())
    cells = set()
    for t, j in zip(trows, jrows):
        assert list(t) == list(j)
        assert [t[k] for k in ("global_index", "audio_file", "aug", "strength")] == \
            [j[k] for k in ("global_index", "audio_file", "aug", "strength")]
        assert all(0.0 <= float(t[k]) <= 1.0 for k in t if k.startswith("tm_rate"))
        if t["aug"] not in DRAWN:
            assert {k: t[k] for k in t if k.startswith("tm_rate")} == {k: j[k] for k in j if k.startswith("tm_rate")}
            cells.add(t["aug"])
    assert len(cells) >= 8
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t" / "audio")) == sorted(os.listdir(tmp_path / "j" / "audio"))


def test_moshi_mode_rows_and_fault_k(files, tmp_path):
    """Three prompt files at batch 2: JAX generates and scores the first
    batch alone (fault (k)), the port both; on the files JAX scores, fed
    JAX's draws, the rows are JAX's."""
    wavs, mimi_path, moshi_path = files
    common = ["--mode", "moshi", "--tiny", "--audio_dir", wavs, "--duration_sec", "0.5", "--batch_size", "2",
              "--steps", "8", "--eval_aug", "false", "--save_audio", "0", "--seed", "3"]
    want = jtm.main(common + ["--output_dir", str(tmp_path / "j")])
    got = ttm.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu", "--mimi_weight", mimi_path,
                             "--moshi_weight", moshi_path], models={"noise": _jax_noise(jax.random.PRNGKey(3))})
    assert [r["global_index"] for r in want] == [0, 1]
    assert [r["global_index"] for r in got] == [0, 1, 2]
    assert len({r["audio_file"] for r in got}) == 3
    for t, j in zip(got[:2], want):
        assert t == j
    assert all(0.0 <= r["tm_rate"] <= 1.0 for r in got)


def test_moshi_mode_without_files(files, tmp_path):
    _, mimi_path, moshi_path = files
    common = ["--mode", "moshi", "--tiny", "--batch_size", "2", "--steps", "6", "--eval_aug", "false",
              "--save_audio", "0"]
    got = ttm.main(common + ["--output_dir", str(tmp_path / "t"), "--device", "cpu", "--mimi_weight", mimi_path,
                             "--moshi_weight", moshi_path])
    assert [r["audio_file"] for r in got] == ["<silence:0>", "<silence:1>"]


def test_fault_j_state_dict_weights(files, tmp_path):
    """A released-layout state dict through ``--mimi_weight``: JAX's loader
    raises ``UnboundLocalError`` (its local ``import jax.numpy as jnp``
    shadows the module-level name), the port converts it and its rates are
    those of JAX's Mimi on ``convert_mimi``'s tree."""
    from safetensors.numpy import save_file

    wavs = files[0]
    cfg = jmimi.MimiConfig(**audio_eval.TINY_MIMI)
    sd = _mimi_sd(cfg)
    path = str(tmp_path / "tokenizer.safetensors")
    save_file(sd, path)
    args = jtm.get_parser().parse_args(["--mode", "mimi", "--output_dir", str(tmp_path), "--mimi_weight", path])
    with pytest.raises(UnboundLocalError):
        jtm._load_mimi(args)
    got = ttm.main(["--mode", "mimi", "--tiny", "--device", "cpu", "--audio_dir", wavs, "--duration_sec", "0.5",
                    "--batch_size", "3", "--eval_aug", "false", "--save_audio", "0", "--output_dir",
                    str(tmp_path / "t"), "--mimi_weight", path])
    m, v = jmimi.Mimi(cfg), jax.tree.map(jnp.asarray, jmimi.convert_mimi(sd, cfg))
    enc = jax.jit(lambda a: m.apply(v, a, method=jmimi.Mimi.encode))
    dec = jax.jit(lambda c: m.apply(v, c, method=jmimi.Mimi.decode))
    pcm = jtm._load_batches(jtm.get_parser().parse_args(
        ["--mode", "mimi", "--output_dir", "x", "--audio_dir", wavs, "--duration_sec", "0.5"]), 24000)[0][1]
    toks = np.asarray(enc(jnp.asarray(pcm)))
    rates = jtm.compute_tm(toks, np.asarray(enc(dec(jnp.asarray(toks)))), per_channel=True)
    assert len(got) == 3 and all(r[f"tm_rate_{k}"] == rates[k] for r in got for k in range(len(rates)))


def test_fault_l_cell_seeds():
    """JAX hands every strength of an aug the same key; the port seeds each
    (aug, strength) cell apart, and repeats the seeds from run to run."""
    def sweep(module, make_fn):
        seen = []
        augs = [(name, make_fn(seen, name), [0.1, 0.2, 0.3]) for name in ("noise", "pink-noise")]
        args = module.get_parser().parse_args(["--mode", "mimi", "--output_dir", "unused", "--save_audio", "0"])
        toks = np.zeros((1, 2, 3), np.int64)
        x = np.zeros((1, 8, 1), np.float32)
        decoded = jnp.asarray(x) if module is jtm else torch.from_numpy(x)
        module._sweep(args, augs, decoded, toks, lambda a: toks if module is jtm else torch.from_numpy(toks),
                      ["f"], [], 0, 24000)
        return seen

    def jax_fn(seen, name):
        return lambda x, p, r: seen.append((name, p, tuple(np.asarray(jax.random.key_data(r)).tolist()))) or x

    def port_fn(seen, name):
        return lambda x, p, g: seen.append((name, p, g.initial_seed())) or x

    jseen, tseen = sweep(jtm, jax_fn), sweep(ttm, port_fn)
    for name in ("noise", "pink-noise"):
        assert len({k for n, _, k in jseen if n == name}) == 1
        assert len({k for n, _, k in tseen if n == name}) == 3
    assert len({k for _, _, k in tseen}) == 6 and tseen == sweep(ttm, port_fn)


def test_parser_takes_every_jax_flag():
    jax_parser, port = jtm.get_parser(), ttm.get_parser()
    assert {s for a in jax_parser._actions for s in a.option_strings} <= {s for a in port._actions
                                                                          for s in a.option_strings}
    for a in jax_parser._actions:
        if a.dest != "help":
            assert port.get_default(a.dest) == a.default, a.dest


def test_full_size_needs_weights_and_cuda_needs_a_card(tmp_path):
    with pytest.raises(SystemExit, match="--mimi_weight"):
        ttm.main(["--mode", "mimi", "--output_dir", str(tmp_path), "--device", "cpu", "--audio_dir", str(tmp_path)])
    args = ttm.get_parser().parse_args(["--mode", "moshi", "--output_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--moshi_weight"):
        ttm.run_moshi_eval(args, mimi=tmimi.Mimi(tmimi.MimiConfig(**audio_eval.TINY_MIMI)))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            ttm.main(["--mode", "moshi", "--tiny", "--output_dir", str(tmp_path)])
