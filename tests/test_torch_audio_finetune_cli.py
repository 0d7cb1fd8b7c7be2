"""Port parity, the Mimi RCC finetune entry point (``python -m
wmar_tpu_torch.finetune_mimi``) against the root ``finetune_mimi.main`` on
the CPU, and fault (m).

Both take the JAX CLI's ``--tiny`` Mimi (its init from key 0; the port
reads it from the msgpack file the JAX package writes). The JAX CLI runs
on the conftest's 8 host devices, so the batch is 8 in both. One epoch of
three steps at warmup 0 (the first update at rate 0, the next two at the
cosine's), the audio loss ``mse`` (smooth where the trainable decoder
equals the replica, so JAX's jitted step has no kink to take float32
noise's signs at), a one-branch lowpass augmenter from epoch 0, the subset
token-match sweep: every logged metric JAX writes is within 1e-5 relative
(the token match's noise cell, a draw of each package's own, in [0, 1]),
and each part's delta file reads through JAX's ``load_pytree`` within
1e-6 of JAX's own delta. A resumed run (1 epoch, then 2) ends at the
uninterrupted run's weights bit for bit and draws its batch indices; JAX's
resumed epoch draws epoch 0's (fault (m), shown with JAX's train step
stubbed out). ``--finetune_encoder false`` leaves the encoder deltas zero.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finetune_mimi as jcli
from wmar_tpu.audio import finetune as jft
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch import finetune_mimi as tcli
from wmar_tpu_torch.audio.dataloader import train_valid_split

torch.set_num_threads(1)
SEED = 42424242
PARTS = ("encoder", "enc_transformer", "decoder", "dec_transformer")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's ``--tiny`` Mimi (model, variables) and its msgpack file."""
    cfg = jmimi.MimiConfig(**tcli.TINY_FT_MIMI)
    model = jmimi.Mimi(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.hop_length * 4, 1)))
    path = str(tmp_path_factory.mktemp("w") / "mimi.msgpack")
    jckpt.save_pytree(path, variables)
    return model, variables, path


def _argv(out, *extra):
    return ["--tiny", "--synthetic", "24", "--batch_size", "8", "--num_valid", "4", "--output_dir", str(out),
            *extra]


def _logs(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_cli_matches_jax(tiny, tmp_path, monkeypatch):
    model, variables, path = tiny
    monkeypatch.setattr(jcli, "build_mimi", lambda args: (model, variables))
    flags = ["--epochs", "1", "--steps_per_epoch", "3", "--warmup_epochs", "0", "--audio_loss_type", "mse",
             "--augs", "{'lowpass_filter': 1}", "--augs_params",
             "{'lowpass_filter': {'min_cutoff_freq': 3000, 'max_cutoff_freq': 3000}}", "--augmentation_start", "0"]
    jcli.main(_argv(tmp_path / "j", *flags))
    tcli.main(_argv(tmp_path / "t", *flags, "--device", "cpu", "--mimi_weights", path))
    (want,), (got,) = _logs(tmp_path / "j"), _logs(tmp_path / "t")
    assert set(want) | {"train_s", "train_steps"} == set(got)
    for k, v in want.items():
        if k == "eval_token_match_noise_0.001":
            assert 0.0 <= got[k] <= 1.0
        else:
            assert abs(got[k] - v) <= 1e-5 * abs(v) + 1e-9, (k, got[k], v)
    jw = jft.MimiFTWrapper(model, variables)
    like = jax.tree.map(np.asarray, jw.init_trainable())
    moved = 0.0
    for part in PARTS:
        name = f"epoch0_{part}_delta.msgpack"
        got_d = jckpt.load_pytree(str(tmp_path / "t" / name), like[part])
        want_d = jckpt.load_pytree(str(tmp_path / "j" / name), like[part])
        for (k, a), (_, b) in zip(bridge.flatten(got_d), bridge.flatten(want_d)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=0, err_msg=f"{part}.{k}")
            moved = max(moved, float(np.abs(np.asarray(b)).max()))
    assert moved > 1e-6
    assert sorted(n for n in os.listdir(tmp_path / "t") if n.endswith(".wav")) == ["000_pred.wav", "000_target.wav"]


class _Recorder:
    """``np.random.default_rng`` that records every ``choice``."""

    def __init__(self, draws, *args, **kwargs):
        self.g, self.draws = _REAL_RNG(*args, **kwargs), draws

    def choice(self, *args, **kwargs):
        out = self.g.choice(*args, **kwargs)
        self.draws.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.g, name)


_REAL_RNG = np.random.default_rng


def _uninterrupted_draws(epochs, steps, bs=8):
    tr_idx, _ = train_valid_split(24, 4, SEED)
    rng = _REAL_RNG(SEED)
    return [rng.choice(tr_idx, size=bs, replace=len(tr_idx) < bs) for _ in range(epochs * steps)]


def _trainable(state):
    return {k: v.clone() for k, v in state.wrapper.trainable.state_dict().items()}


def test_resume_and_fault_m(tiny, tmp_path, monkeypatch):
    model, variables, path = tiny
    flags = ["--steps_per_epoch", "2", "--warmup_epochs", "1", "--val_token_match", "none", "--eval_freq", "5"]
    want = _uninterrupted_draws(2, 2)
    draws = []
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: _Recorder(draws, *a, **k))
    # JAX: its step stubbed out (the loop's draws are what is held), one epoch, then a resume to two
    monkeypatch.setattr(jcli, "build_mimi", lambda args: (model, variables))
    monkeypatch.setattr(jft, "make_rcc_train_step", lambda *a, **k: lambda state, batch, key: (state, {}))
    jcli.main(_argv(tmp_path / "j", "--epochs", "1", *flags))
    del draws[:]
    jcli.main(_argv(tmp_path / "j", "--epochs", "2", *flags))
    assert len(draws) == 2
    for got, w in zip(draws, want[:2]):  # epoch 1 of the resumed run: epoch 0's indices
        np.testing.assert_array_equal(got, w)
    assert not all(np.array_equal(a, b) for a, b in zip(draws, want[2:]))
    # the port: drawn and discarded for the skipped epoch
    port = ["--device", "cpu", "--mimi_weights", path]
    straight = tcli.main(_argv(tmp_path / "t1", "--epochs", "2", *flags, *port))
    tcli.main(_argv(tmp_path / "t2", "--epochs", "1", *flags, *port))
    del draws[:]
    resumed = tcli.main(_argv(tmp_path / "t2", "--epochs", "2", *flags, *port))
    assert len(draws) == 4
    for got, w in zip(draws, want):
        np.testing.assert_array_equal(got, w)
    a, b = _trainable(straight), _trainable(resumed)
    assert straight.step == resumed.step == 4
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    assert [lg["epoch"] for lg in _logs(tmp_path / "t2")] == [0, 1]
    assert json.load(open(tmp_path / "t2" / "checkpoint_meta.json")) == {"epoch": 2}
    tcli.main(_argv(tmp_path / "t2", "--epochs", "2", *flags, *port))  # nothing left to run
    assert len(_logs(tmp_path / "t2")) == 2


def test_decoder_only_and_resume_from(tiny, tmp_path):
    model, variables, path = tiny
    jw = jft.MimiFTWrapper(model, variables)
    rng = np.random.default_rng(1)
    start = jax.tree.map(lambda a: (np.asarray(a) + 1e-3 * rng.standard_normal(a.shape)).astype(np.float32),
                         jw.init_trainable())
    jckpt.save_pytree(str(tmp_path / "start.msgpack"), start)
    state = tcli.main(_argv(tmp_path / "t", "--epochs", "1", "--steps_per_epoch", "2", "--warmup_epochs", "0",
                            "--val_token_match", "none", "--finetune_encoder", "false", "--resume_from",
                            str(tmp_path / "start.msgpack"), "--device", "cpu", "--mimi_weights", path))
    like = jax.tree.map(np.asarray, jw.init_trainable())
    got = bridge.mimi_ft_tree(state.wrapper)
    for part in ("encoder", "enc_transformer"):  # untouched: the resume_from weights, their delta to the frozen ones
        delta = dict(bridge.flatten(jckpt.load_pytree(str(tmp_path / "t" / f"epoch0_{part}_delta.msgpack"),
                                                      like[part])))
        s, o, g = (dict(bridge.flatten(t[part])) for t in (start, like, got))
        for k in s:
            np.testing.assert_array_equal(g[k].numpy(), s[k], err_msg=k)
            np.testing.assert_allclose(np.asarray(delta[k]), s[k] - o[k], atol=1e-7, rtol=0, err_msg=k)
    start_dec = dict(bridge.flatten(start["decoder"]))
    assert max(float(np.abs(g.numpy() - start_dec[k]).max()) for k, g in bridge.flatten(got["decoder"])) > 0
    assert not any(p.requires_grad for part in ("encoder", "enc_transformer")
                   for p in state.wrapper.trainable[part].parameters())


def test_parser_takes_every_jax_flag():
    jax_parser, port = jcli.get_parser(), tcli.get_parser()
    assert {s for a in jax_parser._actions for s in a.option_strings} <= {s for a in port._actions
                                                                          for s in a.option_strings}
    for a in jax_parser._actions:
        if a.dest != "help":
            assert port.get_default(a.dest) == a.default, a.dest


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="--mimi_weights or --tiny"):
        tcli.main(["--synthetic", "4", "--device", "cpu", "--output_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="multiple of 80ms"):
        tcli.main(_argv(tmp_path, "--device", "cpu", "--target_duration", "0.05"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            tcli.main(_argv(tmp_path))
