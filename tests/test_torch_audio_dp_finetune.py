"""Port parity, data-parallel Mimi RCC finetuning (``torchrun -m
wmar_tpu_torch.finetune_mimi``) on the CPU.

Two gloo ranks (``parallel.launch.spawn_ranks``, a ``file://`` rendezvous
under the test's directory, spawned once for the file, one torch thread a
rank) run ``finetune_mimi.main`` for each case at ``--batch_size 8``, 4
rows a rank, beside the references in this process:

- ``tf_loudness`` (its softmax groups the ratios by the batch size) with a
  lowpass augmenter, from the JAX CLI's tiny Mimi: every number of JAX's
  ``log.txt`` on the conftest's 8 host devices within 1e-5 relative, and
  each part's delta within 1e-6 of JAX's, as ``test_torch_audio_finetune_
  cli.py`` holds the one process;
- ``mrstft`` (its spectral convergence sums over the batch) with white and
  pink noise from epoch 0, evaluated every epoch with the token-match
  sweep: every number of the one process's ``log.txt`` (torch's draws)
  within 1e-5 relative, its deltas within 1e-6, the same files; rank 1
  writes none;
- the same run cut after one epoch and resumed (both ranks read the file
  the first rank wrote) ends at the uninterrupted two-rank run's weights bit
  for bit;
- ``--batch_size 5`` trains JAX's rounded batch of 4.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import finetune_mimi as jcli
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch import finetune_mimi as tcli
from wmar_tpu_torch.parallel.launch import spawn_ranks, wait
from wmar_tpu_torch.utils import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402

PARTS = ("encoder", "enc_transformer", "decoder", "dec_transformer")
REL = 1e-5
DELTA_ATOL = 1e-6
BASE = ["--tiny", "--synthetic", "24", "--batch_size", "8", "--num_valid", "4"]
JAX_RUN = ["--epochs", "1", "--steps_per_epoch", "3", "--warmup_epochs", "0", "--val_token_match", "none",
           "--audio_loss_type", "tf_loudness",
           "--augs", "{'lowpass_filter': 1}", "--augs_params",
           "{'lowpass_filter': {'min_cutoff_freq': 3000, 'max_cutoff_freq': 3000}}", "--augmentation_start", "0"]
NOISE_RUN = ["--steps_per_epoch", "2", "--warmup_epochs", "1", "--audio_loss_type", "mrstft", "--augs",
             "{'noise_injection': 1, 'pink_noise': 1}", "--augmentation_start", "0"]
NO_EVAL = ["--val_token_match", "none", "--eval_freq", "5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs beside JAX's and the one process's; the work
    directory and JAX's tiny Mimi."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    workdir = str(tmp_path_factory.mktemp("dp_mimi"))
    cfg = jmimi.MimiConfig(**tcli.TINY_FT_MIMI)
    model = jmimi.Mimi(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.hop_length * 4, 1)))
    weights = os.path.join(workdir, "mimi.msgpack")
    jckpt.save_pytree(weights, variables)
    port = ["--device", "cpu"]
    out = lambda name: ["--output_dir", os.path.join(workdir, name)]  # noqa: E731
    cases = [("jax", "mimi", BASE + JAX_RUN + port + ["--mimi_weights", weights] + out("jax_r{rank}")),
             ("noise", "mimi", BASE + NOISE_RUN + ["--epochs", "2"] + port + out("noise_r{rank}")),
             ("cut", "mimi", BASE + NOISE_RUN + NO_EVAL + ["--epochs", "1"] + port + out("cut")),
             ("resumed", "mimi", BASE + NOISE_RUN + NO_EVAL + ["--epochs", "2"] + port + out("cut")),
             ("odd", "mimi", ["--tiny", "--synthetic", "24", "--batch_size", "5", "--num_valid", "4", "--epochs", "1",
                              "--steps_per_epoch", "1", *NO_EVAL, *port, *out("odd")])]
    spawned = spawn_ranks(ranks.finetune_rank, 2, "gloo", f"file://{workdir}/rendezvous", args=(workdir, cases),
                          join=False)
    try:  # the references beside the ranks
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcli, "build_mimi", lambda args: (model, variables))
            jcli.main(BASE + JAX_RUN + out("jax_jax"))
        tcli.main(BASE + NOISE_RUN + ["--epochs", "2"] + port + out("noise_one"))
    finally:
        wait(spawned)
    yield workdir, model, variables
    torch.set_num_threads(n_threads)


def _logs(path):
    with open(os.path.join(path, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _same_logs(got, want, skip=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            if k not in skip:
                assert abs(g[k] - v) <= REL * abs(v) + 1e-9, (k, g[k], v)


def _deltas(path, epoch, like=None):
    return {part: dict(bridge.flatten(tckpt.load_pytree(os.path.join(path, f"epoch{epoch}_{part}_delta.msgpack"),
                                                        **({"like": like[part]} if like else {}))))
            for part in PARTS}


def _close(got, want, atol):
    moved = 0.0
    for part in PARTS:
        for k, w in want[part].items():
            np.testing.assert_allclose(np.asarray(got[part][k]), np.asarray(w), atol=atol, rtol=0,
                                       err_msg=f"{part}.{k}")
            moved = max(moved, float(np.abs(np.asarray(w)).max()))
    return moved


def test_two_ranks_give_jax_tf_loudness_run(runs):
    """``tf_loudness`` on two ranks of 4 rows against JAX's 8 devices of 1:
    the log (losses, idempotence, the eval's device metrics and its host
    metrics over the gathered rows) and the deltas."""
    workdir, model, variables = runs
    (want,), (got,) = _logs(os.path.join(workdir, "jax_jax")), _logs(os.path.join(workdir, "jax_r0"))
    assert set(want) | {"train_s", "train_steps"} == set(got)
    _same_logs([got], [want])
    from wmar_tpu.audio import finetune as jft

    like = jax.tree.map(np.asarray, jft.MimiFTWrapper(model, variables).init_trainable())
    jax_deltas = {part: dict(bridge.flatten(jckpt.load_pytree(
        os.path.join(workdir, "jax_jax", f"epoch0_{part}_delta.msgpack"), like[part]))) for part in PARTS}
    assert _close(_deltas(os.path.join(workdir, "jax_r0"), 0, like), jax_deltas, DELTA_ATOL) > 1e-6
    assert not os.path.exists(os.path.join(workdir, "jax_r1"))


def test_two_ranks_give_the_one_process_noise_run(runs):
    """``mrstft`` with white and pink noise on two ranks against the one
    process at batch 8: both epochs' logs (the eval's device metrics the
    ranks' means, its host metrics and token match the first rank's over
    the gathered rows), both epochs' deltas, the same files."""
    workdir, _, _ = runs
    got, want = (os.path.join(workdir, f"noise_{s}") for s in ("r0", "one"))
    logs = _logs(got)
    _same_logs(logs, _logs(want), skip=("train_s",))
    assert {"eval_sisnr", "eval_stoi", "eval_token_match_noise_0.001"} <= set(logs[-1])
    for epoch in (0, 1):
        assert _close(_deltas(got, epoch), _deltas(want, epoch), DELTA_ATOL) > 0
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert not os.path.exists(os.path.join(workdir, "noise_r1"))


def test_resumed_two_ranks_end_where_the_uninterrupted_run_ends(runs):
    workdir, _, _ = runs
    straight, resumed = (os.path.join(workdir, d) for d in ("noise_r0", "cut"))
    assert _close(_deltas(resumed, 1), _deltas(straight, 1), 0.0) > 0
    assert [lg["epoch"] for lg in _logs(resumed)] == [0, 1]
    _same_logs(_logs(resumed), [{k: v for k, v in lg.items() if not k.startswith("eval_")}
                                for lg in _logs(straight)], skip=("train_s",))
    with open(os.path.join(resumed, "checkpoint_meta.json")) as f:
        assert json.load(f) == {"epoch": 2}


def test_batch_rounds_to_the_ranks(runs):
    """``--batch_size 5`` over two ranks trains JAX's rounded batch of 4 (a
    batch that did not split would raise in the ranks)."""
    workdir, _, _ = runs
    (log,) = _logs(os.path.join(workdir, "odd"))
    assert log["train_steps"] == 1 and np.isfinite(log["loss"])


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """``chip_smoke``'s data-parallel finetuning (part (c) of its multi-rank
    phase) on its own, with the CLIs' tiny models on the CPU."""
    import chip_smoke

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield chip_smoke, chip_smoke.phase_dp_finetune("cpu", str(tmp_path_factory.mktemp("smoke")), tiny=True)
    finally:
        torch.set_num_threads(n)


def _move(path, edit):
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(edit(text))
    return text


def _scale_first(key, factor):
    """An edit of a JSON log that scales the first ``"key": value``."""
    def edit(text):
        head, tail = text.split(f'"{key}": ', 1)
        value, rest = tail.split(",", 1)
        return f'{head}"{key}": {float(value) * factor!r},{rest}'
    return edit


def _scale_rcc(epoch, key, factor):
    """An edit of RCC's ``history.json`` that scales ``key`` of the step
    logged in ``epoch``."""
    def edit(text):
        tree = json.loads(text)
        (entry,) = [e for e in tree["epochs"] if e["epoch"] == epoch]
        entry["metrics"][0][key] *= factor
        return json.dumps(tree)
    return edit


def test_chip_smoke_dp_finetune_on_cpu(smoke):
    """The gates pass: the first resumed step within ``DP_FIRST_REL`` (here
    the same numbers up to the order of float32 sums) with its drift and
    GAN weight not 0, every logged number within ``DP_LOGGED_REL``, the
    parameters within their bounds, rank 1's copies unchanged; the report
    has both trainers' seconds, peak and all-reduced bytes for each rank."""
    chip_smoke, out = smoke
    gates = out["gates"]
    assert set(gates["first_rel"]) == {"rcc loss", "rcc vqgan_gan_weight", "rcc grad_norm", "mimi audio_loss"}
    assert all(v <= chip_smoke.DP_FIRST_REL for v in gates["first_rel"].values())
    assert all(v <= chip_smoke.DP_LOGGED_REL for v in gates["logged_max_rel"].values())
    first = gates["first_step"]
    assert first["rcc"]["rec_l1"] > 0 and first["rcc"]["vqgan_gan_weight"] > 0 and first["mimi audio_loss"] > 0
    for name in ("rcc", "mimi"):
        steps = chip_smoke.DP_EPOCHS[name][1] - chip_smoke.DP_EPOCHS[name][0]
        assert gates["params"][name]["max_abs_lr"] <= 2 * steps
        assert gates["params"][name][f"share_above_{chip_smoke.DP_PARAMS_APART_LR:g}_lr"] <= chip_smoke.DP_PARAMS_SHARE
    for rank in out["ranks"]:
        assert set(rank) == {"rcc", "mimi"} and all(r["all_reduce_bytes_per_step"] > 0 for r in rank.values())


@pytest.mark.parametrize("what", ["rcc_step0", "mimi_step0", "rcc_later", "mimi_eval", "rcc_params",
                                  "rcc_params_share", "rank1_file", "rank1_rewrite"])
def test_chip_smoke_dp_finetune_gates_raise_when_a_rank_moves(smoke, what):
    """Moving one number of the ranks' run past its bound fails the gates:
    the first resumed step's RCC loss or Mimi audio loss by 1e-3 relative,
    the next RCC step's GAN weight or the Mimi eval's SI-SNR by 1e-2, one
    trained weight by 5 lr, every weight by twice the distance whose share
    is bounded; and a file added to or rewritten in rank 1's directory."""
    chip_smoke, out = smoke
    spec, root = out["spec"], out["spec"]["out"]
    first, last = chip_smoke.DP_EPOCHS["rcc"][0], chip_smoke.DP_EPOCHS["rcc"][1] - 1
    logs = {"rcc_step0": (os.path.join(root, "rcc_r0", "history.json"), _scale_rcc(first, "loss", 1 + 1e-3),
                          "first resumed step"),
            "mimi_step0": (os.path.join(root, "mimi_r0", "log.txt"), _scale_first("audio_loss", 1 + 1e-3),
                           "first resumed step"),
            "rcc_later": (os.path.join(root, "rcc_r0", "history.json"),
                          _scale_rcc(first + 1, "vqgan_gan_weight", 1 + 1e-2), "rcc step 1 vqgan_gan_weight"),
            "mimi_eval": (os.path.join(root, "mimi_r0", "log.txt"), _scale_first("eval_sisnr", 1 + 1e-2),
                          "mimi step 0 eval_sisnr")}
    if what in logs:
        path, edit, match = logs[what]
        saved = _move(path, edit)
        try:
            with pytest.raises(AssertionError, match=match):
                chip_smoke.dp_finetune_gates(spec)
        finally:
            with open(path, "w") as f:
                f.write(saved)
    elif what.startswith("rcc_params"):
        path = os.path.join(root, "rcc_r0", f"epoch{last}_trainable.msgpack")
        with open(path, "rb") as f:
            saved = f.read()
        tree = tckpt.load_pytree(path)
        if what == "rcc_params":
            tree["decoder"]["conv_out"]["kernel"].view(-1)[0] += 5 * chip_smoke.DP_RCC_LR
        else:
            for _, leaf in bridge.flatten(tree):
                leaf += 2 * chip_smoke.DP_PARAMS_APART_LR * chip_smoke.DP_RCC_LR
        tckpt.save_pytree(path, tree)
        try:
            with pytest.raises(AssertionError, match="parameters of two ranks"):
                chip_smoke.dp_finetune_gates(spec)
        finally:
            with open(path, "wb") as f:
                f.write(saved)
    elif what == "rank1_file":
        path = os.path.join(root, "mimi_r1", "log.txt")
        with open(path, "w") as f:
            f.write("{}\n")
        try:
            with pytest.raises(AssertionError, match="rank 1 wrote"):
                chip_smoke.dp_finetune_gates(spec)
        finally:
            os.remove(path)
    else:
        path = os.path.join(root, "rcc_r1", "checkpoint_meta.json")
        with open(path) as f:
            text = f.read()
        stat = os.stat(path)
        with open(path, "w") as f:
            f.write(text)
        os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns + 1_000_000))
        try:
            with pytest.raises(AssertionError, match="rank 1 wrote"):
                chip_smoke.dp_finetune_gates(spec)
        finally:
            os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns))
    chip_smoke.dp_finetune_gates(spec)  # put back: the gates pass again
