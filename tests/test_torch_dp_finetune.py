"""Port parity, data-parallel RCC finetuning (``torchrun -m
wmar_tpu_torch.finetune``) on the CPU.

Two gloo ranks (``parallel.launch.spawn_ranks``, a ``file://`` rendezvous
under the test's directory, spawned once for the file, one torch thread a
rank) run ``finetune.cli.main`` for each case at ``--batch_size_per_device
4``, a global batch of 8:

- Taming and MaskGit, ``--augs none``, from the JAX CLI's tiny weights: the
  history and deltas of JAX's ``finetune.py`` on the conftest's 8 host
  devices at ``--batch_size_per_device 1``;
- Taming with the GAN branch on (a discriminator file) over warmup, then
  weak, the seed picking the noise branch at both of the weak epoch's
  steps: the one process's run at batch 8 (torch's draws);

both at the tolerances of ``test_torch_port_finetune_cli.py`` (the GAN
weight, a ratio of the drift's gradient norms, at the drift's), and rank 1
writes no file. A two-rank run cut after one epoch and resumed ends bit for
bit where the uninterrupted two-rank run ends.

The gates, parametrised: each data-parallel piece on the ranks' rows (the
GAN branch's adaptive weight, the spectral-convergence STFT loss,
``tf_loudness``, the noise of the image and pink-noise branches), computed
as the trainers run it and again made rank-local, against the one process
on the whole batch: the first within ``UNIT_REL``, the second past it.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch.finetune import cli
from wmar_tpu_torch.finetune import gan as tgan
from wmar_tpu_torch.finetune import rcc as trcc
from wmar_tpu_torch.parallel.launch import spawn_ranks, wait
from wmar_tpu_torch.utils import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402
from test_torch_port_finetune_cli import (  # noqa: E402
    DRIFT_RTOL, LOSS_RTOL, LR, NOISY_SHARE, _jax_finetune, _tiny_adapter)

UNIT_REL = 1e-4  # a data-parallel piece against the one process, relative to the largest value
JAX_FLAGS = ["--synthetic", "40", "--nb_epochs", "1", "--augs", "none", "--lr", str(LR), "--idempotence_loss_weight",
             "100", "--log_every", "1", "--disable_gan", "--seed", "3"]
GAN_SEED = 9  # the weak epoch's two steps draw the noise branch (gate < 0.5)
GAN_FLAGS = ["--model", "taming", "--tiny", "--device", "cpu", "--synthetic", "24", "--nb_epochs", "2",
             "--augs_schedule", "1,1,0,0", "--lr", str(LR), "--idempotence_loss_weight", "100", "--log_every", "1",
             "--seed", str(GAN_SEED)]
RESUME_FLAGS = ["--model", "taming", "--tiny", "--device", "cpu", "--batch_size_per_device", "4", "--augs", "none",
                "--lr", "1e-3", "--val_percent", "0", "--seed", "5", "--log_every", "1"]


def _cases(workdir):
    out = lambda name: ["--outdir", os.path.join(workdir, name)]  # noqa: E731
    cases = [(f"jax_{m}", "rcc", ["--model", m, *JAX_FLAGS, "--device", "cpu", "--batch_size_per_device", "4",
                                  *out(f"jax_{m}_r{{rank}}")]) for m in ("taming", "rar")]
    cases.append(("gan", "rcc", GAN_FLAGS + ["--disc_ckpt", os.path.join(workdir, "disc.msgpack"),
                                             "--batch_size_per_device", "4", *out("gan_r{rank}")]))
    data = ["--datapath", os.path.join(workdir, "codes.npy")]
    cases += [("whole", "rcc", RESUME_FLAGS + data + ["--nb_epochs", "2", *out("whole_r{rank}")]),
              ("cut", "rcc", RESUME_FLAGS + data + ["--nb_epochs", "1", *out("cut")]),  # both ranks: one directory
              ("resumed", "rcc", RESUME_FLAGS + data + ["--nb_epochs", "2", "--resume", *out("cut")])]
    return cases


def unit_inputs(seed: int = 0) -> dict:
    """The gates' global batch: 8 rows of tiny-Taming codes, audio (a
    prediction and its target), images in [0, 1]."""
    rng = np.random.default_rng(seed)
    target = np.cumsum(rng.normal(size=(8, 2400, 1)), axis=1) / 40.0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return {"codes": torch.from_numpy(rng.integers(0, 64, size=(8, 256))),
            "target": f32(np.tanh(target)), "pred": f32(np.tanh(target + 0.1 * rng.normal(size=target.shape))),
            "images": f32(rng.uniform(size=(8, 32, 32, 3))), "audio": f32(0.3 * np.tanh(target))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs, JAX's and the one process's; the work directory."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    workdir = str(tmp_path_factory.mktemp("dp_finetune"))
    adapters, variables = {}, {}
    for m in ("taming", "rar"):
        adapters[f"jax_{m}"], variables[m] = _tiny_adapter(m)
    torch.save(adapters, os.path.join(workdir, "adapters.pt"))
    disc = tgan.init_taming_discriminator(torch.Generator().manual_seed(1), ndf=16)
    tckpt.save_pytree(os.path.join(workdir, "disc.msgpack"), bridge.flax_tree(disc))  # the JAX layout
    rows = np.random.default_rng(5).permutation(64 * 256)[: 16 * 256].reshape(16, 256) % 64
    np.save(os.path.join(workdir, "codes.npy"), rows.astype(np.int32))
    torch.save(unit_inputs(), os.path.join(workdir, "units.pt"))
    spawned = spawn_ranks(ranks.finetune_rank, 2, "gloo", f"file://{workdir}/rendezvous",
                          args=(workdir, _cases(workdir)), join=False)
    try:  # the references beside the ranks
        for m in ("taming", "rar"):
            _jax_finetune().main(["--model", m, *JAX_FLAGS, "--tiny", "--batch_size_per_device", "1", "--outdir",
                                  os.path.join(workdir, f"jax_{m}_jax")])
        cli.main(GAN_FLAGS + ["--disc_ckpt", os.path.join(workdir, "disc.msgpack"), "--batch_size_per_device", "8",
                              "--outdir", os.path.join(workdir, "gan_one")])
    finally:
        wait(spawned)
    yield workdir, variables
    torch.set_num_threads(n_threads)


def _history(path):
    with open(os.path.join(path, "history.json")) as f:
        return json.load(f)["epochs"]


def _rtol(key):
    return LOSS_RTOL if key in ("loss", "idem", "enc_dist", "idem_loss", "l0") else DRIFT_RTOL


def _same_history(got, want, validation_cells=("Identity_0",)):
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want]
    for ge, we in zip(got, want):
        assert len(ge["metrics"]) == len(we["metrics"])
        for gm, wm in zip(ge["metrics"], we["metrics"]):
            assert set(wm) <= set(gm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=_rtol(k), atol=2e-6, err_msg=f"{ge['epoch']} {k}")
        cells = validation_cells if validation_cells else [c for c in we["validation"] if c != "drift"]
        for cell in cells:
            for k, v in we["validation"][cell].items():
                np.testing.assert_allclose(ge["validation"][cell][k], v, rtol=_rtol(k), atol=2e-6,
                                           err_msg=f"{ge['epoch']} val {cell} {k}")


def _within_adam_steps(got, want, steps, label):
    """Every element within ``2 * lr`` a step, at most ``NOISY_SHARE`` of
    them more than ``lr`` apart."""
    diff = np.concatenate([np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
                           for g, w in zip(got, want)])
    assert diff.max() <= 2 * LR * steps, (label, diff.max())
    assert (diff > LR).mean() <= NOISY_SHARE, (label, (diff > LR).mean())


@pytest.mark.parametrize("model", ["taming", "rar"])
def test_two_ranks_give_jax_history_and_deltas(runs, model):
    """Two ranks of 4 rows against JAX's 8 devices of 1: the logged losses,
    the validation (2 held-out rows padded to the global batch) and both
    delta files; the file names are JAX's."""
    workdir, variables = runs
    got, want = (os.path.join(workdir, f"jax_{model}_{s}") for s in ("r0", "jax"))
    _same_history(_history(got), _history(want))
    params = variables[model]["params"]
    for part in ("encoder", "decoder"):
        name = f"epoch0_{part}_delta.msgpack"
        w = jckpt.load_pytree(os.path.join(want, name), params[part])
        g = tckpt.load_pytree(os.path.join(got, name), like=params[part])
        _within_adam_steps([np.asarray(x) for x in jax.tree.leaves(jax.tree.map(np.asarray, g))],
                           [np.asarray(x) for x in jax.tree.leaves(w)], 4, name)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert not os.path.exists(os.path.join(workdir, f"jax_{model}_r1"))


def _picks(seed, epoch, steps, level):
    """The branch each step draws (None: the gate said no), as the trainer
    draws them."""
    branches, logits = trcc.expand_level(level), trcc._branch_logits(level)
    probs = torch.from_numpy(np.exp(logits.astype(np.float64)))
    out = []
    for bi in range(steps):
        g = torch.Generator().manual_seed(seed + epoch * 100000 + bi)
        gate, index = float(torch.rand((), generator=g)), int(torch.multinomial(probs, 1, generator=g))
        out.append(branches[index].name if gate < 0.5 else None)
    return out


def test_two_ranks_give_the_one_process_gan_and_noise_run(runs):
    """The GAN branch on, warmup then weak, the noise branch drawn at both
    of the weak epoch's steps: the two ranks' history (every validation
    cell of both levels and the final one) and every epoch's trainable
    weights are the one process's at batch 8; the GAN metrics are logged."""
    workdir, _ = runs
    assert _picks(GAN_SEED, 1, 2, "weak") == ["noise", "noise"]
    got, want = (os.path.join(workdir, f"gan_{s}") for s in ("r0", "one"))
    hist = _history(got)
    _same_history(hist, _history(want), validation_cells=None)
    assert all({"vqgan_gan_loss", "vqgan_gan_weight"} <= set(m) for e in hist for m in e["metrics"])
    assert hist[1]["metrics"][1]["vqgan_gan_weight"] > 0
    for e in (0, 1):
        name = f"epoch{e}_trainable.msgpack"
        g, w = (dict(_flat(tckpt.load_pytree(os.path.join(d, name)))) for d in (got, want))
        assert g.keys() == w.keys()
        _within_adam_steps([g[k] for k in w], list(w.values()), 2 * (e + 1), name)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert not os.path.exists(os.path.join(workdir, "gan_r1"))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v.numpy() if isinstance(v, torch.Tensor) else v


def test_resumed_two_ranks_end_where_the_uninterrupted_run_ends(runs):
    """One epoch on two ranks, then ``--resume`` to two (both ranks read the
    file the first rank wrote): the weights, Adam's moments and the logged
    history of the uninterrupted two-rank run, bit for bit."""
    workdir, _ = runs
    whole, cut = (os.path.join(workdir, d) for d in ("whole_r0", "cut"))
    for name in ("epoch1_trainable.msgpack", "checkpoint.msgpack"):
        a, b = (dict(_flat(tckpt.load_pytree(os.path.join(d, name)))) for d in (whole, cut))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), name
    assert [e["metrics"] for e in _history(cut)] == [e["metrics"] for e in _history(whole)]
    assert [e["epoch"] for e in _history(cut)] == [0, 1]


@pytest.fixture(scope="module")
def units(runs):
    """Per gate: the two ranks' results (dp and rank-local) and the one
    process's on the whole batch."""
    workdir, _ = runs
    per_rank = [torch.load(os.path.join(workdir, f"rank{r}_units.pt")) for r in range(2)]
    return per_rank, ranks.dp_units(unit_inputs())


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def _gate_distance(case, how, per_rank, one) -> float:
    """The largest relative distance, over the pieces of ``case``, of the
    ranks' results computed ``how`` from the one process's."""
    want = one[case]["dp"]
    if case == "gan_weight":  # each rank's weight is the global batch's
        return max(_rel(r[case][how][0], want[0]) for r in per_rank)
    if case == "noise":  # the ranks' rows joined are the whole batch's draw
        return max(_rel(torch.cat([r[case][how][i] for r in per_rank]), want[i]) for i in range(2))
    value = _rel(torch.stack([r[case][how][0] for r in per_rank]).mean(), want[0])  # the logged mean
    grad = _rel(torch.cat([r[case][how][1] for r in per_rank]), want[1])  # the gradients' mean over the ranks
    return max(value, grad)


@pytest.mark.parametrize("case", ["gan_weight", "mrstft", "tf_loudness", "noise"])
def test_gate_passes_with_the_ranks_and_fails_rank_local(units, case):
    """The piece as the trainers run it on two ranks equals the one process
    on the whole batch within ``UNIT_REL``; made rank-local (the weight from
    the rank's gradients, the loss of the rank's rows, the noise drawn at
    the rank's shape), it misses by more."""
    per_rank, one = units
    assert _gate_distance(case, "dp", per_rank, one) <= UNIT_REL
    assert _gate_distance(case, "local", per_rank, one) > UNIT_REL
