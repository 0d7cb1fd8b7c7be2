"""Port parity, the RCC finetune entry point: ``python -m
wmar_tpu_torch.finetune`` (``finetune.cli.main``) against the JAX package's
root ``finetune.py`` on the CPU.

Both start from the JAX CLI's tiny weights (``--tiny`` draws them from
``PRNGKey(0)``; the test bridges the same tree into the port's adapter) and
see the same batches: synthetic codes, the validation split and the epoch
permutations all come from numpy seeds. The JAX CLI runs on the tests'
eight host devices, so its ``--batch_size_per_device 1`` is the port's 8.

Tolerances. The first step sits at the drift loss's kink: the trainable
decoder still equals the frozen one, so every L1 difference is 0. There
the port, as the reference's ``torch.abs``, has no drift gradient, while
JAX's jitted step decodes the two copies with different fusions and takes
the signs of float32 noise. Adam moves every parameter by about ``lr`` on
its first step whatever the size of its gradient, so the runs use
``--idempotence_loss_weight 100``: the idempotence term then sets the
direction of nearly every first update in both packages. The logged
losses and validations then agree at ``LOSS_RTOL``, the drift terms and
the gradient norm (which feel the first step's noise) at ``DRIFT_RTOL``.
Every element of the port's deltas lies within ``2 * lr * steps`` of
JAX's, and at most ``NOISY_SHARE`` of them more than ``lr`` apart.
"""

import argparse
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch.finetune import cli
from wmar_tpu_torch.finetune import rcc as trcc
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
LOSS_RTOL = 1e-3
DRIFT_RTOL = 3e-2
NOISY_SHARE = 0.02


def _jax_finetune():
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("finetune")
    finally:
        sys.path.remove(REPO)


def _tiny_adapter(model: str):
    """The port's adapter over the JAX CLI's tiny weights, and those weights."""
    if model == "rar":
        cfg = dict(cli.TINY_MASKGIT)
        variables = jmg.MaskGitVQGAN(jmg.MaskGitVQConfig(**cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
        variables = jax.tree.map(np.asarray, variables)
        return trcc.MaskGitRCCAdapter(bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**cfg)), variables)), \
            variables
    cfg = dict(cli.TINY_TAMING)
    variables = jvq.TamingVQGAN(jvq.VQGANConfig(**cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree.map(np.asarray, variables)
    return trcc.TamingRCCAdapter(bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**cfg)), variables)), \
        variables


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", ["taming", "rar"])
def test_cli_gives_jax_history_and_deltas(tmp_path, model):
    """``--augs none`` (two warmup epochs of four steps, validation first
    and final): the logged losses and validations are JAX's, the delta
    files have JAX's layout and values, and JAX's ``load_and_apply_delta``
    reads the port's deltas into the weights JAX trained."""
    common = ["--model", model, "--synthetic", "40", "--nb_epochs", "2", "--augs", "none", "--lr", str(LR),
              "--idempotence_loss_weight", "100", "--log_every", "1", "--disable_gan", "--seed", "3"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_finetune().main(common + ["--tiny", "--batch_size_per_device", "1", "--outdir", jdir])
    adapter, variables = _tiny_adapter(model)
    state = cli.main(common + ["--device", "cpu", "--batch_size_per_device", "8", "--outdir", tdir], adapter=adapter)
    steps = 8
    assert state.step == steps

    jh, th = (json.load(open(os.path.join(d, "history.json")))["epochs"] for d in (jdir, tdir))
    assert [e["epoch"] for e in th] == [e["epoch"] for e in jh] == [0, 1, 2]
    for je, te in zip(jh, th):
        assert len(te["metrics"]) == len(je["metrics"])
        for jm, tm in zip(je["metrics"], te["metrics"]):
            for k in ("loss", "idem", "enc_dist", "rec_l1", "perceptual", "grad_norm", "dec_dist"):
                rtol = LOSS_RTOL if k in ("loss", "idem", "enc_dist") else DRIFT_RTOL
                np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=2e-6, err_msg=f"{te['epoch']} {k}")
        for k in ("loss", "idem_loss", "vqgan_loss", "vqgan_rec_loss", "l0"):
            rtol = LOSS_RTOL if k in ("loss", "idem_loss", "l0") else DRIFT_RTOL
            np.testing.assert_allclose(te["validation"]["Identity_0"][k], je["validation"]["Identity_0"][k],
                                       rtol=rtol, atol=2e-6, err_msg=f"{te['epoch']} val {k}")

    params = variables["params"]
    for part, sub in (("encoder", "encoder"), ("decoder", "decoder")):
        for e in (0, 1):
            name = f"epoch{e}_{part}_delta.msgpack"
            want = jckpt.load_pytree(os.path.join(jdir, name), params[sub])
            got = tckpt.load_pytree(os.path.join(tdir, name), like=params[sub])
            diff = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel() for g, w in
                                   zip(jax.tree.leaves(jax.tree.map(np.asarray, got)), jax.tree.leaves(want))])
            assert diff.max() <= 2 * LR * (e + 1) * 4, (name, diff.max())
            assert (diff > LR).mean() <= NOISY_SHARE, (name, (diff > LR).mean())
        applied = jckpt.load_and_apply_delta(os.path.join(tdir, f"epoch1_{part}_delta.msgpack"), params[sub])
        trained = jckpt.load_pytree(os.path.join(jdir, "epoch1_trainable.msgpack"),
                                    {"decoder": params["decoder"], "watermark_encoder": params["encoder"]})
        diff = np.concatenate([np.abs(np.asarray(a) - np.asarray(w)).ravel() for a, w in zip(
            jax.tree.leaves(applied), jax.tree.leaves(trained["watermark_encoder" if part == "encoder" else "decoder"]))])
        assert diff.max() <= 2 * LR * steps and (diff > LR).mean() <= NOISY_SHARE
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


def _distinct_rows(path, n=16, seed=5):
    """``n`` distinct code rows of the tiny Taming tokenizer as an ``.npy``,
    so that the order of the batches shows in the weights."""
    rows = np.random.default_rng(seed).permutation(64 * 256)[: n * 256].reshape(n, 256) % 64
    assert len({r.tobytes() for r in rows}) == n
    np.save(path, rows.astype(np.int32))
    return rows


def test_cli_resume_continues_from_the_saved_epoch(tmp_path):
    """One epoch, then ``--resume`` with two: the run starts at epoch 1 from
    the saved weights, Adam state, schedule and step, trains on the
    uninterrupted run's batches (16 distinct rows, four steps an epoch, so
    epoch 1's shuffle differs from epoch 0's) and ends bit for bit where an
    uninterrupted two-epoch run ends; its ``history.json`` holds both
    epochs, with epoch 1 logged as the uninterrupted run logs it."""
    _distinct_rows(tmp_path / "codes.npy")
    common = ["--model", "taming", "--tiny", "--device", "cpu", "--datapath", str(tmp_path / "codes.npy"),
              "--batch_size_per_device", "4", "--augs", "none", "--lr", "1e-3", "--val_percent", "0", "--seed", "5",
              "--log_every", "1"]
    whole = cli.main(common + ["--nb_epochs", "2", "--outdir", str(tmp_path / "whole")])
    cut = cli.main(common + ["--nb_epochs", "1", "--outdir", str(tmp_path / "cut")])
    reread = trcc.init_state(cli.build_adapter(cli.get_parser().parse_args(common + ["--outdir", "x"]),
                                               torch.device("cpu")), trcc.RCCConfig(lr=1e-3), 4)
    cli.load_resume(str(tmp_path / "cut" / "checkpoint.msgpack"), reread)
    assert reread.step == cut.step == 4
    for a, b in zip(cut.optimizer.state.values(), reread.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert reread.scheduler.state_dict() == cut.scheduler.state_dict()
    resumed = cli.main(common + ["--nb_epochs", "2", "--resume", "--outdir", str(tmp_path / "cut")])
    assert resumed.step == whole.step == 8
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9**2)
    for (k, a), b in zip(whole.trainable.state_dict().items(), resumed.trainable.state_dict().values()):
        assert torch.equal(a, b), k
    hist, want = (json.load(open(tmp_path / d / "history.json"))["epochs"] for d in ("cut", "whole"))
    assert [e["epoch"] for e in hist] == [e["epoch"] for e in want] == [0, 1]
    for e, w in zip(hist, want):
        assert e["metrics"] == w["metrics"], e["epoch"]


def test_jax_resume_reshuffles_as_the_first_epoch(tmp_path, monkeypatch):
    """Fault (c) of the JAX package, pinned: after ``--resume`` its loop
    skips the finished epochs before it draws their permutations, so the
    resumed epoch 1 trains on epoch 0's batches, and its ``history.json``
    keeps the resumed epochs only. The port draws and discards the skipped
    epochs' permutations and carries the history in its checkpoint meta
    (the test above)."""
    import wmar_tpu.parallel as jpar

    rows = _distinct_rows(tmp_path / "codes.npy")
    seen = []
    shard = jpar.shard_batch

    def spy(mesh, batch):
        seen.append(np.asarray(batch))
        return shard(mesh, batch)

    monkeypatch.setattr(jpar, "shard_batch", spy)
    common = ["--model", "taming", "--tiny", "--datapath", str(tmp_path / "codes.npy"), "--batch_size_per_device",
              "1", "--augs", "none", "--lr", "1e-3", "--val_percent", "0", "--seed", "5", "--outdir",
              str(tmp_path / "jax")]
    jft = _jax_finetune()
    jft.main(common + ["--nb_epochs", "1"])
    jft.main(common + ["--nb_epochs", "2", "--resume"])
    rng = np.random.default_rng(5)
    perms = [rng.permutation(16) for _ in range(2)]
    batches = lambda perm: [rows[perm[:8]], rows[perm[8:]]]  # noqa: E731
    assert len(seen) == 4
    assert all(np.array_equal(a, b) for a, b in zip(seen[2:], batches(perms[0])))  # the resumed epoch 1
    assert not any(np.array_equal(a, b) for a, b in zip(seen[2:], batches(perms[1])))  # the uninterrupted run's
    hist = json.load(open(tmp_path / "jax" / "history.json"))["epochs"]
    assert [e["epoch"] for e in hist] == [1]


def test_cli_gan_and_curriculum_files(tmp_path):
    """Every level with the GAN branch on (a discriminator file in the JAX
    layout, ``{"layers": {"0": ...}}``): finite losses, Identity idem down
    from epoch 0 to the final validation, the GAN metrics logged, each
    epoch's deltas re-applied to the base giving that epoch's trainable."""
    from wmar_tpu.finetune import gan as jgan

    disc = jax.tree.map(np.asarray, jgan.init_taming_discriminator(jax.random.PRNGKey(1), ndf=16))
    jckpt.save_pytree(str(tmp_path / "disc.msgpack"), {"layers": disc})
    out = tmp_path / "out"
    cli.main(["--model", "taming", "--tiny", "--device", "cpu", "--synthetic", "40", "--batch_size_per_device", "4",
              "--nb_epochs", "4", "--augs_schedule", "1,1,1,1", "--lr", "1e-3", "--log_every", "4",
              "--disc_ckpt", str(tmp_path / "disc.msgpack"), "--outdir", str(out)])
    hist = json.load(open(out / "history.json"))["epochs"]
    assert [e["level"] for e in hist] == ["warmup", "weak", "medium", "strong", "final"]
    logged = [m for e in hist for m in e["metrics"]]
    assert logged and all(np.isfinite(v) for m in logged for v in m.values())
    assert all({"vqgan_gan_loss", "vqgan_gan_weight", "vqgan_gan_factor"} <= set(m) for m in logged)
    assert len(hist[3]["validation"]) == 1 + 23 + 1  # Identity, strong's cells, drift
    assert hist[-1]["validation"]["Identity_0"]["idem_loss"] < hist[0]["validation"]["Identity_0"]["idem_loss"]
    adapter = cli.build_adapter(argparse.Namespace(model="taming", tiny=True), torch.device("cpu"))
    for e in range(4):
        trained = tckpt.load_pytree(str(out / f"epoch{e}_trainable.msgpack"))
        for part, name in (("encoder", "watermark_encoder"), ("decoder", "decoder")):
            base = bridge.flax_tree(adapter.frozen_parts()[name])
            got = tckpt.load_and_apply_delta(str(out / f"epoch{e}_{part}_delta.msgpack"), base)
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6),
                         got, trained[name])


def test_bench_runs_at_the_entry_points_precision(tmp_path):
    """``tools/bench_rcc.py`` and ``python -m wmar_tpu_torch.finetune`` set
    the same TF32 switches through ``cli.set_precision`` (cuDNN on, matmuls
    off), whatever the process had before, and the bench reports them."""
    from wmar_tpu_torch.tools import bench_rcc

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, True
        (r,) = bench_rcc.main(["--tiny", "--device", "cpu", "--batch", "2", "--level", "warmup", "--iters", "1"])
        assert r["tf32"] == {"cudnn": True, "matmul": False} and np.isfinite(r["loss"]) and r["imgs_per_s"] > 0
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, True
        cli.main(["--model", "taming", "--tiny", "--device", "cpu", "--synthetic", "8", "--nb_epochs", "1",
                  "--augs", "none", "--no_validate", "--outdir", str(tmp_path)])
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_chameleon_builds_its_own_tokenizer(monkeypatch):
    """Fault (b) of the JAX package, pinned: its ``build_adapter`` sends
    ``--model chameleon7b`` to TAMING_IMAGENET_F16 (16,384 codes at 256 px),
    which Anole's 8,192-code 512 px tokenizer cannot load into. The port
    builds CHAMELEON_F16 for it."""
    jft = _jax_finetune()
    seen = {}

    def capture(path, like):
        seen["path"], seen["codebook"] = path, like["params"]["quantize"]["embedding"].shape
        raise RuntimeError("captured")

    monkeypatch.setattr(jckpt, "load_pytree", capture)
    with pytest.raises(RuntimeError, match="captured"):
        jft.build_adapter(argparse.Namespace(model="chameleon7b", tiny=False, modelpath="ckpt"))
    assert seen["codebook"] == (16384, 256) and seen["path"].endswith("vqgan.msgpack")

    def port_load(cls, cfg, path, device=None):
        seen["port"] = path
        with torch.device("meta"):
            return cls(cfg)

    monkeypatch.setattr(bridge, "load_flax_file", port_load)
    adapter = cli.build_adapter(argparse.Namespace(model="chameleon7b", tiny=False, modelpath="ckpt"),
                                torch.device("cpu"))
    assert adapter.model.cfg == tvq.CHAMELEON_F16 and tuple(adapter.model.quantize.embedding.shape) == (8192, 256)
    assert adapter.model.cfg.resolution == 512 and seen["port"].endswith("vqgan.msgpack")


def test_chip_smoke_rcc_phase_on_cpu(tmp_path):
    """``chip_smoke.py``'s "RCC finetune" phase with the CLI's tiny models on
    the CPU: both tokenizers through files and the entry point, its gates,
    then the sweep's Taming run with epoch 3's deltas, whose tokenizer is
    base + delta within bf16 rounding (exactly here: float32)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    rcc = chip_smoke.phase_rcc_finetune("cpu", str(tmp_path), tiny=True, rows=24, batch=4, bench_batches=(2,),
                                        bench_iters=1)
    assert set(rcc["runs"]) == {"Taming", "MaskGit"} and len(rcc["bench"]) == 1
    assert rcc["runs"]["Taming"]["gan"] and not rcc["runs"]["MaskGit"]["gan"]
    for run in rcc["runs"].values():
        assert run["steps"] == 20 and run["identity_idem"][1] < run["identity_idem"][0]
        assert set(run["imgs_per_s"]) == {"warmup", "weak", "medium", "strong"}
    tuned = [f"--{part}_ft_ckpt={rcc['runs']['Taming']['deltas'][part]}" for part in ("encoder", "decoder")]
    out = chip_smoke.phase_attack_sweep("cpu", tiny=True, n_rar=1, n_taming=2, taming_extra=tuned,
                                        inspect=chip_smoke.check_tuned_tokenizer(rcc))
    assert list(out["runs"]) == ["RAR-XL", "Taming-1.4B"] and out["runs"]["Taming-1.4B"]["records"] == 2 * 64
    assert rcc["runs"]["Taming"]["generate_decoder_err"] == 0.0
