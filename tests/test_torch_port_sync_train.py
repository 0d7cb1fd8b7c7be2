"""Port parity, SyncSeal training: the quantizable UNet and the
discriminator, the valuemetric bank, the geometric corner sampler, the
reference-spec model and discriminator steps under AdamW and the cosine
schedule (fed JAX's draws), the train state across the bridge, JAX's faults
(e) and (f) against the port's trainer, the YAML configs and their reader,
the eval grid (SSIM, corner errors, SIFT), the WAM corner baseline, and
the files the trainer writes, against the JAX package on the CPU.

Tolerances: the loss terms within 1e-5 relative; gradients within 1e-4 of
their largest magnitude; parameters after a step within 1e-5 where Adam's
first update is decided. Adam's first update of an element is
``lr * g / (|g| + eps)``: where ``|g|`` sits at the float32 noise of the
gradient sums (under 1e-7, or under ten times the gap between the two
packages' gradients), the update follows the noise's sign in either
package, so those elements, at most 1% of a model, are held to the bound of
two updates (2 lr) instead.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wmar_tpu.finetune.perceptual import PerceptualLoss as JPerceptual
from wmar_tpu.sync import configs as jcfg
from wmar_tpu.sync import syncseal as jss
from wmar_tpu.sync import syncseal_models as jsm
from wmar_tpu.sync import wam_logic as jwl
from wmar_tpu_torch import bridge
from wmar_tpu_torch.finetune.perceptual import PerceptualLoss
from wmar_tpu_torch.sync import configs as tcfg
from wmar_tpu_torch.sync import syncseal as tss
from wmar_tpu_torch.sync import syncseal_models as tsm
from wmar_tpu_torch.sync import wam_logic as twl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(z_channels=8, num_blocks=1, z_channels_mults=(1, 2), norm_groups=4)
QUANT = dict(activation="relu", normalization="batch")
J_CN = jsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16), out_dim=8)
T_CN = tsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16), out_dim=8)
LR, TOTAL, B, SIDE = 1e-3, 10, 4, 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the fast tier runs six workers on the
    machine's cores, where torch's default of a thread per core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _capture(inner):
    """``inner`` whose state also keeps the last gradients, so one jitted
    JAX step gives both the update and the gradients."""
    def init(p):
        return inner.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


@jax.jit
def _jax_draw_arrays(key):
    k_aug, k_type, k_geo = jax.random.split(key, 3)
    keys = jax.random.split(k_aug, B)
    noise = jax.vmap(lambda k: jax.random.normal(k, (1, SIDE, SIDE, 3))[0])(keys)
    return (jax.random.randint(k_type, (B,), 0, 11), noise,
            jax.vmap(lambda k: jss.sample_geometric_corners(k))(jax.random.split(k_geo, B)))


def _jax_draws(key):
    """The draws JAX's model step makes from ``key``: the branch ids, the
    noise of the noise branch's images and the corners (one jitted call; a
    vmap over the keys draws what each key draws alone)."""
    ids, noise, corners = (np.asarray(a) for a in _jax_draw_arrays(key))
    return tss.RefDraws(_t(ids), _t(noise[ids == tss.NOISE_BRANCH]), _t(corners))


_branch_ids = jax.jit(lambda key: jax.random.randint(jax.random.split(key, 3)[1], (B,), 0, 11))


def _key_with_noise(b=B):
    """The first key whose draws give each image its own branch, one of
    them the noise."""
    for i in range(200):
        ids = np.asarray(_branch_ids(jax.random.PRNGKey(i)))
        if tss.NOISE_BRANCH in ids and len(set(ids.tolist())) == b:
            return jax.random.PRNGKey(i)
    raise AssertionError("no key")


def _sd(tree, unet_cfg):
    tree = jax.tree.map(np.asarray, tree)
    return bridge.syncseal_ref_state_dict(tree["unet"], tree["convnext"], unet_cfg, T_CN)


def _port_state(params, unet_cfg):
    model = tss.SyncSealRef(unet_cfg=unet_cfg, convnext_cfg=T_CN)
    model.load_state_dict(_sd(params, unet_cfg))
    return tss.init_ref_train_state(model, LR, TOTAL, seed=3)


def _maxabs(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _params_close(named, want_sd, grads_sd, label):
    """Each parameter within 1e-5 of JAX's where Adam's first update is
    decided: the gradient above 1e-7 and ten times the gap between the two
    packages' gradients. Elsewhere the update follows float32 noise (within
    two updates, 2 lr), and those elements are at most 1% of the model."""
    n_noise = n_all = 0
    for name, p in named:
        err = (p.detach() - want_sd[name]).abs()
        g = grads_sd[name].abs()
        noisy = g <= torch.clamp(10 * (p.grad - grads_sd[name]).abs(), min=1e-7)
        n_noise += int(noisy.sum())
        n_all += noisy.numel()
        assert _maxabs(err[~noisy]) <= 1e-5, (label, name, _maxabs(err[~noisy]))
        assert _maxabs(err[noisy]) <= 2 * LR + 1e-5, (label, name)
    assert n_noise <= 0.01 * n_all, (label, n_noise, n_all)


@pytest.fixture(scope="module", params=["group", "quantizable"])
def jax_run(request):
    """JAX's steps on a tiny SyncSealRef (32 px, batch 4, the pyramid
    perceptual loss): a model step and a disc step from the initial state,
    then a detector-only model step and a second model step from there."""
    kw = {**TINY, **(QUANT if request.param == "quantizable" else {})}
    ju, tu = jsm.UNetConfig(**kw), tsm.UNetConfig(**kw)
    sched = optax.cosine_decay_schedule(LR, TOTAL, 1e-2)
    opt, opt_d = _capture(optax.adamw(sched)), _capture(optax.adamw(sched))
    model = jss.SyncSealRef.init(0, unet_cfg=ju, convnext_cfg=J_CN)
    ms, ds = jss.make_ref_train_steps(model, opt, opt_d, jss.RefTrainConfig(), perceptual=JPerceptual())
    ms, ds = jax.jit(ms), jax.jit(ds)
    imgs = np.random.default_rng(0).uniform(0, 1, (B, SIDE, SIDE, 3)).astype(np.float32)
    key, key2 = _key_with_noise(), jax.random.PRNGKey(1000)
    st0 = jss.init_ref_train_state(model, opt, opt_d, seed=3)
    args = (jnp.asarray(imgs), key, jnp.float32(0.2), jnp.float32(1.0))
    st1, m1 = ms(st0, *args, jnp.bool_(False))
    st2, d1 = ds(st1, *args)
    st3, _ = ms(st2, jnp.asarray(imgs), key2, jnp.float32(0.2), jnp.float32(1.0), jnp.bool_(True))
    st4, _ = ms(st2, jnp.asarray(imgs), key2, jnp.float32(0.2), jnp.float32(1.0), jnp.bool_(False))
    return dict(kind=request.param, tu=tu, imgs=imgs, key=key, key2=key2, st0=st0, st1=st1, st2=st2, st3=st3,
                st4=st4, m1=m1, d1=d1)


def test_model_loss_terms_and_gradients_match_jax(jax_run):
    """One model step's loss terms within 1e-5 relative of JAX's and its
    gradients within 1e-4 of the largest, fed JAX's draws."""
    r = jax_run
    state = _port_state(r["st0"][0], r["tu"])
    state.disc.requires_grad_(False)
    total, metrics = tss.ref_model_loss(state, _t(r["imgs"]), _jax_draws(r["key"]), 0.2, 1.0, False,
                                        tss.RefTrainConfig(), PerceptualLoss())
    for k in ("percep", "gan_g", "detect", "transform", "loss"):
        want = float(r["m1"][k])
        got = float(metrics[k].detach())
        assert abs(got - want) <= 1e-5 * abs(want), (r["kind"], k, got, want)
    total.backward()
    grads = _sd(r["st1"][1][1], r["tu"])
    gmax = max(float(g.abs().max()) for g in grads.values())
    for name, p in state.model.named_parameters():
        assert float((p.grad - grads[name]).abs().max()) <= 1e-4 * gmax, (r["kind"], name)


def test_model_and_disc_steps_match_jax(jax_run):
    """A model step then a disc step (AdamW, optax's decay 1e-4, the cosine
    schedule): the disc step's terms equal JAX's, both models' parameters
    JAX's after them."""
    r = jax_run
    state = _port_state(r["st0"][0], r["tu"])
    model_step, disc_step = tss.make_ref_train_steps(state, tss.RefTrainConfig(), PerceptualLoss())
    imgs = _t(r["imgs"])
    model_step(imgs, 0.2, 1.0, False, draws=_jax_draws(r["key"]))
    dm = disc_step(imgs, 0.2, 1.0)
    for k in ("disc_loss", "logits_real", "logits_fake"):
        want = float(r["d1"][k])
        assert abs(float(dm[k]) - want) <= 1e-5 * max(abs(want), 1e-3), (k, float(dm[k]), want)
    _params_close(state.model.named_parameters(), _sd(r["st2"][0], r["tu"]), _sd(r["st1"][1][1], r["tu"]), "model")
    disc_grads = bridge.discriminator_state_dict(jax.tree.map(np.asarray, r["st2"][3][1]))
    _params_close(state.disc.named_parameters(), bridge.discriminator_state_dict(jax.tree.map(np.asarray, r["st2"][2])),
                  disc_grads, "disc")
    assert state.sched.last_epoch == 1 and state.sched_d.last_epoch == 1


def test_train_state_crosses_the_bridge(jax_run):
    """JAX's state after a step of each (parameters, both Adam moments and
    counts) loaded into the port: the port's next model step on JAX's draws
    lands on JAX's parameters."""
    r = jax_run
    state = _port_state(r["st0"][0], r["tu"])
    bridge.load_ref_train_state(state, jax.tree.map(lambda x: np.asarray(x), r["st2"]))
    assert state.sched.last_epoch == 1 and float(state.opt.param_groups[0]["lr"]) == pytest.approx(
        float(optax.cosine_decay_schedule(LR, TOTAL, 1e-2)(1)), rel=1e-6)
    model_step, _ = tss.make_ref_train_steps(state, tss.RefTrainConfig(), PerceptualLoss())
    model_step(_t(r["imgs"]), 0.2, 1.0, False, draws=_jax_draws(r["key2"]))
    want = _sd(r["st4"][0], r["tu"])
    for name, p in state.model.named_parameters():  # the second update is conditioned by the moments
        assert float((p.detach() - want[name]).abs().max()) <= 1e-5, name


def test_fault_e_detector_only_step_leaves_the_unet(jax_run):
    """Fault (e): after a normal step, JAX's detector-only step still moves
    the UNet (adamw's decay and momentum act on zero gradients); the port's
    leaves it bit-equal, and both move the ConvNeXt."""
    r = jax_run
    ju2, ju3 = (jax.tree.map(np.asarray, r[k][0]["unet"]) for k in ("st2", "st3"))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(jax.tree.leaves(ju2), jax.tree.leaves(ju3)))
    assert moved > 1e-6
    state = _port_state(r["st0"][0], r["tu"])
    model_step, disc_step = tss.make_ref_train_steps(state, tss.RefTrainConfig(), PerceptualLoss())
    imgs = _t(r["imgs"])
    model_step(imgs, 0.2, 1.0, False, draws=_jax_draws(r["key"]))
    disc_step(imgs, 0.2, 1.0)
    unet = {k: v.clone() for k, v in state.model.embedder.state_dict().items()}
    cn = {k: v.clone() for k, v in state.model.extractor.state_dict().items()}
    model_step(imgs, 0.2, 1.0, True, draws=_jax_draws(r["key2"]))
    for k, v in state.model.embedder.state_dict().items():
        assert torch.equal(v, unet[k]), k
    assert max(float((v - cn[k]).abs().max()) for k, v in state.model.extractor.state_dict().items()) > 0


# ---------------------------------------------------------------------------
# The pieces of the step
# ---------------------------------------------------------------------------


def test_quantizable_unet_and_discriminator_forward_match_jax():
    """The quantizable UNet (ReLU, batch norm over the batch) and the
    discriminator on JAX's weights; the discriminator's init equals JAX's
    numpy draws, and ``hinge_d_loss`` JAX's."""
    cfg = dict(TINY, **QUANT)
    params = jsm.init_unet_params(5, jsm.UNetConfig(**cfg))
    x = np.random.default_rng(1).uniform(-1, 1, (3, 16, 16, 1)).astype(np.float32)
    unet = tsm.UNet(tsm.UNetConfig(**cfg))
    unet.load_state_dict({k[len("embedder.unet."):]: v for k, v in bridge.syncseal_ref_state_dict(
        params, jsm.init_convnext_params(0, J_CN), tsm.UNetConfig(**cfg), T_CN).items() if k.startswith("embedder.")})
    want = jax.jit(lambda p, v: jsm.unet_forward(p, jsm.UNetConfig(**cfg), v))(params, jnp.asarray(x))
    _close(unet(_t(x)).detach(), want, 1e-5)
    assert dataclasses.asdict(tsm.UNET_SMALL2_YUV_QUANTIZABLE) == dataclasses.asdict(jsm.UNET_SMALL2_YUV_QUANTIZABLE)
    disc = tsm.init_discriminator(2)
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jd = jsm.init_discriminator_params(2)
    got = disc(_t(imgs)).detach()
    want = jax.jit(jsm.discriminator_forward)(jax.tree.map(jnp.asarray, jd), jnp.asarray(imgs))
    _close(got, want, 1e-5)
    fake = disc(_t(imgs[::-1].copy())).detach()
    assert float(tsm.hinge_d_loss(got, fake)) == pytest.approx(
        float(jsm.hinge_d_loss(want, jnp.asarray(fake.numpy()))), rel=1e-6)
    ref_sd = {f"d.{k}": v for k, v in disc.state_dict().items()}
    converted = tsm.convert_discriminator({k.replace("d.main.", "x."): v for k, v in ref_sd.items()}, prefix="x.")
    assert all(torch.equal(converted[k], v) for k, v in disc.state_dict().items())


@pytest.mark.parametrize("branch", range(11))
def test_valuemetric_branch_matches_jax(branch):
    """Each branch of the in-training bank on a batch, the noise fed, within
    1e-5 of JAX's; grouped by id, a batch of all branches at once too."""
    imgs = np.random.default_rng(branch).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(branch)
    want = jax.jit(jss.valuemetric_branches()[branch])(jnp.asarray(imgs), key)  # one compile, not op by op
    noise = np.asarray(jax.random.normal(key, imgs.shape))
    got = tss.apply_valuemetric(_t(imgs), torch.full((2,), branch), _t(noise))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("case", ["shrink", "grow", "up2", "up4", "pad"])
def test_deterministic_forms_match_the_library_ops(case):
    """Under ``torch.use_deterministic_algorithms`` (the trainer's
    ``--deterministic``) the resizes, the UNet's upsampling and its reflect
    pad take forms whose backward is deterministic on the card: values and
    gradients within 1e-6 of ``F.interpolate`` / ``F.pad``'s (relative to
    the largest where that exceeds 1: an input's gradient sums up to 16
    outputs), and the
    resizes within 1e-6 of ``jax.image.resize``."""
    from wmar_tpu_torch.augmentations import geometric as TG

    gen = torch.Generator().manual_seed(0)
    if case in ("shrink", "grow"):
        x, size = torch.rand(2, 24, 20, 3, generator=gen), ((13, 9) if case == "shrink" else (40, 31))
        fn = lambda v: TG.resize_linear(v, size)  # noqa: E731
        want = jax.image.resize(jnp.asarray(x.numpy()), (2, *size, 3), "linear")
    elif case == "pad":
        x, fn, want = torch.rand(2, 3, 7, 5, generator=gen), tsm.ReflectPad1(), None
    else:
        x, want = torch.rand(2, 3, 7, 5, generator=gen), None
        fn = lambda v: TG.bilinear_up_nchw(v, int(case[2:]))  # noqa: E731
    probe = torch.rand(fn(x).shape, generator=gen)
    outs = {}
    saved = torch.are_deterministic_algorithms_enabled()
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        try:
            v = x.clone().requires_grad_(True)
            out = fn(v)
            (out * probe).sum().backward()
            outs[det] = (out.detach(), v.grad)
        finally:
            torch.use_deterministic_algorithms(saved)
    for got, lib in zip(outs[True], outs[False]):
        _close(got, lib, 1e-6 * max(1.0, _maxabs(lib)))
    if want is not None:
        _close(outs[True][0], want, 1e-6)


def test_valuemetric_grouping_keeps_each_image_in_its_row():
    imgs = np.random.default_rng(0).uniform(0, 1, (11, 16, 16, 3)).astype(np.float32)
    ids = torch.randperm(11, generator=torch.Generator().manual_seed(0))
    noise = torch.randn(1, 16, 16, 3)
    got = tss.apply_valuemetric(_t(imgs), ids, noise)
    for i, k in enumerate(ids.tolist()):
        one = tss.apply_valuemetric(_t(imgs[i: i + 1]), torch.tensor([k]), noise)
        _close(got[i], one[0], 0)


def test_geometric_corners_from_jax_draws():
    """Fed JAX's family and uniforms, ``sample_geometric_corners`` gives
    JAX's corners (all five families, two perspective strengths)."""
    keys = jax.random.split(jax.random.PRNGKey(3), 40)

    def draws(k):
        k_type, k1, _ = jax.random.split(k, 3)
        return jax.random.randint(k_type, (), 0, 5), jax.random.uniform(k1, ()), jax.random.uniform(k1, (4, 2))

    fam, u0, u42 = (np.asarray(a) for a in jax.jit(jax.vmap(draws))(keys))
    assert set(fam.tolist()) == set(range(5))
    uniforms = np.where((fam == 3)[:, None, None], u42, np.broadcast_to(u0[:, None, None], (40, 4, 2)))
    corners = jax.jit(jax.vmap(lambda k, s: jss.sample_geometric_corners(k, perspective_strength=s), (0, None)))
    for strength in (0.25, 0.05):
        want = corners(keys, strength)
        got = tss.sample_geometric_corners(40, perspective_strength=strength, family=_t(fam), uniforms=_t(uniforms))
        _close(got, want, 1e-6)
    weighted = tss.sample_geometric_corners(64, torch.Generator().manual_seed(0), probs=(1.0, 0, 0, 0, 0))
    _close(weighted, np.tile(np.asarray(tss.TV_CORNERS), (64, 1, 1)), 0)


def test_scaling_schedule_and_cosine_decay_match_jax():
    cfg = tss.RefTrainConfig(scaling_w=0.2, scaling_w_min=0.05, schedule_epochs=10)
    jcfg_ = jss.RefTrainConfig(scaling_w=0.2, scaling_w_min=0.05, schedule_epochs=10)
    for e in (0, 5, 10, 99):
        assert tss.scaling_w_at(cfg, e) == jss.scaling_w_at(jcfg_, e)
    sched, fn = optax.cosine_decay_schedule(1e-4, 24, 1e-2), tss.cosine_decay(24)
    for c in (0, 1, 7, 24, 30):
        assert 1e-4 * fn(c) == pytest.approx(float(sched(c)), rel=1e-6)


# ---------------------------------------------------------------------------
# The eval grid and the WAM corner baseline
# ---------------------------------------------------------------------------


def test_ssim_and_eval_grid_match_jax(monkeypatch):
    """``ssim`` and every row of ``evaluate_sync_ref`` (12 cells, SIFT
    included where OpenCV imports) fed JAX's corners and noise."""
    ju, tu = jsm.UNetConfig(**TINY), tsm.UNetConfig(**TINY)
    jm = jss.SyncSealRef.init(0, unet_cfg=ju, convnext_cfg=J_CN)
    tm = tss.SyncSealRef.init(0, unet_cfg=tu, convnext_cfg=T_CN)
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    a, b = imgs, np.clip(imgs + np.random.default_rng(1).normal(0, 0.05, imgs.shape), 0, 1).astype(np.float32)
    _close(tss.ssim(_t(a), _t(b)), jss.ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    try:
        import cv2  # noqa: F401
        sift = True
    except ImportError:
        sift = False
    rng = jax.random.PRNGKey(0)
    jm.embed01, jm.detect01 = jax.jit(jm.embed01), jax.jit(jm.detect01)  # JAX's eager ops are slow
    for name in ("apply_tv_corner_warp", "ssim", "sample_geometric_corners"):
        monkeypatch.setattr(jss, name, jax.jit(getattr(jss, name)))
    from wmar_tpu.augmentations import valuemetric as JV

    for name in ("jpeg_diff", "gaussian_blur"):
        monkeypatch.setattr(JV, name, jax.jit(getattr(JV, name), static_argnums=1))
    want = jss.evaluate_sync_ref(jm, jnp.asarray(imgs), rng, with_sift_baseline=sift)
    corners = [np.asarray(jax.vmap(lambda k: jss.sample_geometric_corners(k, perspective_strength=s))(
        jax.random.split(jax.random.fold_in(rng, gi), 2))) for gi, s in enumerate(tss.EVAL_STRENGTHS)]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), imgs.shape))
    got = tss.evaluate_sync_ref(tm, _t(imgs), corners=corners, noise=_t(noise), with_sift_baseline=sift)
    assert got["quality"]["psnr"] == pytest.approx(want["quality"]["psnr"], rel=1e-5)
    assert got["quality"]["ssim"] == pytest.approx(want["quality"]["ssim"], abs=1e-6)
    assert len(got["grid"]) == len(want["grid"]) == 12
    for g, w in zip(got["grid"], want["grid"]):
        assert (g["strength"], g["valuemetric"]) == (w["strength"], w["valuemetric"])
        assert g["corner_mae"] == pytest.approx(w["corner_mae"], abs=1e-5)
        if sift:
            assert (g["sift_corner_mae"] is None) == (w["sift_corner_mae"] is None), g
            if w["sift_corner_mae"] is not None:
                assert g["sift_corner_mae"] == pytest.approx(w["sift_corner_mae"], abs=1e-3), g


def test_wam_corner_baseline_matches_jax_over_the_mock():
    """The corners of ``WamSync``'s estimates after a flip, a rotation and
    an upper-left crop, over the mock pixel watermark of the sync tests."""
    from tests.test_torch_port_sync import _mock_syncs

    from wmar_tpu_torch.augmentations import geometric as TG

    tsync, jsync = _mock_syncs(64)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    x[..., 2] = 0.0
    s01 = (tsync.add_sync(_t(x)) + 1) / 2
    attacked = torch.cat([TG.hflip(s01), TG.rotate(s01, 10.0), TG.upper_left_crop_resize_back(s01, 0.75)])
    got = tss.wam_corner_baseline(tsync, attacked * 2 - 1, image_size=64)
    want = jss.wam_corner_baseline(jsync, jnp.asarray(attacked.numpy() * 2 - 1), image_size=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert isinstance(twl.WamSync, type) and isinstance(jwl.WamSync, type)


def test_flax_design_train_step_and_eval_run():
    """The Flax design's ``make_train_step`` and ``evaluate_sync`` (random
    draws): finite metrics, the embedder trained (its output conv starts at
    zero)."""
    model = tss.SyncSealModel.init(0, tss.SyncSealConfig(image_size=32))
    step = tss.make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    imgs = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    metrics = step(imgs, gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(model.embedder.out.weight.abs().max()) > 0
    report = tss.evaluate_sync(model, imgs, gen)
    assert len(report["grid"]) == 3 and np.isfinite(report["psnr"])
    corners = tss.random_corner_homography(3, gen, jitter=torch.zeros(3, 4, 2), flip=torch.tensor([0, 1, 0]).bool())
    _close(corners[0], tss.CANON_CORNERS, 0)
    _close(corners[1][:, 0], 1 - tss.CANON_CORNERS[:, 0], 0)


# ---------------------------------------------------------------------------
# The YAML configs
# ---------------------------------------------------------------------------

EMBEDDER_YAML = """\
model: tiny
tiny:
  z_channels: 4
  num_blocks: 1
  z_channels_mults: [1, 2]
  activation: relu
  normalization: batch
  last_tanh: True
unet_small2_yuv:   # the shipped one
  z_channels: 16
  z_channels_mults: [1, 2, 4, 8]
"""
AUGS_YAML = """\
# all_augs-style weights
augs:
  identity: 2
  crop: 1
  jpeg: 1
  brightness: 1
  median_filter: 0
  hue: 0.0
  unknown_aug: 3
"""
EXTRACTOR_YAML = """\
model: convnext_tiny
convnext_tiny:
  encoder:
    depths: [1, 1]
    dims: [8, 16]
  head:
    out_dim: 8
sam_small:
  encoder:
    embed_dim: 16
    depth: 2
    num_heads: 2
    window_size: 2
    global_attn_indexes: [1]
    patch_size: 8
  pixel_decoder:
    upscale_stages: [2, 2, 2]
    nbits: 8
"""
ATTEN_YAML = "jnd_1_1:\n  in_channels: 1\n  out_channels: 1\njnd_3_3:\n  in_channels: 3\n  out_channels: 3\n"
DATASET_YAML = "train_dir: /data/train\nval_dir: /data/val\ntrain_annotation_file: null\n"
EXTRA_YAML = "a: 1.0e-4\nb: 1e-4\nc: ~\nd: 'q s'\ne: [[1, 2], []]\nf: -3\ng: yes\nh:\ni: .5\nj: 007x\n"


@pytest.mark.parametrize("text", [EMBEDDER_YAML, AUGS_YAML, EXTRACTOR_YAML, ATTEN_YAML, DATASET_YAML, EXTRA_YAML])
def test_yaml_reader_equals_safe_load(text):
    yaml = pytest.importorskip("yaml")
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: *x\n", "a: |\n  x\n", "---\na: 1\n",
                                  "a: !!str 1\n", "a: 0x1f\n", "a:\n\tb: 1\n", "a: [1, {b: 2}]\n", "- 1\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(tcfg.YAMLSubsetError):
        tcfg.parse_yaml(text)


def test_config_loaders_give_jax_dataclasses(tmp_path):
    files = {}
    for name, text in (("embedder", EMBEDDER_YAML), ("augs", AUGS_YAML), ("extractor", EXTRACTOR_YAML),
                       ("atten", ATTEN_YAML), ("ds", DATASET_YAML)):
        files[name] = str(tmp_path / f"{name}.yaml")
        with open(files[name], "w") as f:
            f.write(text)
    assert dataclasses.asdict(tcfg.load_embedder_config(files["embedder"])) == dataclasses.asdict(
        jcfg.load_embedder_config(files["embedder"]))
    assert dataclasses.asdict(tcfg.load_extractor_config(files["extractor"])) == dataclasses.asdict(
        jcfg.load_extractor_config(files["extractor"]))
    assert dataclasses.asdict(tcfg.load_augs_config(files["augs"])) == dataclasses.asdict(
        jcfg.load_augs_config(files["augs"]))
    assert tcfg.load_attenuation_config(files["atten"]) == jcfg.load_attenuation_config(files["atten"]) == (1, 1)
    with pytest.raises(NotImplementedError):
        tcfg.load_attenuation_config(files["atten"], "jnd_3_3")
    assert tcfg.load_dataset_config(files["ds"]) == jcfg.load_dataset_config(files["ds"])
    sam = str(tmp_path / "sam.yaml")
    with open(sam, "w") as f:
        f.write(EXTRACTOR_YAML.replace("model: convnext_tiny", "model: sam_small"))
    assert dataclasses.asdict(tcfg.load_extractor_config(sam, img_size=32)) == dataclasses.asdict(
        jcfg.load_extractor_config(sam, img_size=32))


# ---------------------------------------------------------------------------
# The trainer: YAML configs, fault (f), the files it writes
# ---------------------------------------------------------------------------

TINY_ARGS = ["--synthetic", "true", "--tiny", "--steps_per_epoch", "2", "--batch_size", "2", "--img_size", "32",
             "--eval_freq", "100", "--lambda_i", "0", "--device", "cpu"]


def test_trainer_with_yaml_configs_runs_and_copies_them(tmp_path):
    """``train_syncseal --tiny --device cpu`` with an embedder.yaml that
    selects the quantizable variant and an aug-weights yaml: it runs, logs
    finite numbers and copies the configs (train_sync.py:197-201)."""
    from wmar_tpu_torch import train_syncseal

    emb, augs = tmp_path / "embedder.yaml", tmp_path / "augs.yaml"
    emb.write_text(EMBEDDER_YAML)
    augs.write_text(AUGS_YAML)
    out = train_syncseal.main(["--output_dir", str(tmp_path / "run"), "--epochs", "1", *TINY_ARGS,
                               "--embedder_config", str(emb), "--augmentation_config", str(augs)])
    assert (tmp_path / "run" / "configs" / "embedder.yaml").read_text() == EMBEDDER_YAML
    assert (tmp_path / "run" / "configs" / "augs.yaml").exists()
    assert out["state"].model.unet_cfg.normalization == "batch"
    assert all(np.isfinite(v) for v in out["log"][0].values() if isinstance(v, float))
    assert (tmp_path / "run" / "log.jsonl").exists() and (tmp_path / "run" / "eval_0000.json").exists()


def test_fault_f_port_resume_ends_where_an_uninterrupted_run_ends(tmp_path):
    """Fault (f), the port: a run of 3 epochs stopped after 2 (a copy of its
    directory then) and resumed to 3 equals the 3 epochs straight, bit for
    bit (checkpoint, log of epoch 2, eval), with a detector-only epoch in
    between."""
    import shutil

    from wmar_tpu_torch import train_syncseal

    args = ["--epochs", "3", *TINY_ARGS, "--finetune_detector_start", "1"]

    def stop_after_two(epoch):
        if epoch == 1:
            shutil.copytree(tmp_path / "b", tmp_path / "a")

    straight = train_syncseal.main(["--output_dir", str(tmp_path / "b"), *args], on_epoch_end=stop_after_two)
    resumed = train_syncseal.main(["--output_dir", str(tmp_path / "a"), *args])
    assert [r["epoch"] for r in resumed["log"]] == [2]
    a, b = (torch.load(tmp_path / d / "checkpoint.pt", weights_only=True) for d in "ab")
    for part in ("model", "disc"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for k in ("loss", "detect", "transform"):
        assert resumed["log"][0][k] == straight["log"][-1][k]
    assert resumed["evals"][2]["grid"] == straight["evals"][2]["grid"]


def test_fault_f_jax_resume_repeats_the_first_epoch(tmp_path, monkeypatch):
    """Fault (f), JAX: ``train_syncseal.py --resume`` after 1 epoch starts
    its epoch 1 from ``PRNGKey(seed)`` and a fresh batch source, so it draws
    epoch 0's keys and batches again (steps spied, the model untouched)."""
    sys.path.insert(0, ROOT)
    import train_syncseal as jtrain

    seen = []

    def fake_steps(model, optimizer, optimizer_d, cfg, perceptual=None, aug_weights=None):
        def model_step(state, imgs, rng, sw, df, detector_only):
            jax.debug.callback(lambda i, k: seen[-1].append((np.array(i), np.array(k))), imgs, rng)
            return state, {}

        def disc_step(state, imgs, rng, sw, df):
            return state, {}
        return model_step, disc_step

    monkeypatch.setattr(jss, "make_ref_train_steps", fake_steps)
    monkeypatch.setattr(jss, "evaluate_sync_ref", lambda *a, **k: {"quality": {}, "grid": [{"corner_mae": 0.0}]})
    base = ["train_syncseal.py", "--output_dir", str(tmp_path / "j"), "--synthetic", "true", "--tiny",
            "--steps_per_epoch", "2", "--batch_size", "2", "--img_size", "32", "--eval_freq", "100"]
    for epochs in ("1", "2"):
        seen.append([])
        monkeypatch.setattr(sys, "argv", [*base, "--epochs", epochs])
        jtrain.main()
    first, resumed = seen
    assert len(first) == len(resumed) == 2
    for (i0, k0), (i1, k1) in zip(first, resumed):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(k0, k1)


def test_trainer_refuses_quietly_skipping_sift_and_a_missing_card(tmp_path, monkeypatch):
    from wmar_tpu_torch import train_syncseal

    monkeypatch.setattr(train_syncseal, "_sift_available", lambda: False)
    with pytest.raises(SystemExit, match="--sift_baseline false"):
        train_syncseal.main(["--output_dir", str(tmp_path), "--synthetic", "true", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            train_syncseal.main(["--output_dir", str(tmp_path), "--tiny", "--synthetic", "true"])


def test_jax_reads_the_port_trainers_syncmodel(tmp_path, monkeypatch):
    """JAX's own ``SyncSealRef.load`` reads the port trainer's
    ``syncmodel.msgpack`` (its default widths set to the tiny trainer's, so
    its template matches) and gives the port's ``add_sync`` within 1e-5, the
    rounding aside; the port reads its file back."""
    from wmar_tpu_torch import train_syncseal

    out = train_syncseal.main(["--output_dir", str(tmp_path / "t"), "--epochs", "1", *TINY_ARGS])
    path = str(tmp_path / "t" / "syncmodel.msgpack")
    monkeypatch.setattr(jsm, "UNET_SMALL2_YUV", jsm.UNetConfig(**TINY))
    monkeypatch.setattr(jsm, "CONVNEXT_TINY", J_CN)
    jm = jss.SyncSealRef.load(path)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    port = out["state"].model.eval()
    _assert_add_sync_close(port.add_sync(_t(x)), jax.jit(jm.add_sync)(jnp.asarray(x)))
    back = tss.SyncSealRef.load(path, unet_cfg=port.unet_cfg, convnext_cfg=port.convnext_cfg)
    _close(back.add_sync(_t(x)), port.add_sync(_t(x)), 0)


def _assert_add_sync_close(got, want):
    """Within 1e-5 but for pixels the 8-bit rounding sent the other way
    at a float32 tie (one level, 2/255 in [-1, 1]), at most 1 in 1000."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 2 / 255 + 1e-5, diff.max()


def test_eval_file_and_log_match_json(tmp_path):
    from wmar_tpu_torch import train_syncseal

    train_syncseal.main(["--output_dir", str(tmp_path), "--epochs", "1", *TINY_ARGS, "--eval_freq", "1"])
    rows = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    report = json.load(open(tmp_path / "eval_0000.json"))
    assert rows[0]["epoch"] == 0 and len(report["grid"]) == 12 and "sift_corner_mae" not in report["grid"][0]
