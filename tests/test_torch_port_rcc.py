"""Port parity, RCC finetuning: ``wmar_tpu_torch.finetune`` (augmentation
branches, curriculum draws, adapters, the train and validation steps, Adam
and its schedule, the GAN branch, LPIPS) and the straight-through
quantizers against the JAX package on the CPU, eagerly.

Sizes are the JAX tests' tiny configs (Taming 32 px, ch 32; MaskGit
16 px). Weights cross through the bridge; inputs come from numpy seeds;
JAX's noise and branch draws are fed to the port. Tolerances (float32,
summation order only): forward values ``FWD_TOL`` absolute; gradients
``GRAD_REL`` of the largest magnitude of their leaf, or of ``NOISE_FLOOR``
times the largest gradient of the step for a leaf whose gradient is zero
in exact arithmetic; Adam's parameters ``ADAM_TOL`` absolute. Integer outputs (branch choices, masks, codes, L0)
are equal.

JAX's gradients come from its own ``make_train_step``, run eagerly with
an optimizer that keeps the gradients as its state and updates nothing.
A forced branch replaces JAX's ``apply_random_augmentation`` for the call
(monkeypatch), and the port takes the same branch through its fed draws.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wmar_tpu.finetune import gan as jgan
from wmar_tpu.finetune import perceptual as jperc
from wmar_tpu.finetune import rcc as jrcc
from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.utils import logging as jlog
from wmar_tpu_torch import bridge
from wmar_tpu_torch.finetune import gan as tgan
from wmar_tpu_torch.finetune import perceptual as tperc
from wmar_tpu_torch.finetune import rcc as trcc
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.utils import logging as tlog

FWD_TOL = 1e-5
GRAD_REL = 1e-3
NOISE_FLOOR = 1e-3
ADAM_TOL = 2e-7
TAMING = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32,
              n_embed=64, embed_dim=16)
MASKGIT = dict(resolution=16, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16, n_embed=64,
               embed_dim=16)
BRANCHES = sorted({(b.name, b.param) for lv in ("weak", "medium", "strong") for b in trcc.expand_level(lv)})
NOISE_KEY = 99


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_grads_close(got, want, path="", floor=None):
    """Each leaf within ``GRAD_REL`` of its largest magnitude, or of
    ``NOISE_FLOOR`` times the tree's largest gradient where the leaf's
    gradient is zero in exact arithmetic and float32 noise here (a conv
    bias before a GroupNorm of one channel a group, the key bias of a
    softmax attention)."""
    if floor is None:
        floor = NOISE_FLOOR * max(float(np.abs(np.asarray(w)).max()) for w in jax.tree.leaves(want))
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_grads_close(got[k], want[k], f"{path}/{k}", floor)
        return
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=GRAD_REL * scale, err_msg=path)


def _pair(kind):
    """(JAX adapter, port adapter) over the same random tiny tokenizer; the
    codebook spread to N(0, 1) so nearest codes are well apart."""
    if kind == "taming":
        model = jvq.TamingVQGAN(jvq.VQGANConfig(**TAMING))
        variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        cb = ("params", "quantize", "embedding")
    else:
        model = jmg.MaskGitVQGAN(jmg.MaskGitVQConfig(**MASKGIT))
        variables = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
        cb = ("params", "embedding")
    node = variables
    for k in cb[:-1]:
        node = node[k]
    node[cb[-1]] = np.random.default_rng(1).standard_normal(node[cb[-1]].shape).astype(np.float32)
    if kind == "taming":
        tmodel = bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**TAMING)), variables)
        return jrcc.TamingRCCAdapter(model, variables), trcc.TamingRCCAdapter(tmodel)
    tmodel = bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**MASKGIT)), variables)
    return jrcc.MaskGitRCCAdapter(model, variables), trcc.MaskGitRCCAdapter(tmodel)


@pytest.fixture(scope="module")
def pairs():
    return {kind: _pair(kind) for kind in ("taming", "maskgit")}


def _codes(tad, batch=2, seed=0):
    return np.random.default_rng(seed).integers(0, 64, size=(batch, tad.latent_side**2)).astype(np.int32)


def _grab():
    """An optax transformation that updates nothing and keeps the gradients
    as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_grads(trainable):
    return {name: bridge.flax_tree([(k, p.grad) for k, p in trainable[name].named_parameters()])
            for name in ("decoder", "watermark_encoder")}


# ---------------------------------------------------------------------------
# Augmentation branches, draws and masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,param", BRANCHES, ids=[f"{n}_{p}" for n, p in BRANCHES])
def test_branch_forward_and_input_gradient(name, param):
    """Each of the 38 distinct (aug, param) branches of the curriculum: the
    images and the gradient of ``sum(out * w)`` with respect to the input
    against ``jax.grad`` (noise fed). The input has pixels exactly on 0
    and 1, where the clips split the gradient as JAX's do; the JPEG's
    straight-through round, the rotation's gather and the crop's pad pass
    gradients as JAX's."""
    jb = next(b for lv in ("weak", "medium", "strong") for b in jrcc.expand_level(lv) if (b.name, b.param) == (name, param))
    tb = trcc.AugBranch(name, param, jb.mask_kind)
    rng = np.random.default_rng(BRANCHES.index((name, param)))
    x = np.clip(rng.uniform(-0.1, 1.1, (2, 32, 32, 3)), 0.0, 1.0).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(NOISE_KEY)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    want, vjp = jax.vjp(lambda v: jb.fn(v, key), jnp.asarray(x))
    (gwant,) = vjp(jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    got = tb(xt, noise=torch.as_tensor(noise))
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gwant), rtol=0, atol=FWD_TOL * np.abs(w).max())


@pytest.mark.parametrize("level", ["warmup", "weak", "medium", "strong"])
def test_branch_logits_and_latent_masks(level):
    """Branch log-probabilities and every branch's latent mask at sides 2-16
    are JAX's."""
    jbs, tbs = jrcc.expand_level(level), trcc.expand_level(level)
    assert [(b.name, b.param, b.mask_kind) for b in jbs] == [(b.name, b.param, b.mask_kind) for b in tbs]
    if not jbs:
        return
    np.testing.assert_array_equal(trcc._branch_logits(level), jrcc._branch_logits(level))
    for side in (2, 4, 8, 16):
        for jb, tb in zip(jbs, tbs):
            np.testing.assert_array_equal(trcc._latent_mask(tb, side), jrcc._latent_mask(jb, side))


def test_apply_random_augmentation_with_fed_draws():
    """JAX's gate uniform, branch index and noise, fed to the port, give
    JAX's images and mask, key by key; with p = 0 nothing happens; the
    port's own draws pick each class about equally (two-stage uniform)."""
    level, side = "medium", 8
    jbs, tbs = jrcc.expand_level(level), trcc.expand_level(level)
    logits = jrcc._branch_logits(level)
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    seen = set()
    jitted = jax.jit(lambda v, key: jrcc.apply_random_augmentation(v, jbs, logits, side, key, p=0.5))
    for s in range(16):
        rng = jax.random.PRNGKey(s)
        want, wmask = jitted(jnp.asarray(x), rng)
        k_gate, k_pick, k_aug = jax.random.split(rng, 3)
        idx = int(jax.random.categorical(k_pick, jnp.asarray(logits)))
        gate = float(jax.random.uniform(k_gate))
        noise = torch.as_tensor(np.asarray(jax.random.normal(k_aug, x.shape, jnp.float32)))
        got, mask = trcc.apply_random_augmentation(torch.as_tensor(x), tbs, logits, side, p=0.5, gate=gate, index=idx,
                                                   noise=noise)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=FWD_TOL)
        np.testing.assert_array_equal(_np(mask), np.asarray(wmask))
        seen.add((gate < 0.5, jbs[idx].name))
    assert len(seen) >= 5
    out, mask = trcc.apply_random_augmentation(torch.as_tensor(x), tbs, logits, side, torch.Generator().manual_seed(0),
                                               p=0.0)
    assert torch.equal(out, torch.as_tensor(x)) and bool((mask == 1).all())
    gen = torch.Generator().manual_seed(0)
    probs = torch.from_numpy(np.exp(logits.astype(np.float64)))
    picks = torch.multinomial(probs, 6000, replacement=True, generator=gen).numpy()
    frac = np.bincount([["jpeg", "blur", "noise", "brightness", "rotate", "croppad"].index(tbs[i].name)
                        for i in picks], minlength=6) / 6000
    assert np.abs(frac - 1 / 6).max() < 0.02


# ---------------------------------------------------------------------------
# Straight-through quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["taming", "maskgit"])
def test_straight_through_quantizer(pairs, kind):
    """``VectorQuantizer.forward`` (Taming) and ``quantize_st`` (MaskGit):
    quantized latents, indices, codebook and commitment losses, and the
    input gradient of ``sum(z_q * w) + losses`` (the straight-through
    identity plus the commitment term) against JAX's."""
    jad, tad = pairs[kind]
    z = np.random.default_rng(3).standard_normal((2, 4, 4, 16)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal(z.shape).astype(np.float32)
    if kind == "taming":
        jfn = lambda v: jad.model.apply(jad._vars(), v, method=lambda m, zz: m.quantize(zz))  # noqa: E731
        tfn = tad.model.quantize
    else:
        jfn = lambda v: jad.model.apply(jad._vars(), v, method=jmg.MaskGitVQGAN.quantize_st)  # noqa: E731
        tfn = tad.model.quantize_st

    def jloss(v):
        zq, idx, (cb, commit) = jfn(v)
        return (zq * w).sum() + cb + commit, (zq, idx, cb, commit)

    (_, (zq, idx, cb, commit)), g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    tq, tidx, (tcb, tcommit) = tfn(zt)
    ((tq * torch.as_tensor(w)).sum() + tcb + tcommit).backward()
    np.testing.assert_array_equal(_np(tidx), np.asarray(idx))
    np.testing.assert_allclose(_np(tq), np.asarray(zq), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose([float(tcb), float(tcommit)], [float(cb), float(commit)], rtol=1e-5)
    np.testing.assert_allclose(_np(zt.grad), np.asarray(g), rtol=0, atol=FWD_TOL)


def test_encode_and_decode_latent(pairs):
    """``encode_latent`` / ``decode_latent`` of both tokenizers against JAX's
    (Taming: images in [-1, 1]; MaskGit: encoder on [0, 1] images)."""
    for kind in ("taming", "maskgit"):
        jad, tad = pairs[kind]
        r = tad.model.cfg.resolution
        x = np.random.default_rng(5).uniform(-1, 1, (2, r, r, 3)).astype(np.float32)
        if kind == "taming":
            want = jad.model.apply(jad._vars(), jnp.asarray(x), method=jvq.TamingVQGAN.encode_latent)
            got = tad.model.encode_latent(torch.as_tensor(x))
            z = np.asarray(want)
            np.testing.assert_allclose(_np(tad.model.decode_latent(torch.as_tensor(z))),
                                       np.asarray(jad.model.apply(jad._vars(), jnp.asarray(z),
                                                                  method=jvq.TamingVQGAN.decode_latent)),
                                       rtol=0, atol=1e-4)
        else:
            want = jad.model.apply(jad._vars(), jnp.asarray(x) / 2 + 0.5, method=jmg.MaskGitVQGAN.encode_latent)
            got = tad.model.encode_latent(torch.as_tensor(x) / 2 + 0.5)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_CASES = [("warmup", None), ("weak", ("brightness", 1.0)), ("medium", ("rotate", -2)), ("strong", ("croppad", 0.6))]


def _off_kink(jad):
    """The trainable decoder moved off the frozen one by 1e-3 x N(0, 1):
    at equality every drift L1 difference is 0, the kink, where torch.abs
    (the reference's) has no gradient, eager JAX +1 and jitted JAX the
    signs of float32 noise."""
    rng = np.random.default_rng(11)
    return jax.tree.map(lambda a: (np.asarray(a) + 1e-3 * rng.standard_normal(a.shape)).astype(np.float32),
                        jad.frozen["decoder"])


def _jax_step(jad, cfg, level, codes, forced, monkeypatch, gan=None, step=0):
    """JAX's loss, metrics and gradients for one step (eager), the branch
    ``forced`` (an index of the level) in place of its random draw, the
    trainable decoder off the kink (:func:`_off_kink`)."""
    if forced is not None:
        def fixed(x01, branches, logits, side, rng, p):
            b = branches[forced]
            return b.fn(x01, jax.random.PRNGKey(NOISE_KEY)), jnp.asarray(jrcc._latent_mask(b, side))

        monkeypatch.setattr(jrcc, "apply_random_augmentation", fixed)
    opt = _grab()
    state = jrcc.init_state(jad, opt)
    state = state.replace(step=jnp.asarray(step, jnp.int32),
                          trainable=dict(state.trainable, decoder=jax.tree.map(jnp.asarray, _off_kink(jad))))
    train_step = jrcc.make_train_step(jad, cfg, level, opt, gan=gan)
    new_state, metrics = train_step(state, jnp.asarray(codes), jax.random.PRNGKey(0))
    return {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, new_state.opt_state)


def _port_step(jad, tad, cfg, level, codes, forced, gan=None, step=0):
    side = tad.latent_side
    draws = {}
    if forced is not None:
        draws = dict(gate=0.0, index=forced, noise=torch.as_tensor(np.asarray(
            jax.random.normal(jax.random.PRNGKey(NOISE_KEY), (codes.shape[0], side * 0 + tad.model.cfg.resolution,
                                                              tad.model.cfg.resolution, 3), jnp.float32))))
    trainable = tad.init_trainable()
    bridge.load_flax(trainable["decoder"], _off_kink(jad))
    loss_fn = trcc.make_loss_fn(tad, cfg, level, gan=gan)
    loss, metrics = loss_fn(trainable, torch.as_tensor(codes).long(), step, **draws)
    loss.backward()
    return {k: float(v) for k, v in metrics.items()}, _port_grads(trainable)


@pytest.mark.parametrize("kind", ["taming", "maskgit"])
@pytest.mark.parametrize("level,branch", STEP_CASES, ids=[f"{lv}-{b[0] if b else 'none'}" for lv, b in STEP_CASES])
def test_train_step_loss_metrics_and_gradients(pairs, monkeypatch, kind, level, branch):
    """One step's loss, L1, perceptual (pyramid fallback), idem and every
    gradient leaf of the decoder and the watermark encoder against
    ``jax.value_and_grad`` of JAX's loss (the trainable decoder moved off
    the frozen one), at ``warmup`` and with a branch of
    each level forced: brightness 1.0 (MaskGit's clip leaves decoded pixels
    on 0 and 1), a rotation and a crop (their masks). Every branch's own
    gradient is held by ``test_branch_forward_and_input_gradient``."""
    jad, tad = pairs[kind]
    cfg_j, cfg_t = jrcc.RCCConfig(idem_weight=2.0), trcc.RCCConfig(idem_weight=2.0)
    forced = None if branch is None else [(b.name, b.param) for b in jrcc.expand_level(level)].index(branch)
    codes = _codes(tad)
    jm, jg = _jax_step(jad, cfg_j, level, codes, forced, monkeypatch)
    tm, tg = _port_step(jad, tad, cfg_t, level, codes, forced)
    for k in ("loss", "rec_l1", "perceptual", "idem"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    _assert_grads_close(tg, jg)


def test_train_step_updates_and_counts(pairs):
    """The port's ``train_step`` runs Adam and the schedule in place: the
    step counts, ``grad_norm`` is the global norm of the gradients, the
    parameters move and the metrics stay tensors."""
    _, tad = pairs["taming"]
    state = trcc.init_state(tad, trcc.RCCConfig(lr=1e-3), steps_per_epoch=2)
    before = copy.deepcopy(state.trainable.state_dict())
    step = trcc.make_train_step(tad, trcc.RCCConfig(lr=1e-3), "strong")
    codes = torch.as_tensor(_codes(tad)).long()
    metrics = step(state, codes, torch.Generator().manual_seed(0), torch.Generator().manual_seed(0))
    grads = [p.grad for p in state.trainable.parameters()]
    assert state.step == 1 and all(isinstance(v, torch.Tensor) for v in metrics.values())
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads))), rtol=1e-5)
    assert any(not torch.equal(before[k], v) for k, v in state.trainable.state_dict().items())


def test_adam_and_schedule_land_on_optax(pairs):
    """Given JAX's gradients for three steps across an epoch boundary
    (two steps an epoch, lr decay 0.9), the port's Adam and LambdaLR put
    every parameter where optax's ``adam(schedule)`` puts it."""
    jad, tad = pairs["taming"]
    cfg_j, cfg_t = jrcc.RCCConfig(lr=1e-3), trcc.RCCConfig(lr=1e-3)
    opt = jrcc.make_optimizer(cfg_j, steps_per_epoch=2)
    jstate = jrcc.init_state(jad, opt)
    state = trcc.init_state(tad, cfg_t, steps_per_epoch=2)
    rng = np.random.default_rng(6)
    params = jstate.trainable
    opt_state = jstate.opt_state
    for s in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * (10.0 ** -s), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        gmod = copy.deepcopy(state.trainable)
        for name in ("decoder", "watermark_encoder"):
            bridge.load_flax(gmod[name], grads[name])
        for p, g in zip(state.trainable.parameters(), gmod.parameters()):
            p.grad = g.detach().clone()
        state.optimizer.step()
        state.scheduler.step()
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.9 ** ((s + 1) // 2))
        got = {name: bridge.flax_tree(state.trainable[name]) for name in ("decoder", "watermark_encoder")}
        jax.tree.map(lambda g, w: np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=ADAM_TOL),
                     got, jax.tree.map(np.asarray, params))


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

VAL_CELLS = [None, ("jpeg", 40), ("blur", 9), ("noise", 0.1), ("brightness", 2.0), ("rotate", 3), ("croppad", 0.5)]


@pytest.mark.parametrize("kind", ["taming", "maskgit"])
def test_val_step_metrics_per_cell(pairs, kind):
    """``make_val_step`` at Identity and a cell of each kind of ``strong``
    (noise fed): loss, idem, drift and rec losses within float32 rounding,
    and the count of mismatched tokens behind L0 equal; ``validation_l0``
    per row equal."""
    jad, tad = pairs[kind]
    codes = _codes(tad, batch=3, seed=7)
    jtrain, ttrain = jad.init_trainable(), tad.init_trainable()
    key = jax.random.PRNGKey(NOISE_KEY)
    r = tad.model.cfg.resolution
    noise = torch.as_tensor(np.asarray(jax.random.normal(key, (3, r, r, 3), jnp.float32)))
    by_name = {(b.name, b.param): (jb, b) for jb, b in zip(jrcc.expand_level("strong"), trcc.expand_level("strong"))}
    for cell in VAL_CELLS:
        jb, tb = by_name[cell] if cell else (None, None)
        want = jrcc.make_val_step(jad, jrcc.RCCConfig(), jb)(jtrain, jnp.asarray(codes), key)
        got = trcc.make_val_step(tad, trcc.RCCConfig(), tb)(ttrain, torch.as_tensor(codes).long(), noise=noise)
        for k in ("loss", "idem_loss", "vqgan_loss", "vqgan_rec_loss"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=f"{cell} {k}")
        assert round(float(got["l0"]) * codes.size) == round(float(want["l0"]) * codes.size), cell  # mismatches
    np.testing.assert_array_equal(_np(trcc.validation_l0(tad, ttrain, torch.as_tensor(codes).long())),
                                  np.asarray(jrcc.validation_l0(jad, jtrain, jnp.asarray(codes))))


# ---------------------------------------------------------------------------
# The GAN branch, the discriminator and LPIPS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("disc_start", [0, 5])
def test_gan_branch_against_jax(pairs, monkeypatch, disc_start):
    """With ``init_taming_discriminator``'s weights (JAX's draw, bridged):
    ``g_loss``, the adaptive ``d_weight`` (the last-layer gradients through
    a detached copy of the decoder), the gate ``disc_factor`` (on from step
    0, and off at step 2 < ``disc_start`` 5), the total loss and every
    gradient against JAX's train step."""
    jad, tad = pairs["taming"]
    disc = jgan.init_taming_discriminator(jax.random.PRNGKey(3))
    jg = jgan.GanConfig.create(disc, disc_factor=1.0, disc_weight=0.8, disc_start=disc_start)
    tg = tgan.GanConfig(tgan.discriminator_from_flax(jax.tree.map(np.asarray, disc)), disc_factor=1.0,
                        disc_weight=0.8, disc_start=disc_start)
    codes = _codes(tad, seed=8)
    cfg_j, cfg_t = jrcc.RCCConfig(), trcc.RCCConfig()
    jm, jgrads = _jax_step(jad, cfg_j, "weak", codes, 3, monkeypatch, gan=jg, step=2)
    tm, tgrads = _port_step(jad, tad, cfg_t, "weak", codes, 3, gan=tg, step=2)
    assert tm["vqgan_gan_factor"] == jm["vqgan_gan_factor"] == (1.0 if disc_start == 0 else 0.0)
    for k in ("loss", "vqgan_gan_loss", "vqgan_gan_weight", "idem"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-5, err_msg=k)
    _assert_grads_close(tgrads, jgrads)


def test_discriminator_forward_and_conversion():
    """The PatchGAN forward against ``discriminator_forward``; the
    reference's ``loss.discriminator.main.*`` state dict through both
    converters; the flax tree of the port's module is JAX's list; the d
    losses, ``adopt_weight`` and ``adaptive_weight`` against JAX's."""
    params = jax.tree.map(np.asarray, jgan.init_taming_discriminator(jax.random.PRNGKey(4), ndf=16))
    rng = np.random.default_rng(9)
    for layer in params[1:-1]:  # statistics away from the identity
        layer["bn"]["mean"] = rng.standard_normal(layer["bn"]["mean"].shape).astype(np.float32) * 0.1
        layer["bn"]["var"] = rng.uniform(0.5, 2.0, layer["bn"]["var"].shape).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jgan.discriminator_forward(params, jnp.asarray(x)))
    disc = tgan.discriminator_from_flax(params)
    np.testing.assert_allclose(_np(disc(torch.as_tensor(x))), want, rtol=0, atol=1e-4)
    tree = bridge.flax_tree(disc)["layers"]
    for i, layer in enumerate(params):
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(_np(g), w), tree[str(i)], layer)
    sd, idx = {}, 0
    for i, layer in enumerate(params):
        sd[f"loss.discriminator.main.{idx}.weight"] = torch.as_tensor(layer["kernel"].transpose(3, 2, 0, 1).copy())
        if "bias" in layer:
            sd[f"loss.discriminator.main.{idx}.bias"] = torch.as_tensor(layer["bias"])
        idx += 1
        if "bn" in layer:
            for n, k in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
                sd[f"loss.discriminator.main.{idx}.{n}"] = torch.as_tensor(layer["bn"][k])
            idx += 1
        if i < len(params) - 1:
            idx += 1  # LeakyReLU
    jconv = jgan.convert_taming_discriminator({k: v.numpy() for k, v in sd.items()})
    tconv = tgan.convert_taming_discriminator(sd)
    np.testing.assert_allclose(_np(tconv(torch.as_tensor(x))),
                               np.asarray(jgan.discriminator_forward(jconv, jnp.asarray(x))), rtol=0, atol=1e-4)
    a, b = rng.standard_normal((2, 5)).astype(np.float32), rng.standard_normal((2, 5)).astype(np.float32)
    for jf, tf in ((jgan.hinge_d_loss, tgan.hinge_d_loss), (jgan.vanilla_d_loss, tgan.vanilla_d_loss)):
        np.testing.assert_allclose(float(tf(torch.as_tensor(a), torch.as_tensor(b))), float(jf(a, b)), rtol=1e-6)
    assert tgan.adopt_weight(1.0, 3, threshold=5) == float(jgan.adopt_weight(1.0, 3, threshold=5)) == 0.0
    assert tgan.adopt_weight(1.0, 5, threshold=5) == float(jgan.adopt_weight(1.0, 5, threshold=5)) == 1.0
    np.testing.assert_allclose(float(tgan.adaptive_weight(torch.as_tensor(a), torch.as_tensor(b), 0.5)),
                               float(jgan.adaptive_weight(jnp.asarray(a), jnp.asarray(b), 0.5)), rtol=1e-6)
    init = tgan.init_taming_discriminator(torch.Generator().manual_seed(0))
    assert [tuple(c.weight.shape) for c in init.layers] == [tuple(p["kernel"].shape[::-1][:2]) + (4, 4) for p in
                                                          jax.tree.map(np.asarray, jgan.init_taming_discriminator(
                                                              jax.random.PRNGKey(0)))]


def test_lpips_from_a_flax_file_and_the_pyramid_fallback(tmp_path):
    """LPIPS with random weights that flax writes to a file: the port loads
    the file through its own codec and gives JAX's distances; the pyramid
    fallback (also where it stops early, under 4 px) equals JAX's."""
    import flax.serialization as fs

    rng = np.random.default_rng(10)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    variables = jax.jit(jperc.LPIPS().init)(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    variables = jax.tree.map(lambda v: np.abs(np.asarray(v)) if v.ndim == 4 and v.shape[:2] == (1, 1) else v,
                             variables)  # LPIPS heads are non-negative
    path = tmp_path / "lpips_vgg.msgpack"
    path.write_bytes(fs.to_bytes(jax.device_get(variables)))
    want = np.asarray(jax.jit(jperc.PerceptualLoss(fs.msgpack_restore(path.read_bytes())).__call__)(
        jnp.asarray(a), jnp.asarray(b)))
    got = tperc.PerceptualLoss(tperc.load_lpips(str(path)))(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-6)
    for size in (32, 6):
        x, y = (rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32) for _ in range(2))
        np.testing.assert_allclose(_np(tperc.laplacian_pyramid_l1(torch.as_tensor(x), torch.as_tensor(y))),
                                   np.asarray(jperc.laplacian_pyramid_l1(jnp.asarray(x), jnp.asarray(y))),
                                   rtol=1e-6)


def test_encoder_drift_and_average_metrics(pairs):
    """``encoder_drift`` of a perturbed trainable against JAX's on the same
    weights; ``average_metrics`` in one process returns floats."""
    jad, tad = pairs["maskgit"]
    trainable = tad.init_trainable()
    with torch.no_grad():
        for i, p in enumerate(trainable.parameters()):
            p.add_(0.01 * (i % 3))
    got = tlog.encoder_drift(trainable["decoder"], tad.model.decoder)
    want = jlog.encoder_drift(bridge.flax_tree(trainable["decoder"]), jad.frozen["decoder"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tlog.average_metrics({"a": torch.tensor(2.0), "b": 3}) == {"a": 2.0, "b": 3.0}
