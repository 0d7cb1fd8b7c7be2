"""Port parity, the Mimi RCC finetune (``wmar_tpu_torch.audio.finetune``),
its augmenter (``audio.augmenter``), Mimi's straight-through quantizer and
the finetune's bridge against ``wmar_tpu.audio`` on the CPU, at the JAX
CLI's ``--tiny`` Mimi (``finetune_mimi.TINY_FT_MIMI``) and the audio eval's
(``audio_eval.TINY_MIMI``, with the learned resampling).

Tolerances: ``encode_decode`` / ``encode_decode_all`` codes equal, latents
and the straight-through gradient within 1e-5; ``rcc_forward`` every
output within 1e-5 (codes equal), with and without an augmenter fed JAX's
picks and noise. Training: three AdamW steps (optax's warmup-cosine, so
the first at rate 0) from a seeded perturbation of the trainable trees
(+1e-3 N(0, 1) from numpy: at init the trainable decoder equals the
replica and the MR-STFT's log-magnitude L1 sits at its kink, where JAX's
jitted gradient takes signs of float32 noise and the port's is 0) move
every parameter by JAX's update within lr / 4 (the parameters move by
about 2 lr in all, so a missing or wrong update fails) and leave the
metrics within 1e-5 relative, for each code target type and both audio
targets; the gradient of the whole RCC loss with respect to every
trainable leaf at that start is ``jax.grad``'s within 1e-4 of the leaf's
largest entry (Adam's first steps are near sign(g), so the updates alone
would not see wrong magnitudes); step 0 is pinned from the unperturbed
start on the code loss alone. Also
held: a resume from JAX's optax state (``bridge.load_adam_state``), the
decoder-only optimizer against ``optax.multi_transform``, the legacy
``make_train_step`` fed JAX's gate, pick and noise, and
``validation_token_match``. The augmenter: JAX's labels and
log-probabilities, every branch on JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wmar_tpu.audio import augmenter as jaug
from wmar_tpu.audio import finetune as jft
from wmar_tpu.audio import losses as jl
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu_torch import audio_eval, bridge, finetune_mimi
from wmar_tpu_torch.audio import augmentations as taugs
from wmar_tpu_torch.audio import augmenter as taug
from wmar_tpu_torch.audio import finetune as tft
from wmar_tpu_torch.audio import losses as tl
from wmar_tpu_torch.audio import mimi as tmimi

torch.set_num_threads(1)
FT, EVAL = finetune_mimi.TINY_FT_MIMI, audio_eval.TINY_MIMI
LR = 1e-5


def _variables(kw, seed=0):
    cfg = jmimi.MimiConfig(**kw)
    m = jmimi.Mimi(cfg)
    return m, jax.jit(m.init)(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.hop_length * 4, 1)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ft():
    """(JAX wrapper, numpy variables, a perturbed trainable tree, audio)."""
    m, jvars = _variables(FT)
    jw, variables = jft.MimiFTWrapper(m, jvars), _np(jvars)
    rng = np.random.default_rng(0)
    pert = jax.tree.map(lambda a: (a + 1e-3 * rng.standard_normal(a.shape)).astype(np.float32),
                        jax.tree.map(np.asarray, jw.init_trainable()))
    audio = np.clip(rng.standard_normal((2, m.cfg.hop_length * 8, 1)) * 0.3, -1, 1).astype(np.float32)
    return jw, variables, pert, audio


def _port(variables, trainable=None, kw=FT):
    with torch.device("meta"):
        model = tmimi.Mimi(tmimi.MimiConfig(**kw))
    return bridge.load_mimi_ft(tft.MimiFTWrapper(model.to_empty(device="cpu")), variables, trainable)


def _schedule():
    return optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10, LR * 1e-2), tft.warmup_cosine_decay(0.0, LR, 1, 10,
                                                                                                LR * 1e-2)


def _close_trees(got, want, start):
    """Each leaf's update from ``start`` within lr / 4 of JAX's."""
    g, w, s = dict(bridge.flatten(got)), dict(bridge.flatten(want)), dict(bridge.flatten(start))
    assert sorted(g) == sorted(w) == sorted(s)
    for k in w:
        got_k = g[k].numpy() if isinstance(g[k], torch.Tensor) else np.asarray(g[k])
        np.testing.assert_allclose(got_k - s[k], np.asarray(w[k]) - s[k], atol=LR / 4, rtol=0, err_msg=k)


def _grad_tree(wrapper):
    """The trainable parameters' ``.grad`` as a Flax tree (the bridge's
    layout maps are linear)."""
    params = list(wrapper.trainable.parameters())
    saved = [p.data for p in params]
    for p in params:
        p.data = p.grad
    try:
        return bridge.mimi_ft_tree(wrapper)
    finally:
        for p, d in zip(params, saved):
            p.data = d


# ---------------------------------------------------------------------------
# The straight-through quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [FT, EVAL], ids=["ft", "eval"])
def test_encode_decode_all(kw):
    m, variables = _variables(kw, seed=1)
    cfg = m.cfg
    port = bridge.load_mimi(tmimi.Mimi(tmimi.MimiConfig(**kw)), _np(variables))
    z = (np.random.default_rng(2).standard_normal((2, 6, cfg.dimension)) * 0.5).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((2, 6, cfg.dimension)).astype(np.float32)

    def jax_all(v, zz):
        return m.apply(v, zz, method=lambda mm, x: mm.rvq_rest.encode_decode_all(x))

    codes, out, pre, post = jax.jit(jax_all)(variables, jnp.asarray(z))
    jgrad = jax.jit(jax.grad(lambda zz: (jax_all(variables, zz)[1] * w).sum() + jax_all(variables, zz)[2].sum()))(
        jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    tcodes, tout, tpre, tpost = port.rvq_rest.encode_decode_all(zt)
    ((tout * torch.from_numpy(w)).sum() + tpre.sum()).backward()
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    for got, want in ((tout, out), (tpre, pre), (tpost, post), (zt.grad, jgrad)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    c2, o2, y2, q2 = port.rvq_first.encode_decode(zt)
    jc, jo, jy, jq = jax.jit(lambda v, zz: m.apply(v, zz, method=lambda mm, x: mm.rvq_first.encode_decode(x)))(
        variables, jnp.asarray(z))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc))
    for got, want in ((o2, jo), (y2, jy), (q2, jq)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("spec", ["pre_q", "post_q", "0", "013", "0-2,5", "1-3, 7", "2-1", "x", ""])
def test_parse_code_target_indices(spec):
    try:
        want = jft.parse_code_target_indices(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tft.parse_code_target_indices(spec)
        return
    assert tft.parse_code_target_indices(spec) == want


def test_backward_reaches_every_trainable_parameter(ft):
    """No in-place op or ``no_grad`` of the serving modules blocks a
    backward pass: the RCC loss reaches every trainable parameter."""
    jw, variables, pert, audio = ft
    tw = _port(variables, pert)
    out = tft.rcc_forward(tw, torch.from_numpy(audio))
    loss, _ = tft.rcc_losses_and_metrics(out, torch.from_numpy(audio), tl.get_audio_loss("mrstft"),
                                         tl.get_code_loss("mse"), 1e-3, 1.0)
    loss.backward()
    for name, p in tw.trainable.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0, name
    assert all(p.grad is None for p in tw.model.parameters())


def test_bridge_round_trip():
    """``mimi_tree`` inverts ``load_mimi`` bit for bit, the channel-wise
    transposed upsampling included."""
    variables = _np(_variables(EVAL, seed=4)[1])
    port = bridge.load_mimi(tmimi.Mimi(tmimi.MimiConfig(**EVAL)), variables)
    got, want = dict(bridge.flatten(bridge.mimi_tree(port))), dict(bridge.flatten(variables["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# ---------------------------------------------------------------------------
# rcc_forward and the training steps
# ---------------------------------------------------------------------------


AUGS = {"identity": 1, "noise_injection": 1, "lowpass_filter": 1, "temporal_crop": 1}


def _draw(branch, key, x):
    """JAX's draw for ``branch`` under ``key``, as the port takes it fed."""
    if branch.name in ("noise_injection", "pink_noise"):
        return torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
    if branch.name == "temporal_crop":
        ratio = {f"crop_{v:.2f}": float(v) for v in jaug._levels(0.5, 0.9, 4)}[branch.label]
        keep = int(x.shape[1] * ratio)
        return int(jax.random.randint(key, (), 0, x.shape[1] - keep + 1))
    return None


def _jax_picks(augmenter, key, x):
    """Replay ``Augmenter.__call__``'s key splits: the picks and each
    application's draw."""
    picks, noise = [], []
    for _ in range(augmenter.num_augs):
        k_pick, k_aug, key = jax.random.split(key, 3)
        idx = int(jax.random.categorical(k_pick, augmenter.log_probs))
        picks.append(idx)
        noise.append(_draw(augmenter.branches[idx], k_aug, x))
    return picks, noise


@pytest.mark.parametrize("with_aug", [False, True])
def test_rcc_forward(ft, with_aug):
    jw, variables, pert, audio = ft
    tw = _port(variables, pert)
    key = jax.random.PRNGKey(5)
    aug_fn = None
    if with_aug:
        jaugm = jaug.Augmenter(AUGS, num_augs=2, sample_rate=24000)
        picks, noise = _jax_picks(jaugm, key, audio)
        assert len(set(picks)) == 2
        taugm = taug.Augmenter(AUGS, num_augs=2, sample_rate=24000)
        def aug_fn(x, g):
            return taugm(x, g, picks=picks, noise=noise)
    want = jax.jit(lambda tr, a, k: jft.rcc_forward(jw, tr, a, jaugm if with_aug else None, k))(pert, audio, key)
    got = tft.rcc_forward(tw, torch.from_numpy(audio), aug_fn)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        if k in ("codes", "recons_codes", "selected_aug"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
        else:
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0, err_msg=k)


_STEPS = {}


def _jax_step(jw, audio_weight, ctt, att, sched):
    """JAX's optimizer and jitted train step, one compile a configuration."""
    key = (audio_weight, ctt, att, sched)
    if key not in _STEPS:
        opt = optax.adamw(_schedule()[0] if sched else LR)
        _STEPS[key] = opt, jax.jit(jft.make_rcc_train_step(jw, opt, jl.get_audio_loss("mrstft"),
                                                           jl.get_code_loss("mse"), audio_weight, 1.0, None, att,
                                                           ctt))
    return _STEPS[key]


def _run_both(ft, steps, ctt="pre_q", att="replica", audio_weight=1e-3, sched=True, start=None):
    jw, variables, pert, audio = ft
    start = pert if start is None else start
    opt, step = _jax_step(jw, audio_weight, ctt, att, sched)
    state = jft.MimiFTState(jnp.zeros((), jnp.int32), start, opt.init(start))
    tw = _port(variables, start)
    ts = tft.init_state(tw, LR, _schedule()[1] if sched else None)
    tstep = tft.make_rcc_train_step(ts, tl.get_audio_loss("mrstft"), tl.get_code_loss("mse"), audio_weight, 1.0,
                                    None, att, ctt)
    for i in range(steps):
        state, jm = step(state, jnp.asarray(audio), jax.random.PRNGKey(i))
        tm = tstep(torch.from_numpy(audio))
        for k, v in jm.items():
            assert abs(float(tm[k]) - float(v)) <= 1e-5 * abs(float(v)) + 1e-12, (i, k, float(tm[k]), float(v))
    return state, ts


@pytest.mark.parametrize("ctt,att", [("pre_q", "replica"), ("post_q", "original"), ("0-2", "original")])
def test_three_adamw_steps(ft, ctt, att):
    state, ts = _run_both(ft, 3, ctt, att)
    assert ts.step == 3
    _close_trees(bridge.mimi_ft_tree(ts.wrapper), state.trainable, ft[2])


@pytest.mark.parametrize("ctt,att", [("pre_q", "replica"), ("post_q", "original"), ("0-2", "original"),
                                     ("pre_q", "original")])
def test_rcc_loss_gradient(ft, ctt, att):
    """The gradient of the whole RCC loss (the MR-STFT audio loss at 1e-3
    plus the code loss) with respect to every trainable leaf, at the
    perturbed start: each leaf within 1e-4 of its largest entry of
    ``jax.grad``'s."""
    jw, variables, pert, audio = ft

    def loss_fn(trainable):
        out = jft.rcc_forward(jw, trainable, jnp.asarray(audio))
        return jft.rcc_losses_and_metrics(out, jnp.asarray(audio), jl.get_audio_loss("mrstft"),
                                          jl.get_code_loss("mse"), 1e-3, 1.0, att, ctt)[0]

    want = dict(bridge.flatten(_np(jax.jit(jax.grad(loss_fn))(pert))))
    tw = _port(variables, pert)
    out = tft.rcc_forward(tw, torch.from_numpy(audio))
    loss, _ = tft.rcc_losses_and_metrics(out, torch.from_numpy(audio), tl.get_audio_loss("mrstft"),
                                         tl.get_code_loss("mse"), 1e-3, 1.0, att, ctt)
    loss.backward()
    got = dict(bridge.flatten(_grad_tree(tw)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=k)


def test_step0_code_loss_from_the_unperturbed_start(ft):
    """Step 0 as the CLI takes it (trainable == frozen), on the code loss
    alone at a constant rate: the audio loss's kink plays no part."""
    jw = ft[0]
    start = jax.tree.map(np.asarray, jw.init_trainable())
    state, ts = _run_both(ft, 1, audio_weight=0.0, sched=False, start=start)
    _close_trees(bridge.mimi_ft_tree(ts.wrapper), state.trainable, start)
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(jax.tree.leaves(state.trainable),
                                                                        jax.tree.leaves(start)))
    assert moved > 0.5 * LR


def test_resume_from_jax_adam_state(ft):
    """JAX's state after two steps (trainable trees and optax's adamw state,
    through ``bridge.load_adam_state``) carried into the port; its third
    step is JAX's."""
    jw, variables, pert, audio = ft
    opt, step = _jax_step(jw, 1e-3, "pre_q", "replica", True)
    state = jft.MimiFTState(jnp.zeros((), jnp.int32), pert, opt.init(pert))
    for i in range(2):
        state, _ = step(state, jnp.asarray(audio), jax.random.PRNGKey(i))
    tw = _port(variables, jax.tree.map(np.asarray, state.trainable))
    ts = tft.init_state(tw, LR, _schedule()[1])

    def to_sd(tree):
        return {f"{part}.{k}": v for part in tree for k, v in bridge.mimi_state_dict(tw.trainable[part],
                                                                                     tree[part]).items()}

    count = bridge.load_adam_state(ts.optimizer, ts.scheduler, tw.trainable.named_parameters(),
                                   jax.tree.map(np.asarray, state.opt_state), to_sd)
    assert count == 2
    before = _np(state.trainable)
    state, jm = step(state, jnp.asarray(audio), jax.random.PRNGKey(2))
    tm = tft.make_rcc_train_step(ts, tl.get_audio_loss("mrstft"), tl.get_code_loss("mse"), 1e-3, 1.0)(
        torch.from_numpy(audio))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    _close_trees(bridge.mimi_ft_tree(tw), state.trainable, before)


def test_decoder_only(ft):
    """``parts`` without the encoder parts: those stay exactly as they were
    and out of the optimizer; the decoder parts follow JAX's
    ``optax.multi_transform`` with ``set_to_zero`` on the rest."""
    jw, variables, pert, audio = ft
    inner = optax.adamw(_schedule()[0])
    opt = optax.multi_transform({"train": inner, "freeze": optax.set_to_zero()},
                                lambda tree: {k: "train" if k.startswith("dec") else "freeze" for k in tree})
    step = jax.jit(jft.make_rcc_train_step(jw, opt, jl.get_audio_loss("mrstft"), jl.get_code_loss("mse"), 1e-3, 1.0))
    state = jft.MimiFTState(jnp.zeros((), jnp.int32), pert, opt.init(pert))
    tw = _port(variables, pert)
    ts = tft.init_state(tw, LR, _schedule()[1], parts=("decoder", "dec_transformer"))
    assert len(ts.optimizer.param_groups[0]["params"]) == sum(1 for part in ("decoder", "dec_transformer")
                                                              for _ in tw.trainable[part].parameters())
    tstep = tft.make_rcc_train_step(ts, tl.get_audio_loss("mrstft"), tl.get_code_loss("mse"), 1e-3, 1.0)
    for i in range(3):
        state, _ = step(state, jnp.asarray(audio), jax.random.PRNGKey(i))
        tstep(torch.from_numpy(audio))
    got = bridge.mimi_ft_tree(tw)
    _close_trees(got, state.trainable, pert)
    for part in ("encoder", "enc_transformer"):
        for k, v in bridge.flatten(got[part]):
            np.testing.assert_array_equal(v.numpy(), dict(bridge.flatten(pert[part]))[k], err_msg=k)


def test_legacy_train_step(ft):
    """``make_train_step`` on codes, fed JAX's gate, pick and noise for two
    keys (one applies its branch)."""
    jw, variables, pert, _ = ft
    cfg = jft.MimiFTConfig(lr=LR)
    opt = optax.adamw(LR)
    step = jax.jit(jft.make_train_step(jw, cfg, opt))
    state = jft.MimiFTState(jnp.zeros((), jnp.int32), pert, opt.init(pert))
    ts = tft.init_state(_port(variables, pert), LR)
    tstep = tft.make_train_step(ts, tft.MimiFTConfig())
    assert [n for n, _ in tft.TRAIN_AUGS] == [n for n, _ in jft.TRAIN_AUGS]
    codes = np.random.default_rng(6).integers(0, FT["cardinality"], (2, FT["n_q"], 8)).astype(np.int32)
    gates = []
    for seed in (3, 11):
        key = jax.random.PRNGKey(seed)
        k_gate, k_pick, k_aug = jax.random.split(key, 3)
        pick = int(jax.random.randint(k_pick, (), 0, len(jft.TRAIN_AUGS)))
        gate = float(jax.random.uniform(k_gate))
        name = jft.TRAIN_AUGS[pick][0]
        shape = (2, 8 * jw.model.cfg.hop_length, 1)
        noise = torch.from_numpy(np.array(jax.random.normal(k_aug, shape))) if name in ("noise", "pink") else None
        state, jm = step(state, jnp.asarray(codes), key)
        tm = tstep(torch.from_numpy(codes).long(), gate=gate, pick=pick, noise=noise)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (seed, k)
        gates.append(gate < cfg.aug_prob)
    assert any(gates)
    _close_trees(bridge.mimi_ft_tree(ts.wrapper), state.trainable, pert)


def test_validation_token_match(ft):
    jw, variables, pert, _ = ft
    tw = _port(variables, pert)
    codes = np.random.default_rng(7).integers(0, FT["cardinality"], (2, FT["n_q"], 8)).astype(np.int32)
    for aug in (None, "lowpass"):
        jfn = (lambda x, r: jft.A.lowpass(x, 0.3)) if aug else None
        tfn = (lambda x, g: taugs.lowpass(x, 0.3)) if aug else None
        want = np.asarray(jax.jit(lambda tr, c: jft.validation_token_match(jw, tr, c, jfn, jax.random.PRNGKey(0)))(
            pert, jnp.asarray(codes)))
        got = tft.validation_token_match(tw, torch.from_numpy(codes).long(), tfn).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The augmenter
# ---------------------------------------------------------------------------


def _all_augs():
    return {name: 1 for name in jaug._DEFAULTS if name != "mp3_compression" or taugs.mp3_available()}


def test_augmenter_labels_and_log_probs():
    augs = _all_augs()
    j = jaug.Augmenter(augs, {"echo": {"min_volume": 0.2}}, sample_rate=24000)
    t = taug.Augmenter(augs, {"echo": {"min_volume": 0.2}}, sample_rate=24000)
    assert t.labels == j.labels and len(t.labels) > 40
    np.testing.assert_array_equal(t.log_probs.numpy(), np.asarray(j.log_probs))


def test_augmenter_branches_on_jax_draws():
    augs = _all_augs()
    j = jaug.Augmenter(augs, sample_rate=24000)
    t = taug.Augmenter(augs, sample_rate=24000)
    x = (np.random.default_rng(8).standard_normal((2, 2400, 1)) * 0.3).astype(np.float32)
    for i, (jb, tb) in enumerate(zip(j.branches, t.branches)):
        key = jax.random.PRNGKey(100 + i)
        want = np.asarray(jb.fn(jnp.asarray(x), key))
        got = tb.fn(torch.from_numpy(x), None, _draw(jb, key, x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=jb.label)


def test_augmenter_draws_and_refusals(monkeypatch):
    t = taug.Augmenter({"identity": 1, "smooth": 3}, num_augs=3, sample_rate=24000)
    x = torch.zeros((1, 480, 1))
    _, picked = t(x, torch.Generator().manual_seed(0))
    assert picked.shape == (3,) and all(0 <= int(p) < len(t.branches) for p in picked)
    assert [b.label for b in taug.Augmenter({}).branches] == ["identity"]
    with pytest.raises(ValueError):
        taug.Augmenter({"nope": 1})
    monkeypatch.setattr(taugs, "mp3_available", lambda: False)
    with pytest.raises(RuntimeError, match="libmp3lame"):
        taug.Augmenter({"mp3_compression": 1})
