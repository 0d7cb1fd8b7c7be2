"""Port parity, the Moshi LM (``wmar_tpu_torch.audio.lm``) against
``wmar_tpu.audio.lm`` on the CPU, at two tiny configs: the audio eval's
``--tiny`` one (``n_q = dep_q``, shared depformer weights, rope) and one
shaped like ``MOSHI_V01`` (``n_q = 6 > dep_q = 4``, the user streams fed
from ``other_codes``, ``depformer_multi_linear``,
``depformer_weights_per_step``, no depformer rope, delays ``(0, 1, 1, 1, 0,
1)``). The JAX parameters cross through ``bridge.load_moshi``.

Tolerances: the temporal step's hidden state within 1e-5 at float32; every
token equal (Gumbel needs no noise; Maryland and plain sampling take JAX's
Gumbel draws through ``noise``). Over the packed caches JAX's Pallas
kernels (interpret mode) round q and the softmax weights to bf16 while the
port's plain versions stay in float32, so a greedy token whose top two
logits lie within ``TIE`` may flip: the tokens are held frame by frame, and
where the first difference falls the test asserts that the port's logit
gap there is below ``TIE`` and reports it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.audio import lm as jlm
from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.utils import convert as jconvert
from wmar_tpu_torch import bridge
from wmar_tpu_torch.audio import lm as tlm
from wmar_tpu_torch.engine.kvcache import KVCache

TINY = dict(n_audio_streams=4, audio_vocab=64, text_vocab=64, dim=64, n_layers=2, n_heads=2, dep_dim=32,
            dep_layers=1, dep_heads=2, delays=(0, 1, 1, 1))
MULTI = dict(TINY, n_q=6, delays=(0, 1, 1, 1, 0, 1), depformer_multi_linear=True, depformer_weights_per_step=True,
             depformer_pos_emb="none")
CONFIGS = {"tiny": TINY, "multi": MULTI}
FRAMES, BATCH = 5, 2
TIE = 5e-3  # logit gap below which bf16 rounding in JAX's packed kernels may flip a greedy token


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    jcfg, tcfg = jlm.MoshiConfig(**kw), tlm.MoshiConfig(**kw)
    jp = jlm.init_moshi_params(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, bridge.load_moshi(jax.tree.map(np.asarray, jp))


def _jax_noise(key):
    """The port's ``noise`` callable that hands out JAX's draw of each (frame, stream)."""
    def noise(t, s, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, t), s)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))
    return noise


def _inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    n_other = jcfg.num_inputs - jcfg.n_audio_streams
    other = rng.integers(0, jcfg.audio_vocab, (BATCH, n_other, 3)) if n_other else None
    cond = (rng.standard_normal((BATCH, 1, jcfg.dim)) * 0.1).astype(np.float32)
    return other, cond


def _run_both(jcfg, tcfg, jp, tp, jwm, twm, cache=("f32", "f32"), key=3, prompts=None, inputs=None, noise=True):
    jcache = jnp.float32 if cache[0] == "f32" else cache[0]
    tcache = torch.float32 if cache[1] == "f32" else cache[1]
    other, cond = inputs if inputs is not None else (None, None)
    pc, tpr = prompts if prompts is not None else (None, None)
    jgen = jlm.MoshiGen(jp, jcfg, jwm, cache_dtype=jcache)
    jt, ja = jgen.generate_with_inputs(
        FRAMES, jax.random.PRNGKey(key), BATCH, None if pc is None else jnp.asarray(pc, jnp.int32),
        None if tpr is None else jnp.asarray(tpr, jnp.int32), None if other is None else jnp.asarray(other, jnp.int32),
        None if cond is None else jnp.asarray(cond))
    tgen = tlm.MoshiGen(tp, tcfg, twm, cache_dtype=tcache)
    tt, ta = tgen.generate_with_inputs(
        FRAMES, 0, BATCH, None if pc is None else torch.from_numpy(pc), None if tpr is None else torch.from_numpy(tpr),
        None if other is None else torch.from_numpy(other), None if cond is None else torch.from_numpy(cond),
        noise=_jax_noise(jax.random.PRNGKey(key)) if noise else None)
    return (np.asarray(jt), np.asarray(ja)), (tt.numpy(), ta.numpy())


def test_temporal_step_hidden_state(model):
    name, jcfg, tcfg, jp, tp = model
    tc = jcfg.temporal_cfg()
    jcache = jkv.KVCache.zeros(tc.n_layers, BATCH, tc.n_heads, 8, tc.head_dim, jnp.float32)
    tcache = KVCache.zeros(tc.n_layers, BATCH, tc.n_heads, 8, tc.head_dim)
    rng = np.random.default_rng(1)
    for pos in range(4):
        x = (rng.standard_normal((BATCH, jcfg.dim)) * 0.1).astype(np.float32)
        jh, jcache = jlm._temporal_step(jp["temporal"], jcfg, jnp.asarray(x), jcache, pos)
        th = tlm._temporal_step(tp["temporal"], tcfg, torch.from_numpy(x), tcache, pos,
                                torch.full((1,), pos + 1, dtype=torch.int32))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)


def test_gumbel_tokens_all_streams(model):
    """Gumbel on the text and every audio stream, a 1-gram text context,
    plus the user streams and a sum condition: deterministic given the
    logits, so the tokens are JAX's."""
    name, jcfg, tcfg, jp, tp = model
    streams = tuple(range(1 + jcfg.n_audio_streams))
    j, t = _run_both(jcfg, tcfg, jp, tp, jlm.WMConfig(method="gumbel", streams=streams, ngram=1),
                     tlm.WMConfig(method="gumbel", streams=streams, ngram=1), inputs=_inputs(jcfg), noise=False)
    assert t[1].shape == (BATCH, jcfg.n_audio_streams, FRAMES)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_maryland_tokens_with_jax_noise(model):
    """Maryland on the text and streams 1 and 3, plain sampling on the
    rest, each (frame, stream) fed JAX's draw."""
    name, jcfg, tcfg, jp, tp = model
    kw = dict(method="maryland", streams=(0, 1, 3), ngram=2, delta=4.0, gamma=0.25, seed=11)
    j, t = _run_both(jcfg, tcfg, jp, tp, jlm.WMConfig(**kw), tlm.WMConfig(**kw), key=7)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def _greedy_margins(monkeypatch):
    """Record the port's top-two logit gap of every sampler call, in call order."""
    margins = []
    orig = tlm.MoshiGen._sample_stream

    def spy(self, logits, stream_idx, ctx, draw):
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        return orig(self, logits, stream_idx, ctx, draw)

    monkeypatch.setattr(tlm.MoshiGen, "_sample_stream", spy)
    return margins


@pytest.mark.parametrize("cache", ["packed", "packed4"])
def test_greedy_tokens_packed_caches(model, cache, monkeypatch):
    """Greedy decoding over the packed caches: JAX through its Pallas
    kernels in interpret mode, the port through the kernels' plain
    versions. Held frame by frame; see the module docstring for ties."""
    name, jcfg, tcfg, jp, tp = model
    margins = _greedy_margins(monkeypatch)
    j, t = _run_both(jcfg, tcfg, jp, tp, jlm.WMConfig(method="none", greedy=True),
                     tlm.WMConfig(method="none", greedy=True), cache=(cache, cache))
    k = jcfg.n_audio_streams
    delays = (0,) + tuple(jcfg.delays[s % len(jcfg.delays)] for s in range(k))
    gap = np.stack(margins).reshape(-1, 1 + k, BATCH)  # [frame, stream, row]
    # emitted position e of stream s was sampled at frame e + delay_s
    diffs = [(e + delays[s], s, b) for b in range(BATCH) for s in range(1 + k) for e in range(FRAMES)
             if (t[0][b, e] if s == 0 else t[1][b, s - 1, e]) != (j[0][b, e] if s == 0 else j[1][b, s - 1, e])]
    if diffs:
        frame, s, b = min(diffs)
        g = float(gap[frame, s, b])
        print(f"{name} {cache}: first token difference at frame {frame}, stream {s}, row {b}: logit gap {g:.3e}")
        assert g < TIE, f"frame {frame} stream {s} row {b}: tokens differ at a logit gap of {g}"
    else:
        np.testing.assert_array_equal(t[1], j[1])


def test_int8_weights(model):
    name, jcfg, tcfg, jp, tp = model
    jq = jlm.quantize_moshi_params_int8(jp)
    tq = tlm.quantize_moshi_params_int8(tp)
    for jb, tb in zip(jq["temporal"]["blocks"], tq["temporal"]["blocks"]):
        for key in ("wq", "w1", "w2"):
            np.testing.assert_array_equal(tb[key]["q"].numpy(), np.asarray(jb[key]["q"]))
            np.testing.assert_array_equal(tb[key]["s"].float().numpy(), np.asarray(jb[key]["s"], np.float32))
    np.testing.assert_array_equal(tq["text_head"]["q"].numpy(), np.asarray(jq["text_head"]["q"]))
    assert bridge.load_moshi(jax.tree.map(np.asarray, jq))["text_head"]["q"].dtype == torch.int8
    wm = dict(method="none", greedy=True)
    j, t = _run_both(jcfg, tcfg, jq, bridge.load_moshi(jax.tree.map(np.asarray, jq)), jlm.WMConfig(**wm),
                     tlm.WMConfig(**wm))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_prompt_teacher_forcing(model):
    """Audio and text prompts force the first frames; Gumbel on every stream."""
    name, jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    prompts = (rng.integers(0, jcfg.audio_vocab, (BATCH, jcfg.n_audio_streams, 3)),
               rng.integers(0, jcfg.text_vocab, (BATCH, 2)))
    streams = tuple(range(1 + jcfg.n_audio_streams))
    j, t = _run_both(jcfg, tcfg, jp, tp, jlm.WMConfig(method="gumbel", streams=streams),
                     tlm.WMConfig(method="gumbel", streams=streams), prompts=prompts, noise=False)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[0][:, :2], prompts[1])
    # the semantic stream (delay 0) emits the prompt frames as they were forced
    np.testing.assert_array_equal(t[1][:, 0, :3], prompts[0][:, 0])


def _moshi_sd(cfg):
    """A synthetic Moshi state dict in the released key layout (the JAX
    package's ``tests/test_moshi_parity.py`` builds the same)."""
    g = np.random.default_rng(3)
    r = lambda *s: (0.1 * g.standard_normal(s)).astype(np.float32)  # noqa: E731
    d, dd, card, text = cfg.dim, cfg.dep_dim, cfg.audio_vocab, cfg.text_vocab
    hidden = jlm.gating_hidden(d, int(cfg.hidden_scale * d))
    dhidden = jlm.gating_hidden(dd, int(cfg.hidden_scale * dd))
    k = cfg.n_audio_streams
    sd = {}
    for i in range(cfg.n_layers):
        p = f"transformer.layers.{i}."
        sd.update({p + "self_attn.in_proj_weight": r(3 * d, d), p + "self_attn.out_proj.weight": r(d, d),
                   p + "norm1.alpha": r(1, 1, d), p + "norm2.alpha": r(1, 1, d),
                   p + "gating.linear_in.weight": r(2 * hidden, d), p + "gating.linear_out.weight": r(d, hidden),
                   p + "layer_scale_1.scale": r(d), p + "layer_scale_2.scale": r(d)})
    for i in range(cfg.dep_layers):
        p = f"depformer.layers.{i}."
        sd.update({p + "self_attn.in_proj_weight": r(k * 3 * dd, dd), p + "self_attn.out_proj.weight": r(k * dd, dd),
                   p + "norm1.alpha": r(1, 1, dd), p + "norm2.weight": r(dd)})
        for s in range(k):
            sd[p + f"gating.{s}.linear_in.weight"] = r(2 * dhidden, dd)
            sd[p + f"gating.{s}.linear_out.weight"] = r(dd, dhidden)
    sd.update({"out_norm.alpha": r(1, 1, d), "text_emb.weight": r(text + 1, d), "text_linear.weight": r(text, d),
               "depformer_text_emb.weight": r(text + 1, dd), "depformer.norm.alpha": r(1, 1, dd)})
    for i in range(cfg.num_inputs):
        sd[f"emb.{i}.weight"] = r(card + 1, d)
    for i in range(k):
        sd[f"depformer_in.{i}.weight"] = r(dd, d)
        sd[f"linears.{i}.weight"] = r(card, dd)
    for i in range(k - 1):
        sd[f"depformer_emb.{i}.weight"] = r(card + 1, dd)
    return sd


def test_convert_moshi_lm():
    cfg = jlm.MoshiConfig(**MULTI)
    sd = _moshi_sd(cfg)
    want = jconvert.convert_moshi_lm(sd, cfg)
    got = tlm.convert_moshi_lm({k: torch.from_numpy(v) for k, v in sd.items()}, tlm.MoshiConfig(**MULTI))
    jleaves = dict(bridge.flatten(want))
    tleaves = dict(bridge.flatten(got))
    assert sorted(jleaves) == sorted(tleaves)
    for path, leaf in jleaves.items():
        np.testing.assert_array_equal(tleaves[path].numpy(), np.asarray(leaf), err_msg=path)
    # the converted tree has init_moshi_params's shapes, so msgpack files interoperate
    # (LayerScale, which init_moshi_params leaves out, aside)
    init = dict(bridge.flatten(tlm.init_moshi_params(tlm.MoshiConfig(**MULTI), None, device="meta")))
    assert {p: tuple(v.shape) for p, v in init.items()} == {
        p: tuple(v.shape) for p, v in tleaves.items() if not p.endswith((".ls1", ".ls2"))}


def test_moshi_v01_loop_length():
    """``MOSHI_V01`` runs ``n_frames + max_delay`` frames, each a temporal
    forward of its 32 layers: the kernel launches a generation makes."""
    cfg = tlm.MOSHI_V01
    assert cfg.full_delays() == (0,) + tuple(cfg.delays)
    assert cfg.total_steps(64) == 65 and cfg.temporal_cfg().head_dim == 128 and cfg.num_inputs == 16
    jcfg = jlm.MOSHI_V01
    assert (cfg.ffn_hidden, cfg.dep_ffn_hidden) == (jcfg.ffn_hidden, jcfg.dep_ffn_hidden)
