"""Port parity, Moshi's conditioners (``wmar_tpu_torch.audio.conditioners``)
against ``wmar_tpu.audio.conditioners`` on the CPU.

JAX's parameters (``init_lut_params``, or ``convert_conditioners`` of the
released layout) cross through ``bridge.load_conditioners``. Tolerances:
tokens and masks equal; conditions and their sum within 1e-6 (float32, one
lookup and one product of width 8); a ``MoshiGen`` generation with that
sum as ``condition_sum``, fed JAX's Gumbel draws, token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.audio import conditioners as jcond
from wmar_tpu.audio import lm as jlm
from wmar_tpu_torch import bridge
from wmar_tpu_torch.audio import conditioners as tcond
from wmar_tpu_torch.audio import lm as tlm

CFGS = {"genre": dict(n_bins=8, dim=4, output_dim=16),
        "mood": dict(n_bins=4, dim=4, output_dim=16, possible_values=("calm", "angry", "sad", "happy"))}
ATTRS = [{"genre": "rock", "mood": "calm"}, {"genre": None, "mood": "sad"}]


def _providers():
    jconds = {name: (jcond.LUTConditionerConfig(**kw), jcond.init_lut_params(i, jcond.LUTConditionerConfig(**kw)))
              for i, (name, kw) in enumerate(CFGS.items())}
    jprov = jcond.ConditionProvider({n: (c, jax.tree.map(jnp.asarray, p)) for n, (c, p) in jconds.items()})
    return jprov, tcond.ConditionProvider(bridge.load_conditioners(jconds))


def test_hash_and_tokens_match_jax():
    for word in ("jazz", "warm male voice", ""):
        assert tcond.hash_trick(word, 31) == jcond.hash_trick(word, 31)
    for kw in CFGS.values():
        texts = ["rock", None, "calm"] if "possible_values" not in kw else ["angry", None, "happy"]
        jt, jm = jcond.tokenize_lut(jcond.LUTConditionerConfig(**kw), texts)
        tt, tm = tcond.tokenize_lut(tcond.LUTConditionerConfig(**kw), texts)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    with pytest.raises(ValueError, match="possible_values"):
        tcond.tokenize_lut(tcond.LUTConditionerConfig(**CFGS["mood"]), ["loud"])


def test_provider_and_sum_match_jax():
    jprov, tprov = _providers()
    jc, tc = jprov.condition_tensors(ATTRS), tprov.condition_tensors(ATTRS)
    for name in CFGS:
        np.testing.assert_allclose(tc[name][0].numpy(), np.asarray(jc[name][0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tc[name][1].numpy(), np.asarray(jc[name][1]))
    fuse = {"sum": ["genre", "mood"]}
    got = tcond.ConditionFuser(fuse).get_sum(tc)
    assert got.shape == (2, 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcond.ConditionFuser(fuse).get_sum(jc)), rtol=0, atol=1e-6)
    assert tcond.cfg_pair(ATTRS) == jcond.cfg_pair(ATTRS)
    with pytest.raises(RuntimeError, match="did not receive"):
        tprov.condition_tensors([{"genre": "rock"}])
    for method in ("prepend", "cross"):
        with pytest.raises(RuntimeError, match="only `sum`"):
            tcond.ConditionFuser({method: ["genre"]})
    assert not tcond.ConditionFuser({"sum": []}).has_conditions
    assert tcond.ConditionFuser({"sum": []}).get_sum(tc) is None


def test_convert_released_layout_matches_jax():
    """The released layout (``embed.weight``, ``output_proj.weight`` as
    torch's ``[out, in]``, ``learnt_padding``) through both converters."""
    rng = np.random.default_rng(0)
    p = "condition_provider.conditioners.description."
    sd = {p + "embed.weight": rng.standard_normal((17, 8)).astype(np.float32),
          p + "output_proj.weight": rng.standard_normal((12, 8)).astype(np.float32),
          p + "learnt_padding": rng.standard_normal((1, 1, 12)).astype(np.float32)}
    kw = dict(n_bins=16, dim=8, output_dim=12)
    jconds = jcond.convert_conditioners(sd, {"description": jcond.LUTConditionerConfig(**kw)})
    tconds = tcond.convert_conditioners(sd, {"description": tcond.LUTConditionerConfig(**kw)})
    for k, v in jconds["description"][1].items():
        np.testing.assert_array_equal(tconds["description"][1][k].numpy(), np.asarray(v))
    texts = ["warm male voice", None, "whisper"]
    cfg = tconds["description"][0]
    got = tcond.lut_condition(tconds["description"][1], *tcond.tokenize_lut(cfg, texts))
    want = jcond.lut_condition(jconds["description"][1], *jcond.tokenize_lut(jconds["description"][0], texts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_port_init_shapes():
    cfg = tcond.LUTConditionerConfig(**CFGS["genre"])
    p = tcond.init_lut_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == {"embed": (9, 4), "output_proj": (4, 16),
                                                          "learnt_padding": (1, 1, 16)}


def test_condition_sum_generation_matches_jax():
    """The fused sum of both conditioners as ``condition_sum`` of a tiny
    Moshi (dim 16): Maryland on the text and stream 1, plain sampling on the
    rest, each (frame, stream) fed JAX's draw; the same tokens, and other
    tokens than without the condition."""
    jprov, tprov = _providers()
    fuse = {"sum": ["genre", "mood"]}
    jsum = jcond.ConditionFuser(fuse).get_sum(jprov.condition_tensors(ATTRS))
    tsum = tcond.ConditionFuser(fuse).get_sum(tprov.condition_tensors(ATTRS))
    kw = dict(text_vocab=32, audio_vocab=24, n_audio_streams=2, dim=16, n_layers=1, n_heads=2, dep_dim=16,
              dep_layers=1, dep_heads=2, delays=(0, 1))
    jcfg, tcfg = jlm.MoshiConfig(**kw), tlm.MoshiConfig(**kw)
    jp = jlm.init_moshi_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.load_moshi(jax.tree.map(np.asarray, jp))
    wm = dict(method="maryland", streams=(0, 1), ngram=1, delta=4.0, gamma=0.25, seed=3)
    key = jax.random.PRNGKey(1)

    def noise(t, s, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, t), s)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))

    jt, ja = jlm.MoshiGen(jp, jcfg, jlm.WMConfig(**wm)).generate_with_inputs(6, key, batch=2, condition_sum=jsum)
    tgen = tlm.MoshiGen(tp, tcfg, tlm.WMConfig(**wm))
    tt, ta = tgen.generate_with_inputs(6, 0, 2, condition_sum=tsum, noise=noise)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    t0, a0 = tgen.generate_with_inputs(6, 0, 2, noise=noise)
    assert not (torch.equal(t0, tt) and torch.equal(a0, ta))
