"""Port parity, the Llama backbone of Chameleon.

JAX parameters are made from a PRNG key, turned into numpy trees and
bridged into the port (:func:`wmar_tpu_torch.bridge.load_llama`). Prefill
with ragged left padding and one decode step at a long cache (the chunked
packed kernels' route) go through both packages at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.models import llama as jl
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.models import llama as tl

CFG = dict(dim=32, n_layers=2, n_heads=4, vocab_size=64, multiple_of=16, qk_normalization=True)


def _pair(seed=0, **overrides):
    jcfg = jl.LlamaConfig(**{**CFG, **overrides})
    params = jl.init_llama_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 7)
    # qk-norm scales and biases away from 1 and 0, so the LayerNorm's affine part is tested
    for blk in params["blocks"]:
        for key in ("q_norm", "k_norm"):
            if key in blk:
                blk[key] = {"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(jcfg.head_dim), jnp.float32),
                            "bias": jnp.asarray(0.1 * rng.standard_normal(jcfg.head_dim), jnp.float32)}
    tcfg = tl.LlamaConfig(**{**CFG, **overrides})
    return jcfg, params, tcfg, bridge.load_llama(jax.tree.map(np.asarray, params))


def _prompts(rng, b, t, vocab):
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    start = rng.integers(0, t - 1, b).astype(np.int32)
    start[0] = 0
    positions = np.maximum(np.arange(t)[None, :] - start[:, None], 0).astype(np.int32)
    return tokens, start, positions


@pytest.mark.parametrize("overrides", [{}, {"n_kv_heads": 2}, {"qk_normalization": False, "layer_scale": True}],
                         ids=["chameleon", "gqa", "no_qk_norm_layer_scale"])
def test_prefill_logits_ragged_start(overrides):
    """Prefill of left-padded prompts with a ragged ``start`` (f32 cache):
    logits within 1e-4, and the written cache within 1e-5."""
    jcfg, params, tcfg, tparams = _pair(**overrides)
    tokens, start, positions = _prompts(np.random.default_rng(1), 3, 7, CFG["vocab_size"])
    jcache = jkv.KVCache.zeros(jcfg.n_layers, 3, jcfg.n_heads, 12, jcfg.head_dim)
    want, jcache = jl.llama_forward(params, jcfg, jnp.asarray(tokens), jcache, 0, jnp.asarray(positions),
                                    start=jnp.asarray(start))
    tcache = tkv.KVCache.zeros(tcfg.n_layers, 3, tcfg.n_heads, 12, tcfg.head_dim)
    got, tcache = tl.llama_forward(tparams, tcfg, torch.as_tensor(tokens, dtype=torch.int64), tcache, 0,
                                   torch.as_tensor(positions), start=torch.as_tensor(start))
    assert got.dtype == torch.float32 and got.shape == (3, 7, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=0)


def test_left_padded_prompt_matches_unpadded():
    """A right-aligned prompt with left pads gives the unpadded prompt's
    last-token logits (pad masking and rope offsets), as in JAX: 2e-4."""
    _, _, tcfg, tparams = _pair()
    prompt = torch.tensor([[0, 7, 8, 2]])
    cache = tkv.KVCache.zeros(tcfg.n_layers, 1, tcfg.n_heads, 8, tcfg.head_dim)
    logits_a, _ = tl.llama_forward(tparams, tcfg, prompt, cache, 0, torch.arange(4)[None], start=torch.tensor([0]))
    padded = torch.cat([torch.full((1, 3), 4), prompt], dim=1)
    cache_b = tkv.KVCache.zeros(tcfg.n_layers, 1, tcfg.n_heads, 11, tcfg.head_dim)
    pos_b = torch.clamp_min(torch.arange(7)[None] - 3, 0)
    logits_b, _ = tl.llama_forward(tparams, tcfg, padded, cache_b, 0, pos_b, start=torch.tensor([3]))
    torch.testing.assert_close(logits_a[:, -1], logits_b[:, -1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["packed4", "packed"])
def test_decode_step_long_packed_cache(kind):
    """Prefill then one decode step with a ragged ``start`` on a packed
    cache of 1024 slots: JAX runs its chunked Pallas kernels in interpret
    mode (bf16 dots), the port their plain float32 versions. Decode-step
    logits within 5e-2 (the kernels' bf16 rounding through two layers).
    The payloads both wrote differ by at most one quantization level on
    under 2% of the values: K and V agree to float32 rounding, which moves
    a value across a rounding boundary now and then."""
    jcfg, params, tcfg, tparams = _pair(seed=3)
    tokens, start, positions = _prompts(np.random.default_rng(4), 4, 6, CFG["vocab_size"])
    jcache = jkv.KVCache.zeros(jcfg.n_layers, 4, jcfg.n_heads, 1024, jcfg.head_dim, kind)
    tcache = tkv.KVCache.zeros(tcfg.n_layers, 4, tcfg.n_heads, 1024, tcfg.head_dim, kind)
    jstart, tstart = jnp.asarray(start), torch.as_tensor(start)
    _, jcache = jl.llama_forward(params, jcfg, jnp.asarray(tokens), jcache, 0, jnp.asarray(positions), start=jstart)
    _, tcache = tl.llama_forward(tparams, tcfg, torch.as_tensor(tokens, dtype=torch.int64), tcache, 0,
                                 torch.as_tensor(positions), start=tstart)
    nxt = np.array([[1], [5], [9], [3]], np.int32)
    pos = (6 - start)[:, None]
    want, jcache = jl.llama_forward(params, jcfg, jnp.asarray(nxt), jcache, 6, jnp.asarray(pos), start=jstart)
    got, tcache = tl.llama_forward(tparams, tcfg, torch.as_tensor(nxt, dtype=torch.int64), tcache, torch.tensor(6),
                                   torch.as_tensor(pos), start=tstart)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]), atol=5e-2, rtol=0)
    got_kv, want_kv = tcache.kv[:, :, :7].numpy(), np.asarray(jcache.kv[:, :, :7])
    if kind == "packed4":  # compare the nibbles, not the packed bytes
        got_kv = np.stack([got_kv & 0xF, got_kv >> 4])
        want_kv = np.stack([want_kv & 0xF, want_kv >> 4])
    diff = np.abs(got_kv.astype(np.int32) - want_kv.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02, ((diff > 0).mean(), diff.max())


def test_flash_decode_case_raises(monkeypatch):
    """Where JAX takes the flash-decode kernels #5/#6 (a float or int8
    cache of >= 2048 slots, single-token step) the port no longer raises
    ``NotImplementedError``: it takes its own (on the CPU their plain
    versions), and the logits agree with the plain attention route forced
    by ``USE_FLASH_DECODE = False`` (f32 within 1e-5; int8 within 2e-2,
    the plain route dequantizes to bf16). What still raises is a CUDA-only
    precondition asked of a CUDA tensor, which no CPU test can reach."""
    _, _, tcfg, tparams = _pair()
    for dtype, atol in ((torch.float32, 1e-5), (torch.int8, 2e-2)):
        logits = []
        for flag in (None, False):
            monkeypatch.setattr(tl, "USE_FLASH_DECODE", flag)
            cache = tkv.KVCache.zeros(tcfg.n_layers, 1, tcfg.n_heads, 2048, tcfg.head_dim, dtype)
            out, _ = tl.llama_forward(tparams, tcfg, torch.tensor([[3]]), cache, 0, torch.zeros((1, 1), dtype=torch.int64))
            out2, _ = tl.llama_forward(tparams, tcfg, torch.tensor([[9]]), cache, 1, torch.ones((1, 1), dtype=torch.int64))
            logits.append(torch.cat([out, out2], dim=1))
        assert torch.isfinite(logits[0]).all()
        torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=atol)


def test_int8_quantization_bit_identical():
    """``quantize_llama_params_int8`` payloads and scales equal JAX's bit for
    bit (bf16 compute dtype), and the int8 forward agrees at 1e-4 in f32."""
    jcfg, params, tcfg, tparams = _pair(seed=5)
    jq = jax.tree.map(np.asarray, jl.quantize_llama_params_int8(params, compute_dtype=jnp.bfloat16))
    tq = tl.quantize_llama_params_int8(tparams, compute_dtype=torch.bfloat16)
    jleaves, tleaves = dict(bridge.flatten(jq)), dict(bridge.flatten(tq))
    assert jleaves.keys() == tleaves.keys() and "blocks.0.wq.q" in tleaves and "output.s" in tleaves
    for key, j in jleaves.items():
        t = tleaves[key]
        j = np.asarray(j)
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=key)
    # bits=4: grouped-int4 leaves, bit-identical too
    jq4 = dict(bridge.flatten(jax.tree.map(np.asarray, jl.quantize_llama_params_int8(params, bits=4))))
    tq4 = dict(bridge.flatten(tl.quantize_llama_params_int8(tparams, bits=4)))
    assert jq4.keys() == tq4.keys() and "blocks.0.w2.q4" in tq4 and "output.s4" in tq4
    for key, j in jq4.items():
        np.testing.assert_array_equal(_bits(tq4[key]), _bits(j), err_msg=key)
    # the int8 tree at f32 compute: the port and JAX forward agree
    jq32 = jl.quantize_llama_params_int8(params)
    tq32 = tl.quantize_llama_params_int8(tparams)
    tokens = np.array([[0, 7, 8]], np.int32)
    want, _ = jl.llama_forward(jq32, jcfg, jnp.asarray(tokens), jkv.KVCache.zeros(2, 1, 4, 8, 8), 0,
                               jnp.arange(3)[None])
    got, _ = tl.llama_forward(tq32, tcfg, torch.as_tensor(tokens, dtype=torch.int64), tkv.KVCache.zeros(2, 1, 4, 8, 8),
                              0, torch.arange(3)[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _bits(x):
    """Raw bytes of a tensor or numpy array (bf16 seen as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_int4_forward_logits():
    """int4 weights (group 32: every matrix's input, 32 or the FFN's 96, is
    a multiple of 32 only), f32 compute: prefill logits of the port and JAX
    within 1e-4."""
    jcfg, params, tcfg, tparams = _pair(seed=6)
    jq, tq = jl.quantize_llama_params_int8(params, bits=4), tl.quantize_llama_params_int8(tparams, bits=4)
    assert tq["blocks"][0]["wq"]["q4"].shape[1] == 16 and tq["blocks"][0]["w2"]["q4"].shape == (3, 16, 32)
    tokens = np.array([[0, 7, 8, 2], [3, 9, 1, 5]], np.int32)
    want, _ = jl.llama_forward(jq, jcfg, jnp.asarray(tokens), jkv.KVCache.zeros(2, 2, 4, 8, 8), 0,
                               jnp.tile(jnp.arange(4)[None], (2, 1)))
    got, _ = tl.llama_forward(tq, tcfg, torch.as_tensor(tokens, dtype=torch.int64), tkv.KVCache.zeros(2, 2, 4, 8, 8),
                              0, torch.arange(4)[None].expand(2, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_rope_and_init():
    """Rotary embedding on adjacent pairs at per-row positions (f32, 1e-6),
    and the port's init follows JAX's rules."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5))
    np.testing.assert_allclose(tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0).numpy(),
                               np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), atol=1e-6)
    cfg = tl.LlamaConfig(**CFG)
    p = tl.init_llama_params(cfg, torch.Generator().manual_seed(0))
    assert set(p["blocks"][0]) == {"attention_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w1", "w3", "w2",
                                   "q_norm", "k_norm"}
    assert p["blocks"][0]["w1"].shape == (32, cfg.ffn_hidden) and abs(p["tok_embeddings"].std() - 0.02) < 0.003
    assert tl.CHAMELEON_7B.ffn_hidden == 11008 and tl.CHAMELEON_7B.head_dim == 128
