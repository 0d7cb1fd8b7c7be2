"""Port parity, engine and ops: KV caches, attention, the packed4 decode
kernel's plain version, int8 weights.

The same numpy-seeded inputs go through the JAX package (its Pallas kernel
in interpret mode, as its own tests run it) and the port. Cache payloads,
scales and int8 weights must be byte-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import attention as jattn
from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.ops import wquant as jwq
from wmar_tpu.ops.flash_decode import packed4_decode_attention as jax_packed4
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import attention as tattn
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.ops import wquant as twq
from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention, packed4_decode_attention_plain

L, B, H, T = 2, 3, 4, 24


def _np(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _t(x):
    x = x.detach()
    return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()


def _writes(d, seed, n_single=5, burst=3):
    """A burst write then single-token writes, as prefill then decode."""
    rng = np.random.default_rng(seed)
    out = [(0, rng.standard_normal((B, H, burst, d)).astype(np.float32),
            rng.standard_normal((B, H, burst, d)).astype(np.float32))]
    for pos in range(burst, burst + n_single):
        out.append((pos, rng.standard_normal((B, H, 1, d)).astype(np.float32) * 3,
                    rng.standard_normal((B, H, 1, d)).astype(np.float32)))
    return out


def _filled(kind, d, seed=0, pos_as_tensor=True):
    jc = jkv.KVCache.zeros(L, B, H, T, d, dtype=kind)
    tc = tkv.KVCache.zeros(L, B, H, T, d, dtype={jnp.float32: torch.float32, jnp.int8: torch.int8}.get(kind, kind))
    for pos, k, v in _writes(d, seed):
        for li in range(L):
            jc = jc.write(li, pos, jnp.asarray(k), jnp.asarray(v))
            tpos = torch.tensor(pos) if pos_as_tensor else pos
            tc = tc.write(li, tpos, torch.as_tensor(k), torch.as_tensor(v))
    return jc, tc


@pytest.mark.parametrize("kind", [jnp.float32, jnp.int8, "packed4"], ids=["f32", "int8", "packed4"])
def test_cache_bytes_identical(kind):
    """Payload and scale bytes equal JAX's after burst and single writes,
    with the slot given as a device tensor or a Python int."""
    for as_tensor in (True, False):
        jc, tc = _filled(kind, 16, pos_as_tensor=as_tensor)
        if kind == "packed4":
            pairs = [(jc.kv, tc.kv), (jc.scale, tc.scale)]
        elif kind == jnp.int8:
            pairs = [(jc.k, tc.k), (jc.v, tc.v), (jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)]
        else:
            pairs = [(jc.k, tc.k), (jc.v, tc.v)]
        for j, t in pairs:
            assert _t(t).dtype == _np(j).dtype
            np.testing.assert_array_equal(_t(t), _np(j))
        for li in range(L):
            for j, t in zip(jc.layer(li), tc.layer(li)):
                np.testing.assert_array_equal(_t(t), _np(j))


def test_packed4_cache_bridges_from_jax():
    jc, tc = _filled("packed4", 20, seed=3)
    bc = bridge.packed4_cache(np.asarray(jc.kv), np.asarray(jc.scale), 20)
    assert bc.n_heads == H and bc.max_len == T
    for li in range(L):
        for a, b in zip(bc.layer(li), tc.layer(li)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("d", [16, 20])
def test_packed4_plain_vs_jax_interpret_kernel(d):
    """The plain version against JAX's Pallas kernel run in interpret mode:
    atol 2e-2, the kernel's bf16 dots (q and p are rounded to bf16 there)."""
    jc, tc = _filled("packed4", d, seed=d)
    q = np.random.default_rng(d + 1).standard_normal((B, H, 1, d)).astype(np.float32)
    for li, n in ((0, 1), (1, 5), (1, 8)):
        want = jax_packed4(jnp.asarray(q), jc.kv, jc.scale, li, n, interpret=True)
        got = packed4_decode_attention_plain(torch.as_tensor(q), tc.kv, tc.scale, li, n)
        assert got.dtype == torch.float32 and got.shape == (B, H, 1, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize("d", [16, 20])
def test_packed4_plain_vs_jax_decode_attention(d):
    """The plain version against JAX's XLA path over the dequantized
    ``cache.layer()``: atol 2e-2, that path's bf16 p @ V product."""
    jc, tc = _filled("packed4", d, seed=10 + d)
    q = np.random.default_rng(d).standard_normal((B, H, 1, d)).astype(np.float32)
    for li in range(L):
        for n in (1, 2, 4, 8):
            want = jattn.decode_attention(jnp.asarray(q), *jc.layer(li), valid_len=n)
            got = packed4_decode_attention(torch.as_tensor(q), tc.kv, tc.scale, li, torch.tensor(n))
            np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=0)
            # slots past valid_len hold data but must not take part
            if n < 8:
                longer = packed4_decode_attention(torch.as_tensor(q), tc.kv, tc.scale, li, 8)
                assert not torch.allclose(got, longer, atol=1e-3)


def test_packed4_wrapper_refuses_the_chunked_cases():
    """JAX's routing rule: from 1024 slots on the wrapper takes the chunked
    path (its plain version on the CPU), with or without ``start`` and
    ``key_mask``; below 1024 slots a masked call raises ``ValueError``."""
    tc = tkv.Packed4QuantKVCache.zeros(1, 2, 2, 1024, 8)
    tc.write(0, 0, torch.randn((2, 2, 6, 8)), torch.randn((2, 2, 6, 8)))
    q = torch.randn((2, 2, 1, 8))
    start = torch.tensor([0, 2], dtype=torch.int32)
    torch.testing.assert_close(packed4_decode_attention(q, tc.kv, tc.scale, 0, 5),
                               packed4_decode_attention_plain(q, tc.kv, tc.scale, 0, 5), rtol=0, atol=0)
    torch.testing.assert_close(packed4_decode_attention(q, tc.kv, tc.scale, 0, 5, start=start),
                               packed4_decode_attention_plain(q, tc.kv, tc.scale, 0, 5, start), rtol=0, atol=0)
    small = tkv.Packed4QuantKVCache.zeros(1, 2, 2, 16, 8)
    with pytest.raises(ValueError, match="chunked"):
        packed4_decode_attention(q, small.kv, small.scale, 0, 5, start=start)
    with pytest.raises(ValueError, match="chunked"):
        packed4_decode_attention(q, small.kv, small.scale, 0, 5, key_mask=torch.ones((2, 16), dtype=torch.bool))


@pytest.mark.parametrize("kind", [jnp.float32, jnp.int8, "packed4"], ids=["f32", "int8", "packed4"])
def test_cached_decode_attention_dispatch(kind):
    """The dispatchers agree for single-token steps (kernel path for
    packed4) and 2-token bursts (plain path everywhere): atol 2e-2 where
    bf16 products enter (int8, packed4), 1e-5 at f32."""
    jc, tc = _filled(kind, 16, seed=7)
    atol = 1e-5 if kind == jnp.float32 else 2e-2
    rng = np.random.default_rng(8)
    for t, n in ((1, 6), (2, 8)):
        q = rng.standard_normal((B, H, t, 16)).astype(np.float32)
        want = jattn.cached_decode_attention(jnp.asarray(q), jc, 1, n)
        got = tattn.cached_decode_attention(torch.as_tensor(q), tc, 1, torch.tensor(n))
        assert got.shape == (B, H, t, 16)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


def test_decode_attention_masks_match():
    """Burst causality, ragged ``start`` and ``key_mask`` at f32: atol 1e-5."""
    rng = np.random.default_rng(9)
    k = rng.standard_normal((B, H, T, 8)).astype(np.float32)
    v = rng.standard_normal((B, H, T, 8)).astype(np.float32)
    start = np.array([0, 2, 5], np.int32)
    key_mask = rng.random((B, T)) < 0.8
    key_mask[:, :6] = True
    for t in (1, 3):
        q = rng.standard_normal((B, H, t, 8)).astype(np.float32)
        for kw in ({}, {"start": start}, {"key_mask": key_mask}, {"start": start, "key_mask": key_mask}):
            want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 10,
                                          **{a: jnp.asarray(b) for a, b in kw.items()})
            got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.tensor(10),
                                         **{a: torch.as_tensor(b) for a, b in kw.items()})
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    q = rng.standard_normal((B, H, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tattn.prefill_attention(*(torch.as_tensor(x) for x in (q, k[:, :, :5], v[:, :, :5]))).numpy(),
        np.asarray(jattn.prefill_attention(*(jnp.asarray(x) for x in (q, k[:, :, :5], v[:, :, :5])))),
        atol=1e-5, rtol=0)


def test_int8_weights_identical():
    """int8 payloads and bf16 scales are bit-identical; the int8 linear
    then agrees at f32 (atol 1e-4) and at bf16 (atol 5e-2)."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((48, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    b = rng.standard_normal(40).astype(np.float32)
    jq = jwq.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, compute_dtype=jnp.bfloat16)
    tq = twq.quantize_linear_int8({"w": torch.as_tensor(w), "b": torch.as_tensor(b)}, compute_dtype=torch.bfloat16)
    for key in ("w_q", "w_scale", "b"):
        assert _t(tq[key]).dtype == _np(jq[key]).dtype
        np.testing.assert_array_equal(_t(tq[key]), _np(jq[key]))
    x = rng.standard_normal((5, 48)).astype(np.float32)
    jf = {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v for k, v in jq.items()}
    tf = {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in tq.items()}
    np.testing.assert_allclose(twq.linear(torch.as_tensor(x), tf).numpy(),
                               np.asarray(jwq.linear(jnp.asarray(x), jf)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        twq.linear(torch.as_tensor(x).bfloat16(), tq).float().numpy(),
        np.asarray(jwq.linear(jnp.asarray(x, jnp.bfloat16), jq), np.float32), atol=5e-2, rtol=0)
    lin = twq.Linear(48, 40)
    lin.w, lin.b = torch.as_tensor(w), torch.as_tensor(b)
    lin.quantize_int8()
    assert set(lin.params()) == {"w_q", "w_scale", "b"}
    # bits=4 at n_in 48: no int4 group divides it, so both packages give int8
    j4 = jwq.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, bits=4, compute_dtype=jnp.bfloat16)
    t4 = twq.quantize_linear({"w": torch.as_tensor(w), "b": torch.as_tensor(b)}, bits=4, compute_dtype=torch.bfloat16)
    assert set(t4) == set(j4) == {"w_q", "w_scale", "b"}
    for key in t4:
        np.testing.assert_array_equal(_t(t4[key]), _np(j4[key]))


def test_cast_float_leaves():
    tree = {"a": [torch.ones(2), torch.ones(2, dtype=torch.int8)], "b": torch.zeros(1)}
    out = twq.cast_float_leaves(tree, torch.bfloat16)
    assert out["a"][0].dtype == torch.bfloat16 and out["a"][1].dtype == torch.int8
    assert out["b"].dtype == torch.bfloat16
    jout = jwq.cast_float_leaves({"a": [jnp.ones(2), jnp.ones(2, jnp.int8)]}, jnp.bfloat16)
    assert jout["a"][0].dtype == jnp.bfloat16 and jout["a"][1].dtype == jnp.int8
