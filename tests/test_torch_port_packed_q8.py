"""Port parity, the int8 packed KV cache and the packed decode kernels'
plain versions (kernels #2-#4), against the JAX package.

The same numpy-seeded inputs go through both packages. Cache payloads and
scales must be byte-identical. The plain versions are held to JAX's Pallas
kernels run in interpret mode (as its own tests run them), single-block
below 1024 slots and chunked (``chunk_t=128``) from 1024 on, at atol 2e-2:
the TPU kernels round q and p to bf16 for their dots. Every masked row
keeps at least one valid slot, the kernels' precondition.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import attention as jattn
from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.ops import flash_decode as jfd
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import attention as tattn
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.ops import flash_decode as tfd

L, B, H, D = 2, 4, 4, 16
TL = 1024  # long context: the chunked kernels and the masked route


def _bits(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _filled(kind, t, seed, writes=12, burst=3):
    """A burst write, then single-token writes, through both packages."""
    rng = np.random.default_rng(seed)
    jc = jkv.KVCache.zeros(L, B, H, t, D, dtype=kind)
    tc = tkv.KVCache.zeros(L, B, H, t, D, dtype=torch.int8 if kind is jnp.int8 else kind)
    pos = 0
    while pos < writes:
        n = burst if pos == 0 else 1
        for li in range(L):
            k = rng.standard_normal((B, H, n, D)).astype(np.float32) * (1 + li)
            v = rng.standard_normal((B, H, n, D)).astype(np.float32)
            jc = jc.write(li, pos, jnp.asarray(k), jnp.asarray(v))
            tc = tc.write(li, torch.tensor(pos) if pos % 2 else pos, torch.as_tensor(k), torch.as_tensor(v))
        pos += n
    return jc, tc


def _masks(t, seed):
    rng = np.random.default_rng(seed)
    start = np.array([0, 2, 5, 1], np.int32)
    km = rng.integers(0, 2, (B, t)).astype(bool)
    km[np.arange(B), start] = True  # every row keeps a valid slot
    km[:, 3] = False
    return start, km


def test_packed_cache_bytes_identical():
    """Payload and scale bytes equal JAX's after burst and single writes,
    the slot given as a device tensor or a Python int; ``layer()`` equal,
    and equal to the int8 ``QuantKVCache``'s dequantized values."""
    jc, tc = _filled("packed", 24, seed=0)
    assert isinstance(tc, tkv.PackedQuantKVCache) and tc.n_heads == H and tc.max_len == 24
    for j, t in ((jc.kv, tc.kv), (jc.scale, tc.scale)):
        assert _bits(t).dtype == _bits(j).dtype
        np.testing.assert_array_equal(_bits(t), _bits(j))
    _, tq = _filled(jnp.int8, 24, seed=0)
    for li in range(L):
        for j, t, q in zip(jc.layer(li), tc.layer(li), tq.layer(li)):
            np.testing.assert_array_equal(_bits(t), _bits(j))
            np.testing.assert_array_equal(_bits(t), _bits(q))
    bc = bridge.packed_cache(np.asarray(jc.kv), np.asarray(jc.scale), D)
    for a, b in zip(bc.layer(1), tc.layer(1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 7, 12])
def test_q8_plain_vs_jax_single_block_kernel(n):
    """Kernel #2's plain version against JAX's ``_packed_attn_kernel_q8``
    in interpret mode (T < 1024): atol 2e-2."""
    jc, tc = _filled("packed", 24, seed=n)
    q = np.random.default_rng(n + 1).standard_normal((B, H, 1, D)).astype(np.float32)
    for li in range(L):
        want = jfd.packed_decode_attention_q8(jnp.asarray(q), jc.kv, jc.scale, li, n, interpret=True)
        got = tfd.packed_decode_attention_q8_plain(torch.as_tensor(q), tc.kv, tc.scale, li, n)
        assert got.dtype == torch.float32 and got.shape == (B, H, 1, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize("kind", ["packed", "packed4"])
@pytest.mark.parametrize("masks", ["none", "start", "key_mask", "both"])
def test_chunked_plain_vs_jax_chunked_kernel(kind, masks):
    """Kernels #3 (int8) and #4 (int4): the plain versions against JAX's
    chunked kernels in interpret mode (T = 1024, chunk_t = 128), with and
    without ``start``/``key_mask``: atol 2e-2. Also through the port's
    public wrapper, which routes to the chunked path on the CPU."""
    jc, tc = _filled(kind, TL, seed=30)
    start, km = _masks(TL, seed=31)
    kw = {"start": start if masks in ("start", "both") else None,
          "key_mask": km if masks in ("key_mask", "both") else None}
    q = np.random.default_rng(32).standard_normal((B, H, 1, D)).astype(np.float32)
    jfn, plain, public = {
        "packed": (jfd.packed_decode_attention_q8, tfd.packed_decode_attention_q8_plain,
                   tfd.packed_decode_attention_q8),
        "packed4": (jfd.packed4_decode_attention, tfd.packed4_decode_attention_plain, tfd.packed4_decode_attention),
    }[kind]
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: None if v is None else torch.as_tensor(v) for k, v in kw.items()}
    for li, n in ((0, 12), (1, 9)):
        want = np.asarray(jfn(jnp.asarray(q), jc.kv, jc.scale, li, n, chunk_t=128, interpret=True, **jkw))
        got = plain(torch.as_tensor(q), tc.kv, tc.scale, li, n, **tkw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)
        routed = public(torch.as_tensor(q), tc.kv, tc.scale, li, torch.tensor(n), **tkw)
        torch.testing.assert_close(routed, got, rtol=0, atol=0)


def test_chunked_plain_spans_chunks():
    """Valid slots past the first 128-slot chunk, a ragged ``start`` that
    blanks the whole first chunk of some rows, and a key mask: the int4
    plain version against JAX's chunked kernel at atol 2e-2."""
    rng = np.random.default_rng(40)
    jc = jkv.KVCache.zeros(1, B, H, TL, D, dtype="packed4")
    tc = tkv.KVCache.zeros(1, B, H, TL, D, dtype="packed4")
    k = rng.standard_normal((B, H, 300, D)).astype(np.float32)
    v = rng.standard_normal((B, H, 300, D)).astype(np.float32)
    jc = jc.write(0, 0, jnp.asarray(k), jnp.asarray(v))
    tc.write(0, 0, torch.as_tensor(k), torch.as_tensor(v))
    start = np.array([0, 130, 131, 250], np.int32)
    km = rng.random((B, TL)) < 0.7
    km[np.arange(B), start] = True
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    want = jfd.packed4_decode_attention(jnp.asarray(q), jc.kv, jc.scale, 0, 300, start=jnp.asarray(start),
                                        key_mask=jnp.asarray(km), chunk_t=128, interpret=True)
    got = tfd.packed4_decode_attention_plain(torch.as_tensor(q), tc.kv, tc.scale, 0, 300,
                                             torch.as_tensor(start), torch.as_tensor(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize("kind", ["packed", "packed4"])
def test_masked_calls_below_1024_slots_raise(kind):
    """JAX's rule: start/key_mask only on the chunked path (T >= 1024)."""
    _, tc = _filled(kind, 24, seed=5)
    public = tfd.packed_decode_attention_q8 if kind == "packed" else tfd.packed4_decode_attention
    q = torch.zeros((B, H, 1, D))
    with pytest.raises(ValueError, match="chunked"):
        public(q, tc.kv, tc.scale, 0, 5, start=torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="chunked"):
        public(q, tc.kv, tc.scale, 0, 5, key_mask=torch.ones((B, 24), dtype=torch.bool))
    jc, _ = _filled(kind, 24, seed=5)
    jfn = jfd.packed_decode_attention_q8 if kind == "packed" else jfd.packed4_decode_attention
    with pytest.raises(ValueError, match="chunked"):
        jfn(jnp.zeros((B, H, 1, D)), jc.kv, jc.scale, 0, 5, start=jnp.zeros(B, jnp.int32), interpret=True)


@pytest.mark.parametrize("kind", ["packed", "packed4"])
@pytest.mark.parametrize("t", [24, TL])
def test_cached_decode_attention_dispatch(kind, t):
    """Both dispatchers agree for the packed caches: single-token steps
    (the kernels' plain versions here, JAX's kernels in interpret mode),
    masked steps (through the kernels at T >= 1024, through the plain
    attention on ``layer()`` below) and 2-token bursts: atol 2e-2."""
    jc, tc = _filled(kind, t, seed=50)
    start, km = _masks(t, seed=51)
    rng = np.random.default_rng(52)
    for tq, n in ((1, 12), (2, 12)):
        q = rng.standard_normal((B, H, tq, D)).astype(np.float32)
        for kw in ({}, {"start": start}, {"start": start, "key_mask": km}):
            want = jattn.cached_decode_attention(jnp.asarray(q), jc, 1, n, **{a: jnp.asarray(b) for a, b in kw.items()})
            got = tattn.cached_decode_attention(torch.as_tensor(q), tc, 1, torch.tensor(n),
                                                **{a: torch.as_tensor(b) for a, b in kw.items()})
            assert got.shape == (B, H, tq, D)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=0)
