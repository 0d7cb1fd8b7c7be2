"""Port parity, the flash-decode attention kernels and the two probes.

On the CPU the port's wrappers take their plain float32 versions; JAX runs
its Pallas kernels in interpret mode. The same numpy inputs go through both.
Tolerances: 1e-5 of the largest output at f32 (summation order), 2^-8 of it
with bf16 q (the output's rounding to bf16; both sides compute in float32).
The int8 kernel is held to JAX's int8 *kernel* (which scales in float32),
not to JAX's plain int8 path, which dequantizes to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.models import llama as jl
from wmar_tpu.ops import flash_decode as jfd
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.ops import flash_decode as tfd

F32_REL, BF16_REL = 1e-5, 2.0**-8


def _close(got: torch.Tensor, want, bf16: bool):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = (BF16_REL if bf16 else F32_REL) * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _masks(rng, b, t, valid_len, start, key_mask):
    starts = np.minimum(rng.integers(0, 8, b), valid_len - 1).astype(np.int32) if start else None
    km = None
    if key_mask:
        km = rng.random((b, t)) > 0.4
        km[np.arange(b), starts if start else 0] = True  # every row keeps a slot that takes part
    return starts, km


def _t(x, dtype=None):
    return None if x is None else torch.as_tensor(x, dtype=dtype)


CASES = [(d, dt, st, km) for d in (16, 80, 128) for dt in ("f32", "bf16")
         for st, km in ((False, False), (True, False), (False, True), (True, True))]


@pytest.mark.parametrize("d,dtype,start,key_mask", CASES)
def test_flash_decode_matches_jax_kernel(d, dtype, start, key_mask):
    """Kernel #5's plain version against ``flash_decode_attention(...,
    interpret=True)``: f32 and bf16 q and cache, with and without ``start``
    and ``key_mask``, head dims 16, 80 and 128."""
    rng = np.random.default_rng(d + 7 * start + 13 * key_mask)
    b, h, t, valid_len = 3, 2, 32, 20
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, 1, d), (b, h, t, d), (b, h, t, d)))
    starts, km = _masks(rng, b, t, valid_len, start, key_mask)
    want = jfd.flash_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.int32(valid_len),
        start=None if starts is None else jnp.asarray(starts), key_mask=None if km is None else jnp.asarray(km),
        interpret=True)
    got = tfd.flash_decode_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), valid_len, start=_t(starts),
                                     key_mask=_t(km))
    assert got.dtype == tdt
    _close(got, np.asarray(want, np.float32), dtype == "bf16")
    # valid_len as a device tensor of one element, the decode loop's form
    again = tfd.flash_decode_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt),
                                       torch.tensor([valid_len], dtype=torch.int32), start=_t(starts), key_mask=_t(km))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("d,dtype,start,key_mask", CASES)
def test_flash_decode_q8_matches_jax_kernel(d, dtype, start, key_mask):
    """Kernel #6's plain version against ``flash_decode_attention_q8(...,
    interpret=True)`` over a cache that JAX's ``QuantKVCache.write`` filled
    and :func:`bridge.quant_cache` carried over. The port scales the score
    and the probability where JAX scales each element: float32 rounding."""
    rng = np.random.default_rng(100 + d + 7 * start + 13 * key_mask)
    b, h, t, valid_len = 3, 2, 32, 24
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, 1, d), (b, h, t, d), (b, h, t, d)))
    jcache = jkv.KVCache.zeros(2, b, h, t, d, dtype=jnp.int8).write(1, 0, jnp.asarray(k), jnp.asarray(v))
    tcache = bridge.quant_cache(*(np.asarray(x) for x in (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)))
    assert isinstance(tcache, tkv.QuantKVCache) and tcache.k.dtype == torch.int8 \
        and tcache.k_scale.dtype == torch.bfloat16 and tcache.max_len == t
    starts, km = _masks(rng, b, t, valid_len, start, key_mask)
    want = jfd.flash_decode_attention_q8(
        jnp.asarray(q, jdt), jcache.k[1], jcache.v[1], jcache.k_scale[1], jcache.v_scale[1], jnp.int32(valid_len),
        start=None if starts is None else jnp.asarray(starts), key_mask=None if km is None else jnp.asarray(km),
        interpret=True)
    got = tfd.flash_decode_attention_q8(_t(q).to(tdt), tcache.k[1], tcache.v[1], tcache.k_scale[1], tcache.v_scale[1],
                                        valid_len, start=_t(starts), key_mask=_t(km))
    assert got.dtype == tdt
    _close(got, np.asarray(want, np.float32), dtype == "bf16")


def test_port_quant_write_matches_jax_bytes():
    """The port's ``QuantKVCache.write`` gives JAX's payload and scale bytes,
    and ``bridge.kv_cache`` carries a float cache over unchanged."""
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal((2, 3, 5, 16)).astype(np.float32) for _ in range(2))
    jcache = jkv.KVCache.zeros(1, 2, 3, 8, 16, dtype=jnp.int8).write(0, 2, jnp.asarray(k), jnp.asarray(v))
    tcache = tkv.KVCache.zeros(1, 2, 3, 8, 16, torch.int8).write(0, 2, _t(k), _t(v))
    np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(tcache.v.numpy(), np.asarray(jcache.v))
    np.testing.assert_array_equal(tcache.k_scale.view(torch.int16).numpy(), np.asarray(jcache.k_scale).view(np.int16))
    jf = jkv.KVCache.zeros(1, 2, 3, 8, 16, dtype=jnp.bfloat16).write(0, 2, jnp.asarray(k), jnp.asarray(v))
    tf = bridge.kv_cache(np.asarray(jf.k), np.asarray(jf.v))
    assert isinstance(tf, tkv.KVCache) and tf.k.dtype == torch.bfloat16 and tf.max_len == 8
    np.testing.assert_array_equal(tf.v.float().numpy(), np.asarray(jf.v, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,d", [(4, 2, 16), (8, 3, 80)])
def test_dma_probe_matches_jax_kernel(dtype, b, h, d):
    """Kernel #7's plain version against ``_packed_dma_probe(...,
    interpret=True)``: the same output exactly, ``kv[b, 0, :HD] + scale[b,
    0, 0]`` in q's dtype."""
    rng = np.random.default_rng(b + d)
    t = 12
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(2))
    jcache = jkv.KVCache.zeros(2, b, h, t, d, dtype="packed").write(1, 0, jnp.asarray(k), jnp.asarray(v))
    tcache = bridge.packed_cache(np.asarray(jcache.kv), np.asarray(jcache.scale), d)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    want = jfd._packed_dma_probe(jnp.asarray(q, jdt), jcache.kv, jcache.scale, 1, rows_per_block=4, interpret=True)
    got = tfd._packed_dma_probe(_t(q).to(tdt), tcache.kv, tcache.scale, 1)
    assert got.dtype == tdt and got.shape == (b, h, 1, d)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert np.abs(got.float().numpy()).max() > 1  # int8 payload values, not zeros


@pytest.mark.parametrize("rows", [1, 64, 1024])
def test_row_mean_probe_matches_numpy(rows):
    """Kernel #9's plain version: float32 row means of a bf16 ``[rows,
    1024]`` array in all 128 output columns, within bf16's rounding (2^-8)
    of numpy's float64 means."""
    x = torch.as_tensor(np.random.default_rng(rows).standard_normal((rows, 1024)).astype(np.float32)).bfloat16()
    got = tfd.row_mean_probe(x)
    assert got.shape == (rows, 128) and got.dtype == torch.bfloat16
    want = x.double().numpy().mean(axis=1, keepdims=True)
    assert np.abs(got.double().numpy() - want).max() <= 2.0**-8 * np.abs(want).max() + 1e-8
    assert bool((got == got[:, :1]).all())


def test_cpu_wrappers_count_no_launches_and_check_nothing_on_cpu():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; a CUDA-only precondition (head dim a multiple of 4) is not
    asked of them."""
    before = (tfd.flash_decode_attention.launches, tfd.flash_decode_attention_q8.launches,
              tfd._packed_dma_probe.launches, tfd.row_mean_probe.launches)
    q, k = torch.randn(1, 1, 1, 6), torch.randn(1, 1, 4, 6)
    out = tfd.flash_decode_attention(q, k, k, 3)
    ref = torch.softmax((q[0, 0] @ k[0, 0, :3].T) * 6**-0.5, dim=-1) @ k[0, 0, :3]
    torch.testing.assert_close(out[0, 0], ref, rtol=1e-5, atol=1e-6)
    tfd.row_mean_probe(torch.zeros((2, 8), dtype=torch.bfloat16))
    assert before == (tfd.flash_decode_attention.launches, tfd.flash_decode_attention_q8.launches,
                      tfd._packed_dma_probe.launches, tfd.row_mean_probe.launches)


CFG = dict(dim=32, n_layers=2, n_heads=4, vocab_size=64, multiple_of=16, qk_normalization=True)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_llama_decode_step_flash_route(kind, monkeypatch):
    """Prefill (6 tokens, 3 rows, a per-row ``key_mask``) and one decode step
    over a 2048-slot ``KVCache`` / ``QuantKVCache`` in both packages with
    ``USE_FLASH_DECODE`` forced (JAX's auto rule needs a single device; the
    test process has 8 host devices): the step's attention takes the
    flash-decode kernels (JAX in interpret mode, the port's plain versions).
    Decode-step logits within 1e-4 at f32; within 2e-2 on the int8 cache,
    where the prefill wrote payloads that may differ by one quantization
    level and the prefill's attention dequantizes to bf16 in both."""
    monkeypatch.setattr(jl, "USE_FLASH_DECODE", True)
    monkeypatch.setattr(tl, "USE_FLASH_DECODE", True)
    jcfg, tcfg = jl.LlamaConfig(**CFG), tl.LlamaConfig(**CFG)
    params = jl.init_llama_params(jax.random.PRNGKey(2), jcfg)
    tparams = bridge.load_llama(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(9)
    t_max, lp = 2048, 6
    tokens = rng.integers(0, 64, (1, lp)).astype(np.int32).repeat(3, axis=0)
    km = np.zeros((3, t_max), bool)
    km[0, : lp + 1] = True
    km[1, [0, 2, 3, lp]] = True
    km[2, [0, lp]] = True
    positions = np.maximum(np.cumsum(km[:, :lp], axis=1) - 1, 0).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if kind == "f32" else (jnp.int8, torch.int8)
    jcache = jkv.KVCache.zeros(2, 3, 4, t_max, 8, dtype=jdt)
    tcache = tkv.KVCache.zeros(2, 3, 4, t_max, 8, tdt)
    _, jcache = jl.llama_forward(params, jcfg, jnp.asarray(tokens), jcache, 0, jnp.asarray(positions),
                                 key_mask=jnp.asarray(km))
    _, tcache = tl.llama_forward(tparams, tcfg, torch.as_tensor(tokens, dtype=torch.int64), tcache, 0,
                                 torch.as_tensor(positions), key_mask=torch.as_tensor(km))
    nxt = np.full((3, 1), 17, np.int32)
    pos = km[:, :lp].sum(axis=1, keepdims=True).astype(np.int32)
    calls = []
    for name in ("flash_decode_attention", "flash_decode_attention_q8"):
        real = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _real=real, _name=name, **kw: (calls.append(_name), _real(*a, **kw))[1])
    want, _ = jl.llama_forward(params, jcfg, jnp.asarray(nxt), jcache, lp, jnp.asarray(pos), key_mask=jnp.asarray(km))
    got, _ = tl.llama_forward(tparams, tcfg, torch.as_tensor(nxt, dtype=torch.int64), tcache, torch.tensor(lp),
                              torch.as_tensor(pos), key_mask=torch.as_tensor(km))
    assert calls == ["flash_decode_attention" if kind == "f32" else "flash_decode_attention_q8"] * 2
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]), atol=1e-4 if kind == "f32" else 2e-2, rtol=0)
    assert np.abs(got[0, 0].numpy() - got[2, 0].numpy()).max() > 1e-3  # the rows do see different contexts


def test_flash_route_auto_rule():
    """``USE_FLASH_DECODE = None``: the kernels from 2048 slots on, the plain
    attention below; True / False force."""
    assert tl.USE_FLASH_DECODE is None and tl.FLASH_DECODE_MIN_CACHE == jl.FLASH_DECODE_MIN_CACHE == 2048
    assert not tl._flash_enabled(2047) and tl._flash_enabled(2048) and tl._flash_enabled(4096)


SPLIT_MASKS = ["none", "start", "key_mask", "both", "short", "masked_split"]


def _split_case(rng, b, t, tile, splits, masks):
    """``(valid_len, start, key_mask)`` of one mask case of the split tests:
    ``short`` has fewer valid slots than splits, ``masked_split`` masks
    every slot of the second share (or of the second tile when there is one
    share)."""
    valid_len = 2 if masks == "short" else t - 13
    starts, km = _masks(rng, b, t, valid_len, masks in ("start", "both"), masks in ("key_mask", "both", "masked_split"))
    if masks == "masked_split":
        n_tiles = -(-valid_len // tile)
        per = -(-n_tiles // splits) if splits > 1 else 1
        km[:, per * tile: 2 * per * tile] = False
        assert km[:, :valid_len].any(axis=1).all() and not km[:, per * tile: min(2 * per * tile, valid_len)].any()
    return valid_len, starts, km


@pytest.mark.parametrize("masks", SPLIT_MASKS)
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_split_plain_matches_plain(kind, splits, masks):
    """The split arithmetic of kernels #5 and #6 (per-share ``(max, sum,
    acc)``, merged in split order, empty shares included) against the plain
    versions that CPU tensors take: within 1e-6 of the largest output at
    f32, for 1, 2, 3 and 8 shares."""
    rng = np.random.default_rng(31 * splits + SPLIT_MASKS.index(masks))
    b, h, t, d = 3, 2, 200, 16
    q = _t(rng.standard_normal((b, h, 1, d)).astype(np.float32))
    if kind == "f32":
        k, v = (_t(rng.standard_normal((b, h, t, d)).astype(np.float32)) for _ in range(2))
        scales = ()
    else:
        k, v = (_t(rng.integers(-127, 128, (b, h, t, d)).astype(np.int8)) for _ in range(2))
        scales = tuple(_t((rng.random((b, h, t)) * 0.02 + 0.001).astype(np.float32)).bfloat16() for _ in range(2))
    tile = tfd.flash_decode_tile(d, k.dtype)
    assert tile == 32
    valid_len, starts, km = _split_case(rng, b, t, tile, splits, masks)
    got = tfd.flash_decode_attention_split_plain(q, k, v, valid_len, _t(starts), _t(km), splits, *scales)
    if kind == "f32":
        want = tfd.flash_decode_attention_plain(q, k, v, valid_len, _t(starts), _t(km))
    else:
        want = tfd.flash_decode_attention_q8_plain(q, k, v, *scales, valid_len, _t(starts), _t(km))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max() <= 1e-6 * want.abs().max() + 1e-7


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("d,dtype,start,key_mask", [c for c in CASES if c[0] != 80])
def test_split_plain_matches_jax_kernel(d, dtype, start, key_mask, splits, kind):
    """The split arithmetic against JAX's kernels in interpret mode, as
    ``test_flash_decode_matches_jax_kernel`` and its q8 twin run them, at
    their tolerances, over a cache long enough to fill several shares."""
    rng = np.random.default_rng(200 + d + 7 * start + 13 * key_mask + splits)
    b, h, t, valid_len = 3, 2, 96, 70
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((b, h, 1, d), (b, h, t, d), (b, h, t, d)))
    starts, km = _masks(rng, b, t, valid_len, start, key_mask)
    jmasks = dict(start=None if starts is None else jnp.asarray(starts), key_mask=None if km is None else jnp.asarray(km))
    if kind == "float":
        want = jfd.flash_decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                          jnp.int32(valid_len), interpret=True, **jmasks)
        got = tfd.flash_decode_attention_split_plain(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), valid_len,
                                                     _t(starts), _t(km), splits)
    else:
        jcache = jkv.KVCache.zeros(2, b, h, t, d, dtype=jnp.int8).write(1, 0, jnp.asarray(k), jnp.asarray(v))
        tcache = bridge.quant_cache(*(np.asarray(x) for x in (jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)))
        want = jfd.flash_decode_attention_q8(jnp.asarray(q, jdt), jcache.k[1], jcache.v[1], jcache.k_scale[1],
                                             jcache.v_scale[1], jnp.int32(valid_len), interpret=True, **jmasks)
        got = tfd.flash_decode_attention_split_plain(_t(q).to(tdt), tcache.k[1], tcache.v[1], valid_len, _t(starts),
                                                     _t(km), splits, tcache.k_scale[1], tcache.v_scale[1])
    assert got.dtype == tdt
    _close(got, np.asarray(want, np.float32), dtype == "bf16")


@pytest.mark.parametrize("b,h,t,want", [
    (3, 32, 4096, 4),      # the interleaved Chameleon rows: 96 (row, head)s on 132 SMs, 384 blocks
    (3, 32, 2252, 4),      # the entry point's two-image cache
    (16, 16, 4096, 1),
    (128, 16, 258, 1),     # RAR-XL: 2048 (row, head)s fill the card by themselves
    (24, 32, 1043, 1),
    (5, 3, 40, 1),         # a cache shorter than one share
    (5, 3, 2100, 8),
    (1, 1, 4096, 8),
    (1, 1, 300, 2),
])
def test_flash_decode_splits_planner(b, h, t, want):
    """The split count is a function of the shapes and the SM count only,
    at least 1, 1 where ``b * h`` alone gives every SM three blocks, never
    above 8 (the kernel takes up to 16), never more than one share per 128
    cache slots, and never a grid of more blocks than the card holds at
    once."""
    s = tfd.flash_decode_splits(b, h, t, 132)
    assert s == want and 1 <= s <= 8 <= tfd._FLASH_MAX_SPLITS
    assert s == 1 or (s * b * h <= 3 * 132 and s * tfd._FLASH_MIN_SHARE <= t)
    assert tfd.flash_decode_splits(b + 2, h, t, 1) == 1  # three (row, head)s fill a card of one SM
    assert tfd.flash_decode_splits(b, h, t, 132) == s  # nothing but its arguments decides


@pytest.mark.parametrize("d,dtype,tile,load", [
    (128, torch.bfloat16, 16, 16), (128, torch.int8, 32, 16), (128, torch.float32, 8, 16),
    (80, torch.bfloat16, 16, 16), (104, torch.bfloat16, 16, 16), (80, torch.int8, 32, 16),
    (104, torch.int8, 16, 8), (20, torch.int8, 32, 4), (20, torch.bfloat16, 32, 8), (8, torch.float32, 32, 16),
])
def test_flash_decode_tile_and_load(d, dtype, tile, load):
    """The tile (the unit of the split and of the softmax) and the bytes of
    one lane's load, as the kernel derives them from the head dim and the
    payload type: 16-byte loads wherever a slot is a multiple of 16 bytes."""
    assert tfd._flash_load_bytes(d, dtype) == load
    assert tfd.flash_decode_tile(d, dtype) == tile
