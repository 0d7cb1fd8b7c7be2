"""Port parity, tensor-parallel packed caches and the sharded decode attention.

The packed caches' grouped lane order (``tp_groups``) is held against JAX's
``PackedQuantKVCache`` / ``Packed4QuantKVCache`` built on a mesh of the
conftest's 8 host devices, and the port's per-rank attention
(``sharded_packed_decode_attention``, plain versions on the CPU) against
JAX's ``shard_map`` wrapper with its Pallas kernels in interpret mode, on a
(2, 2) grid whose four ranks the port views one at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.ops import flash_decode as jfd
from wmar_tpu.parallel import make_mesh as jax_mesh
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import attention as tattn
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.ops import flash_decode as tfd
from wmar_tpu_torch.parallel import P, apply_specs, kvcache_tp_specs, make_mesh

L, B, H, D = 2, 4, 8, 16
KINDS = {"packed": (jkv.PackedQuantKVCache, tkv.PackedQuantKVCache),
         "packed4": (jkv.Packed4QuantKVCache, tkv.Packed4QuantKVCache)}


def _bits(x) -> np.ndarray:
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _writes(seed, t_burst=3, singles=4, h=H):
    rng = np.random.default_rng(seed)
    out = [(0, rng.standard_normal((B, h, t_burst, D)).astype(np.float32),
            rng.standard_normal((B, h, t_burst, D)).astype(np.float32))]
    for pos in range(t_burst, t_burst + singles):
        out.append((pos, 3 * rng.standard_normal((B, h, 1, D)).astype(np.float32),
                    rng.standard_normal((B, h, 1, D)).astype(np.float32)))
    return out


def _fill(cache, writes, as_jax: bool):
    for pos, k, v in writes:
        for li in range(L):
            if as_jax:
                cache = cache.write(li, pos, jnp.asarray(k), jnp.asarray(v))
            else:
                cache = cache.write(li, torch.tensor(pos), torch.as_tensor(k), torch.as_tensor(v))
    return cache


def _levels(kind, x: np.ndarray) -> np.ndarray:
    """The stored quantization levels: int8 as is, the two nibbles of int4."""
    x = np.asarray(x)
    if kind == "packed4":
        return np.stack([x & 0xF, x >> 4]).astype(np.int16)
    return x.astype(np.int16)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("g", [2, 4])
def test_grouped_cache_matches_jax(kind, g):
    """A ``tp_groups=g`` cache after a burst and single writes: scale rows
    equal JAX's (grouped alike), payload levels within the known one-level
    quantisation bound (ROADMAP section 3: at most one level, on at most 1%
    of values), and ``layer()`` equal to JAX's within one level's value."""
    jcls, tcls = KINDS[kind]
    jc = jcls.zeros(L, B, H, 16, D, mesh=jax_mesh(dp=8 // g, tp=g), tp_axis="tp")
    assert jc.tp_groups == g
    tc = tcls.zeros(L, B, H, 16, D, tp_groups=g)
    writes = _writes(seed=g)
    jc, tc = _fill(jc, writes, True), _fill(tc, writes, False)
    np.testing.assert_array_equal(_bits(tc.scale), _bits(jc.scale))
    diff = np.abs(_levels(kind, _bits(tc.kv)) - _levels(kind, np.asarray(jc.kv)))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    for li in range(L):
        for got, want in zip(tc.layer(li), jc.layer(li)):
            step = np.asarray(jnp.abs(want).max()) / (7 if kind == "packed4" else 127)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                       atol=1.01 * step + 1e-6, rtol=0)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("g", [2, 4])
def test_lane_group_is_plain_cache_of_its_heads(kind, g):
    """Lane group i of a grouped cache is, byte for byte, the plain packed
    cache of heads ``[i*H/g, (i+1)*H/g)``; and the grouped cache dequantizes
    to the plain one of all heads bit for bit."""
    _, tcls = KINDS[kind]
    writes = _writes(seed=10 + g)
    grouped = _fill(tcls.zeros(L, B, H, 16, D, tp_groups=g), writes, False)
    plain = _fill(tcls.zeros(L, B, H, 16, D), writes, False)
    hl = H // g
    lanes = grouped.kv.shape[-1] // g
    for i in range(g):
        heads = [(pos, k[:, i * hl:(i + 1) * hl], v[:, i * hl:(i + 1) * hl]) for pos, k, v in writes]
        local = _fill(tcls.zeros(L, B, hl, 16, D), heads, False)
        assert torch.equal(grouped.kv[..., i * lanes:(i + 1) * lanes], local.kv)
        assert torch.equal(grouped.scale[:, :, i * 2 * hl:(i + 1) * 2 * hl], local.scale)
    for li in range(L):
        for got, want in zip(grouped.layer(li), plain.layer(li)):
            assert torch.equal(got, want)


def _rank_views(dp, tp):
    return [make_mesh(dp=dp, tp=tp, rank=r) for r in range(dp * tp)]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("t", [32, 1024], ids=["short", "chunked"])
def test_sharded_attention_matches_jax(kind, t, monkeypatch):
    """On a (2, 2) grid: each rank's shard of a ``tp_groups=2`` cache (its
    rows and lane group, cut by ``apply_specs``) through the port's dispatch,
    put together, equals the plain version over the whole cache at f32 to
    1e-5, and JAX's ``sharded_packed_decode_attention`` on the same bytes at
    2e-2 (JAX's interpret-mode kernels round q and p to bf16 in their dots,
    the bound of every packed-kernel parity test); from 1024 slots with
    ``start`` and ``key_mask`` (kernels #3/#4's route), below without
    (#1/#2's). Every call goes through the sharded entry point."""
    jcls, _ = KINDS[kind]
    mesh = jax_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    jc = jcls.zeros(L, B, H, t, D, mesh=mesh, dp_axis="dp", tp_axis="tp")
    jc = _fill(jc, _writes(seed=20, t_burst=5, singles=5), True)
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    start = km = None
    if t >= 1024:
        start = np.asarray([0, 2, 1, 3], np.int32)
        km = rng.integers(0, 2, (B, t)).astype(bool)
        km[:, 3:4] = True
    want = jfd.sharded_packed_decode_attention(
        jnp.asarray(q), jc, 1, 10, start=None if start is None else jnp.asarray(start),
        key_mask=None if km is None else jnp.asarray(km), interpret=True)

    calls = []
    real = tfd.sharded_packed_decode_attention
    monkeypatch.setattr(tfd, "sharded_packed_decode_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    loader = bridge.packed4_cache if kind == "packed4" else bridge.packed_cache
    whole = loader(np.asarray(jc.kv), np.asarray(jc.scale), D, tp_groups=2)
    spec = whole.replace(kv=P(None, "dp", None, "tp"), scale=P(None, "dp", "tp", None))
    got = np.zeros_like(q)
    for view in _rank_views(2, 2):
        local = apply_specs(view, whole, spec)
        assert local.n_heads == H // 2 and local.kv.shape[1] == B // 2 and local.mesh is view
        rows = slice(view.axis_index("dp") * 2, view.axis_index("dp") * 2 + 2)
        heads = slice(view.axis_index("tp") * 4, view.axis_index("tp") * 4 + 4)
        out = tattn.cached_decode_attention(
            torch.as_tensor(q[rows, heads]).contiguous(), local, 1, 10,
            start=None if start is None else torch.as_tensor(start[rows]),
            key_mask=None if km is None else torch.as_tensor(km[rows]))
        got[rows, heads] = out.numpy()
    assert len(calls) == 4
    plain = tfd.packed4_decode_attention_plain if kind == "packed4" else tfd.packed_decode_attention_q8_plain
    flat = _ungrouped(whole)
    want_plain = plain(torch.as_tensor(q), flat.kv, flat.scale, 1, 10,
                       None if start is None else torch.as_tensor(start),
                       None if km is None else torch.as_tensor(km))
    np.testing.assert_allclose(got, want_plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-2, rtol=0)


def _ungrouped(cache):
    """The plain (``tp_groups=1``) layout of a grouped cache's bytes."""
    n, b, t, lanes = cache.kv.shape
    g, h, d = cache.tp_groups, cache.n_heads, cache.head_dim
    kv = cache.kv
    if isinstance(cache, tkv.PackedQuantKVCache):
        kv = kv.reshape(n, b, t, g, 2, h // g * d).transpose(3, 4).reshape(n, b, t, lanes)
    scale = cache.scale.reshape(n, b, g, 2, h // g, t).transpose(2, 3).reshape(n, b, 2 * h, t)
    return cache.replace(kv=kv.contiguous(), scale=scale.contiguous(), tp_groups=1)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_attention_refuses_ungrouped_lanes(kind):
    """A plain (``tp_groups=1``) cache cut over tp would hand a rank K of
    one head group and V of another: the sharded attention raises, as JAX's
    does."""
    _, tcls = KINDS[kind]
    whole = _fill(tcls.zeros(L, B, H, 32, D), _writes(seed=30), False)
    local = apply_specs(make_mesh(dp=1, tp=2, rank=1), whole, kvcache_tp_specs(whole))
    q = torch.randn((B, H // 2, 1, D))
    with pytest.raises(ValueError, match="tp_groups=1 != mesh tp=2"):
        tattn.cached_decode_attention(q, local, 0, 6)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_grouped_without_rank_context_takes_plain_path(kind, monkeypatch):
    """A grouped cache without a rank's context must not reach a kernel
    (it reads the plain layout): the dispatch takes the plain path over
    ``layer()``, equal to the plain cache's answer."""
    _, tcls = KINDS[kind]
    writes = _writes(seed=40)
    grouped = _fill(tcls.zeros(L, B, H, 32, D, tp_groups=4), writes, False)
    plain = _fill(tcls.zeros(L, B, H, 32, D), writes, False)

    def refuse(*a, **k):
        raise AssertionError("a grouped cache reached a kernel wrapper")

    q = torch.randn((B, H, 1, D), generator=torch.Generator().manual_seed(41))
    want = tattn.decode_attention(q, *plain.layer(0), 6)
    for name in ("packed4_decode_attention", "packed_decode_attention_q8", "sharded_packed_decode_attention"):
        monkeypatch.setattr(tfd, name, refuse)
    got = tattn.cached_decode_attention(q, grouped, 0, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, "packed", "packed4"],
                         ids=["bf16", "int8", "packed", "packed4"])
def test_cache_spec_builds_a_ranks_cache(dtype):
    """``KVCache.zeros`` with a ``CacheSpec`` on a tp rank holds that rank's
    heads; a packed one carries the rank's mesh and ``tp_groups`` (so the
    dispatch sends it to the sharded attention), and its bytes after a write
    equal its lane group of a grouped cache."""
    view = make_mesh(dp=1, tp=2, rank=1)
    cache = tkv.KVCache.zeros(L, B, H, 32, D, tkv.CacheSpec(dtype, view, None, "tp"))
    if dtype in ("packed", "packed4"):
        assert (cache.n_heads, cache.tp_groups, cache.mesh, cache.tp_axis) == (H // 2, 2, view, "tp")
        writes = _writes(seed=50)
        cache = _fill(cache, [(p, k[:, H // 2:], v[:, H // 2:]) for p, k, v in writes], False)
        grouped = _fill(tkv.KVCache.zeros(L, B, H, 32, D, dtype).replace(tp_groups=2), writes, False)
        assert torch.equal(cache.kv, grouped.kv.chunk(2, dim=-1)[1])
        assert torch.equal(cache.scale, grouped.scale.chunk(2, dim=2)[1])
    else:
        assert cache.k.shape[2] == H // 2
