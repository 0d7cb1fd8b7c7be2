"""Port parity, the split-over-T arithmetic of the chunked packed decode
kernels (#3 int8, #4 int4) in plain torch, and their planner.

On the card the kernels cut a row's slots ``[start_b, valid_len)`` into tiles,
deal the tiles to ``S`` blocks and merge the blocks' ``(max, sum, acc)`` in
split order. ``packed_decode_attention_split_plain`` is that arithmetic on
the CPU. It is held to the one-pass plain versions at 1e-5 of the largest
output (float32 throughout: the two differ in summation order and in where
exp is taken) and to the JAX package's chunked Pallas kernels in interpret
mode at atol 2e-2 (the TPU kernels round q and p to bf16 for their dots).
Inputs come from a numpy seed; every masked row keeps a slot that takes
part, the kernels' precondition.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.ops import flash_decode as jfd
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.ops import flash_decode as tfd

B, H, T = 3, 2, 1100
SPLITS = [1, 2, 3, 4, 8]
PLAIN = {"packed": tfd.packed_decode_attention_q8_plain, "packed4": tfd.packed4_decode_attention_plain}


def _filled(kind, d, fill, seed, jax_too=False, t=T):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, H, fill, d)).astype(np.float32)
    v = rng.standard_normal((B, H, fill, d)).astype(np.float32)
    tc = tkv.KVCache.zeros(1, B, H, t, d, dtype=kind).write(0, 0, torch.as_tensor(k), torch.as_tensor(v))
    q = rng.standard_normal((B, H, 1, d)).astype(np.float32)
    start = np.array([0, 130, 37], np.int32)  # row 1 blanks its first 128 slots
    km = rng.random((B, t)) < 0.6
    km[np.arange(B), start] = True
    jc = None
    if jax_too:
        jc = jkv.KVCache.zeros(1, B, H, t, d, dtype=kind).write(0, 0, jnp.asarray(k), jnp.asarray(v))
    return tc, jc, q, start, km


def _mask_variants(start, km):
    return {"none": (None, None), "start": (start, None), "key_mask": (None, km), "both": (start, km)}


@pytest.mark.parametrize("kind", ["packed", "packed4"])
@pytest.mark.parametrize("d", [20, 80, 104, 128, 256])
@pytest.mark.parametrize("splits", SPLITS)
def test_packed_split_plain_matches_plain(kind, d, splits):
    """The split arithmetic against the one-pass plain version for both
    payloads, every mask variant and ``valid_len`` 1, 128, 129 (shares come
    out empty), 600 and 1043: within 1e-5 of the largest output."""
    tc, _, q, start, km = _filled(kind, d, 1043, seed=d + splits)
    tq = torch.as_tensor(q)
    for n in (1, 128, 129, 600, 1043):
        st = np.minimum(start, n - 1)
        mask = km.copy()
        mask[np.arange(B), st] = True
        for name, (s_, m_) in _mask_variants(st, mask).items():
            s_t = None if s_ is None else torch.as_tensor(s_)
            m_t = None if m_ is None else torch.as_tensor(m_)
            want = PLAIN[kind](tq, tc.kv, tc.scale, 0, n, s_t, m_t)
            got = tfd.packed_decode_attention_split_plain(tq, tc.kv, tc.scale, 0, n, s_t, m_t, splits,
                                                          int4=kind == "packed4")
            assert got.shape == (B, H, 1, d) and got.dtype == torch.float32
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item() + 1e-6, (n, name, err)


@pytest.mark.parametrize("kind", ["packed", "packed4"])
@pytest.mark.parametrize("splits", SPLITS)
def test_packed_split_plain_vs_jax_chunked_kernel(kind, splits):
    """The split arithmetic against JAX's chunked kernels in interpret mode
    (T = 1024, ``chunk_t`` = 128), every mask variant, at a fill that spans
    chunks and at one that leaves most shares empty: atol 2e-2."""
    tc, jc, q, start, km = _filled(kind, 16, 300, seed=70 + splits, jax_too=True, t=1024)
    jfn = jfd.packed_decode_attention_q8 if kind == "packed" else jfd.packed4_decode_attention
    for n in (300, 9):
        st = np.minimum(start, n - 1)
        mask = km.copy()
        mask[np.arange(B), st] = True
        for name, (s_, m_) in _mask_variants(st, mask).items():
            want = np.asarray(jfn(jnp.asarray(q), jc.kv, jc.scale, 0, n, chunk_t=128, interpret=True,
                                  start=None if s_ is None else jnp.asarray(s_),
                                  key_mask=None if m_ is None else jnp.asarray(m_)))
            got = tfd.packed_decode_attention_split_plain(
                torch.as_tensor(q), tc.kv, tc.scale, 0, n, None if s_ is None else torch.as_tensor(s_),
                None if m_ is None else torch.as_tensor(m_), splits, int4=kind == "packed4")
            np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0, err_msg=f"{n} {name}")


@pytest.mark.parametrize("d,t", [(80, 258), (104, 257)])
def test_packed4_split_plain_vs_jax_single_block_kernel(d, t):
    """Kernel #1's arithmetic on the card (the tiled kernel without masks:
    tiles of ``packed_decode_tile(d)`` slots, 30 at RAR-XL's D = 80 and 16 at
    Taming's D = 104, S = 1 as the planner gives at both main-path shapes,
    and S = 2) against JAX's single-block kernel ``_packed4_attn_kernel`` in
    interpret mode over a full and a part-filled cache: atol 2e-2, that
    kernel's bf16 dots."""
    tc, jc, q, _, _ = _filled("packed4", d, t, seed=d, jax_too=True, t=t)
    assert tfd.packed_decode_splits(128 if d == 80 else 32, 16, t, 132) == 1
    for n in (t, t // 2 + 1, 1):
        want = np.asarray(jfd.packed4_decode_attention(jnp.asarray(q), jc.kv, jc.scale, 0, n, interpret=True))
        for splits in (1, 2):
            got = tfd.packed_decode_attention_split_plain(torch.as_tensor(q), tc.kv, tc.scale, 0, n, None, None,
                                                          splits, int4=True)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0, err_msg=f"{n} S={splits}")


def test_packed_split_plain_row_without_a_slot_is_zero():
    """A row whose slots are all masked gets zeros, as on the card."""
    tc, _, q, _, km = _filled("packed4", 16, 200, seed=3)
    km[1] = False
    got = tfd.packed_decode_attention_split_plain(torch.as_tensor(q), tc.kv, tc.scale, 0, 200, None,
                                                  torch.as_tensor(km), 3, int4=True)
    assert bool((got[1] == 0).all()) and bool(torch.isfinite(got).all()) and bool((got[0] != 0).any())


@pytest.mark.parametrize("d,tile", [(16, 32), (20, 30), (40, 30), (80, 30), (88, 16), (104, 16), (128, 32),
                                    (256, 16), (132, 0), (252, 0)])
def test_packed_decode_tile(d, tile):
    """Slots of a tile: 8 passes of a warp whose lanes of a slot are the next
    power of two above d / (16, 8 or 4 bytes a load), at least 8; a slot of
    five loads (20, 40, 80) five passes of six groups of five lanes; 0 where
    a slot does not fit a warp (those head dims keep the slot-by-slot
    kernel)."""
    assert tfd.packed_decode_tile(d) == tile
    assert tfd._packed_load_bytes(d) == (16 if d % 16 == 0 else 8 if d % 8 == 0 else 4)


def test_packed_planner_is_a_function_of_the_shapes_only():
    """``packed_decode_splits`` at the two main-path shapes on the H100's 132
    SMs: 1 or 2 at 24 rows x 32 heads over 1043 slots (the rows alone fill
    the card), 4 or more at 3 rows x 32 heads over 4096; never above the
    kernel's limit, never below 1, one split per 128 slots at most; and the
    fill is no argument of it, so a captured launch stays right."""
    assert list(inspect.signature(tfd.packed_decode_splits).parameters) == ["b", "h", "t", "sm_count"]
    assert tfd.packed_decode_splits(24, 32, 1043, 132) in (1, 2)
    assert 4 <= tfd.packed_decode_splits(3, 32, 4096, 132) <= tfd._PACKED_MAX_SPLITS
    assert tfd.packed_decode_splits(1, 1, 1 << 20, 132) == tfd._PACKED_MAX_SPLITS
    assert tfd.packed_decode_splits(1, 1, 1024, 132) == 8
    assert tfd.packed_decode_splits(512, 64, 4096, 132) == 1
    assert tfd.packed_decode_splits(3, 32, 100, 132) == 1
    for sms in (1, 80, 132):
        for b, h, t in ((1, 1, 1024), (3, 32, 4096), (24, 32, 1043), (128, 16, 2048)):
            assert 1 <= tfd.packed_decode_splits(b, h, t, sms) <= min(tfd._PACKED_MAX_SPLITS, max(1, t // 128))


def test_packed_launcher_takes_no_cpu_tensor():
    """The launcher of kernels #3/#4 raises on CPU tensors (only the public
    wrappers take the plain version there), and the wrappers count nothing
    on the CPU."""
    tc, _, q, _, _ = _filled("packed4", 16, 50, seed=4)
    before = tfd.packed4_decode_attention_chunked.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfd._launch_packed(torch.as_tensor(q), tc.kv, tc.scale, 0, 50, None, None, True, splits=2)
    out = tfd.packed4_decode_attention_chunked(torch.as_tensor(q), tc.kv, tc.scale, 0, 50)
    assert out.shape == (B, H, 1, 16) and tfd.packed4_decode_attention_chunked.launches == before
