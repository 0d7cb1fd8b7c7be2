"""Port parity, grouped-int4 weights and the w4a16 matmul's plain version.

The same numpy-seeded weights and inputs go through the JAX package and the
port. Int4 payloads and scales must be bit-identical (both quantize in
float32 and round half to even); ``matmul_w4_plain`` must agree with the
JAX package's default route ``wquant.matmul4_xla`` at float32, and with its
Pallas kernel (``w4_matmul._matmul_w4_2d``, run in interpret mode by a
direct call, so no environment switch is needed) within the rounding that
kernel adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.ops import w4_matmul as jw4
from wmar_tpu.ops import wquant as jwq
from wmar_tpu_torch.bridge import to_tensor
from wmar_tpu_torch.ops import w4_matmul as tw4
from wmar_tpu_torch.ops import wquant as twq


def _np(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _t(x):
    x = x.detach()
    return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()


def _weights(seed, k, n):
    """Weights with the hard cases of the quantizer: an all-zero (group,
    column) cell (the 1e-12 scale floor) and values near a half step."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:32, 3] = 0.0
    w[:4, 5] = [0.7, 0.25, -0.35, 0.05]  # steps of 0.1: 2.5, -3.5 and 0.5 steps
    return w


def _port(tree, f32=False):
    """A JAX dict of arrays as tensors; ``f32`` casts bf16 leaves to float32."""
    out = {k: to_tensor(np.asarray(v)) for k, v in tree.items()}
    return {k: v.float() if f32 and v.dtype == torch.bfloat16 else v for k, v in out.items()}


def _jax_f32(tree):
    return {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v for k, v in tree.items()}


@pytest.mark.parametrize("group", [128, 64, 32])
def test_int4_payload_and_scales_bit_identical(group):
    """``quantize_matrix_int4`` and ``quantize_linear_int4``: uint8 payloads
    and bf16 scales equal to JAX's bit for bit."""
    w = _weights(group, 256, 40)
    b = np.random.default_rng(1).standard_normal(40).astype(np.float32)
    jq = jwq.quantize_matrix_int4(w, group=group)
    tq = twq.quantize_matrix_int4(torch.as_tensor(w), group=group)
    assert tq["q4"].dtype == torch.uint8 and tuple(tq["q4"].shape) == (256 // group, group // 2, 40)
    assert tq["s4"].dtype == torch.bfloat16 and tuple(tq["s4"].shape) == (256 // group, 40)
    for key in ("q4", "s4"):
        np.testing.assert_array_equal(_t(tq[key]), _np(jq[key]), err_msg=key)
    jl = jwq.quantize_linear_int4({"w": w, "b": jnp.asarray(b)}, compute_dtype=jnp.bfloat16, group=group)
    tl = twq.quantize_linear_int4({"w": torch.as_tensor(w), "b": torch.as_tensor(b)}, compute_dtype=torch.bfloat16,
                                  group=group)
    assert set(tl) == set(jl) == {"w_q4", "w_s4", "b"}
    for key in tl:
        np.testing.assert_array_equal(_t(tl[key]), _np(jl[key]), err_msg=key)
    with pytest.raises(ValueError):
        twq.quantize_matrix_int4(torch.as_tensor(w[:100]), group=group)


@pytest.mark.parametrize("n_in", [1664, 6656, 11008, 4096, 256, 192, 96, 48, 20])
def test_int4_group_for_and_fallback(n_in):
    """The largest group of 128, 64, 32 that divides ``n_in``, else int8;
    ``quantize_matrix`` and ``quantize_linear`` with ``bits=4`` then give the
    JAX package's leaves, int8 ones where no group divides."""
    assert twq._int4_group_for(n_in) == jwq._int4_group_for(n_in)
    if n_in > 2048:
        return
    w = _weights(n_in, n_in, 24)
    jm = jwq.quantize_matrix(w, bits=4)
    tm = twq.quantize_matrix(torch.as_tensor(w), bits=4)
    assert set(tm) == set(jm) == ({"q4", "s4"} if jwq._int4_group_for(n_in) else {"q", "s"})
    for key in tm:
        np.testing.assert_array_equal(_t(tm[key]), _np(jm[key]), err_msg=key)
    b = np.zeros(24, np.float32)
    jl = jwq.quantize_linear({"w": w, "b": b}, bits=4)
    tl = twq.quantize_linear({"w": torch.as_tensor(w), "b": torch.as_tensor(b)}, bits=4)
    assert set(tl) == set(jl)
    for key in tl:
        np.testing.assert_array_equal(_t(tl[key]), _np(jl[key]), err_msg=key)


def test_unpack_int4_equal():
    """Every byte value: low nibbles are rows [0, G/2), high [G/2, G)."""
    q4 = np.random.default_rng(2).integers(0, 256, (3, 16, 10)).astype(np.uint8)
    q4[0, 0, :] = [0, 1, 15, 16, 0x88, 0xF0, 0x0F, 0xFF, 0x80, 0x08]
    got = tw4.unpack_int4(torch.as_tensor(q4))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 32, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwq.unpack_int4(jnp.asarray(q4))))
    assert twq.unpack_int4 is tw4.unpack_int4


@pytest.mark.parametrize("m,k,n,group", [(5, 256, 128, 128), (32, 1664, 96, 128), (1, 384, 40, 64),
                                          (7, 96, 33, 32), (2, 512, 130, 64)])
def test_plain_matches_matmul4_xla_f32(m, k, n, group):
    """f32 x: ``matmul_w4_plain`` against ``matmul4_xla`` within 1e-5 of
    max|y| (float32 summation order only), leading dims kept."""
    rng = np.random.default_rng(m + k + n)
    jq = jwq.quantize_matrix_int4(_weights(k, k, n), group=group)
    tq = _port(jq)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    want = np.asarray(jwq.matmul4_xla(jnp.asarray(x), jq))
    got = tw4.matmul_w4_plain(torch.as_tensor(x), tq["q4"], tq["s4"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("m,k,n,group", [(5, 256, 128, 128), (12, 256, 256, 128), (3, 128, 384, 128),
                                          (9, 256, 128, 64), (4, 128, 256, 32)])
def test_plain_matches_pallas_kernel_interpret(m, k, n, group):
    """bf16 x: ``matmul_w4_plain`` (float32 products and scales) against the
    TPU kernel in interpret mode, within 2^-7 of max|y|: the TPU kernel
    rounds each ``w * s`` to bf16 (a relative 2^-9 per weight) before its
    float32-accumulated dot; the port's kernel and plain version do not."""
    rng = np.random.default_rng(k * n + group)
    jq = jwq.quantize_matrix_int4(_weights(group, k, n), group=group)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    want = np.asarray(jw4._matmul_w4_2d(x, jq["q4"], jq["s4"], interpret=True), np.float32)
    xt = torch.as_tensor(np.asarray(x, np.float32))
    q4, s4 = _port(jq).values()
    got = tw4.matmul_w4_plain(xt, q4, s4)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2.0**-7 * np.abs(want).max(), rtol=0)
    bf = tw4.matmul_w4_plain(xt.bfloat16(), q4, s4)  # the output in x's dtype
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), got.numpy(), atol=2.0**-8 * np.abs(want).max(), rtol=0)


def test_matmul_and_linear_dispatch():
    """``matmul`` on a bare matrix, ``{"q","s"}`` and ``{"q4","s4"}``;
    ``linear`` on ``{"w","b"}``, int8 and int4 dicts: the port against JAX at
    f32 (atol 1e-5 of max|y|). CPU tensors never count kernel launches."""
    rng = np.random.default_rng(3)
    w = _weights(3, 256, 48)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    before = tw4.matmul_w4.launches
    mats = [("bare", jnp.asarray(w), torch.as_tensor(w))]
    lins = [("float", {"w": jnp.asarray(w), "b": jnp.asarray(b)}, {"w": torch.as_tensor(w), "b": torch.as_tensor(b)})]
    for bits in (8, 4):
        jm = jwq.quantize_matrix(w, bits=bits)
        mats.append((f"int{bits}", _jax_f32(jm), _port(jm, f32=True)))
        jl = jwq.quantize_linear({"w": w, "b": b}, bits=bits)
        lins.append((f"int{bits}", _jax_f32(jl), _port(jl, f32=True)))
    assert set(mats[2][2]) == {"q4", "s4"} and set(lins[2][2]) == {"w_q4", "w_s4", "b"}
    for (label, jm, tm), (_, jl, tl) in zip(mats, lins):
        for want, got in ((jwq.matmul(jx, jm), twq.matmul(tx, tm)), (jwq.linear(jx, jl), twq.linear(tx, tl))):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0, err_msg=label)
    assert tw4.matmul_w4.launches == before


def test_linear_module_quantize_int4():
    """``Linear.quantize_int4`` keeps the JAX leaf names (``w_q4``, ``w_s4``,
    ``b``) and equals the dict function's output; a width no group divides
    falls back to int8 as JAX does."""
    w = _weights(4, 128, 16)
    lin = twq.Linear(128, 16)
    lin.w = torch.as_tensor(w)
    lin.quantize_int4(torch.bfloat16)
    assert set(dict(lin.named_buffers())) == {"w_q4", "w_s4", "b"} and lin.b.dtype == torch.bfloat16
    want = twq.quantize_linear_int4({"w": torch.as_tensor(w), "b": torch.zeros(16)})
    torch.testing.assert_close(lin.w_q4, want["w_q4"], rtol=0, atol=0)
    torch.testing.assert_close(lin.w_s4, want["w_s4"], rtol=0, atol=0)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 128)).astype(np.float32)).bfloat16()
    torch.testing.assert_close(lin(x), tw4.matmul_w4_plain(x, want["w_q4"], want["w_s4"]) + lin.b, rtol=0, atol=0)
    narrow = twq.Linear(48, 8)
    narrow.quantize(bits=4)
    assert set(narrow.params()) == {"w_q", "w_scale", "b"}
