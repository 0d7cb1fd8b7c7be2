"""Port parity, the split-over-K arithmetic of the tensor-core w4a16 kernel
(#8) in plain torch, and its planner.

On the card the kernel cuts K into chunks of 128, deals the chunks to ``S``
blocks, sums each group's float32 partial times its scale in group order
inside a block, and adds the blocks' sums in split order.
``matmul_w4_split_plain`` is that arithmetic on the CPU. It is held, at every
split count, to the one-pass plain version and to the JAX package's default
route ``wquant.matmul4_xla`` at 1e-5 of max|y| (float32 throughout: only the
order of the sums differs), and to the JAX Pallas kernel in interpret mode at
2^-7 of max|y| (that kernel rounds each w * s to bf16 before its dot; the
port does not). Inputs come from a numpy seed.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.ops import w4_matmul as jw4
from wmar_tpu.ops import wquant as jwq
from wmar_tpu_torch.bridge import to_tensor
from wmar_tpu_torch.ops import w4_matmul as tw4

K, N = 384, 128  # three chunks of 128 (three groups of 128, six of 64, twelve of 32); one Pallas lane tile


def _weights(seed, k=K, n=N):
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("m", [1, 7, 33])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_split_plain_matches_plain_xla_and_pallas(m, group):
    """Every split count from 1 to the chunks: against ``matmul_w4_plain``
    and ``matmul4_xla`` (f32 x) within 1e-5 of max|y|, and against the Pallas
    kernel in interpret mode (bf16 x) within 2^-7 of max|y|."""
    rng = np.random.default_rng(m * 1000 + group)
    jq = jwq.quantize_matrix_int4(_weights(group), group=group)
    q4, s4 = to_tensor(np.asarray(jq["q4"])), to_tensor(np.asarray(jq["s4"]))
    x = rng.standard_normal((m, K)).astype(np.float32)
    plain = tw4.matmul_w4_plain(torch.as_tensor(x), q4, s4)
    xla = np.asarray(jwq.matmul4_xla(jnp.asarray(x), jq))
    xb = jnp.asarray(x, jnp.bfloat16)
    pallas = np.asarray(jw4._matmul_w4_2d(xb, jq["q4"], jq["s4"], interpret=True), np.float32)
    xbt = torch.as_tensor(np.asarray(xb, np.float32))
    for splits in range(1, K // 128 + 1):
        got = tw4.matmul_w4_split_plain(torch.as_tensor(x), q4, s4, splits)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, N)
        scale = np.abs(xla).max()
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5 * scale, rtol=0, err_msg=f"S={splits}")
        np.testing.assert_allclose(got.numpy(), xla, atol=1e-5 * scale, rtol=0, err_msg=f"S={splits}")
        got_b = tw4.matmul_w4_split_plain(xbt, q4, s4, splits)
        np.testing.assert_allclose(got_b.numpy(), pallas, atol=2.0**-7 * np.abs(pallas).max(), rtol=0,
                                   err_msg=f"S={splits}")


def test_split_plain_ragged_chunk_and_leading_dims():
    """A K that is no multiple of 128 (the last chunk part empty) and
    leading dimensions: every split count against the plain version; a split
    count outside [1, chunks] raises."""
    k = 352  # 11 groups of 32: chunks of 4, 4 and 3 groups
    rng = np.random.default_rng(5)
    jq = jwq.quantize_matrix_int4(_weights(5, k, 24), group=32)
    q4, s4 = to_tensor(np.asarray(jq["q4"])), to_tensor(np.asarray(jq["s4"]))
    x = torch.as_tensor(rng.standard_normal((2, 3, k)).astype(np.float32))
    want = tw4.matmul_w4_plain(x, q4, s4)
    for splits in (1, 2, 3):
        got = tw4.matmul_w4_split_plain(x, q4, s4, splits)
        assert tuple(got.shape) == (2, 3, 24)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    for bad in (0, 4):
        with pytest.raises(ValueError, match="splits"):
            tw4.matmul_w4_split_plain(x, q4, s4, bad)


# (M, K, N) of the timed products: Taming-1.4B's four at 32 rows, Chameleon-7B's FFN at 24
PLANS = [((32, 1664, 1664), 8), ((32, 1664, 6656), 4), ((32, 6656, 1664), 8), ((32, 1664, 16384), 1),
         ((24, 4096, 11008), 4)]


@pytest.mark.parametrize("shape,want", PLANS)
def test_w4_splits_at_the_timed_shapes(shape, want):
    """``w4_splits`` on the H100's 132 SMs: 1 where the output tiles nearly
    cover the SMs, else a power of two that keeps the grid within three
    blocks an SM, never more than the chunks of 128 k or 8 (the blocks of a
    column tile are one cluster), the same for every group size; it reads
    the shapes and the SM count only, so a captured launch stays right."""
    m, k, n = shape
    assert list(inspect.signature(tw4.w4_splits).parameters) == ["m", "n", "k", "group", "sm_count"]
    got = {tw4.w4_splits(m, n, k, group, 132) for group in (128, 64, 32)}
    assert got == {want}
    tiles = -(-n // 128) * -(-m // 32)
    most = min(-(-k // 128), 8)
    assert 1 <= want <= most and want * tiles <= 3 * 132 and (want == 1) == (10 * tiles >= 9 * 132)
    for sms in (1, 78, 132):
        assert 1 <= tw4.w4_splits(m, n, k, 128, sms) <= most
    assert tw4.w4_splits(1, 16, 4096, 128, 132) == 8  # one tile: as many splits as a cluster holds
    assert tw4.w4_splits(456, 4096, 4096, 128, 132) == 1  # 15 x 32 tiles fill the card alone


def test_w4_routes_and_cpu_tensors():
    """The route: bf16 x with N a multiple of 8 on the tensor cores, f32 x
    and any other N on the CUDA cores; the private launcher refuses CPU
    tensors (only the public wrapper takes the plain version there), and
    the wrapper counts nothing on the CPU."""
    w = torch.zeros((2, 64, 16), dtype=torch.uint8)
    bf = torch.zeros((3, 256), dtype=torch.bfloat16)
    assert tw4._tensor_cores(bf, 16) and not tw4._tensor_cores(bf.float(), 16) and not tw4._tensor_cores(bf, 12)
    s = torch.ones((2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tw4._launch(bf, w, s, splits=1)
    before = tw4.matmul_w4.launches
    out = tw4.matmul_w4(bf, w, s)
    assert out.shape == (3, 16) and tw4.matmul_w4.launches == before
