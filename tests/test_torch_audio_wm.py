"""Port parity, audio watermark (``wmar_tpu_torch.audio.wm``) against
``wmar_tpu.audio.wm`` on the CPU.

Tolerances: window hashes, the hash bits behind the green masks and the
Gumbel uniforms, the green masks, the Maryland counts and every sampled
token are equal. The Gumbel scores ``-log1p(-u)`` agree within 3e-7
relative (two float32 ulps): XLA's float32 ``log1p`` is not correctly
rounded and differs from torch's by one ulp on about a tenth of the inputs,
so bit equality cannot hold there. The p-values are the port's float64
(``scipy``) ones: equal to the port's ``core.detect.pvalue_from_counts``
and to scipy's ``gammaincc`` within 1e-9 relative; JAX computes both in
float32 (``betainc``, ``gammaincc``), whose own error against the float64
value reaches ~1e-4 relative here, so the comparison with JAX is held at
5e-4 relative where JAX's value is a normal float32 (below, JAX underflows
and the port's value must lie below float32's range as well).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from wmar_tpu.audio import wm as jwm
from wmar_tpu.core import hashing as jhash
from wmar_tpu_torch.audio import wm as twm
from wmar_tpu_torch.core import hashing as thash
from wmar_tpu_torch.core.detect import pvalue_from_counts

JAX_F32_REL = 5e-4
F32_TINY = float(np.finfo(np.float32).tiny)


def _close_to_jax_f32(got, want):
    """Within JAX_F32_REL where JAX's float32 value is a normal number;
    below that JAX underflows (to 0 or a subnormal) and the port's float64
    value must lie below float32's range too."""
    normal = want >= F32_TINY
    np.testing.assert_allclose(got[normal], want[normal], rtol=JAX_F32_REL)
    assert (got[~normal] < F32_TINY).all(), (got[~normal], want[~normal])


@pytest.mark.parametrize("n", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_window_hash_bit_exact(n, seed):
    ctx = np.random.default_rng(n).integers(0, 32001, (5, n))
    got = twm.window_hash(torch.from_numpy(ctx), seed)
    want = np.asarray(jwm.window_hash(jnp.asarray(ctx, jnp.int32), seed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_bits_and_green_masks_bit_exact():
    rng = np.random.default_rng(1)
    hashes = rng.integers(-2**31, 2**31, 6).astype(np.int32)
    vocab = np.arange(2049)
    bits = thash.hash_key_token(torch.from_numpy(hashes)[:, None], torch.from_numpy(vocab), 3)
    want = np.asarray(jhash.hash_key_token(jnp.asarray(hashes)[:, None], jnp.asarray(vocab), 3))
    np.testing.assert_array_equal(bits.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(thash.uniform_from_hash(bits).numpy(), np.asarray(jhash.uniform_from_hash(want)))
    for gamma in (0.25, 0.5, 1.0):
        got = twm.maryland_green(torch.from_numpy(vocab), torch.from_numpy(hashes)[:, None], gamma, salt=3)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jwm.maryland_green(jnp.asarray(vocab), jnp.asarray(hashes)[:, None], gamma, 3)))


def test_gumbel_scores():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 2048, 4000)
    hashes = rng.integers(-2**31, 2**31, 4000).astype(np.int32)
    got = twm.gumbel_score(torch.from_numpy(tokens), torch.from_numpy(hashes)).numpy()
    want = np.asarray(jwm.gumbel_score(jnp.asarray(tokens), jnp.asarray(hashes)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (250, 0.0), (0, 0.9)])
def test_gumbel_sample_tokens_equal(top_k, top_p):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 2048)).astype(np.float32) * 2
    hashes = rng.integers(-2**31, 2**31, 6).astype(np.int32)
    got = twm.gumbel_sample(torch.from_numpy(logits), torch.from_numpy(hashes), temp=0.8, top_k=top_k, top_p=top_p)
    want = jwm.gumbel_sample(jnp.asarray(logits), jnp.asarray(hashes), temp=0.8, top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["maryland", "none"])
def test_sampling_with_jax_noise(method):
    """``jax.random.categorical`` is ``argmax(logits + gumbel(key))``: fed
    that noise, the port draws JAX's tokens, watermarked or not."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((8, 512)).astype(np.float32)
    hashes = np.full((8,), 5, np.int32)
    for i in range(4):
        key = jax.random.PRNGKey(i)
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        kw = dict(temp=0.8, top_k=250, gamma=0.25, delta=4.0)
        want = jwm.wm_sample_token(jnp.asarray(logits), method, window_hashes=jnp.asarray(hashes), rng=key, **kw)
        got = twm.wm_sample_token(torch.from_numpy(logits), method, window_hashes=torch.from_numpy(hashes),
                                  noise=torch.from_numpy(noise), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = twm.maryland_sample(torch.from_numpy(logits), torch.from_numpy(hashes), use_sampling=False,
                                 gamma=0.25, delta=4.0)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jwm.maryland_sample(
        jnp.asarray(logits), jnp.asarray(hashes), use_sampling=False, gamma=0.25, delta=4.0)))


def test_maryland_scoring_and_pvalues():
    rng = np.random.default_rng(5)
    for t in (1, 16, 64):
        tokens = rng.integers(0, 12, t)  # repeats, so the first-occurrence dedup matters
        hashes = np.where(rng.random(t) < 0.5, 0, 7).astype(np.int32)
        ng, ns = twm.score_stream_maryland(torch.from_numpy(tokens), torch.from_numpy(hashes), 0.25)
        jng, jns = jwm.score_stream_maryland(jnp.asarray(tokens), jnp.asarray(hashes), 0.25)
        assert (int(ng), int(ns)) == (int(jng), int(jns))
    k = np.array([0, 1, 5, 17, 40, 60, 64])
    n = np.array([10, 64, 64, 64, 64, 64, 64])
    got = np.asarray(twm.pvalue_maryland(torch.from_numpy(k), torch.from_numpy(n), 0.25))
    np.testing.assert_allclose(got, pvalue_from_counts(torch.from_numpy(k), torch.from_numpy(n), 0.25),
                               rtol=1e-9)
    ref = np.where(k > 0, scipy.special.betainc(np.maximum(k, 1), 1 + n - k, 0.25), 1.0)
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    _close_to_jax_f32(got, np.asarray(jwm.pvalue_maryland(jnp.asarray(k), jnp.asarray(n), 0.25), np.float64))


def test_gumbel_pvalues():
    rng = np.random.default_rng(6)
    n = np.array([4, 16, 64, 64, 64, 65, 128], np.int32)
    s = (n + rng.standard_normal(n.shape) * 2 * np.sqrt(n)).astype(np.float32)
    got = np.asarray(twm.pvalue_gumbel(torch.from_numpy(s), torch.from_numpy(n)))
    np.testing.assert_allclose(got, scipy.special.gammaincc(n.astype(np.float64), s.astype(np.float64)), rtol=1e-9)
    _close_to_jax_f32(got, np.asarray(jwm.pvalue_gumbel(jnp.asarray(s), jnp.asarray(n)), np.float64))
