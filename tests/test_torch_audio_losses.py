"""Port parity, the Mimi RCC finetune's loss bank
(``wmar_tpu_torch.audio.losses``) and the straight-through MP3
(``wmar_tpu_torch.audio.augmentations.mp3_compression_st``) against
``wmar_tpu.audio`` on the CPU.

Tolerances: every loss of ``get_audio_loss`` within 1e-5 relative, on a
64-sample clip (every STFT pad longer than the clip, so numpy's reflect
rule folds it again) and a 0.1 s one; gradients against ``jax.grad``
within 1e-4 of the largest. The STFT losses' log-magnitude L1 is ill
conditioned in float32 (each package's gradient sits 4e-5 to 1.2e-4 from a
float64 one at the clip's edges), so their gradients are compared in
float64 (JAX with ``jax_enable_x64``); the others in float32. Inputs are
noisy copies, away from the L1 kinks. The constant tables (mel filterbank,
band-split kernels, K-weighting) are JAX's bit for bit. MP3: the forward
is the host codec's bytes, the backward the identity; it skips where this
host's ``libmp3lame`` does not load.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.audio import augmentations as jaugs
from wmar_tpu.audio import finetune as jft
from wmar_tpu.audio import losses as jl
from wmar_tpu_torch.audio import augmentations as taugs
from wmar_tpu_torch.audio import finetune as tft
from wmar_tpu_torch.audio import losses as tl

torch.set_num_threads(1)
NAMES = ["mse", "l1", "sisnr", "multi_mel", "stft", "mrstft", "tf_loudness"]
LENGTHS = [64, 2400]


def _pair(t: int, seed: int = 0, dtype=np.float32):
    rng = np.random.default_rng(seed + t)
    x = rng.standard_normal((2, t, 1)) * 0.3
    return x.astype(dtype), (x + rng.standard_normal((2, t, 1)) * 0.05).astype(dtype)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_value_and_grad(name, x, y):
    jf = jl.get_audio_loss(name, 24000)
    v, g = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x), jnp.asarray(y))
    return float(v), np.asarray(g)


def _port_value_and_grad(name, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    v = tl.get_audio_loss(name, 24000)(xt, torch.from_numpy(y))
    v.backward()
    return float(v.detach()), xt.grad.numpy()


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("name", NAMES)
def test_loss_values_and_gradients(name, t):
    """Values within 1e-5 relative; the gradients here in float32, except
    the STFT losses' (:func:`test_stft_gradients_f64`)."""
    x, y = _pair(t)
    want, want_g = _jax_value_and_grad(name, x, y)
    got, got_g = _port_value_and_grad(name, x, y)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    if name not in ("stft", "mrstft"):
        assert got_g.dtype == want_g.dtype == np.float32
        np.testing.assert_allclose(got_g, want_g, atol=1e-4 * np.abs(want_g).max(), rtol=0)


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("name", ["stft", "mrstft"])
def test_stft_gradients_f64(name, t, x64):
    x, y = _pair(t, seed=2, dtype=np.float64)
    _, want = _jax_value_and_grad(name, x, y)
    _, got = _port_value_and_grad(name, x, y)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("left,right", [(3, 2), (13, 11), (0, 9)])
def test_reflect_pad_is_numpys(left, right):
    a = np.arange(10, dtype=np.float32).reshape(2, 5)
    np.testing.assert_array_equal(tl.reflect_pad(torch.from_numpy(a), left, right).numpy(),
                                  np.pad(a, ((0, 0), (left, right)), mode="reflect"))


def test_tables_bit_equal():
    np.testing.assert_array_equal(tl._mel_fbank(24000, 512, 64), jl._mel_fbank(24000, 512, 64))
    np.testing.assert_array_equal(tl._split_bands_kernels(24000, 16), jl._split_bands_kernels(24000, 16))
    np.testing.assert_array_equal(tl._k_weighting_response(24000, 4096), jl._k_weighting_response(24000, 4096))


@pytest.mark.parametrize("loss", ["sisnr_whole", "stft_single", "mel_l1", "msspec_normalized"])
def test_other_settings(loss):
    x, y = _pair(2400, seed=3)
    jfn, tfn = {
        "sisnr_whole": (jl.SISNR(24000, segment=None), tl.SISNR(24000, segment=None)),
        "stft_single": (jl.STFTLoss(512, 50, 240), tl.STFTLoss(512, 50, 240)),
        "mel_l1": (jl.MelSpectrogramL1Loss(24000, 512, 128, 512, 40),
                   tl.MelSpectrogramL1Loss(24000, 512, 128, 512, 40)),
        "msspec_normalized": (jl.MultiScaleMelSpectrogramLoss(24000, normalized=True),
                              tl.MultiScaleMelSpectrogramLoss(24000, normalized=True)),
    }[loss]
    want = float(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(y)))
    assert abs(float(tfn(torch.from_numpy(x), torch.from_numpy(y))) - want) <= 1e-5 * abs(want)


def test_equal_inputs_give_finite_zero_gradient():
    """At the finetune's first step the trainable decoder's audio equals the
    target: the eps inside the square root keeps the MR-STFT finite, and the
    port's L1 gives its kink no gradient."""
    x, _ = _pair(2400, seed=4)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tl.MRSTFTLoss()(xt, torch.from_numpy(x))
    loss.backward()
    assert torch.isfinite(loss) and float(loss.detach()) < 1e-5
    assert torch.isfinite(xt.grad).all() and float(xt.grad.abs().max()) == 0.0


def test_dispatchers():
    x, y = _pair(64, seed=5)
    for name in ("mse", "l1"):
        want = float(jl.get_code_loss(name)(jnp.asarray(x), jnp.asarray(y)))
        assert abs(float(tl.get_code_loss(name)(torch.from_numpy(x), torch.from_numpy(y))) - want) <= 1e-6 * want
    with pytest.raises(ValueError):
        tl.get_audio_loss("nope")
    with pytest.raises(ValueError):
        tl.get_code_loss("nope")


@pytest.mark.parametrize("t", [400, 2400])
def test_legacy_multi_res_stft_loss(t):
    """The legacy step's drift term (sizes the clip does not fill are skipped
    but still counted in the mean), value and gradient."""
    x, y = _pair(t, seed=6)
    want, want_g = jax.jit(jax.value_and_grad(jft.multi_res_stft_loss))(jnp.asarray(x), jnp.asarray(y))
    want, want_g = float(want), np.asarray(want_g)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tft.multi_res_stft_loss(xt, torch.from_numpy(y))
    got.backward()
    assert abs(float(got.detach()) - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, atol=1e-4 * np.abs(want_g).max(), rtol=0)


def test_mp3_straight_through():
    if not taugs.mp3_available():
        pytest.skip("libmp3lame does not load on this host: the straight-through MP3 is held where it does")
    x = (np.random.default_rng(7).standard_normal((2, 4800, 1)) * 0.2).astype(np.float32)
    want = np.asarray(jaugs.mp3_compression_st(jnp.asarray(x), 64, 24000))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = taugs.mp3_compression_st(xt, 64, 24000)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    (got * w).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), w.numpy())
    jg = jax.grad(lambda a: (jaugs.mp3_compression_st(a, 64, 24000) * jnp.asarray(w.numpy())).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jg), w.numpy())
