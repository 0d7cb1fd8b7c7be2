"""Port parity, the audio attack grid (``wmar_tpu_torch.audio.augmentations``),
the MP3 bridge (``wmar_tpu_torch.native.mp3``) and the audio metrics
(``wmar_tpu_torch.utils.metrics``) against the JAX package on the CPU.

Tolerances: every grid cell within 1e-5 of JAX's on the same waveform, the
random cells fed JAX's draws (``noise``, ``white``, ``start``), and
``time-shift`` against JAX's ``time_shift`` at the shift the reference
means (JAX's cell is the identity: fault (g), pinned below); the
resampling cells (``speed``, ``updown-resample``) compute JAX's float32
sample positions, with the rounding of XLA's fused multiply-add. MP3 equal
to JAX's where ``libmp3lame`` loads (both bind the same library); the Mimi
round trip within 1e-5; STOI, SI-SNR and SNR within 1e-6 (float64 on the
host in both); PESQ None in both where the ``pesq`` package is absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.audio import augmentations as ja
from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.native import mp3 as jmp3
from wmar_tpu.utils import metrics as jmetrics
from wmar_tpu_torch import audio_eval, bridge
from wmar_tpu_torch.audio import augmentations as ta
from wmar_tpu_torch.audio import mimi as tmimi
from wmar_tpu_torch.native import mp3 as tmp3
from wmar_tpu_torch.utils import metrics as tmetrics

LENGTHS = (16 * 24, 1920 * 2 + 3)
JAX_GRID = {name: (fn, params) for name, fn, params in ja.get_validation_augs()}
PORT_GRID = {name: (fn, params) for name, fn, params in ta.get_validation_augs()}


def _wave(t, seed=0):
    return np.clip(np.random.default_rng(seed).standard_normal((2, t, 1)) * 0.3, -1, 1).astype(np.float32)


def test_grid_names_and_params():
    assert list(JAX_GRID) == list(PORT_GRID)
    assert all(JAX_GRID[n][1] == PORT_GRID[n][1] for n in JAX_GRID)
    assert ("mp3-compression" in PORT_GRID) == tmp3.available() == jmp3.available()


@pytest.mark.parametrize("name", [n for n in JAX_GRID if n != "mp3-compression"])
def test_grid_family_matches_jax(name):
    jfn, params = JAX_GRID[name]
    pfn, _ = PORT_GRID[name]
    key = jax.random.PRNGKey(5)
    for t in LENGTHS:
        x = _wave(t, t)
        for p in params:
            want = np.asarray(jfn(jnp.asarray(x), p, key))
            xt = torch.from_numpy(x)
            if name == "noise":
                got = ta.gaussian_noise(xt, p, noise=torch.from_numpy(np.array(jax.random.normal(key, x.shape))))
            elif name == "pink-noise":
                got = ta.pink_noise(xt, p, white=torch.from_numpy(np.array(jax.random.normal(key, x.shape))))
            elif name == "time-shift":  # fault (g): JAX's cell divides by the channel axis; held to its function
                want = np.asarray(ja.time_shift(jnp.asarray(x), p / 1000 * 24000 / t))
                got = pfn(xt, p, None)
            elif name == "temporal-crop":
                keep = int(t * p)
                got = ta.temporal_crop(xt, p, start=int(jax.random.randint(key, (), 0, t - keep + 1)))
            else:
                got = pfn(xt, p, None)
            assert tuple(got.shape) == want.shape, (name, p, t)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0, err_msg=f"{name} {p} T={t}")


def test_fault_g_jax_time_shift_cell_is_the_identity():
    """JAX's ``time-shift`` cell divides the shift by ``x.shape[-1]``, the
    channel axis of ``[B, T, 1]``, so it rolls by whole clip lengths and
    returns the waveform unchanged; the port's rolls by 10, 20 and 40 ms,
    as the reference's ``[B, C, T]`` lambda does."""
    x = _wave(24000 // 2, 7)
    for p in JAX_GRID["time-shift"][1]:
        np.testing.assert_array_equal(np.asarray(JAX_GRID["time-shift"][0](jnp.asarray(x), p, None)), x)
        got = PORT_GRID["time-shift"][0](torch.from_numpy(x), p, None).numpy()
        np.testing.assert_array_equal(got, np.roll(x, int(p / 1000 * 24000), axis=1))


def test_random_cells_draw_from_the_generator():
    x = torch.from_numpy(_wave(512))
    for name in ("noise", "pink-noise", "temporal-crop"):
        fn, params = PORT_GRID[name]
        a = fn(x, params[0], torch.Generator().manual_seed(3))
        b = fn(x, params[0], torch.Generator().manual_seed(3))
        c = fn(x, params[0], torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c), name


@pytest.mark.skipif(not tmp3.available(), reason="libmp3lame does not load on this host")
def test_mp3_matches_jax():
    x = _wave(24000 // 2, 1) * 0.5
    for kbps in (16, 64, 128):
        got = PORT_GRID["mp3-compression"][0](torch.from_numpy(x), kbps, None)
        want = np.asarray(JAX_GRID["mp3-compression"][0](jnp.asarray(x), kbps, None))
        assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.array_equal(want, x)


def test_mimi_compression_matches_jax():
    jcfg = jmimi.MimiConfig(**audio_eval.TINY_MIMI)
    m = jmimi.Mimi(jcfg)
    variables = jax.jit(m.init)(jax.random.PRNGKey(1), jnp.zeros((1, jcfg.hop_length * 4, 1)))
    with torch.device("meta"):
        model = tmimi.Mimi(tmimi.MimiConfig(**audio_eval.TINY_MIMI))
    port = bridge.load_mimi(model.to_empty(device="cpu"), jax.tree.map(np.asarray, variables))
    x = _wave(jcfg.hop_length * 12 + 5, 2)
    want = np.asarray(ja.MimiCompression(m, variables)(jnp.asarray(x)))
    got = ta.MimiCompression(port)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, jcfg.hop_length * 12, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_audio_metrics():
    ref = _wave(24000, 3)[0, :, 0]
    for noise in (0.01, 0.3):
        est = np.clip(ref + np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32) * noise, -1, 1)
        for fn in ("stoi", "sisnr", "snr"):
            kw = {"fs": 24000} if fn == "stoi" else {}
            got = getattr(tmetrics, fn)(torch.from_numpy(est), torch.from_numpy(ref), **kw)
            want = getattr(jmetrics, fn)(est, ref, **kw)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=fn)
        assert tmetrics.pesq_metric(est, ref) == jmetrics.pesq_metric(est, ref)
    assert tmetrics.stoi(ref[:1000], ref[:1000]) == jmetrics.stoi(ref[:1000], ref[:1000]) == 0.0  # < 30 frames
