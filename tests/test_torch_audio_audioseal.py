"""Port parity, AudioSeal, the sync pattern and ``eval_audioseal``
(``wmar_tpu_torch.audio.{audioseal,sync,eval_audioseal}``) against the JAX
package on the CPU.

* The synthetic state dicts are JAX's numpy draws, array for array; the
  JAX tests' torch oracles (the audioseal package's layout, weight_g/v)
  and those draws go through both packages' shape-driven converters, whose
  trees and configs must be equal bit for bit, at the tiny widths and at
  ``AUDIOSEAL_16B``.
* The watermark, the presence and the bits' logits within 1e-5 of the
  output's scale (float32 both).
* ``SyncPattern`` over an oracle watermark model whose presence is the
  mask: the speed-up and shift JAX's numpy search finds, exactly (the same
  host code, fed signals equal to 1e-6); ``invert`` against
  ``jax.image.resize`` within 1e-6.
* ``eval_audioseal --tiny``: JAX's CSV rows, the scores within 1e-5 where
  the cell draws no noise, and the TPR summary's keys; with ``--eval_aug
  false`` the summary equal.
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests import test_audioseal as oracle  # noqa: E402
from wmar_tpu.audio import audioseal as ja  # noqa: E402
from wmar_tpu.audio import eval_audioseal as jeval  # noqa: E402
from wmar_tpu.audio import sync as jsync  # noqa: E402
from wmar_tpu_torch import bridge  # noqa: E402
from wmar_tpu_torch.audio import audioseal as ta  # noqa: E402
from wmar_tpu_torch.audio import eval_audioseal as teval  # noqa: E402
from wmar_tpu_torch.audio import sync as tsync  # noqa: E402

TOL = 1e-5  # of the reference output's scale


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return ta.AudioSealConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


TINY = _tcfg(oracle.TINY)


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _same_trees(got, want):
    g, w = dict(bridge.flatten(got)), dict(bridge.flatten(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert np.array_equal(g[k], np.asarray(w[k])) and g[k].dtype == np.asarray(w[k]).dtype, k


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * float(np.abs(want).max()))


def _audio(b, t, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, t, 1)).astype(np.float32)


@pytest.mark.parametrize("cfg", [TINY, ta.AUDIOSEAL_16B], ids=["tiny", "16bits"])
def test_synthetic_state_dicts_are_jax_draws(cfg):
    jcfg = ja.AudioSealConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    for tfn, jfn in ((ta.synthetic_generator_sd, ja.synthetic_generator_sd),
                     (ta.synthetic_detector_sd, ja.synthetic_detector_sd)):
        got, want = tfn(cfg, seed=7), jfn(jcfg, seed=7)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_converters_at_16bits_give_jax_trees():
    """The published geometry (generator 14,850,913 and detector 8,734,818
    parameters) through both packages' shape-driven converters."""
    cfg = ta.AUDIOSEAL_16B
    gsd, dsd = ta.synthetic_generator_sd(cfg), ta.synthetic_detector_sd(cfg)
    (tg, tgc), (jg, jgc) = ta.convert_audioseal_generator(gsd), ja.convert_audioseal_generator(gsd)
    (td, tdc), (jd, jdc) = ta.convert_audioseal_detector(dsd), ja.convert_audioseal_detector(dsd)
    _same_trees(tg, jg)
    _same_trees(td, jd)
    assert tgc.__dict__ == jgc.__dict__ and tdc.__dict__ == jdc.__dict__
    model = bridge.load_audioseal(tg, td, dataclasses.replace(tgc, detector_output_dim=tdc.detector_output_dim))
    assert sum(p.numel() for p in model.generator.parameters()) == 14_850_913
    assert sum(p.numel() for p in model.detector.parameters()) == 8_734_818


def test_generator_matches_jax_and_the_oracle():
    """The oracle's generator (weight_g/v) with a random message: JAX's tree,
    JAX's watermark within 1e-5 of its scale, the oracle's within 3e-4 (JAX's
    own bound against it); the zero message by default, as JAX's."""
    torch.manual_seed(0)
    ref = oracle.GenOracle(oracle.TINY).eval()
    sd = _np(ref.state_dict())
    (tp, tcfg), (jp, jcfg) = ta.convert_audioseal_generator(sd), ja.convert_audioseal_generator(sd)
    _same_trees(tp, jp)
    model = bridge.load_audioseal(tp, ta.convert_audioseal_detector(ta.synthetic_detector_sd(TINY))[0],
                                  dataclasses.replace(tcfg, detector_output_dim=TINY.detector_output_dim))
    x = _audio(2, 200)
    msg = np.random.default_rng(1).integers(0, 2, (2, TINY.nbits))
    jpar = jax.tree.map(jnp.asarray, jp)
    got = model.get_watermark(torch.from_numpy(x), torch.from_numpy(msg)).numpy()
    _close(got, ja.audioseal_get_watermark(jpar, jcfg, jnp.asarray(x), jnp.asarray(msg)))
    with torch.no_grad():
        want = ref.get_watermark(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(msg)).transpose(1, 2)
    np.testing.assert_allclose(got, want.numpy(), atol=3e-4)
    _close(model.get_watermark(torch.from_numpy(x)).numpy(), ja.audioseal_get_watermark(jpar, jcfg, jnp.asarray(x)))


def test_detector_matches_jax():
    """The oracle's detector in the package layout: presence within 1e-5,
    the bits' logits within 1e-5 of their scale, the decoded bits equal."""
    torch.manual_seed(1)
    ref = oracle.DetOracle(oracle.TINY).eval()
    sd = {k.replace("keep.", "detector.0.").replace("head.", "detector.1."): v
          for k, v in _np(ref.state_dict()).items() if not k.startswith("detector.")}
    (tp, tcfg), (jp, jcfg) = ta.convert_audioseal_detector(sd), ja.convert_audioseal_detector(sd)
    _same_trees(tp, jp)
    model = bridge.load_audioseal(ta.convert_audioseal_generator(ta.synthetic_generator_sd(TINY))[0], tp, tcfg)
    x = _audio(2, 203, seed=2)
    presence, logits = model.detect_full(torch.from_numpy(x))
    jpres, jlog = ja.audioseal_detect(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    np.testing.assert_allclose(presence.numpy(), np.asarray(jpres), rtol=0, atol=TOL)
    _close(logits.numpy(), jlog)
    np.testing.assert_array_equal(ta.decode_message(logits).numpy(), np.asarray(ja.decode_message(jlog)))


def test_writer_round_trip(tmp_path):
    """``audioseal_state_dicts`` writes the audioseal layout: the files read
    back through ``from_checkpoints`` give the same module."""
    from wmar_tpu_torch.audio.codecs import random_codec

    src = random_codec(lambda: ta.AudioSealModel(TINY), torch.Generator().manual_seed(0))
    gen, det = ta.audioseal_state_dicts(src)
    torch.save(gen, tmp_path / "g.pth")
    torch.save(det, tmp_path / "d.pth")
    back = ta.AudioSealModel.from_checkpoints(str(tmp_path / "g.pth"), str(tmp_path / "d.pth"))
    assert back.cfg.__dict__ == TINY.__dict__ | {"sample_rate": 24000}
    x = torch.from_numpy(_audio(1, 96, seed=3))
    assert torch.equal(back.get_watermark(x), src.get_watermark(x))
    assert torch.equal(back.detect(x), src.detect(x))


class MaskModel:
    """A watermark model whose presence is the sync mask itself (1 where the
    delta is on), on the package's arrays: the oracle of the search."""

    def __init__(self, torch_side: bool):
        self.torch_side = torch_side

    def get_watermark(self, audio):
        return (torch.ones_like(audio) if self.torch_side else jnp.ones_like(audio)) * 0.05

    def detect(self, audio):
        return (audio[..., 0] > 0.025) * 1.0


@pytest.mark.parametrize("speed,shift", [(1.1, 0), (1.1, 37), (0.9, 101), (1.0, 250)])
def test_sync_search_recovers_speed_and_shift_as_jax(speed, shift):
    """A gated watermark over silence, sped up (linear resampling as the
    grid's ``speed``) and delayed by ``shift`` samples: both packages' search
    give the same (speed-up, shift); at 1.1 and no shift the speed-up is
    the estimate's grid point nearest 1.1."""
    from wmar_tpu_torch.audio.augmentations import resize_linear_time

    n = 24000
    tp, jp = tsync.SyncPattern(MaskModel(True), 2, 400), jsync.SyncPattern(MaskModel(False), 2, 400)
    wm_t = tp.get_sync_wm(torch.zeros((1, n, 1)))
    wm_j = jp.get_sync_wm(jnp.zeros((1, n, 1)))
    np.testing.assert_array_equal(wm_t.numpy(), np.asarray(wm_j))
    sped = resize_linear_time(wm_t, int(round(n / speed)), antialias=speed > 1)
    sped = torch.nn.functional.pad(sped, (0, 0, shift, 0))
    sig_t, sig_j = tp.detect_signal(sped), jp.detect_signal(jnp.asarray(sped.numpy()))
    np.testing.assert_array_equal(sig_t, sig_j)
    got, want = tp.get_speedup_and_shift(sig_t[0]), jp.get_speedup_and_shift(sig_j[0])
    assert got == want
    if shift == 0:
        assert abs(got[0] - speed) < 0.02, got


@pytest.mark.parametrize("speedup,shift", [(1.1, 13), (0.8, 0), (1.25, 400)])
def test_invert_matches_jax_resize(speedup, shift):
    x = _audio(2, 1000, seed=4)
    tp, jp = tsync.SyncPattern(MaskModel(True), 2, 400), jsync.SyncPattern(MaskModel(False), 2, 400)
    got = tp.invert(torch.from_numpy(x), speedup, shift).numpy()
    want = np.asarray(jp.invert(jnp.asarray(x), speedup, shift))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    from scipy.io import wavfile

    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for i in range(3):
        wavfile.write(str(d / f"c{i}.wav"), 24000, (rng.normal(0, 0.1, 2400 + 160 * i) * 32767).astype(np.int16))
    return d


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


# cells that draw no noise, so the two packages score the same audio
_DRAWS = ("noise", "pink-noise", "temporal-crop")


def test_eval_audioseal_tiny_matches_jax(wav_dir, tmp_path):
    flags = ["--audio_dir", str(wav_dir), "--tiny", "--batch_size", "2", "--save_audio", "1"]
    jrows, jsum = jeval.main(flags + ["--output_dir", str(tmp_path / "jax")])
    trows, tsum = teval.main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = _csv(tmp_path / "port" / "audioseal_eval_results.csv")
    want = _csv(tmp_path / "jax" / "audioseal_eval_results.csv")
    key = ("global_index", "aug_name", "strength")
    assert [tuple(r[k] for k in key) for r in got] == [tuple(r[k] for k in key) for r in want]
    assert len(got) == len(trows) and list(tsum) == list(jsum)
    for g, w in zip(got, want):
        assert g["audio_file"] == w["audio_file"]
        vals = [float(g["score_wm"]), float(g["score_orig"])]
        assert all(0.0 <= v <= 1.0 for v in vals)
        if g["aug_name"] not in _DRAWS:
            np.testing.assert_allclose(vals, [float(w["score_wm"]), float(w["score_orig"])], rtol=0, atol=TOL)
    assert all(0.0 <= v <= 1.0 for v in tsum.values())
    saved = sorted(p.name for p in (tmp_path / "port" / "audio_samples").iterdir())
    assert saved == sorted(p.name for p in (tmp_path / "jax" / "audio_samples").iterdir())


def test_eval_audioseal_identity_summary_equals_jax(wav_dir, tmp_path):
    flags = ["--audio_dir", str(wav_dir), "--tiny", "--eval_aug", "false", "--nsamples", "3", "--fpr_target", "0.5"]
    _, jsum = jeval.main(flags + ["--output_dir", str(tmp_path / "jax")])
    rows, tsum = teval.main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(rows) == 3 and tsum == jsum


def test_eval_audioseal_same_noise_on_both_branches():
    """A noise cell draws the same noise for the watermarked and the
    original batch (two generators seeded alike, JAX's one key)."""
    from wmar_tpu_torch.audio.augmentations import gaussian_noise

    seed = teval.cell_seed(42, "noise", 0.05)
    x = torch.zeros((2, 64, 1))
    a = gaussian_noise(x, 0.05, torch.Generator().manual_seed(seed))
    b = gaussian_noise(x + 0.01, 0.05, torch.Generator().manual_seed(seed))
    torch.testing.assert_close(b - a, torch.full_like(a, 0.01), rtol=0, atol=1e-7)


def test_eval_audioseal_refusals(wav_dir, tmp_path):
    with pytest.raises(SystemExit, match="need --generator_ckpt"):
        teval.main(["--audio_dir", str(wav_dir), "--output_dir", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            teval.main(["--audio_dir", str(wav_dir), "--output_dir", str(tmp_path), "--tiny"])
