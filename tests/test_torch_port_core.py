"""Port parity, core: hashing, greenlists, sampling, ngrams, detection.

The same numpy-seeded inputs go through ``wmar_tpu.core`` (JAX, on the CPU)
and ``wmar_tpu_torch.core``. Integer paths must agree exactly; p-values at
rtol 1e-4 where p > 1e-20 (JAX's betainc runs in float32, the port's
scipy one in float64).
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.core import greenlist as jgl
from wmar_tpu.core import hashing as jhash
from wmar_tpu.core import ngrams as jngrams
from wmar_tpu.core import sampling as jsampling
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.utils import metrics as jmetrics
from wmar_tpu_torch.core import greenlist as tgl
from wmar_tpu_torch.core import hashing as thash
from wmar_tpu_torch.core import ngrams as tngrams
from wmar_tpu_torch.core import sampling as tsampling
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.utils import metrics as tmetrics

# the packages' __init__ re-export a function named detect, so import the modules by name
jdetect = importlib.import_module("wmar_tpu.core.detect")
tdetect = importlib.import_module("wmar_tpu_torch.core.detect")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(method, vocab, dim=16):
    return (JSpec.from_string(method, vocab_size=vocab, spatial_dim=dim),
            TSpec.from_string(method, vocab_size=vocab, spatial_dim=dim))


def test_hash_bits_identical():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31 - 1, size=(64, 1))
    toks = rng.integers(0, 2**31 - 1, size=(1, 257))
    for salt in (15485863, 2**32 + 7, 0):
        want = np.asarray(jhash.hash_key_token(jnp.asarray(keys, jnp.int32), jnp.asarray(toks, jnp.int32), salt))
        got = thash.hash_key_token(torch.as_tensor(keys), torch.as_tensor(toks), salt).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    np.testing.assert_array_equal(
        thash.fmix32(torch.as_tensor(x.astype(np.int64))).numpy(),
        np.asarray(jhash.fmix32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64))


@pytest.mark.parametrize("vocab", [64, 1024, 16384, 65536])
@pytest.mark.parametrize("split", ["rand", "stratifiedrand"])
@pytest.mark.parametrize("seeding", ["fixed", "linear", "spatial"])
def test_hash_greenlist_bit_identical(vocab, split, seeding):
    """Masks and lookups, exactly equal, with and without an alive set."""
    rng = np.random.default_rng(vocab)
    js, ts = _specs(f"{seeding}-{split}-h=1-d=2.0-g=0.25", vocab)
    alive = rng.random(vocab) < 0.6
    keys = rng.integers(0, vocab, size=(3, 2))
    targets = rng.integers(0, vocab, size=(3, 2))
    for alive_mask in (None, alive):
        jg = jgl.HashGreenlist(js, alive_mask=alive_mask)
        tg = tgl.HashGreenlist(ts, alive_mask=alive_mask)
        want = np.asarray(jg.green_mask(jnp.asarray(keys, jnp.int32)))
        got = tg.green_mask(torch.as_tensor(keys)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tg.green_lookup(torch.as_tensor(keys), torch.as_tensor(targets)).numpy(),
            np.asarray(jg.green_lookup(jnp.asarray(keys, jnp.int32), jnp.asarray(targets, jnp.int32))))
        if seeding == "fixed":
            assert got[0, 0].sum() == js.greenlist_size


def test_make_greenlist_refuses_unported_sources():
    ts = TSpec.from_string("fixed-clustering-h=0-d=2.0-g=0.25", vocab_size=64)
    full = tgl.VQInfo(64, alive_ids=np.arange(40), embedding=np.zeros((64, 4), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgl.make_greenlist(ts, full)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgl.make_greenlist(TSpec.from_string("linear-rand-h=1-d=2.0-g=0.25", vocab_size=64), torch_compat=True)


@pytest.mark.parametrize("lacking", ["vq", "embedding", "alive_ids"])
def test_make_greenlist_clustering_needs_embedding_and_alive_ids(lacking):
    """Where the clustering split lacks the codebook or the alive ids, the
    port raises the JAX package's ``ValueError``, message and all."""
    parts = dict(alive_ids=np.arange(40), embedding=np.zeros((64, 4), np.float32))
    parts.pop(lacking, None)
    errors = []
    for mod, spec_cls in ((jgl, JSpec), (tgl, TSpec)):
        vq = None if lacking == "vq" else mod.VQInfo(64, **parts)
        with pytest.raises(ValueError, match="clustering split needs") as e:
            mod.make_greenlist(spec_cls.from_string("fixed-clustering-h=0-d=2.0-g=0.25", vocab_size=64), vq)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_make_greenlist_calls_the_sources_as_jax_does(monkeypatch):
    """The clustering source gets ``(spec, embedding, alive_ids)`` and the
    torch-compat tables ``(spec, alive_ids)``, as in the JAX package."""
    calls = {}
    for mod in (jgl, tgl):
        monkeypatch.setattr(mod, "clustering_greenlist", lambda *a, m=mod: calls.setdefault((m, "c"), a))
        monkeypatch.setattr(mod, "build_table_torch_compat", lambda *a, m=mod: calls.setdefault((m, "t"), a))
    alive, emb = np.arange(40), np.ones((64, 4), np.float32)
    for mod, spec_cls in ((jgl, JSpec), (tgl, TSpec)):
        vq = mod.VQInfo(64, alive_ids=alive, embedding=emb)
        clus = spec_cls.from_string("fixed-clustering-h=0-d=2.0-g=0.25", vocab_size=64)
        rand = spec_cls.from_string("linear-rand-h=1-d=2.0-g=0.25", vocab_size=64)
        mod.make_greenlist(clus, vq)
        mod.make_greenlist(rand, vq, torch_compat=True)
        mod.make_greenlist(rand, None, torch_compat=True)
        assert calls[(mod, "c")][0] is clus and calls[(mod, "c")][1] is emb and calls[(mod, "c")][2] is alive
        assert calls[(mod, "t")][0] is rand and calls[(mod, "t")][1] is alive and len(calls[(mod, "t")]) == 2


@pytest.mark.parametrize("asset,vocab,n_ids", [("assets/vqgan_alive_ids.txt", 16384, 971),
                                                ("assets/rar_all_ids.txt", 1024, 1024)])
def test_alive_id_files_give_jax_thresholds(asset, vocab, n_ids):
    """The port's own reader of the alive-id files gives the ids of
    ``generate.py``'s, and under ``stratifiedrand`` the port's
    ``HashGreenlist`` thresholds equal the JAX package's bit for bit."""
    from wmar_tpu_torch import generate as tgen

    sys.path.insert(0, REPO)
    try:
        import generate as jgen
    finally:
        sys.path.remove(REPO)
    ids = tgen._load_alive_ids(asset)
    np.testing.assert_array_equal(ids, jgen._load_alive_ids(os.path.join(REPO, asset)))
    assert ids.shape == (n_ids,) and tgen._load_alive_ids("assets/no_such_file.txt") is None
    js, ts = _specs("linear-stratifiedrand-h=1-d=2.0-g=0.25", vocab)
    jg = jgl.HashGreenlist(js, alive_mask=jgl.VQInfo(vocab, alive_ids=ids).alive_mask)
    tg = tgl.HashGreenlist(ts, alive_mask=tgl.VQInfo(vocab, alive_ids=ids).alive_mask)
    np.testing.assert_array_equal(tg._thresholds.numpy().astype(np.uint32), np.asarray(jg._thresholds))
    if n_ids < vocab:  # the alive set moves the rates: plain rand thresholds differ
        plain = tgl.HashGreenlist(ts)._thresholds.numpy()
        assert (tg._thresholds.numpy() != plain).any()


@pytest.mark.parametrize("method", [
    "fixed-rand-h=1-d=2.0-g=0.25",
    "linear-rand-h=1-d=2.0-g=0.25",
    "linear-stratifiedrand-h=3-d=1.5-g=0.5",
    "spatial-rand-h=1-d=2.0-g=0.25",
    "spatial-rand-h=3-d=2.0-g=0.25",
])
def test_context_keys_and_bias(method):
    """Keys, validity and the biased logits at every step of a 4x4 grid."""
    rng = np.random.default_rng(1)
    js, ts = _specs(method, 32, dim=4)
    jg, tg = jgl.HashGreenlist(js), tgl.HashGreenlist(ts)
    buffer = rng.integers(0, 32, size=(3, 16))
    logits = rng.standard_normal((3, 32)).astype(np.float32)
    for step in range(16):
        jk, jv = jsampling.context_keys_at_step(js, jnp.asarray(buffer, jnp.int32), jnp.int32(step), jnp.int32(step))
        step_t = torch.tensor(step)
        tk, tv = tsampling.context_keys_at_step(ts, torch.as_tensor(buffer), step_t, step_t)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert bool(tv) == bool(jv)
        want = jsampling.apply_watermark_bias(js, jg, jnp.asarray(logits), jk, jv)
        got = tsampling.apply_watermark_bias(ts, tg, torch.as_tensor(logits), tk, tv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jax_categorical_is_argmax_of_gumbel():
    """The identity the port's sampler relies on to take JAX's noise."""
    key = jax.random.PRNGKey(3)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((16, 40)), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, x, axis=-1)),
        np.asarray(jnp.argmax(x + jax.random.gumbel(key, x.shape, jnp.float32), axis=-1)))


@pytest.mark.parametrize("top_k,top_p,temperature,greedy", [
    (None, None, 1.0, False),
    (8, None, 1.0, False),
    (None, 0.8, 1.0, False),
    (12, 0.9, 0.7, False),
    (100, 0.5, 1.3, False),
    (None, None, 1.0, True),
    (5, 0.7, 1.0, True),
])
def test_warp_and_sample_with_jax_noise(top_k, top_p, temperature, greedy):
    """Equal tokens when the port is fed JAX's Gumbel noise, ties included
    (logits on a 0.25 grid, so the stable sort must order ties as top_k)."""
    rng = np.random.default_rng(4)
    v, b = 64, 32
    logits = np.round(rng.standard_normal((b, v)) * 8) / 4
    logits = logits.astype(np.float32)
    k = min(top_k, v) if top_k else v
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jsampling.warp_and_sample(key, jnp.asarray(logits), temperature, top_k, top_p, greedy)
        noise = np.array(jax.random.gumbel(key, (b, k), jnp.float32))
        got = tsampling.warp_and_sample(torch.as_tensor(logits), temperature, top_k, top_p, greedy,
                                        noise=torch.as_tensor(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_warp_and_sample_generator_is_reproducible():
    logits = torch.randn((4, 50), generator=torch.Generator().manual_seed(0))
    draws = [tsampling.warp_and_sample(logits, top_k=10, generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1])


def test_cfg_schedule():
    for pow_ in (0.0, 1.0, 2.5):
        for step in (0, 5, 255):
            want = jsampling.rar_cfg_scale(jnp.int32(step), 256, 4.0, pow_)
            got = tsampling.rar_cfg_scale(torch.tensor(step), 256, 4.0, pow_)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _watermarked_codes(jg, rng, b, t, vocab):
    """Half the rows drawn so that each token is green for its left
    neighbour with probability ~0.7: p-values spread from ~1 to tiny."""
    table = np.asarray(jg.green_mask(jnp.arange(vocab, dtype=jnp.int32)))  # [key, token]
    codes = rng.integers(0, vocab, size=(b, t))
    for r in range(b // 2):
        for i in range(1, t):
            if rng.random() < 0.7:
                codes[r, i] = rng.choice(np.flatnonzero(table[codes[r, i - 1]]))
    return codes


@pytest.mark.parametrize("method", [
    "linear-rand-h=1-d=2.0-g=0.25",
    "linear-rand-h=2-d=2.0-g=0.5",
    "spatial-rand-h=1-d=2.0-g=0.25",
    "spatial-rand-h=3-d=2.0-g=0.25",
    "fixed-rand-h=0-d=2.0-g=0.25",
    "fixed-rand-h=1-d=2.0-g=0.25",
])
def test_ngram_counts_and_pvalues(method):
    """Counts equal exactly; p-values at rtol 1e-4 where p > 1e-20."""
    rng = np.random.default_rng(5)
    vocab = 24  # small: many duplicate ngrams for the dedup to remove
    js, ts = _specs(method, vocab, dim=8)
    jg, tg = jgl.HashGreenlist(js), tgl.HashGreenlist(ts)
    codes = _watermarked_codes(jg, rng, 8, 64, vocab)
    rows_j, keys_j, tgt_j = jngrams.extract_ngrams(js, jnp.asarray(codes[0], jnp.int32))
    rows_t, keys_t, tgt_t = tngrams.extract_ngrams(ts, torch.as_tensor(codes))
    np.testing.assert_array_equal(rows_t[0].numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(keys_t[0].numpy(), np.asarray(keys_j))
    np.testing.assert_array_equal(tgt_t[0].numpy(), np.asarray(tgt_j))
    np.testing.assert_array_equal(tngrams.first_occurrence_mask(rows_t)[0].numpy(),
                                  np.asarray(jngrams.first_occurrence_mask(rows_j)))
    jn = jax.vmap(lambda c: jdetect.score_codes(js, jg, c))(jnp.asarray(codes, jnp.int32))
    tn = tdetect.score_codes(ts, tg, torch.as_tensor(codes))
    for j, t in zip(jn, tn):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = np.asarray(jdetect.detect(js, jg, jnp.asarray(codes, jnp.int32)), np.float64)
    got = tdetect.detect(ts, tg, torch.as_tensor(codes))
    assert got.shape == want.shape and np.isfinite(got).all()
    sel = want > 1e-20
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-4)
    assert np.all(got[~sel] <= 1e-19)


def test_pvalue_zero_green_is_one():
    p = tdetect.pvalue_from_counts(torch.tensor([0, 0, 3]), torch.tensor([0, 10, 10]), 0.25)
    assert p[0] == 1.0 and p[1] == 1.0 and 0 < p[2] < 1
    np.testing.assert_allclose(
        p[2], float(jdetect.pvalue_from_counts(jnp.int32(3), jnp.int32(10), 0.25)), rtol=1e-4)


def test_image_metrics():
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), -1, 1).astype(np.float32)
    assert tmetrics.psnr_pm1(a, b) == jmetrics.psnr_pm1(a, b)
    c1, c2 = rng.integers(0, 5, (4, 16)), rng.integers(0, 5, (4, 16))
    np.testing.assert_allclose(tmetrics.l0_token_mismatch(c1, c2).numpy(),
                               np.asarray(jmetrics.l0_token_mismatch(c1, c2)), rtol=1e-6)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wmar_tpu_torch\n"
        "for m in pkgutil.walk_packages(wmar_tpu_torch.__path__, 'wmar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax', 'wmar_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('wmar_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 20
