"""Port parity, the greenlist sources beyond the hash: the torch-compat
tables (the reference's own greenlists), their lazy host-side counterpart,
the clustering split and the alive-ids reader, against ``wmar_tpu.core``.

Integer results agree exactly: table words, green masks and lookups bit for
bit at V = 1024 (every context sum), 8192 and 16384 (a ``max_context_sum``
of 40, so the test stays fast); p-values of the host detection within
1e-12 (both float64 ``betainc``); the clustering split's mask exactly, on
sklearn's branch and on the numpy one.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from wmar_tpu import native
from wmar_tpu.core import greenlist as jgl
from wmar_tpu.core.detect import detect as jax_detect
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.models import GenParams as JGenParams
from wmar_tpu.models import RarARMM as JRarARMM
from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import rar as jrar
from wmar_tpu_torch import bridge
from wmar_tpu_torch.core import greenlist as tgl
from wmar_tpu_torch.core.detect import detect as port_detect
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.models import GenParams as TGenParams
from wmar_tpu_torch.models import RarARMM as TRarARMM
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import rar as trar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ["linear-rand-h=1-d=2.0-g=0.25", "linear-stratifiedrand-h=1-d=2.0-g=0.25",
           "fixed-stratifiedrand-h=1-d=2.0-g=0.25", "spatial-rand-h=3-d=2.0-g=0.5"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test: the fast tier runs six workers on
    the machine's cores, where torch's default of a thread per core
    oversubscribes them and the many tiny ops of a grid wait on each other
    (a tiny grid run: 96 s against 3 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(method, vocab):
    return JSpec.from_string(method, vocab_size=vocab), TSpec.from_string(method, vocab_size=vocab)


def _alive(vocab):
    return np.sort(np.random.default_rng(vocab).choice(vocab, vocab * 3 // 4, replace=False))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("vocab,max_sum", [(1024, None), (8192, 40), (16384, 40)])
def test_table_bits_equal_jax(vocab, max_sum, method):
    """Table words, ``green_mask`` over keys in and past the table (clipped
    to its last row) and ``green_lookup``: bit for bit. The port holds the
    words as int32 and unpacks them with ``(w >> s) & 1``."""
    js, ts = _specs(method, vocab)
    alive = _alive(vocab)
    jt = jgl.build_table_torch_compat(js, alive, max_sum)
    tt = tgl.build_table_torch_compat(ts, alive, max_sum)
    assert tt.n_keys == jt.n_keys and tt._table.dtype == torch.int32 and tt.device == torch.device("cpu")
    np.testing.assert_array_equal(tt._table.numpy().view(np.uint32), np.asarray(jt._table))
    rng = np.random.default_rng(1)
    keys = rng.integers(0, tt.n_keys + 5, (3, 4))
    np.testing.assert_array_equal(tt.green_mask(torch.as_tensor(keys)).numpy(),
                                  np.asarray(jt.green_mask(jnp.asarray(keys, jnp.int32))))
    targets = rng.integers(0, vocab, (3, 4))
    np.testing.assert_array_equal(
        tt.green_lookup(torch.as_tensor(keys), torch.as_tensor(targets)).numpy(),
        np.asarray(jt.green_lookup(jnp.asarray(keys, jnp.int32), jnp.asarray(targets, jnp.int32))))
    assert tt.green_mask(torch.as_tensor([0])).sum() == ts.greenlist_size


@pytest.mark.parametrize("vocab", [30, 64, 100])
def test_pack_bool_rows_equals_jax(vocab):
    mask = np.random.default_rng(vocab).random((5, vocab)) < 0.3
    np.testing.assert_array_equal(tgl.pack_bool_rows(mask), jgl.pack_bool_rows(mask))


@pytest.mark.parametrize("method", METHODS[:2])
def test_greenlist_ids_equal_jax(method):
    """The ids of one seed, in the reference's order, for salted context
    sums up to 2^40."""
    js, ts = _specs(method, 1024)
    for seed in (0, 1, 15485863 * 1023, 2**40 + 3):
        np.testing.assert_array_equal(tgl.greenlist_ids_torch_compat(ts, seed, _alive(1024)),
                                      jgl.greenlist_ids_torch_compat(js, seed, _alive(1024)))


def test_table_refusals_equal_jax():
    """Chameleon's 65,536 codes need more than ``_TABLE_BITS_LIMIT`` bits:
    both packages refuse with the same ``ValueError``; so they do a
    stratified split without alive ids and a clustering spec."""
    assert tgl._TABLE_BITS_LIMIT == jgl._TABLE_BITS_LIMIT == 2**31
    for method, vocab, match in (("linear-rand-h=1-d=2.0-g=0.25", 65536, "torch-compat table would need"),
                                 ("linear-stratifiedrand-h=1-d=2.0-g=0.25", 64, "needs alive_ids"),
                                 ("fixed-clustering-h=1-d=2.0-g=0.25", 64, "No torch-compat builder")):
        js, ts = _specs(method, vocab)
        errors = []
        for mod, spec in ((jgl, js), (tgl, ts)):
            with pytest.raises(ValueError, match=match) as e:
                mod.build_table_torch_compat(spec)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("method", ["linear-rand-h=1-d=2.0-g=0.25", "spatial-stratifiedrand-h=1-d=2.0-g=0.25",
                                    "fixed-rand-h=2-d=2.0-g=0.25"])
def test_lazy_detect_host_equals_jax(method, monkeypatch):
    """``LazyTorchCompatGreenlist.detect_host`` (the port's numpy branch)
    against JAX's (its C++ scorer where built, and its numpy branch): p-values
    within 1e-12, rows equal to the table's, lookups equal to JAX's."""
    vocab = 256
    js, ts = _specs(method, vocab)
    alive = _alive(vocab)
    codes = np.random.default_rng(3).integers(0, vocab, (4, 256))  # a 16 x 16 grid for the spatial ngrams
    codes[0, :128] = codes[0, 128:]  # repeated ngrams: the dedup counts
    jl = jgl.LazyTorchCompatGreenlist(js, alive_ids=alive)
    tl = tgl.LazyTorchCompatGreenlist(ts, alive_ids=alive, maxsize=16)
    got = tl.detect_host(codes)
    np.testing.assert_allclose(got, jl.detect_host(codes), rtol=0, atol=1e-12)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_allclose(got, jl.detect_host(codes), rtol=0, atol=1e-12)
    assert len(tl._rows) <= 16 and got.shape == (4,) and (got[1:] > 1e-4).all()
    keys, targets = np.random.default_rng(4).integers(0, 600, 50), np.random.default_rng(5).integers(0, vocab, 50)
    np.testing.assert_array_equal(tl.green_lookup_host(keys, targets), jl.green_lookup_host(keys, targets))
    table = tgl.build_table_torch_compat(ts, alive, max_context_sum=20)
    for k in (0, 7, 20):
        np.testing.assert_array_equal(table.green_mask(torch.as_tensor([k])).numpy()[0], tl._row(k))


def test_lazy_detect_host_scores_the_table_watermark():
    """Codes drawn green under the table score a p-value far below codes
    drawn at random, in both packages alike."""
    js, ts = _specs("linear-rand-h=1-d=2.0-g=0.25", 128)
    table = tgl.build_table_torch_compat(ts)
    rng = np.random.default_rng(5)
    codes = [int(rng.integers(128))]
    for _ in range(99):
        row = table.green_mask(torch.as_tensor([codes[-1]])).numpy()[0]
        codes.append(int(rng.choice(np.flatnonzero(row))))
    batch = np.stack([codes, rng.integers(0, 128, 100)])
    got = tgl.LazyTorchCompatGreenlist(ts).detect_host(batch)
    np.testing.assert_allclose(got, jgl.LazyTorchCompatGreenlist(js).detect_host(batch), rtol=0, atol=1e-12)
    assert got[0] < 1e-20 < got[1]
    np.testing.assert_allclose(port_detect(ts, table, torch.as_tensor(batch)), got, rtol=0, atol=1e-12)


def _block_sklearn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)


@pytest.mark.parametrize("branch", ["sklearn", "numpy"])
def test_clustering_split_equals_jax(branch, monkeypatch):
    """The clustering split of 110 alive codes of 256: t-SNE and KMeans
    where sklearn is installed, the PCA quantile grid where its import
    fails; the fixed mask equal to JAX's either way."""
    if branch == "numpy":
        _block_sklearn(monkeypatch)
    else:
        pytest.importorskip("sklearn")
    js, ts = _specs("fixed-clustering-h=1-d=2.0-g=0.25", 256)
    emb = np.random.default_rng(7).standard_normal((256, 8)).astype(np.float32)
    alive = np.sort(np.random.default_rng(8).choice(256, 110, replace=False))
    with threadpool_limits(limits=1):  # t-SNE's OpenMP threads would oversubscribe the tier's workers
        want = np.asarray(jgl.clustering_greenlist(js, emb, alive)._fixed_mask)
        got = tgl.clustering_greenlist(ts, emb, alive)
    assert isinstance(got, tgl.HashGreenlist)
    np.testing.assert_array_equal(got._fixed_mask.numpy(), want)
    keys = torch.as_tensor([0, 9])
    assert got.green_mask(keys).shape == (2, 256) and torch.equal(got.green_mask(keys)[1], got._fixed_mask)


def test_clustering_refusals_equal_jax():
    """Non-fixed seeding raises as in JAX; where sklearn is installed,
    KMeans cannot make 100 clusters of 64 codes and both packages raise
    sklearn's error."""
    js, ts = _specs("fixed-clustering-h=1-d=2.0-g=0.25", 64)
    emb = np.random.default_rng(9).standard_normal((64, 4)).astype(np.float32)
    for mod, spec in ((jgl, JSpec), (tgl, TSpec)):
        with pytest.raises(ValueError, match="requires fixed seeding"):
            mod.clustering_greenlist(spec.from_string("linear-clustering-h=1-d=2.0-g=0.25", vocab_size=64), emb,
                                     np.arange(64))
    pytest.importorskip("sklearn")
    for mod, spec in ((jgl, js), (tgl, ts)):
        with pytest.raises(ValueError, match="should be >= n_clusters=100"):
            mod.clustering_greenlist(spec, emb, np.arange(64))


def test_fixed_greenlist_from_the_clustering_ids_asset():
    """``assets/clustering_greenlist_ids.txt`` as a fixed greenlist over
    Taming's 16,384 codes, and ``VQInfo.from_alive_ids_file`` on the alive
    ids asset, equal to JAX's."""
    with open(os.path.join(REPO, "assets", "clustering_greenlist_ids.txt")) as f:
        ids = [int(x) for x in f.read().replace("\n", ",").split(",") if x.strip()]
    js, ts = _specs("fixed-clustering-h=1-d=2.0-g=0.25", 16384)
    np.testing.assert_array_equal(tgl.fixed_greenlist_from_ids(ts, ids)._fixed_mask.numpy(),
                                  np.asarray(jgl.fixed_greenlist_from_ids(js, ids)._fixed_mask))
    path = os.path.join(REPO, "assets", "vqgan_alive_ids.txt")
    emb = np.zeros((16384, 2), np.float32)
    tv, jv = tgl.VQInfo.from_alive_ids_file(path, 16384, emb), jgl.VQInfo.from_alive_ids_file(path, 16384, emb)
    assert tv.vocab_size == 16384 and tv.embedding is emb and len(tv.alive_ids) == 971
    np.testing.assert_array_equal(tv.alive_ids, jv.alive_ids)
    np.testing.assert_array_equal(tv.alive_mask, jv.alive_mask)


def test_table_greenlist_in_the_sampler_and_detection():
    """A tiny RAR with ``set_watermarker(spec, torch_compat=True)`` in both
    packages: watermarked draws fed JAX's noise give equal tokens (the table
    biases the sampler), and detection gives JAX's p-values (rtol 1e-4:
    JAX's betainc is float32)."""
    cfg = dict(embed_dim=32, depth=2, num_heads=2, intermediate_size=64, image_seq_len=16, codebook_size=32,
               num_classes=4)
    vq = dict(resolution=8, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16, n_embed=32,
              embed_dim=16)
    params = jrar.init_rar_params(jax.random.PRNGKey(0), jrar.RARConfig(**cfg))
    rng = np.random.default_rng(9)
    params["blocks"] = [{**b, "adaln": {"w": jnp.asarray(rng.standard_normal(b["adaln"]["w"].shape) * 0.05,
                                                          jnp.float32), "b": b["adaln"]["b"]}}
                        for b in params["blocks"]]
    vq_params = jmg.MaskGitVQGAN(jmg.MaskGitVQConfig(**vq)).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    jw = JRarARMM(params, jrar.RARConfig(**cfg), vq_params, jmg.MaskGitVQConfig(**vq), cache_dtype=jnp.float32)
    tw = TRarARMM(bridge.load_rar(trar.RAR(trar.RARConfig(**cfg)), jax.tree.map(np.asarray, params)),
                  bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**vq)), jax.tree.map(np.asarray, vq_params)),
                  cache_dtype=torch.float32, device="cpu")
    method = "linear-rand-h=1-d=2.0-g=0.25"
    jw.set_watermarker(JSpec.from_string(method, vocab_size=32, spatial_dim=4), torch_compat=True)
    tw.set_watermarker(TSpec.from_string(method, vocab_size=32, spatial_dim=4), torch_compat=True)
    assert isinstance(tw.greenlist, tgl.TableGreenlist) and tw.greenlist.device == torch.device("cpu")
    classes, key = np.array([0, 1, 2, 3]), jax.random.PRNGKey(3)
    want = np.asarray(jw.sample(classes, JGenParams(guidance_scale=4.0), apply_watermark=True, rng=key))
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (4, 32), jnp.float32)) for s in range(16)])
    got = tw.sample(classes, TGenParams(guidance_scale=4.0), apply_watermark=True, noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(port_detect(tw.watermark_spec, tw.greenlist, got),
                               np.asarray(jax_detect(jw.watermark_spec, jw.greenlist, jnp.asarray(want)), np.float64),
                               rtol=1e-4)
