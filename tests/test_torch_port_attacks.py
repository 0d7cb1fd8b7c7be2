"""Port parity, the attack grid: ``wmar_tpu_torch.augmentations`` and the
attack loop of ``eval.pipeline`` against the JAX package on the CPU.

The same numpy-seeded images go through every attack at every parameter of
the reference's grid, JAX run eagerly (no ``jit``), at 8 px (no chroma
subsampling, reflect pads wider than the image) and 24 px (4:2:0 chroma,
edge padding to 32). Float32 results agree within 1e-5: the two packages
differ only in summation order. ``jpeg_pil`` and every integer result
(file stems, codes of identical images) agree exactly; gaussian noise is fed
JAX's draws. In ``jpeg_diff`` a DCT coefficient that lies on a rounding
boundary may round the other way in the port: the test counts those and
bounds what they may move.

The slice: the same codes go through JAX's and the port's
``fill_batch_log`` and ``compute_and_save_batch`` for a tiny RAR (8 px) and
a tiny Taming (16 px) whose tokenizer weights the bridge carries over.
"""

import json
import os

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import betainc

from wmar_tpu.augmentations import AugmentationManager as JManager
from wmar_tpu.augmentations import geometric as JG
from wmar_tpu.augmentations import valuemetric as JV
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.eval import pipeline as jpipe
from wmar_tpu.models import armm as jarmm
from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import rar as jrar
from wmar_tpu.models import taming_gpt as jgpt
from wmar_tpu.models import vqgan as jvq
from wmar_tpu_torch import bridge
from wmar_tpu_torch.augmentations import AugmentationManager as TManager
from wmar_tpu_torch.augmentations import geometric as TG
from wmar_tpu_torch.augmentations import valuemetric as TV
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.eval import pipeline as tpipe
from wmar_tpu_torch.models import armm as tarmm
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import rar as trar
from wmar_tpu_torch.models import taming_gpt as tgpt
from wmar_tpu_torch.models import vqgan as tvq

# the package's __init__ re-exports a function named detect, so import the module by name
jdetect = importlib.import_module("wmar_tpu.core.detect")

TOL = 1e-5
ATTACKS = ["gaussian-blur", "gaussian-noise", "jpeg", "brightness", "rotation", "flip-h", "upperleft-crop"]
# where a DCT coefficient counts as on a rounding boundary: |frac - 0.5| below this
BOUNDARY = 1e-4


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


def _images(size, seed=0, batch=2):
    return np.random.default_rng(seed).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)


def _grid(manager):
    return {name: (fn, params) for name, fn, params in manager.augs}


def test_manager_names_and_grids_equal_jax():
    """Names, order and parameters (their types too: the file stems print
    them) equal the JAX manager's, with and without ``exact_jpeg``."""
    for exact in (False, True):
        jm, tm = JManager(exact_jpeg=exact), TManager(exact_jpeg=exact)
        assert tm.names() == jm.names() == ATTACKS
        for (jn, _, jp), (tn, _, tp) in zip(jm.augs, tm.augs):
            assert [repr(p) for p in tp] == [repr(p) for p in jp], jn
        assert sum(len(p) for _, _, p in tm.augs) == 62
        assert tm.exact_jpeg == exact and tm.row_tags == jm.row_tags == {}


def _jpeg_coefficients(module, monkeypatch):
    """Record every input of ``module._st_round`` (the quantized DCT
    coefficients before rounding)."""
    seen = []
    st_round = module._st_round

    def recording(x):
        seen.append(np.asarray(x, np.float64).ravel())
        return st_round(x)

    monkeypatch.setattr(module, "_st_round", recording)
    return seen


def _check_jpeg(x, q, monkeypatch):
    """``jpeg_diff`` at quality ``q``: coefficients that round differently
    must lie on a rounding boundary (JAX's value within ``BOUNDARY`` of
    k + 0.5); with none, pixels agree within ``TOL``, else within the bound
    of one quantization step each (a step moves a pixel by at most
    ``0.25 * table / 255`` per channel, times 1.772 through YCbCr -> RGB).
    Returns (boundary coefficients, flipped coefficients)."""
    jseen, tseen = _jpeg_coefficients(JV, monkeypatch), _jpeg_coefficients(TV, monkeypatch)
    want = np.asarray(JV.jpeg_diff(jnp.asarray(x), q))
    got = TV.jpeg_diff(torch.as_tensor(x), q).numpy()
    assert got.shape == want.shape == x.shape and len(jseen) == len(tseen) == 3
    boundary = flips = 0
    for jc, tc in zip(jseen, tseen):
        np.testing.assert_allclose(tc, jc, atol=1e-3, rtol=1e-5)
        on_edge = np.abs(np.abs(jc - np.floor(jc)) - 0.5) < BOUNDARY
        flipped = np.round(jc) != np.round(tc)
        assert not (flipped & ~on_edge).any(), f"q={q}: a coefficient off any boundary rounded the other way"
        boundary += int(on_edge.sum())
        flips += int(flipped.sum())
    table = max(float(t.max()) for t in JV._quality_tables(q))
    bound = TOL + flips * 0.25 * 1.772 * table / 255.0
    err = float(np.abs(got - want).max())
    assert err <= bound, f"q={q}: max abs err {err} > {bound} ({flips} flips, {boundary} boundary coefficients)"
    return boundary, flips


@pytest.mark.parametrize("size", [8, 24])
@pytest.mark.parametrize("attack", ATTACKS)
def test_attack_cells_match_jax(attack, size, monkeypatch):
    """Every parameter of one attack of the grid, through the managers'
    own functions: float32 within 1e-5 (noise fed JAX's draws; JPEG as
    ``_check_jpeg`` states)."""
    x = _images(size, seed=size)
    (jfn, params), (tfn, tparams) = _grid(JManager())[attack], _grid(TManager())[attack]
    assert tparams == params
    key = jax.random.PRNGKey(7)
    for param in params:
        if attack == "jpeg":
            _check_jpeg(x, param, monkeypatch)
            continue
        want = np.asarray(jfn(jnp.asarray(x), param, key))
        if attack == "gaussian-noise":
            draws = torch.as_tensor(np.array(jax.random.normal(key, x.shape, jnp.float32)))
            got = TV.gaussian_noise(torch.as_tensor(x), float(param), noise=draws).numpy()
        else:
            got = tfn(torch.as_tensor(x), param, None).numpy()
        assert got.shape == want.shape == x.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"{attack} {param}")


@pytest.mark.parametrize("name,args", [("grayscale", ()), ("contrast", (1.7,)), ("contrast", (0.3,)),
                                       ("saturation", (0.2,)), ("saturation", (2.5,)), ("hue", (0.2,)),
                                       ("hue", (-0.45,)), ("median_filter", (3,)), ("median_filter", (5,))])
def test_colour_and_median_match_jax(name, args):
    """The valuemetric functions outside the grid, at 16 px with flat
    patches (grey pixels, ties of the channel max): within 1e-5."""
    x = _images(16, seed=3)
    x[:, :4, :4, :] = 0.5
    x[:, 4:8, :4, 0] = x[:, 4:8, :4, 1]
    want = np.asarray(getattr(JV, name)(jnp.asarray(x), *args))
    got = getattr(TV, name)(torch.as_tensor(x), *args).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("fn", ["upper_left_crop_pad_back", "upper_left_crop_resize_back", "rotate"])
def test_geometric_outside_the_grid_match_jax(fn):
    """Crops padded back, crops resized back at other factors, rotations
    by multiples of 90 and past them (floor division of negative angles)."""
    x = _images(20, seed=4)
    params = {"upper_left_crop_pad_back": (0.33, 0.7, 1.0), "upper_left_crop_resize_back": (0.33, 0.61),
              "rotate": (-270, -100, -90, 90, 135, 180, 200, 359)}[fn]
    for p in params:
        want = np.asarray(getattr(JG, fn)(jnp.asarray(x), p))
        got = getattr(TG, fn)(torch.as_tensor(x), p).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"{fn} {p}")


@pytest.mark.parametrize("quality", [100, 75, 25, 5])
def test_jpeg_pil_exact(quality):
    """PIL's JPEG: the port's bytes in, pixels out, equal to JAX's, back on
    the input's device and dtype."""
    x = _images(24, seed=quality)
    got = TV.jpeg_pil(torch.as_tensor(x), quality)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), JV.jpeg_pil(x, quality))


def test_jpeg_diff_boundary_count(monkeypatch):
    """The count ``_check_jpeg`` states, over the grid's qualities at 32 px
    and four images: boundary coefficients are few, and every flip is one
    of them."""
    x = _images(32, seed=11, batch=4)
    counts = [_check_jpeg(x, q, monkeypatch) for q in JManager().augs[2][2]]
    boundary, flips = (sum(c) for c in zip(*counts))
    assert flips <= boundary < 50, counts


def test_cell_generators_differ_per_param():
    """Each (attack, param) cell draws from a generator of its own, seeded
    from (batch seed, 999, ai * 1000 + pi): two strengths of the noise never
    share their draws (the reference's token-match sweep reused one key),
    and a seed gives the same draws again."""
    seeds = {tpipe.cell_seed(5, ai, pi) for ai in range(7) for pi in range(11)}
    assert len(seeds) == 77 and tpipe.cell_seed(5, 1, 2) != tpipe.cell_seed(6, 1, 2)
    x = torch.full((1, 8, 8, 3), 0.5)
    draws = [TV.gaussian_noise(x, 0.1, torch.Generator().manual_seed(tpipe.cell_seed(5, 1, pi))) for pi in (1, 2, 1)]
    assert not torch.equal(draws[0], draws[1]) and torch.equal(draws[0], draws[2])


# ---------------------------------------------------------------------------
# The slice: fill_batch_log + compute_and_save_batch
# ---------------------------------------------------------------------------

RAR = dict(embed_dim=32, depth=2, num_heads=2, intermediate_size=64, image_seq_len=16, codebook_size=32, num_classes=4)
RAR_VQ = dict(resolution=8, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16, n_embed=32,
              embed_dim=16)
GPT = dict(vocab_size=64, block_size=300, n_layer=2, n_head=2, n_embd=32)
TAMING_VQ = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), z_channels=32,
                 n_embed=64, embed_dim=16)
METHOD = "linear-rand-h=1-d=2.0-g=0.25"


def _rar_pair():
    """Tiny RAR wrappers whose tokenizer weights the bridge carries over
    (the slice never samples, so the generators keep no weights)."""
    vq_cfg = jmg.MaskGitVQConfig(**RAR_VQ)
    vq_params = jmg.MaskGitVQGAN(vq_cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    jw = jarmm.RarARMM(None, jrar.RARConfig(**RAR), vq_params, vq_cfg)
    tw = tarmm.RarARMM(trar.RAR(trar.RARConfig(**RAR)),
                       bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**RAR_VQ)),
                                           jax.tree.map(np.asarray, vq_params)),
                       cache_dtype=torch.float32, device="cpu")
    return jw, tw, 32


def _taming_pair():
    """Tiny Taming wrappers, as ``_rar_pair``."""
    vq_params = jvq.TamingVQGAN(jvq.VQGANConfig(**TAMING_VQ)).init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)))
    # a codebook with the spread of encoder outputs, so nearest() is no near tie
    vq_params["params"]["quantize"]["embedding"] = jnp.asarray(
        np.random.default_rng(6).standard_normal((64, 16)), jnp.float32)
    jw = jarmm.TamingARMM(None, jgpt.GPTConfig(**GPT), vq_params, jvq.VQGANConfig(**TAMING_VQ))
    tw = tarmm.TamingARMM(tgpt.GPT(tgpt.GPTConfig(**GPT)),
                          bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**TAMING_VQ)),
                                                   jax.tree.map(np.asarray, vq_params)),
                          cache_dtype=torch.float32, device="cpu")
    return jw, tw, 64


def _eager(manager):
    """Fill the JAX manager's jit cache with eager calls: the loop then runs
    JAX's own code without compiling 62 programs."""
    manager._jit_cache = {(name, repr(p)): (lambda x, r, fn=fn, p=p: fn(x, p, r))
                          for name, fn, params in manager.augs for p in params}
    return manager


class _JaxDecoder:
    """The port's wrapper with JAX's decoder, so that both attack loops
    start from the same images: what the slice test holds is the attacks,
    the port's re-encodes, detection and the writer. The decoders agree
    within 1e-4 on their own (``test_torch_port_{rar,taming}.py``), which a
    brightness of 3 would triple."""

    def __init__(self, port, jax_wrapper):
        self.port, self.jax_wrapper = port, jax_wrapper

    def __getattr__(self, name):
        return getattr(self.port, name)

    def codes_to_images(self, codes):
        imgs = self.jax_wrapper.codes_to_images(jnp.asarray(np.asarray(codes), jnp.int32))
        return torch.as_tensor(np.array(imgs))


def _read_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json"):
                with open(path) as fh:
                    out[rel] = json.load(fh)
            elif f.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                out[rel] = None
    return out


@pytest.mark.parametrize("model", ["rar", "taming"])
def test_fill_batch_log_and_result_tree_match_jax(model, tmp_path, monkeypatch):
    """The same codes through both packages' attack loop and writer. For
    every cell but noise (each package draws its own): images within 1e-5,
    codes equal on >= 99% of the tokens, and where a row's codes are equal
    its p-value within 1e-6 and its L0 and PSNR equal to JAX's. The trees
    hold the same files; the port's noise cells are finite and in range."""
    jw, tw, vocab = _rar_pair() if model == "rar" else _taming_pair()
    side = tw.codes_size
    jw.set_watermarker(JSpec.from_string(METHOD, vocab_size=vocab, spatial_dim=side))
    tw.set_watermarker(TSpec.from_string(METHOD, vocab_size=vocab, spatial_dim=side))
    codes = np.random.default_rng(2).integers(0, vocab, (3, side * side))
    conds, idx = [0, 1, 0], [1, 1, 2]
    params = jpipe.EvalParams(max_roundtrips=1)
    jlog = jpipe.fill_batch_log(jw, jnp.asarray(codes, jnp.int32), _eager(JManager()), params, jax.random.PRNGKey(9))
    tlog = tpipe.fill_batch_log(_JaxDecoder(tw, jw), torch.as_tensor(codes), TManager(),
                                tpipe.EvalParams(max_roundtrips=1), seed=9)
    assert list(tlog) == list(jlog) == ["roundtrips", *ATTACKS]
    equal_rows = {}
    for transform in jlog:
        for (jp, jc, ji), (tp, tc, ti) in zip(jlog[transform], tlog[transform], strict=True):
            assert repr(tp) == repr(jp) and tc.shape == jc.shape and ti.shape == ji.shape
            if transform == "gaussian-noise":
                assert np.isfinite(ti).all() and ti.min() >= -1 and ti.max() <= 1
                assert tc.min() >= 0 and tc.max() < vocab
                continue
            np.testing.assert_allclose(ti, np.asarray(ji), atol=TOL, rtol=0, err_msg=f"{transform} {tp}")
            agree = float((tc == np.asarray(jc)).mean())
            assert agree >= 0.99, f"{transform} {tp}: codes agree on {agree}"
            equal_rows[(transform, repr(tp))] = (tc == np.asarray(jc)).all(axis=1)
    method = str(tw.watermark_spec)
    # JAX's detection, jitted once: its eager vmap dispatches op by op on every row
    monkeypatch.setattr(jpipe, "detect", jax.jit(jdetect.detect, static_argnums=(0, 1)))
    count = jax.jit(lambda c: jdetect.score_codes(jw.watermark_spec, jw.greenlist, c))
    jrec = jpipe.compute_and_save_batch(jlog, str(tmp_path / "jax"), method, conds, idx, jw.watermark_spec,
                                        jw.greenlist, params)
    trec = tpipe.compute_and_save_batch(tlog, str(tmp_path / "port"), method, conds, idx, tw.watermark_spec,
                                        tw.greenlist, tpipe.EvalParams(max_roundtrips=1))
    assert len(trec) == len(jrec) == 3 * 64
    for n, (j, t) in enumerate(zip(jrec, trec, strict=True)):  # rows of 3 samples, in the log's order
        assert {k: t[k] for k in ("conditioning", "idx", "method", "transform")} == \
               {k: j[k] for k in ("conditioning", "idx", "method", "transform")}
        assert repr(t["param"]) == repr(j["param"])
        key = (t["transform"], repr(t["param"]))
        if key in equal_rows and equal_rows[key][n % 3]:
            codes_n = tlog[t["transform"]][[repr(r[0]) for r in tlog[t["transform"]]].index(key[1])][1][n % 3]
            k, total = count(jnp.asarray(codes_n, jnp.int32))
            want = 1.0 if int(k) == 0 else float(betainc(int(k), 1 + int(total) - int(k), 0.25))
            assert abs(t["pvalue"] - want) <= 1e-12
            assert t["pvalue"] == pytest.approx(j["pvalue"], rel=1e-4) and t["l0"] == j["l0"]
            assert t["psnr"] == pytest.approx(j["psnr"], rel=1e-5, abs=1e-4)
    jtree, ttree = _read_tree(tmp_path / "jax"), _read_tree(tmp_path / "port")
    assert sorted(ttree) == sorted(jtree) and len(ttree) == 3 * 64 * 3
    for rel, v in ttree.items():
        if rel.endswith(".json"):
            assert set(v) == set(jtree[rel]) == {"pvalue", "l0", "psnr"}
