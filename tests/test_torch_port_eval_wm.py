"""Port parity, watermarks through sync: the model zoo (the VAE embedder,
the SAM seg extractor), the trainable WAM pixel model and its train step,
HiDDeN (numpy init and the TorchScript blobs), the baseline bank
(spread spectrum, HiDDeN, the refusing stubs, bit accuracy and p-values),
``eval_wm`` (its grid, CSV rows and grouped summary, the three sync
adapters, the synthetic images) and the examples, against the JAX package
on the CPU.

Tolerances: forward passes within 1e-4 of the largest output (1e-5 for the
small ones); the WAM step's loss terms within 1e-5 relative and its
gradients within 1e-4 of the largest; the CSV rows equal in bit accuracy,
within 1e-4 in log10 p-value and 1e-3 px in corner error; SpreadSpectrum's
carriers and the bit metrics equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wmar_tpu.models.vqgan import VQGANConfig as JVQGANConfig
from wmar_tpu.sync import baselines as jbl
from wmar_tpu.sync import eval_wm as jev
from wmar_tpu.sync import hidden as jh
from wmar_tpu.sync import syncseal as jss
from wmar_tpu.sync import syncseal_models as jsm
from wmar_tpu.sync import syncseal_zoo as jzoo
from wmar_tpu.sync import wam_exact as jwx
from wmar_tpu.sync import wam_model as jwm
from wmar_tpu_torch import bridge
from wmar_tpu_torch.models.vqgan import VQGANConfig
from wmar_tpu_torch.sync import baselines as tbl
from wmar_tpu_torch.sync import eval_wm as tev
from wmar_tpu_torch.sync import hidden as th
from wmar_tpu_torch.sync import syncseal as tss
from wmar_tpu_torch.sync import syncseal_models as tsm
from wmar_tpu_torch.sync import syncseal_zoo as tzoo
from wmar_tpu_torch.sync import wam_exact as twx
from wmar_tpu_torch.sync import wam_model as twm


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the fast tier runs six workers on the
    machine's cores, where torch's default of a thread per core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale, float(np.abs(got - want).max()) / scale


# ---------------------------------------------------------------------------
# The model zoo
# ---------------------------------------------------------------------------

VAE = dict(resolution=32, ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=4)


def test_vae_embedder_matches_jax_and_converts_the_reference_layout():
    """The ``vae*`` embedder against JAX's forward on the same weights (the
    port's numpy init as a Flax tree, which ``bridge`` maps back name for
    name), and the reference's taming-named state dict through
    ``convert_vae_embedder``; ``vae_embedder_config`` gives JAX's."""
    entry = {"encoder": {"resolution": 32, "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4},
             "decoder": {"resolution": 32, "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4,
                         "tanh_out": True}}
    jcfg_, tcfg_ = jzoo.vae_embedder_config(entry, "vae_yuv"), tzoo.vae_embedder_config(entry, "vae_yuv")
    assert dataclasses.asdict(tcfg_) == dataclasses.asdict(jcfg_) and tcfg_.encoder.norm_groups == 16
    model = tzoo.init_vae_embedder(1, tcfg_)
    params = {part: jax.tree.map(lambda t: jnp.asarray(t.numpy()), bridge.flax_tree(getattr(model, part)))
              for part in ("encoder", "decoder")}  # Flax's init compiles for tens of seconds here
    assert bridge.vae_embedder_state_dict(params).keys() == model.state_dict().keys()
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda p, v: jzoo.vae_embedder_forward(p, jcfg_, v))(params, jnp.asarray(x))
    with torch.no_grad():
        _rel_close(model(_t(x)), want)
    ref = {f"{k.split('.', 1)[0]}.{twx.taming_name(k.split('.', 1)[1])}": v for k, v in model.state_dict().items()}
    converted = tzoo.convert_vae_embedder({f"emb.{k}": v for k, v in ref.items()}, tcfg_, prefix="emb.")
    assert all(torch.equal(converted[k], v) for k, v in model.state_dict().items())


SEG_ENTRY = {"encoder": {"patch_size": 8, "embed_dim": 16, "depth": 2, "num_heads": 2, "window_size": 2,
                         "global_attn_indexes": [1]}, "pixel_decoder": {"upscale_stages": [2, 2, 2], "nbits": 8}}


def test_seg_extractor_init_matches_jax_draws_and_forward():
    """The ``sam*`` extractor: ``init_seg_extractor`` draws JAX's numpy tree
    (so the weights are JAX's without the bridge), its forward JAX's, the
    reference layout converts."""
    jcfg_, tcfg_ = jzoo.seg_extractor_config(SEG_ENTRY, 32), tzoo.seg_extractor_config(SEG_ENTRY, 32)
    assert dataclasses.asdict(tcfg_) == dataclasses.asdict(jcfg_)
    assert dataclasses.asdict(tzoo.SAM_TINY) == dataclasses.asdict(jzoo.SAM_TINY)
    model = tzoo.init_seg_extractor(3, tcfg_)
    params = jzoo.init_seg_extractor_params(3, jcfg_)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    want = jax.jit(lambda v: jzoo.seg_extractor_forward(jparams, jcfg_, v))(jnp.asarray(x))
    with torch.no_grad():
        _rel_close(model(_t(x)), want)
    converted = tzoo.convert_seg_extractor({f"x.{k}": v for k, v in model.state_dict().items()}, tcfg_, prefix="x.")
    assert all(torch.equal(converted[k], v) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# The trainable WAM pixel model
# ---------------------------------------------------------------------------

J_WAM = jwm.WAMConfig(nbits=8, hidden=8, latent=16, image_size=32)
T_WAM = twm.WAMConfig(nbits=8, hidden=8, latent=16, image_size=32)


def _wam_pair():
    """The port's init as JAX's Flax trees (``syncseal.flax_tree``; Flax's
    own init compiles for tens of seconds here), read back through
    ``bridge.syncseal_model_state_dict``; the detector head, which Flax
    zero-inits, given weights so the detect path is held."""
    tmodel = twm.WamPixelModel.init(0, T_WAM)
    with torch.no_grad():
        tmodel.extractor.head.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tss.flax_tree(tmodel))
    jmodel = jwm.WamPixelModel(tree["embedder"], tree["extractor"], J_WAM)
    jmodel.embed, jmodel.detect = jax.jit(jmodel.embed), jax.jit(jmodel.detect)
    back = bridge.syncseal_model_state_dict(jax.tree.map(np.asarray, tree))
    assert all(torch.equal(back[k], v) for k, v in tmodel.state_dict().items())
    return jmodel, tmodel


def test_wam_pixel_model_embed_and_detect_match_jax():
    jmodel, tmodel = _wam_pair()
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    msg = np.random.default_rng(3).integers(0, 2, (2, 8)).astype(np.float32)
    with torch.no_grad():
        _rel_close(tmodel.embed(_t(x), _t(msg)), jmodel.embed(jnp.asarray(x), jnp.asarray(msg)), 1e-5)
        _rel_close(tmodel.detect(_t(x)), jmodel.detect(jnp.asarray(x)))
    fresh = twm.WamPixelModel.init(0, T_WAM)
    assert float(fresh.extractor.head.weight.abs().max()) == 0 and float(fresh.embedder.out.weight.abs().max()) > 0


def test_wam_train_step_matches_jax_fed_its_draws():
    """One from-scratch WAM step (Adam): the message, the cut and the noise
    fed from JAX's key; the loss terms and the gradients (captured from the
    same jitted step) match."""
    jmodel, tmodel = _wam_pair()

    def capture(inner):
        return optax.GradientTransformation(
            lambda p: (inner.init(p), jax.tree.map(jnp.zeros_like, p)),
            lambda g, s, p=None: (inner.update(g, s[0], p)[0], (inner.update(g, s[0], p)[1], g)))

    opt = capture(optax.adam(1e-3))
    params = {"embedder": jmodel.embedder_params, "extractor": jmodel.extractor_params}
    step = jax.jit(jwm.make_train_step(J_WAM, opt))
    imgs = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    (_, (_, grads)), metrics = step((params, opt.init(params)), jnp.asarray(imgs), key)
    k_msg, k_mask, k_noise = jax.random.split(key, 3)
    msg = np.asarray(jax.random.bernoulli(k_msg, 0.5, (2, 8))).astype(np.float32)
    cut = np.asarray(jax.random.randint(k_mask, (2, 1, 1, 1), 32 // 4, 3 * 32 // 4)).reshape(2)
    noise = np.asarray(jax.random.normal(k_noise, imgs.shape))
    got = {}
    sgd = torch.optim.SGD(tmodel.parameters(), lr=0.0)
    got = twm.make_train_step(tmodel, sgd)(_t(imgs), msg=_t(msg), cut=_t(cut), noise=_t(noise))
    for k in ("loss", "mask_loss", "bit_loss"):
        assert float(got[k]) == pytest.approx(float(metrics[k]), rel=1e-5), k
    want = bridge.syncseal_model_state_dict(jax.tree.map(np.asarray, grads))
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for name, p in tmodel.named_parameters():
        assert float((p.grad - want[name]).abs().max()) <= 1e-4 * gmax, name


# ---------------------------------------------------------------------------
# HiDDeN and the baselines
# ---------------------------------------------------------------------------

J_HID = jh.HiddenConfig(num_bits=8, channels=8, enc_blocks=2, dec_blocks=3)
T_HID = th.HiddenConfig(num_bits=8, channels=8, enc_blocks=2, dec_blocks=3)


def test_hidden_matches_jax_from_numpy_init_and_torchscript(tmp_path):
    """HiDDeN's encoder and decoder from ``init_hidden`` (JAX's numpy draws)
    match JAX's forward; scripted into TorchScript blobs, both packages
    read them back to the same networks."""
    enc, dec = th.init_hidden(0, T_HID)
    jenc, jdec = jh.init_hidden_params(0, J_HID)
    with torch.no_grad():  # running statistics that are not the identity
        for m in list(enc.modules()) + list(dec.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
                m.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    enc.requires_grad_(False), dec.requires_grad_(False)
    paths = [str(tmp_path / "enc.pt"), str(tmp_path / "dec.pt")]
    torch.jit.script(enc).save(paths[0])
    torch.jit.script(dec).save(paths[1])
    jenc, jdec, jecfg, jdcfg = jh.load_hidden_torchscript(*paths)
    tenc, tdec, tecfg, tdcfg = th.load_hidden_torchscript(*paths)
    assert dataclasses.asdict(tecfg) == dataclasses.asdict(jecfg) and dataclasses.asdict(tdcfg) == dataclasses.asdict(
        jdcfg)
    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    m = np.where(np.random.default_rng(1).integers(0, 2, (2, 8)) > 0, 1.0, -1.0).astype(np.float32)
    xn = jh.normalize(jnp.asarray(x))
    with torch.no_grad():
        _rel_close(tenc(th.normalize(_t(x)), _t(m)), jh.hidden_encoder_forward(jenc, jecfg, xn, jnp.asarray(m)), 1e-5)
        _rel_close(tdec(th.normalize(_t(x))), jh.hidden_decoder_forward(jdec, jdcfg, xn), 1e-5)
    want_enc, _ = jh.init_hidden_params(0, J_HID)
    fresh, _ = th.init_hidden(0, T_HID)
    assert np.array_equal(fresh.conv_bns[0].layers[0].weight.detach().numpy(),
                          np.transpose(want_enc["conv_bns"][0]["conv"]["kernel"], (3, 2, 0, 1)))


@torch.no_grad()
def test_spread_spectrum_carriers_bit_equal_and_baselines_match_jax(monkeypatch):
    """SpreadSpectrum's carriers equal JAX's bit for bit; ``ss`` and
    ``hidden`` (random, 64 px, resized to 32) embed and detect as JAX's;
    ``bit_accuracy`` and ``pvalue`` are JAX's."""
    jss_ = jbl.SpreadSpectrum(nbits=16, img_size=32, seed=3)
    tss_ = tbl.SpreadSpectrum(nbits=16, img_size=32, seed=3)
    assert np.array_equal(tss_.carriers.numpy(), np.asarray(jss_.carriers))
    imgs = np.asarray(jev._synthetic_images(2, 64, 1))
    for name in ("hidden_encoder_forward", "hidden_decoder_forward"):  # JAX's eager ops compile one by one
        monkeypatch.setattr(jh, name, jax.jit(getattr(jh, name), static_argnums=1))
    for method, nbits in (("ss", 16), ("hidden", 8)):
        jb = jbl.build_baseline(method, img_size=32, allow_random=True, nbits=nbits, seed=3)
        tb = tbl.build_baseline(method, img_size=32, allow_random=True, nbits=nbits, seed=3)
        msgs = np.random.default_rng(4).integers(0, 2, (2, nbits))
        je, te = jb.embed(jnp.asarray(imgs), jnp.asarray(msgs)), tb.embed(_t(imgs), _t(msgs))
        _rel_close(te["preds_w"], je["preds_w"], 1e-5)
        diff = np.abs(te["imgs_w"].numpy() - np.asarray(je["imgs_w"]))
        assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1 / 255 + 1e-5, method  # a rounding tie at most
        jp, tp = jb.detect(je["imgs_w"])["preds"], tb.detect(te["imgs_w"])["preds"]
        _rel_close(tp, jp, 1e-4)
        np.testing.assert_array_equal(tbl.bit_accuracy(tp[:, 1:], _t(msgs)).numpy(),
                                      np.asarray(jbl.bit_accuracy(jnp.asarray(tp.numpy()[:, 1:]), jnp.asarray(msgs))))
        np.testing.assert_array_equal(tbl.pvalue(tp[:, 1:], _t(msgs)), jbl.pvalue(jnp.asarray(tp.numpy()[:, 1:]),
                                                                                  jnp.asarray(msgs)))


def test_registry_refuses_as_jax():
    for m in ("mbrs", "cin", "trustmark", "videoseal"):
        with pytest.raises(NotImplementedError):
            tbl.build_baseline(m)
    for m in ("hidden", "wam"):
        with pytest.raises(ValueError):
            tbl.build_baseline(m)
    with pytest.raises(ValueError):
        tbl.build_baseline("nope")


# ---------------------------------------------------------------------------
# eval_wm
# ---------------------------------------------------------------------------

GEOMS = {"identity": [0], "hflip": [0], "rotate": [10], "crop": [0.5], "perspective": [0.2]}


def test_geom_endpoints_and_grids_equal_jax():
    for name, params in jev.GEOM_GRID.items():
        for p in params:
            for tl in (False, True):
                a = jev.geom_endpoints(name, p, np.random.default_rng(5), 3, topleft_crop=tl)
                b = tev.geom_endpoints(name, p, np.random.default_rng(5), 3, topleft_crop=tl)
                np.testing.assert_array_equal(a, b)
    assert tev.GEOM_GRID == jev.GEOM_GRID
    assert sum(len(p) for p in tev.GEOM_GRID.values()) == 21
    assert [(n, s) for n, s, _ in tev.valuemetric_grid()] == [(n, s) for n, s, _ in jev.valuemetric_grid()]
    assert sum(len(s) for _, s, _ in tev.valuemetric_grid()) == 21
    _rel_close(tev._synthetic_images(2, 64, 3), jev._synthetic_images(2, 64, 3), 1e-6)


_JAX_CELLS = {}


def _jitted_grid(only_identity=False, grid=jev.valuemetric_grid):
    """JAX's valuemetric grid with each cell jitted once for the module (its
    eager ops compile one by one)."""
    rows = []
    for name, strengths, fn in grid(only_identity):
        jf = _JAX_CELLS.setdefault(name, jax.jit(lambda x, s, fn=fn: fn(x, s, None), static_argnums=1))
        rows.append((name, strengths, lambda x, s, r, jf=jf: jf(x, s)))
    return rows


def test_valuemetric_grid_cells_match_jax():
    imgs = np.asarray(jev._synthetic_images(2, 64, 0))
    for (name, strengths, tfn), (_, _, jfn) in zip(tev.valuemetric_grid(), _jitted_grid()):
        for s in strengths:
            _rel_close(tfn(_t(imgs), s), jfn(jnp.asarray(imgs), s, None), 1e-5)


def _tiny_syncseal_pair():
    """JAX's ``SyncSealRef.init(0)`` at the tiny widths in both packages,
    its corner head made well posed (the same values in both), so the
    unwarp inverts a near-identity homography."""
    ju = jsm.UNetConfig(z_channels=8, num_blocks=1, z_channels_mults=(1, 2), norm_groups=4)
    tu = tsm.UNetConfig(z_channels=8, num_blocks=1, z_channels_mults=(1, 2), norm_groups=4)
    jc, tc = jsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16)), tsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16))
    tmodel = tss.SyncSealRef.init(0, unet_cfg=tu, convnext_cfg=tc)
    tss.well_posed_head_(tmodel, seed=1)
    jmodel = jss.SyncSealRef.init(0, unet_cfg=ju, convnext_cfg=jc)
    jmodel.embed01 = jax.jit(jmodel.embed01)  # JAX's eager ops compile one by one
    lin = tmodel.extractor.head.linear
    jmodel.convnext_params["head"] = {"w": jnp.asarray(lin.weight.detach().numpy().T),
                                      "b": jnp.asarray(lin.bias.detach().numpy())}
    return jev.SyncSealSync(jmodel), tev.SyncSealSync(tmodel)


@pytest.mark.parametrize("sync_model,only_identity", [("syncseal", True), ("none", False)])
def test_eval_rows_match_jax(sync_model, only_identity, tmp_path, monkeypatch):
    """``--baseline ss`` with the tiny SyncSeal (valuemetric identity) and
    with ``none`` (the full valuemetric grid), over a trimmed geometric grid
    on 2 synthetic 64 px images, JAX's messages fed: the CSV rows equal in
    bit accuracy, within 1e-4 in log10 p-value and 1e-3 px in corner error;
    the summaries equal."""
    imgs = np.asarray(jev._synthetic_images(2, 64, 0))
    jb = jbl.build_baseline("ss", img_size=64, seed=0)
    tb = tbl.build_baseline("ss", img_size=64, seed=0)
    jsync, tsync = _tiny_syncseal_pair() if sync_model == "syncseal" else (None, None)
    msgs = np.asarray(jb.get_random_msg(jax.random.PRNGKey(0), 2))
    monkeypatch.setattr(jev, "valuemetric_grid", _jitted_grid)
    want = jev.evaluate_watermark_with_sync(jb, jsync, jnp.asarray(imgs), str(tmp_path / "j"),
                                            only_identity=only_identity, geoms=GEOMS)
    got = tev.evaluate_watermark_with_sync(tb, tsync, _t(imgs), str(tmp_path / "t"), only_identity=only_identity,
                                           geoms=GEOMS, msgs=_t(msgs))
    assert len(got) == len(want) == 5 * (1 if only_identity else 21)
    for g, w in zip(got, want):
        assert (g["geom_aug"], g["val_aug"]) == (w["geom_aug"], w["val_aug"])
        assert g["bit_accuracy"] == w["bit_accuracy"], g
        assert abs(g["log_pvalue"] - w["log_pvalue"]) <= 1e-4, g
        if sync_model == "none":
            assert np.isnan(g["corner_error"]) and np.isnan(w["corner_error"])
        else:
            assert abs(g["corner_error"] - w["corner_error"]) <= 1e-3, g
    assert tev.grouped_summary(got) == jev.grouped_summary(want)
    header = open(tmp_path / "t" / "watermark_sync_metrics.csv").readline().strip()
    assert header == jev.CSV_HEADER
    if sync_model == "syncseal":
        assert got[0]["val_aug"] == "identity_0" and got[0]["bit_accuracy"] > 0.9


def test_sift_and_wam_sync_adapters(tmp_path, monkeypatch):
    """SIFT's corners as JAX's on the same images (where OpenCV imports);
    the WAM adapter turns ``WamSync``'s estimate into corners as JAX's over
    the mock pixel watermark of the sync tests."""
    pytest.importorskip("cv2")
    from tests.test_torch_port_sync import _mock_syncs

    imgs = np.asarray(jev._synthetic_images(2, 64, 2))
    monkeypatch.setattr(jss, "apply_tv_corner_warp", jax.jit(jss.apply_tv_corner_warp))
    warped = np.asarray(jss.apply_tv_corner_warp(jnp.asarray(imgs), jnp.asarray(
        jev.geom_endpoints("rotate", 10, np.random.default_rng(0), 2))))
    np.testing.assert_allclose(tev.SiftSync().predict_corners(_t(warped), _t(imgs)),
                               jev.SiftSync().predict_corners(jnp.asarray(warped), jnp.asarray(imgs)), atol=1e-6)
    tsync, jsync = _mock_syncs(64)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    x[..., 2] = 0.0
    s01 = ((tsync.add_sync(_t(x)) + 1) / 2).numpy()
    np.testing.assert_allclose(tev.WamSyncBaseline(tsync).predict_corners(_t(s01)),
                               jev.WamSyncBaseline(jsync).predict_corners(jnp.asarray(s01)), atol=1e-6)
    assert isinstance(tev.load_sync("sift"), tev.SiftSync) and tev.load_sync("none") is None
    with pytest.raises(ValueError):
        tev.load_sync("syncseal")


def test_eval_wm_cli_tiny_on_the_cpu(tmp_path, capsys):
    """``python -m wmar_tpu_torch.sync.eval_wm --tiny --device cpu``: the
    CSV, the summary, the rows (5 geometric cells trimmed by the
    valuemetric identity); a missing card without ``--device cpu`` exits."""
    out = str(tmp_path / "o")
    rows = tev.main(["--baseline", "ss", "--sync_model", "syncseal", "--tiny", "--num_samples", "2", "--img_size", "32",
                     "--only_identity", "true", "--device", "cpu", "--output_dir", out])
    assert len(rows) == 21 and os.path.exists(os.path.join(out, "summary.csv"))
    assert len(open(os.path.join(out, "watermark_sync_metrics.csv")).readlines()) == 22
    assert "Grouped Bit Accuracy" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            tev.main(["--baseline", "ss", "--sync_model", "none", "--output_dir", out])


def test_examples_run_tiny_on_the_cpu(tmp_path):
    from wmar_tpu_torch.examples import standalone_sync, train_wam_sync

    out = train_wam_sync.main(["--steps", "2", "--size", "32", "--batch", "2", "--hidden", "8", "--latent", "16",
                               "--device", "cpu"])
    assert all(np.isfinite(v) for row in out["losses"] for v in row.values())
    assert out["reverted"].shape == (1, 32, 32, 3)
    errs = standalone_sync.main(["--outdir", str(tmp_path), "--tiny", "--img_size", "64", "--device", "cpu"])
    assert np.isfinite(errs["ok"]) and os.path.exists(tmp_path / "sync_ok.png")


def test_wam_vqgan_configs_stay_in_step():
    """The zoo's VAE configs are ``models/vqgan.py``'s: the fields JAX's
    ``VQGANConfig`` has, the port's has too."""
    assert {f.name for f in dataclasses.fields(VQGANConfig)} == {f.name for f in dataclasses.fields(JVQGANConfig)}
    assert jwx.NBITS == twx.NBITS
