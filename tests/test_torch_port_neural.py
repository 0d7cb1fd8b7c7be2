"""Port parity of the neural-compression attack bank against the JAX package.

The same weights go into both packages: the numpy trees of each
``init_*_params`` (drawn the same in both) or of each converter, through
``wmar_tpu_torch.bridge``. Inputs come from ``np.random.default_rng``.

Tolerances, relative to the largest value of the reference output (random
codecs at small widths blow reconstructions up to ~1e14, so an absolute
bound would mean nothing):

* compressai (float32 both): latents ``y`` within 5e-5 (~30 float32
  convolutions summed in another order, random weights that grow the
  activations layer by layer); the quantized
  latents' integers may flip where two float32 paths straddle a .5 tie, so
  the share of differing integers is bounded by 1e-3; the synthesis fed
  JAX's own quantized latents within 2e-5; the whole reconstruction within
  2e-5 when no integer flipped; then each likelihood within 0.05 bit
  (mbt2018 and cheng2020 take it of ``y`` itself, which moves by the 5e-5
  above, up to ~1e-3 at |y| ~ 50, and a bin's bits move by up to
  |y - mu| / (sigma^2 ln 2) per unit of y, sigma >= 0.11); the
  bpp within 1e-5 relative, 1e-3 where an integer flipped (a flip moves its
  own bits and, through the 5x5 context, its neighbours').
* KL-VAE and DC-AE (float32): 1e-5 of the output's scale at small widths,
  1e-4 at the published ones (SD-VAE's ~40 convolutions, GroupNorms and
  attention, summed in another order), with JAX's posterior noise fed in
  (``sample_posterior(noise=)``).
* Converters: the port's copies give trees equal bit for bit to JAX's.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from wmar_tpu.augmentations import compressai_jax as jcj  # noqa: E402
from wmar_tpu.augmentations import dcae as jdc  # noqa: E402
from wmar_tpu.augmentations import diffusers_vae as jdv  # noqa: E402
from wmar_tpu.augmentations import manager as jman  # noqa: E402
from wmar_tpu.augmentations import neural as jneural  # noqa: E402
from wmar_tpu_torch import bridge  # noqa: E402
from wmar_tpu_torch.augmentations import compressai_models as cm  # noqa: E402
from wmar_tpu_torch.augmentations import dcae as tdc  # noqa: E402
from wmar_tpu_torch.augmentations import diffusers_vae as tdv  # noqa: E402
from wmar_tpu_torch.augmentations import manager as tman  # noqa: E402
from wmar_tpu_torch.augmentations import neural as tneural  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the fast tier runs six test workers at once, and a
    thread per core in each oversubscribes the cores, so the codecs' many
    small convolutions wait on each other (a cheng2020 oracle case took
    21.6 s against 0.3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 2e-5
Y_REL = 5e-5
BITS = 0.05
BPP_FLIPPED = 1e-3
VAE_PUBLISHED_REL = 1e-4
FLIP_SHARE = 1e-3
TINY_NM = {"cheng2020-anchor": (8, 8), "cheng2020-attn": (8, 8)}


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max()))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.partial(jax.jit, static_argnums=0)
def _jax_run(arch, p, x):
    """JAX's forward (reconstruction, likelihoods), its latents ``y``, their
    quantized ``y_hat`` and the synthesis of that ``y_hat``: one program."""
    rec, liks = jcj.FORWARDS[arch](p, x)
    if arch.startswith("cheng"):
        attn = arch == "cheng2020-attn"
        y = jcj._cheng_g_a(p["g_a"], x, attn)
        y_hat = jcj.st_round(y)
        return rec, liks, y, y_hat, jcj._cheng_g_s(p["g_s"], y_hat, attn)
    y = jcj._g_a(p["g_a"], x)
    if arch == "bmshj2018-factorized":
        y_hat, _ = jcj.entropy_bottleneck(p["eb"], y)
    elif arch == "mbt2018-mean":
        _, _, gparams = jcj._mean_scale_hyper(p, y)
        means = jnp.split(gparams, 2, axis=-1)[1]
        y_hat = jcj.st_round(y - means) + means
    else:
        y_hat = jcj.st_round(y)
    return rec, liks, y, y_hat, jcj._g_s(p["g_s"], y_hat)


def _port_latents(arch, model, x):
    y = model.g_a(x)
    if arch == "bmshj2018-factorized":
        y_hat, _ = model.eb(y)
    elif arch == "mbt2018-mean":
        means = model.hyper(y)[1].chunk(2, dim=1)[1]
        y_hat = cm.st_round(y - means) + means
    else:
        y_hat = cm.st_round(y)
    return y, y_hat


def _hold_codec(arch, tree_j, tree_t, x):
    """The whole compressai comparison of one codec on ``x`` (NHWC numpy);
    returns the share of flipped latent integers."""
    pj = _jax_tree(tree_j)
    model = bridge.load_compressai(arch, tree_t)
    rec_j, liks_j, y_j, yhat_j, synth_j = _jax_run(arch, pj, jnp.asarray(x))
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    with torch.no_grad():
        rec_t, liks_t = model(_nchw(x))
        y_t, yhat_t = _port_latents(arch, model, _nchw(x))
        synth_t = model.synthesis(_nchw(yhat_j))
    assert _rel(_nhwc(y_t), y_j) <= Y_REL, arch
    flipped = np.abs(_nhwc(yhat_t) - np.asarray(yhat_j)) > 0.25
    share = float(flipped.mean())
    assert share <= FLIP_SHARE, (arch, share)
    assert _rel(_nhwc(synth_t), synth_j) <= REL, arch
    if share == 0:
        assert _rel(_nhwc(rec_t), rec_j) <= REL, arch
        for lt, lj in zip(liks_t, liks_j):
            bits = np.abs(np.log2(_nhwc(lt).astype(np.float64)) - np.log2(np.asarray(lj, np.float64)))
            assert bits.max() <= BITS, (arch, bits.max())
    bpp_j = float(jcj.bpp_from_likelihoods(liks_j, num_pixels))
    bpp_t = float(cm.bpp_from_likelihoods(liks_t, num_pixels))
    print(f"{arch}: flipped {share:.2e}, bpp {bpp_t} against {bpp_j}")
    assert abs(bpp_t - bpp_j) <= (1e-5 if share == 0 else BPP_FLIPPED) * max(1.0, abs(bpp_j)), (arch, bpp_t, bpp_j)
    return share


@pytest.mark.parametrize("arch", list(cm.FORWARDS))
def test_compressai_family_matches_jax(arch):
    """Each family at small widths (JAX's tests' (8, 12) / (8) for cheng),
    the numpy draws of ``init_compressai_params`` (equal in both packages),
    two 64 px images."""
    n, m = TINY_NM.get(arch, (8, 12))
    tree_j = jneural.init_compressai_params(3, arch, n, m)
    tree_t = tneural.init_compressai_params(3, arch, n, m)
    jax.tree.map(np.testing.assert_array_equal, tree_t, tree_j)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _hold_codec(arch, tree_j, tree_t, x)


def test_published_width_codec_matches_jax():
    """cheng2020-attn-q=1 at its published width (N = 128), as the bank
    builds it with random weights, on one 64 px image."""
    arch = "cheng2020-attn"
    n, m = cm.quality_nm(arch, 1)
    assert (n, m) == jcj.quality_nm(arch, 1) == (128, 128)
    tree = tneural.init_compressai_params(0, arch, n, m)
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    _hold_codec(arch, tree, tree, x)


# ---------------------------------------------------------------------------
# KL-VAE
# ---------------------------------------------------------------------------


def _kl_cfg(module, use_quant):
    return module.KLVAEConfig(block_out_channels=(8, 16), layers_per_block=2, latent_channels=4, norm_num_groups=4,
                              use_quant_conv=use_quant)


@pytest.mark.parametrize("use_quant", [True, False])
def test_kl_vae_matches_jax_with_its_noise(use_quant):
    """encode, the posterior draw fed JAX's noise, decode: with and without
    the quant convs (FLUX has none)."""
    cfg_j, cfg_t = _kl_cfg(jdv, use_quant), _kl_cfg(tdv, use_quant)
    tree = tdv.init_kl_vae_params(4, cfg_t)
    jax.tree.map(np.testing.assert_array_equal, tree, jdv.init_kl_vae_params(4, cfg_j))
    assert ("quant_conv" in tree) == use_quant
    x = np.random.default_rng(5).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    pj = _jax_tree(tree)
    key = jax.random.PRNGKey(7)
    moments_j, want = jax.jit(lambda p, x: (jdv.encode(p, cfg_j, x), jdv.kl_vae_forward(p, cfg_j, x, key)))(
        pj, jnp.asarray(x))
    noise = jax.random.normal(key, moments_j[..., :4].shape, jnp.float32)
    model = bridge.load_kl_vae(cfg_t, tree)
    with torch.no_grad():
        moments_t = model.encode(_nchw(x))
        got = tdv.kl_vae_roundtrip(model, _nchw(x), noise=_nchw(noise))
    assert _rel(_nhwc(moments_t), moments_j) <= 1e-5
    assert _rel(_nhwc(got), want) <= 1e-5


def test_fault_h_jax_kl_vae_cells_reuse_one_noise():
    """Fault (h) of the JAX package, pinned: its manager's ``_run_codec``
    drops the cell's key, so a KL-VAE draws its posterior noise from
    ``PRNGKey(0)`` in every cell and batch. The port's manager hands the
    cell's generator to the codec: two cells draw two noises. Fed JAX's
    ``PRNGKey(0)`` draw, the port gives JAX's output."""
    cfg_j, cfg_t = _kl_cfg(jdv, True), _kl_cfg(tdv, True)
    tree = tdv.init_kl_vae_params(0, cfg_t)
    jcodec = jdv.DiffusersCompression("diffusers-sd-vae-ft-ema", cfg_j, tree)
    jm = jman.AugmentationManager(include_neural_compress=True, nc_models={"diffusers-sd-vae-ft-ema": jcodec})
    x = np.random.default_rng(6).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    one = np.asarray(jm._run_codec(jnp.asarray(x), "diffusers-sd-vae-ft-ema", jax.random.PRNGKey(11)))
    two = np.asarray(jm._run_codec(jnp.asarray(x), "diffusers-sd-vae-ft-ema", jax.random.PRNGKey(12)))
    np.testing.assert_array_equal(one, two)  # the cell's key never reaches the codec

    tcodec = tdv.DiffusersCompression("diffusers-sd-vae-ft-ema", cfg_t, bridge.load_kl_vae(cfg_t, tree))
    tm = tman.AugmentationManager(nc_models={"diffusers-sd-vae-ft-ema": tcodec})
    xt = torch.from_numpy(x)
    a = tm._run_codec(xt, "diffusers-sd-vae-ft-ema", torch.Generator().manual_seed(11)).numpy()
    b = tm._run_codec(xt, "diffusers-sd-vae-ft-ema", torch.Generator().manual_seed(12)).numpy()
    assert np.abs(a - b).max() > 1e-3
    assert tm.row_tags[("neural-compress", "diffusers-sd-vae-ft-ema")] == {"bpp": 2.0}
    with torch.no_grad():
        shape = _nhwc(tcodec.model.encode(_nchw(x))).shape[:3] + (cfg_t.latent_channels,)
        noise = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
        fed = tdv.kl_vae_roundtrip(tcodec.model, _nchw(x), noise=_nchw(noise))
    assert _rel(np.clip(_nhwc(fed), 0, 1), one) <= 1e-5


# ---------------------------------------------------------------------------
# DC-AE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,down,up,size", [
    ([1, 1, 1], "conv", "interpolate", 32),
    ([1, 1, 1], "pixel_unshuffle", "pixel_shuffle", 32),
    ([0, 1, 1], "conv", "pixel_shuffle", 32),  # the deep (downsampling) stem
    ([0, 1, 1], "pixel_unshuffle", "interpolate", 32),
    ([1, 1, 1], "conv", "interpolate", 8),  # the quadratic attention
])
def test_dcae_matches_jax(layers, down, up, size):
    """Encode and decode at the JAX tests' small geometry: both stems, both
    down modes, both up modes, linear and quadratic attention."""
    args = (["ResBlock", "ResBlock", "EfficientViTBlock"], [8, 16, 16], layers, [(), (), (5,)])
    kw = dict(latent_channels=4, attention_head_dim=4, downsample_block_type=down, upsample_block_type=up)
    cfg_j, cfg_t = jdc.DCAEConfig.from_diffusers(*args, **kw), tdc.DCAEConfig.from_diffusers(*args, **kw)
    tree = tdc.init_dcae_params(8, cfg_t)
    jax.tree.map(np.testing.assert_array_equal, tree, jdc.init_dcae_params(8, cfg_j))
    x = np.random.default_rng(9).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    pj = _jax_tree(tree)
    z_j = jax.jit(lambda p, x: jdc.dcae_encode(p, cfg_j, x))(pj, jnp.asarray(x))
    y_j = jax.jit(lambda p, z: jdc.dcae_decode(p, cfg_j, z))(pj, z_j)
    model = bridge.load_dcae(cfg_t, tree)
    with torch.no_grad():
        z_t = model.encode(_nchw(x))
        y_t = model.decode(_nchw(z_j))
    assert _rel(_nhwc(z_t), z_j) <= 1e-5
    assert _rel(_nhwc(y_t), y_j) <= 1e-5


# ---------------------------------------------------------------------------
# converters: the JAX tests' torch oracles' state dicts
# ---------------------------------------------------------------------------


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _equal_trees(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)


@pytest.mark.parametrize("arch", list(cm.FORWARDS))
def test_convert_compressai_matches_jax_and_the_oracle(arch):
    """``convert_compressai`` on the oracle's zoo-layout state dict gives
    JAX's tree bit for bit; the port's module from it reconstructs the
    oracle's output (2e-4, the JAX package's own bound against it) and its
    bpp."""
    from tests import test_compressai_parity as oracle

    ctor = {"bmshj2018-factorized": lambda: oracle.FactorizedPrior(8, 12),
            "bmshj2018-hyperprior": lambda: oracle.ScaleHyperprior(8, 12),
            "mbt2018-mean": lambda: oracle.MeanScaleHyperprior(8, 12),
            "mbt2018": lambda: oracle.JointAutoregressive(8, 12),
            "cheng2020-anchor": lambda: oracle.Cheng2020Anchor(8),
            "cheng2020-attn": lambda: oracle.Cheng2020Attention(8)}[arch]
    torch.manual_seed(42)
    ref = ctor().eval()
    sd = _sd(ref)
    tree = cm.convert_compressai(sd, arch)
    _equal_trees(tree, jcj.convert_compressai(sd, arch))
    torch.manual_seed(0)
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        want, liks_ref = ref(x)
        got, liks = bridge.load_compressai(arch, tree)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    bpp, bpp_ref = float(cm.bpp_from_likelihoods(liks, 2 * 64 * 64)), oracle.bpp_of(liks_ref, 2 * 64 * 64)
    assert abs(bpp - bpp_ref) < 1e-3 * max(1.0, abs(bpp_ref))


@pytest.mark.parametrize("use_quant", [True, False])
def test_convert_kl_vae_matches_jax_and_the_oracle(use_quant):
    from tests import test_diffusers_vae_parity as oracle

    cfg = _kl_cfg(tdv, use_quant)
    torch.manual_seed(0)
    ref = oracle.TinyAutoencoderKL(cfg).eval()
    sd = _sd(ref)
    tree = tdv.convert_kl_vae(sd, cfg)
    _equal_trees(tree, jdv.convert_kl_vae(sd, _kl_cfg(jdv, use_quant)))
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    model = bridge.load_kl_vae(cfg, tree)
    with torch.no_grad():
        moments = ref.enc_forward(x)
        np.testing.assert_allclose(model.encode(x).numpy(), moments.numpy(), atol=2e-4)
        mean = moments.chunk(2, 1)[0]
        np.testing.assert_allclose(model.decode(mean).numpy(), ref.dec_forward(mean).numpy(), atol=2e-4)


@pytest.mark.parametrize("layers,down,up,deep_first", [
    ([1, 1, 1], "conv", "interpolate", False),
    ([1, 1, 1], "conv", "interpolate", True),
    ([0, 1, 1], "pixel_unshuffle", "pixel_shuffle", True),
])
def test_convert_dcae_matches_jax_and_the_oracle(layers, down, up, deep_first):
    """The shape-driven converter on the oracle's AutoencoderDC: JAX's tree
    and config, and the oracle's latents and reconstruction (3e-4, JAX's
    bound against it), both storage orders of the up blocks."""
    from tests import test_dcae_parity as oracle

    torch.manual_seed(0)
    ref = oracle._randomize(oracle.AutoencoderDC(layers, down, up, deep_first), 1).eval()
    sd = _sd(ref)
    tree, cfg = tdc.convert_dcae(sd, attention_head_dim=oracle.HEAD_DIM)
    tree_j, cfg_j = jdc.convert_dcae(sd, attention_head_dim=oracle.HEAD_DIM)
    _equal_trees(tree, tree_j)
    assert dataclasses_equal(cfg, cfg_j)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(2)) * 2 - 1
    model = bridge.load_dcae(cfg, tree)
    with torch.no_grad():
        z_ref = ref.encoder(x)
        np.testing.assert_allclose(model.encode(x).numpy(), z_ref.numpy(), atol=3e-4)
        np.testing.assert_allclose(model.decode(z_ref).numpy(), ref.decoder(z_ref).numpy(), atol=3e-4)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# weights files, refusals, the bank, row tags
# ---------------------------------------------------------------------------


def test_msgpack_from_jax_and_pth_load(tmp_path):
    """A ``{name}.msgpack`` the JAX package wrote (published widths) loads
    into the port through its own reader, weights bit for bit; a compressai
    ``.pth`` converts on the fly and reconstructs as the oracle; a
    ``.safetensors`` KL-VAE loads through the port's reader."""
    from safetensors.torch import save_file

    from tests import test_compressai_parity as oracle
    from tests import test_diffusers_vae_parity as kl_oracle
    from wmar_tpu.utils import checkpoint as jckpt

    name = "bmshj2018-factorized-q=1"
    tree = jneural.init_compressai_params(5, "bmshj2018-factorized", *jcj.quality_nm("bmshj2018-factorized", 1))
    jckpt.save_pytree(str(tmp_path / f"{name}.msgpack"), tree)
    codec = tneural.NeuralCompression.from_name(name, weights_dir=str(tmp_path))
    assert not codec.random_weights
    want = bridge.load_compressai("bmshj2018-factorized", tree)
    for (k, a), (_, b) in zip(codec.model.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k

    torch.manual_seed(0)
    ref = oracle.FactorizedPrior(8, 12).eval()
    torch.save(ref.state_dict(), tmp_path / "bmshj2018-factorized-q=3.pth")
    codec = tneural.NeuralCompression.from_name("bmshj2018-factorized-q=3", weights_dir=str(tmp_path))
    assert not codec.random_weights
    x = torch.rand(1, 64, 64, 3)
    with torch.no_grad():
        rec_ref, _ = ref(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(codec(x).numpy(), np.clip(_nhwc(rec_ref), 0, 1), atol=2e-4)

    cfg = tdv.KLVAEConfig.for_name("diffusers-sd-vae-ft-ema")
    small = tdv.KLVAEConfig((8, 16), 2, 4, kl_oracle.GROUPS, True, cfg.nominal_bpp)
    torch.manual_seed(1)
    kl = kl_oracle.TinyAutoencoderKL(small).eval()
    save_file({k: v.contiguous() for k, v in kl.state_dict().items()}, str(tmp_path / "vae.safetensors"))
    sd = tneural.read_state_dict(str(tmp_path / "vae.safetensors"))
    model = bridge.load_kl_vae(small, tdv.convert_kl_vae(sd, small))
    with torch.no_grad():
        np.testing.assert_allclose(model.encode(x.permute(0, 3, 1, 2)).numpy(),
                                   kl.enc_forward(x.permute(0, 3, 1, 2)).numpy(), atol=2e-4)


def test_refusals_skips_and_row_tags(tmp_path, capsys):
    """Without weights every family refuses (``RandomWeightsError``); the
    bank skips such codecs and checkpoints whose layout does not convert,
    and lets any other error through; a random codec warns, is tagged, and
    its rows carry ``random_weights`` and the call's bpp."""
    for name in ("bmshj2018-factorized-q=3", "diffusers-flux", "diffusers-deep-compression"):
        with pytest.raises(tneural.RandomWeightsError):
            tneural.NeuralCompression.from_name(name, weights_dir=str(tmp_path))
    assert tneural.build_codec_bank(names=tneural.REFERENCE_CODEC_NAMES[:2]) == {}
    torch.save({"g_a.0.weight": torch.zeros(3, 3, 5, 5)}, tmp_path / "mbt2018-q=1.pth")  # not a whole checkpoint
    assert tneural.build_codec_bank(names=["mbt2018-q=1"], weights_dir=str(tmp_path)) == {}
    out = capsys.readouterr().out
    assert out.count("skipping codec") == 3 and "KeyError" in out

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    real = tneural.NeuralCompression.from_name
    tneural.NeuralCompression.from_name = staticmethod(broken)
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            tneural.build_codec_bank(names=["bmshj2018-factorized-q=1"], allow_random=True)
    finally:
        tneural.NeuralCompression.from_name = real

    def bad_init(*a, **k):
        raise ValueError("the random init disagrees with the module's widths")

    for module, init, name in ((tneural, "init_compressai_params", "bmshj2018-factorized-q=1"),
                               (tdv, "init_kl_vae_params", "diffusers-flux"),
                               (tdc, "init_dcae_params", "diffusers-deep-compression")):
        with pytest.MonkeyPatch.context() as mp:  # a random build that fails is a bug, not a skipped codec
            mp.setattr(module, init, bad_init)
            with pytest.raises(ValueError, match="widths"):
                tneural.build_codec_bank(names=[name], allow_random=True)

    assert tneural.REFERENCE_CODEC_NAMES == jneural.REFERENCE_CODEC_NAMES and len(tneural.REFERENCE_CODEC_NAMES) == 22
    bank = tneural.build_codec_bank(names=["bmshj2018-factorized-q=1", "diffusers-deep-compression"],
                                    allow_random=True)
    assert "RANDOM" in capsys.readouterr().out and all(c.random_weights for c in bank.values())
    assert bank["diffusers-deep-compression"].cfg == tdc.DCAEConfig.tiny(deep_stem=True)  # JAX's random slot
    m = tman.AugmentationManager(nc_models=bank)
    assert m.names()[-1] == "neural-compress" and m.augs[-1][2] == sorted(bank)
    assert m.row_tags == {("neural-compress", n): {"random_weights": True} for n in bank}
    x = torch.rand(2, 32, 32, 3)
    for name in bank:
        out = m.augs[-1][1](x, name, torch.Generator().manual_seed(0))
        assert out.shape == x.shape and 0 <= float(out.min()) and float(out.max()) <= 1
    tags = m.row_tags
    assert tags[("neural-compress", "diffusers-deep-compression")] == {"random_weights": True, "bpp": 1.0}
    bpp = tags[("neural-compress", "bmshj2018-factorized-q=1")]["bpp"]
    assert np.isfinite(bpp) and bpp >= 0
    assert tman.AugmentationManager(nc_models={}).names()[-1] == "upperleft-crop"  # no codecs, no cells


@pytest.mark.slow
def test_all_22_codecs_at_published_widths_match_jax():
    """Every codec of the bank as ``from_name(allow_random=True)`` builds it
    in both packages (published widths; DC-AE JAX's tiny random slot) on
    one 64 px image: compressai held as above, the KL-VAEs fed JAX's
    ``PRNGKey(0)`` draw, DC-AE deterministic."""
    x = np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    for name in tneural.REFERENCE_CODEC_NAMES:
        jc = jneural.NeuralCompression.from_name(name, allow_random=True)
        tc = tneural.NeuralCompression.from_name(name, allow_random=True)
        assert jc.random_weights and tc.random_weights
        if not name.startswith("diffusers"):
            arch, q = cm.parse_codec_name(name)
            tree = tneural.init_compressai_params(0, arch, *cm.quality_nm(arch, q))
            _hold_codec(arch, tree, tree, x)
            continue
        want, bpp = jc(jnp.asarray(x), return_bpp=True)
        with torch.no_grad():
            if isinstance(tc.cfg, tdv.KLVAEConfig):
                moments = tc.model.encode(_nchw(x))
                noise = jax.random.normal(jax.random.PRNGKey(0), _nhwc(moments).shape[:3] + (tc.cfg.latent_channels,))
                got = tdv.kl_vae_roundtrip(tc.model, _nchw(x), noise=_nchw(noise))
                got = np.clip(_nhwc(got), 0, 1)
            else:
                got, tbpp = tc(torch.from_numpy(x), return_bpp=True)
                got = got.numpy()
                assert float(tbpp) == float(bpp) == 1.0
        assert _rel(got, want) <= VAE_PUBLISHED_REL, name
