"""Port parity, the audio codecs (``wmar_tpu_torch.audio.codecs``) against
``wmar_tpu.audio.codecs`` on the CPU.

The state dicts come from the JAX tests' torch oracles (EnCodec in the
encodec package's layout, DAC in descript's, both with ``weight_g`` /
``weight_v``) or from the port's writers (HF's layout, both weight-norm
namings); each goes through both packages' converters and the trees must
be equal bit for bit, then through ``bridge.load_encodec`` / ``load_dac``.

Tolerances (float32 both, relative to the largest value of JAX's output):
latents and decodes within 1e-5; the codes of the two float32 paths may
differ at a near tie of the argmin, so the share of differing codes is at
most 1e-3, each decoder is fed JAX's codes, and the round trip is held
within 1e-5 when no code differs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests import test_audio_codecs_parity as oracle  # noqa: E402
from wmar_tpu.audio import codecs as jc  # noqa: E402
from wmar_tpu_torch import bridge  # noqa: E402
from wmar_tpu_torch.audio import codecs as tc  # noqa: E402

TOL = 1e-5  # of the reference output's scale
FLIPS = 1e-3  # share of codes two float32 argmins may pick differently


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: six test workers with a thread per core each slow
    the many small convolutions down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(cls, jcfg):
    return cls(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


ENC, DAC = _port_cfg(tc.EncodecConfig, oracle.TINY_ENC), _port_cfg(tc.DACConfig, oracle.TINY_DAC)


def _np(sd):
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v) for k, v in sd.items()}


def _same_trees(got, want):
    g, w = dict(bridge.flatten(got)), dict(bridge.flatten(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == np.asarray(w[k]).dtype and np.array_equal(g[k], np.asarray(w[k])), k


def _audio(b, t, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, t, 1)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _flipped(got, want) -> float:
    return float((np.asarray(got) != np.asarray(want)).mean())


def _encodec_oracle_sd(seed=0):
    torch.manual_seed(seed)
    return _np(oracle.EncodecOracle(oracle.TINY_ENC).state_dict())


def _hold_encodec(sd, x):
    jtree = jc.convert_encodec(sd, oracle.TINY_ENC)
    ttree = tc.convert_encodec(sd, ENC)
    _same_trees(ttree, jtree)
    jp = jax.tree.map(jnp.asarray, jtree)
    model = bridge.load_encodec(ttree, ENC)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    z_j = jc.encodec_encode_latent(jp["encoder"], oracle.TINY_ENC, xj)
    codes_j = np.asarray(jc.rvq_encode(jp["codebooks"], z_j))
    with torch.no_grad():
        _close(model.encoder(xt.transpose(1, 2)).transpose(1, 2).numpy(), z_j)
        codes_t = model.encode(xt).numpy()
        assert _flipped(codes_t, codes_j) <= FLIPS
        want = jc.encodec_decode_latent(jp["decoder"], oracle.TINY_ENC, jc.rvq_decode(jp["codebooks"],
                                                                                       jnp.asarray(codes_j)))
        _close(model.decode(torch.from_numpy(codes_j)).numpy(), want)
        if not _flipped(codes_t, codes_j):
            _close(model(xt).numpy(), jc.encodec_roundtrip(jp, oracle.TINY_ENC, xj))
    return model


def test_encodec_encodec_package_layout_matches_jax_and_the_oracle():
    """The oracle's encodec-package layout (``.conv.conv``, weight_g/v):
    JAX's tree bit for bit, JAX's latents, codes and decodes, and the
    oracle's own round trip (3e-4 absolute, JAX's bound against it)."""
    sd = _encodec_oracle_sd()
    x = _audio(2, 256)
    model = _hold_encodec(sd, x)
    torch.manual_seed(0)
    ref = oracle.EncodecOracle(oracle.TINY_ENC).eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   ref(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy(), atol=3e-4)


@pytest.mark.parametrize("weight_norm", [None, "weight_norm", "parametrizations"])
def test_encodec_hf_layout_from_the_port_writer(weight_norm):
    """A random port module written in HF's layout (plain weights and both
    weight-norm namings) converts to JAX's tree and runs as JAX does; the
    module read back equals the one written within float32 rounding of
    ``g * v / ||v||``."""
    src = tc.random_codec(lambda: tc.Encodec(ENC), torch.Generator().manual_seed(3))
    sd = _np(tc.encodec_state_dict(src, "hf", weight_norm))
    assert any(k.startswith("encoder.layers.") for k in sd)
    x = _audio(2, 200, seed=1)
    model = _hold_encodec(sd, x)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), src(torch.from_numpy(x)).numpy(), 1e-6)


def test_weight_norm_namings_compose_alike():
    src = tc.random_codec(lambda: tc.DAC(DAC), torch.Generator().manual_seed(4))
    a = tc.convert_dac(_np(tc.dac_state_dict(src, "weight_norm")), DAC)
    b = tc.convert_dac(_np(tc.dac_state_dict(src, "parametrizations")), DAC)
    _same_trees(a, b)
    _same_trees(a, jc.convert_dac(_np(tc.dac_state_dict(src, "weight_norm")), oracle.TINY_DAC))


def test_reflect_pad_small_input_guard():
    """A clip shorter than the pad: HF's guard zero-extends before the
    reflect (torch's reflect alone refuses it); pad1d, a causal conv and the
    whole EnCodec encode on 3 samples agree with JAX's."""
    x = _audio(2, 3, seed=2)
    for left, right in ((6, 0), (6, 4), (2, 2), (3, 1)):
        want = jc._pad1d(jnp.asarray(x), left, right, "reflect")
        got = tc.pad1d(torch.from_numpy(x).transpose(1, 2), left, right, "reflect").transpose(1, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(RuntimeError):
        torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (6, 0), mode="reflect")
    sd = _encodec_oracle_sd(1)
    jp = jax.tree.map(jnp.asarray, jc.convert_encodec(sd, oracle.TINY_ENC))
    model = bridge.load_encodec(tc.convert_encodec(sd, ENC), ENC)
    conv = model.encoder.conv_in
    with torch.no_grad():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
        _close(got, jc._causal_conv(jp["encoder"]["conv_in"], jnp.asarray(x), 7))
        _close(model.encoder(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy(),
               jc.encodec_encode_latent(jp["encoder"], oracle.TINY_ENC, jnp.asarray(x)))


def _jax_dac_codes(p, cfg, x):
    """``dac_roundtrip``'s projected RVQ, returning its codes."""
    residual = jc.dac_encode_latent(p["encoder"], cfg, x)
    codes = []
    for vq in p["quantizer"][: cfg.n_q]:
        zp = jc._conv1d(vq["in_proj"], residual)
        zp_n = zp / jnp.maximum(jnp.linalg.norm(zp, axis=-1, keepdims=True), 1e-9)
        cb = vq["codebook"]
        cb_n = cb / jnp.maximum(jnp.linalg.norm(cb, axis=-1, keepdims=True), 1e-9)
        idx = jnp.argmin((cb_n ** 2).sum(-1)[None, None] - 2 * jnp.einsum("btd,kd->btk", zp_n, cb_n), axis=-1)
        residual = residual - jc._conv1d(vq["out_proj"], cb[idx])
        codes.append(idx)
    return np.asarray(jnp.stack(codes, axis=1))


def _jax_dac_decode(p, cfg, codes):
    z_hat = sum(jc._conv1d(vq["out_proj"], vq["codebook"][codes[:, q]]) for q, vq in enumerate(p["quantizer"]))
    return jc.dac_decode_latent(p["decoder"], cfg, z_hat)


def test_dac_matches_jax_and_the_oracle():
    """descript's layout from the oracle (weight_g/v, snake alphas, the
    transposed convs with ``ceil(s / 2)`` padding): JAX's tree bit for bit,
    latents, codes, the decoder fed JAX's codes, the round trip, and the
    oracle's (3e-4 absolute)."""
    torch.manual_seed(1)
    ref = oracle.DACOracle(oracle.TINY_DAC).eval()
    sd = _np(ref.state_dict())
    jtree, ttree = jc.convert_dac(sd, oracle.TINY_DAC), tc.convert_dac(sd, DAC)
    _same_trees(ttree, jtree)
    jp = jax.tree.map(jnp.asarray, jtree)
    model = bridge.load_dac(ttree, DAC)
    x = _audio(2, 256, seed=3)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    codes_j = _jax_dac_codes(jp, oracle.TINY_DAC, xj)
    with torch.no_grad():
        _close(model.encoder(xt.transpose(1, 2)).transpose(1, 2).numpy(),
               jc.dac_encode_latent(jp["encoder"], oracle.TINY_DAC, xj))
        codes_t = model.encode(xt).numpy()
        assert _flipped(codes_t, codes_j) <= FLIPS
        _close(model.decode(torch.from_numpy(codes_j)).numpy(), _jax_dac_decode(jp, oracle.TINY_DAC, codes_j))
        out = model(xt).numpy()
        if not _flipped(codes_t, codes_j):
            _close(out, jc.dac_roundtrip(jp, oracle.TINY_DAC, xj))
        np.testing.assert_allclose(out, ref(xt.transpose(1, 2)).transpose(1, 2).numpy(), atol=3e-4)


def test_dac_refuses_a_file_of_other_strides():
    """A strided kernel not ``2 * stride`` wide (a file of other rates) is
    refused, naming both widths; JAX's converter takes it and would run at
    another hop."""
    other = tc.DACConfig(**{**DAC.__dict__, "encoder_rates": (4, 2), "decoder_rates": (2, 4)})
    sd = _np(tc.dac_state_dict(tc.random_codec(lambda: tc.DAC(other), torch.Generator().manual_seed(5))))
    with pytest.raises(ValueError, match=r"encoder\.block\.1\.block\.4: kernel width 8, but the config's stride 2"):
        tc.convert_dac(sd, DAC)
    jc.convert_dac(sd, oracle.TINY_DAC)


def test_codec_compression_pads_to_the_hop(tmp_path):
    """``CodecCompression``: an odd length zero-padded to the hop and cropped
    back, as JAX's wrapper; ``from_checkpoint`` reads a ``.pth`` written by
    ``torch.save`` (DAC) and a ``.safetensors`` (EnCodec, HF layout)."""
    from safetensors.torch import save_file

    x = _audio(1, 101, seed=4)
    torch.manual_seed(1)
    ref = oracle.DACOracle(oracle.TINY_DAC).eval()
    torch.save(ref.state_dict(), tmp_path / "dac.pth")
    dac = tc.CodecCompression.from_checkpoint("dac", str(tmp_path / "dac.pth"), DAC)
    want = jc.CodecCompression("dac", jc.convert_dac(_np(ref.state_dict()), oracle.TINY_DAC), oracle.TINY_DAC)
    _close(dac(torch.from_numpy(x)).numpy(), want(jnp.asarray(x)))
    src = tc.random_codec(lambda: tc.Encodec(ENC), torch.Generator().manual_seed(6))
    sd = tc.encodec_state_dict(src, "hf", "parametrizations")
    save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "encodec.safetensors"))
    enc = tc.CodecCompression.from_checkpoint("encodec", str(tmp_path / "encodec.safetensors"), ENC)
    want = jc.CodecCompression("encodec", jc.convert_encodec(_np(sd), oracle.TINY_ENC), oracle.TINY_ENC)
    out = enc(torch.from_numpy(x))
    assert out.shape == (1, 101, 1)
    _close(out.numpy(), want(jnp.asarray(x)))


def test_full_geometries_convert_as_jax():
    """``ENCODEC_24K`` (14,846,817 parameters and 2 x 1024 x 128 codebook
    entries, HF layout) and ``DAC_24K`` (76,595,169, descript's, weight_g/v)
    written by the port's writers from random modules: JAX's trees, bit for
    bit, and modules loaded at those widths."""
    for cls, cfg, jcfg, write, n_params in (
            (tc.Encodec, tc.ENCODEC_24K, jc.ENCODEC_24K, lambda m: tc.encodec_state_dict(m, "hf"), 15_108_961),
            (tc.DAC, tc.DAC_24K, jc.DAC_24K, tc.dac_state_dict, 76_595_169)):
        src = tc.random_codec(lambda: cls(cfg), torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in src.parameters()) == n_params
        sd = _np(write(src))
        del src
        convert_j, convert_t = (jc.convert_encodec, tc.convert_encodec) if cls is tc.Encodec else \
            (jc.convert_dac, tc.convert_dac)
        ttree = convert_t(sd, cfg)
        _same_trees(ttree, convert_j(sd, jcfg))
        load = bridge.load_encodec if cls is tc.Encodec else bridge.load_dac
        assert sum(p.numel() for p in load(ttree, cfg).parameters()) == n_params
