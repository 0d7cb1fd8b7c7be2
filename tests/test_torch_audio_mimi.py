"""Port parity, the Mimi codec (``wmar_tpu_torch.audio.mimi``) against
``wmar_tpu.audio.mimi`` on the CPU, at the audio eval's ``--tiny`` config
with JAX's parameters carried over by ``bridge.load_mimi``.

Tolerances: codes equal (the RVQ's nearest-code search; a mismatch reports
the distance gap at the first differing code); ``decode`` within 1e-5;
``convert_mimi`` equal to JAX's, leaf for leaf, on a synthetic state dict
in the released layout, and the port's Mimi on those weights gives JAX's
codes. The frame counts follow JAX's padding arithmetic: ``T`` samples
encode to ``T // hop`` frames, ``F`` frames decode to ``F * hop`` samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.audio import mimi as jmimi
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import audio_eval, bridge
from wmar_tpu_torch.audio import mimi as tmimi

TINY = audio_eval.TINY_MIMI


@pytest.fixture(scope="module")
def codec():
    jcfg = jmimi.MimiConfig(**TINY)
    m = jmimi.Mimi(jcfg)
    variables = jax.jit(m.init)(jax.random.PRNGKey(1), jnp.zeros((1, jcfg.hop_length * 4, 1)))
    enc = jax.jit(lambda v, a: m.apply(v, a, method=jmimi.Mimi.encode))
    dec = jax.jit(lambda v, c: m.apply(v, c, method=jmimi.Mimi.decode))
    with torch.device("meta"):
        model = tmimi.Mimi(tmimi.MimiConfig(**TINY))
    port = bridge.load_mimi(model.to_empty(device="cpu"), jax.tree.map(np.asarray, variables))
    return jcfg, variables, enc, dec, port


def _assert_codes_equal(port, audio, got, want):
    """Equal codes; where one differs, report the distance gap of the port's
    RVQ between its choice and JAX's at that code."""
    if np.array_equal(got, want):
        return
    b, q, f = np.argwhere(got != want)[0]
    z = port._to_latent(torch.from_numpy(audio))
    rvq = port.rvq_first if q < port.cfg.n_q_semantic else port.rvq_rest
    residual = rvq.input_proj(z).float()
    first = 0 if q < port.cfg.n_q_semantic else port.cfg.n_q_semantic
    for level in range(q - first):
        residual = residual - rvq.codebooks[level][torch.from_numpy(got[:, first + level])]
    emb = rvq.codebooks[q - first]
    d = (emb**2).sum(-1) - 2.0 * residual @ emb.T
    gap = float(d[b, f, want[b, q, f]] - d[b, f, got[b, q, f]])
    raise AssertionError(f"{int((got != want).sum())} codes differ; first at row {b} level {q} frame {f}: "
                         f"distance gap {gap:.3e} between JAX's code and the port's")


@pytest.mark.parametrize("frames,extra", [(40, 0), (40, 7), (1, 3)])
def test_codes_exact_and_decode(codec, frames, extra):
    jcfg, variables, enc, dec, port = codec
    t = frames * jcfg.hop_length + extra
    audio = np.clip(np.random.default_rng(frames + extra).standard_normal((2, t, 1)) * 0.3, -1, 1).astype(np.float32)
    want = np.array(enc(variables, jnp.asarray(audio)))
    got = port.encode(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, jcfg.n_q, t // jcfg.hop_length)
    _assert_codes_equal(port, audio, got, want)
    pcm = port.decode(torch.from_numpy(want)).numpy()
    ref = np.asarray(dec(variables, jnp.asarray(want)))
    assert pcm.shape == ref.shape == (2, frames * jcfg.hop_length, 1)
    np.testing.assert_allclose(pcm, ref, atol=1e-5, rtol=0)


def test_msgpack_route(codec, tmp_path):
    """A Mimi msgpack the JAX package wrote loads through the entry point's reader."""
    jcfg, variables, enc, dec, port = codec
    path = str(tmp_path / "mimi.msgpack")
    jckpt.save_pytree(path, variables)
    loaded = audio_eval.load_mimi_model(path, tmimi.MimiConfig(**TINY), "cpu")
    for (name, a), b in zip(loaded.named_parameters(), port.parameters()):
        assert torch.equal(a, b), name


def _mimi_sd(cfg, seed=0):
    """A random state dict in the released Mimi layout for ``cfg``."""
    g = np.random.default_rng(seed)
    r = lambda *s: (0.2 * g.standard_normal(s)).astype(np.float32)  # noqa: E731
    sd = {}

    def conv(p, o, i, k, bias=True):
        sd[p + ".weight"] = r(o, i, k) / np.sqrt(i * k)
        if bias:
            sd[p + ".bias"] = r(o)

    def block(p, dim):
        conv(f"{p}.1.conv.conv", dim // 2, dim, cfg.residual_kernel_size)
        conv(f"{p}.3.conv.conv", dim, dim // 2, 1)

    nf = cfg.n_filters
    conv("encoder.model.0.conv.conv", nf, cfg.channels, cfg.kernel_size)
    idx, mult = 1, 1
    for ratio in reversed(cfg.ratios):
        for _ in range(cfg.n_residual_layers):
            block(f"encoder.model.{idx}.block", mult * nf)
            idx += 1
        idx += 1
        conv(f"encoder.model.{idx}.conv.conv", mult * nf * 2, mult * nf, 2 * ratio)
        idx, mult = idx + 1, mult * 2
    conv(f"encoder.model.{idx + 1}.conv.conv", cfg.dimension, mult * nf, cfg.last_kernel_size)
    conv("decoder.model.0.conv.conv", mult * nf, cfg.dimension, cfg.kernel_size)
    idx = 1
    for ratio in cfg.ratios:
        idx += 1
        sd[f"decoder.model.{idx}.convtr.convtr.weight"] = r(mult * nf, mult * nf // 2, 2 * ratio) / np.sqrt(mult * nf)
        sd[f"decoder.model.{idx}.convtr.convtr.bias"] = r(mult * nf // 2)
        idx += 1
        for _ in range(cfg.n_residual_layers):
            block(f"decoder.model.{idx}.block", mult * nf // 2)
            idx += 1
        mult //= 2
    conv(f"decoder.model.{idx + 1}.conv.conv", cfg.channels, nf, cfg.last_kernel_size)
    d, ff = cfg.dimension, cfg.transformer_ff or 4 * cfg.dimension
    for prefix in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.transformer_layers):
            p = f"{prefix}.transformer.layers.{i}"
            sd.update({p + ".norm1.weight": 1 + r(d), p + ".norm1.bias": r(d), p + ".norm2.weight": 1 + r(d),
                       p + ".norm2.bias": r(d), p + ".self_attn.in_proj_weight": r(3 * d, d) / np.sqrt(d),
                       p + ".self_attn.out_proj.weight": r(d, d) / np.sqrt(d), p + ".linear1.weight": r(ff, d),
                       p + ".linear2.weight": r(d, ff) / np.sqrt(ff), p + ".layer_scale_1.scale": r(d),
                       p + ".layer_scale_2.scale": r(d)})
    for name, n_q in (("rvq_first", cfg.n_q_semantic), ("rvq_rest", cfg.n_q - cfg.n_q_semantic)):
        p = f"quantizer.{name}"
        sd[p + ".input_proj.weight"] = r(cfg.codebook_dim, d, 1) / np.sqrt(d)
        sd[p + ".output_proj.weight"] = r(d, cfg.codebook_dim, 1)
        for q in range(n_q):
            usage = g.uniform(0.5, 2.0, cfg.cardinality).astype(np.float32)
            sd[f"{p}.vq.layers.{q}._codebook.embedding_sum"] = r(cfg.cardinality, cfg.codebook_dim) * usage[:, None]
            sd[f"{p}.vq.layers.{q}._codebook.cluster_usage"] = usage
    sd["downsample.conv.conv.conv.weight"] = r(d, d, 2 * cfg.downsample) / np.sqrt(d)
    sd["upsample.convtr.convtr.convtr.weight"] = r(d, 1, 2 * cfg.downsample)
    return sd


def test_convert_mimi(codec):
    jcfg, _, enc, dec, _ = codec
    sd = _mimi_sd(jcfg)
    want = jmimi.convert_mimi(sd, jcfg)
    got = tmimi.convert_mimi({k: torch.from_numpy(v) for k, v in sd.items()}, tmimi.MimiConfig(**TINY))
    jleaves, tleaves = dict(bridge.flatten(want)), dict(bridge.flatten(got))
    assert sorted(jleaves) == sorted(tleaves)
    for path, leaf in jleaves.items():
        np.testing.assert_array_equal(tleaves[path], np.asarray(leaf), err_msg=path)
    # the port's Mimi on the converted weights (the transposed convs' flipped kernels included) gives JAX's codes
    with torch.device("meta"):
        model = tmimi.Mimi(tmimi.MimiConfig(**TINY))
    port = bridge.load_mimi(model.to_empty(device="cpu"), got)
    audio = np.clip(np.random.default_rng(9).standard_normal((2, 24 * jcfg.hop_length, 1)) * 0.3, -1, 1)
    audio = audio.astype(np.float32)
    jv = jax.tree.map(jnp.asarray, want)
    want_codes = np.array(enc(jv, jnp.asarray(audio)))
    _assert_codes_equal(port, audio, port.encode(torch.from_numpy(audio)).numpy(), want_codes)
    np.testing.assert_allclose(port.decode(torch.from_numpy(want_codes)).numpy(),
                               np.asarray(dec(jv, jnp.asarray(want_codes))), atol=1e-5, rtol=0)


def test_mimi_v0_1_geometry():
    """``MIMI_V0_1``: 1920 samples a frame (12.5 fps at 24 kHz), 8 codebooks
    of 2048, and the port's module has JAX's parameter count."""
    cfg = tmimi.MIMI_V0_1
    assert cfg.hop_length == 1920 and cfg.n_q == 8 and cfg.cardinality == 2048
    with torch.device("meta"):
        model = tmimi.Mimi(cfg)
    shapes = jax.eval_shape(lambda: jmimi.Mimi(jmimi.MIMI_V0_1).init(jax.random.PRNGKey(0), jnp.zeros((1, 3840, 1))))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
