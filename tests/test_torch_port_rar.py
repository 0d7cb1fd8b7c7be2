"""Port parity, models: RAR teacher-forced logits and the MaskGit tokenizer.

JAX parameters are made from a PRNG key, turned into numpy trees and
bridged into the port's modules. RAR's adaLN gates get small random
weights: with the faithful zero init attention never reaches the logits,
and the comparison would pass without testing it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import rar as jrar
from wmar_tpu_torch import bridge
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import rar as trar

CFG = dict(embed_dim=64, depth=2, num_heads=4, intermediate_size=128, image_seq_len=16,
           codebook_size=32, num_classes=4)
VQ = dict(resolution=16, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
          z_channels=16, n_embed=64, embed_dim=16)


def jax_rar_params(seed=0, **overrides):
    cfg = jrar.RARConfig(**{**CFG, **overrides})
    params = jrar.init_rar_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 100)
    gate = lambda p: {"w": jnp.asarray(rng.standard_normal(p["w"].shape) * 0.05, jnp.float32), "b": p["b"]}  # noqa: E731
    params = dict(params)
    params["blocks"] = [{**blk, "adaln": gate(blk["adaln"])} for blk in params["blocks"]]
    params["final_adaln"] = gate(params["final_adaln"])
    return cfg, params


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def port_rar(cfg, params):
    return bridge.load_rar(trar.RAR(trar.RARConfig(**vars(cfg))), to_numpy(params))


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("num_heads", [4, 2], ids=["D16", "D32"])
def test_rar_teacher_forced_logits(weights, num_heads):
    """Prefill and 15 teacher-forced steps with CFG at f32 (f32 cache):
    logits agree to atol 1e-4 (float32 summation order only)."""
    cfg, params = jax_rar_params(num_heads=num_heads)
    if weights == "int8":
        params = jrar.quantize_rar_params_int8(params)
    model = port_rar(cfg, params)
    classes = np.array([0, 3, 1])
    js = jrar.RARSampler(params, cfg, jnp.asarray(classes), guidance_scale=4.0, cache_dtype=jnp.float32)
    ts = trar.RARSampler(model, torch.as_tensor(classes), guidance_scale=4.0, cache_dtype=torch.float32)
    jl, jc = jax.jit(js.prefill)()
    jstep = jax.jit(js.step_fn)
    with torch.inference_mode():
        tl, tc = ts.prefill()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        tokens = np.random.default_rng(1).integers(0, cfg.codebook_size, size=(cfg.image_seq_len, len(classes)))
        for s in range(1, cfg.image_seq_len):
            jl, jc = jstep(jc, jnp.asarray(tokens[s - 1], jnp.int32), jnp.int32(s))
            tl, tc = ts.step_fn(tc, torch.as_tensor(tokens[s - 1]), torch.tensor(s))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)


def test_rar_int8_quantization_matches_bridged_jax_quantization():
    """Quantizing in the port gives the buffers the JAX-quantized tree
    bridges to, byte for byte (bf16 compute dtype, as the bench runs)."""
    cfg, params = jax_rar_params(seed=2)
    ported = trar.quantize_rar_params_int8(port_rar(cfg, params), compute_dtype=torch.bfloat16)
    bridged = port_rar(cfg, jrar.quantize_rar_params_int8(params, compute_dtype=jnp.bfloat16))
    a, b = ported.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys() and any(k.endswith("w_q") for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_rar_init_and_head_dims():
    g = torch.Generator().manual_seed(0)
    model = trar.init_rar(trar.RARConfig(**CFG), g)
    assert torch.all(model.blocks[0].adaln.w == 0) and torch.all(model.final_adaln.w == 0)
    assert model.embeddings.abs().max() <= 0.04 and model.embeddings.std() > 0.01
    assert torch.all(model.blocks[1].norm1.scale == 1)
    assert [trar.rar_config(s).head_dim for s in ("rar_b", "rar_l", "rar_xl", "rar_xxl")] == [48, 64, 80, 88]


def _maskgit_pair(dtype=jnp.float32):
    jcfg = jmg.MaskGitVQConfig(**VQ)
    jm = jmg.MaskGitVQGAN(jcfg)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 3)))
    # a codebook with the spread of encoder outputs, so nearest() is no near tie
    params["params"]["embedding"] = jnp.asarray(np.random.default_rng(6).standard_normal((64, 16)), jnp.float32)
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    tm = tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**VQ))
    bridge.load_maskgit(tm, to_numpy(params))
    return jm, params, tm


def test_maskgit_decode_encode_f32():
    """Decode at atol 1e-4 and codes of the re-encode exactly equal, at f32."""
    jm, params, tm = _maskgit_pair()
    jdecode = jax.jit(lambda c: jm.apply(params, c, method=jmg.MaskGitVQGAN.decode_codes))
    jencode = jax.jit(lambda x: jm.apply(params, x, method=jmg.MaskGitVQGAN.encode_codes))
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 64, size=(2, 64))
    want = jdecode(jnp.asarray(codes))
    with torch.inference_mode():
        got = tm.decode_codes(torch.as_tensor(codes))
        assert got.shape == (2, 16, 16, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        imgs = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
        jcodes = jencode(jnp.asarray(imgs[:2]))
        tcodes = tm.encode_codes(torch.as_tensor(imgs[:2]))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        # decode -> encode round trip of the decoded images, as the pipeline does
        np.testing.assert_array_equal(
            tm.encode_codes(got).numpy(),
            np.asarray(jencode(want)))


def test_maskgit_bf16_code_match_rate():
    """Under bf16 the two frameworks round at other places; the share of
    equal codes is reported, and must stay high."""
    jm, params, tm = _maskgit_pair(jnp.bfloat16)
    imgs = np.random.default_rng(8).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    encode = jax.jit(lambda x: jm.apply(params, x, method=jmg.MaskGitVQGAN.encode_codes))
    jcodes = np.asarray(encode(jnp.asarray(imgs, jnp.bfloat16)))
    with torch.inference_mode():
        tcodes = tm.to(torch.bfloat16).encode_codes(torch.as_tensor(imgs)).numpy()
    rate = float((jcodes == tcodes).mean())
    print(f"MaskGit bf16 encode: {rate:.3f} of codes equal to JAX's")
    assert rate >= 0.8, rate


def test_maskgit_init_shapes():
    tm = tmg.init_maskgit(tmg.MaskGitVQConfig(**VQ), torch.Generator().manual_seed(0))
    assert tm.embedding.abs().max() <= 1 / 64
    assert tm.encoder.down_1_block_0.nin_shortcut.weight.shape == (64, 64, 1, 1)
    assert tm.decoder.up_1_upsample_conv.weight.shape == (64, 64, 3, 3)
    assert tmg.MASKGIT_IMAGENET_F16.codes_per_side == 16
