"""Port parity, the Taming path: the cin_transformer GPT, TamingARMM and the
``--model taming`` entry point.

The tiny configuration of the JAX CLI (``generate.py --tiny``: 2 layers, 2
heads, width 32, vocab 64) goes through both packages: JAX weights from PRNG
keys, with ``pos_emb`` given std-0.02 values from a numpy seed (the
faithful zero init would let a wrong position index pass), bridged into the
port. Width 32 quantizes with group 32 and the MLP projection (input 128)
with group 128, so both int4 group sizes run. Teacher-forced logits agree
at f32 within 1e-4 for f32, int8 and int4 weights, with and without a
cache; sampled tokens are equal when the port is fed JAX's per-step Gumbel
noise.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.core.detect import detect as jax_detect
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.models import armm as jarmm
from wmar_tpu.models import taming_gpt as jgpt
from wmar_tpu.models import vqgan as jvq
from wmar_tpu_torch import bridge
from wmar_tpu_torch.core.detect import detect as port_detect
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.models import armm as tarmm
from wmar_tpu_torch.models import taming_gpt as tgpt
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.ops.w4_matmul import matmul_w4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT = dict(vocab_size=64, block_size=300, n_layer=2, n_head=2, n_embd=32)
VQ = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), z_channels=32,
          n_embed=64, embed_dim=16)
# the sampling tests: an 8 x 8 code grid (64 tokens), attention at the 16-pixel level
VQ_SAMPLE = {**VQ, "resolution": 16}
METHOD = "linear-rand-h=1-d=2.0-g=0.25"
CLASSES = np.array([0, 1, 7, 3])
BITS = {"f32": None, "int8": 8, "int4": 4}


def jax_gpt_params(seed=0, weights="f32"):
    cfg = jgpt.GPTConfig(**GPT)
    params = dict(jgpt.init_gpt_params(jax.random.PRNGKey(seed), cfg))
    params["pos_emb"] = jnp.asarray(np.random.default_rng(seed + 50).standard_normal((300, 32)) * 0.02, jnp.float32)
    if BITS[weights]:
        params = jgpt.quantize_gpt_params_int8(params, bits=BITS[weights])
    return cfg, params


def port_gpt(params):
    return bridge.load_gpt(tgpt.GPT(tgpt.GPTConfig(**GPT)), jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("weights", list(BITS))
def test_gpt_teacher_forced_logits(weights, cached):
    """Prefill of the class token and 12 teacher-forced decode steps on an
    f32 cache, or one causal forward over the whole sequence without a
    cache: logits within 1e-4 at f32 (float32 summation order only)."""
    cfg, params = jax_gpt_params(weights=weights)
    model = port_gpt(params)
    if weights == "int4":
        assert "w_q4" in model.blocks[0].attn.q.params() and "q4" in model.head_weight()
        assert model.blocks[0].attn.q.w_q4.shape[1] == 16 and model.blocks[0].mlp.proj.w_q4.shape[1] == 64
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (3, 13))
    with torch.inference_mode():
        if not cached:
            want, _ = jgpt.gpt_forward(params, cfg, jnp.asarray(tokens, jnp.int32))
            got, cache = tgpt.gpt_forward(model, torch.as_tensor(tokens))
            assert cache is None and got.shape == (3, 13, 64)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
            return
        jl, jc = jgpt.prefill(params, cfg, jnp.asarray(tokens[:, :1], jnp.int32), max_len=20)
        tl, tc = tgpt.prefill(model, torch.as_tensor(tokens[:, :1]), max_len=20)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        jstep = jax.jit(jgpt.make_step_fn(params, cfg, cond_len=1))
        tstep = tgpt.make_step_fn(model, cond_len=1)
        for s in range(1, 13):
            jl, jc = jstep(jc, jnp.asarray(tokens[:, s], jnp.int32), jnp.int32(s))
            tl, tc = tstep(tc, torch.as_tensor(tokens[:, s]), torch.tensor(s))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_gpt_quantization_matches_bridged_jax_quantization(bits):
    """Quantizing in the port gives the buffers the JAX-quantized tree
    bridges to, byte for byte (bf16 compute dtype, as the CLI runs it)."""
    _, params = jax_gpt_params(seed=2)
    ported = tgpt.quantize_gpt_params_int8(port_gpt(params), compute_dtype=torch.bfloat16, bits=bits)
    bridged = port_gpt(jgpt.quantize_gpt_params_int8(params, compute_dtype=jnp.bfloat16, bits=bits))
    a, b = ported.state_dict(), bridged.state_dict()
    assert a.keys() == b.keys() and ("head.q4" if bits == 4 else "head.q") in a
    assert ("blocks.1.mlp.fc.w_q4" if bits == 4 else "blocks.1.mlp.fc.w_q") in a
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    assert a["tok_emb"].dtype == a["blocks.0.ln1.scale"].dtype == a["ln_f.bias"].dtype == torch.bfloat16


def test_gpt_init():
    """The port's init follows the reference's rules."""
    model = tgpt.init_gpt(tgpt.GPTConfig(**GPT), torch.Generator().manual_seed(0))
    assert set(dict(model.named_buffers())) == set(dict(bridge.flatten(jax.tree.map(
        np.asarray, jgpt.init_gpt_params(jax.random.PRNGKey(0), jgpt.GPTConfig(**GPT))))))
    assert abs(float(model.tok_emb.std()) - 0.02) < 0.003 and abs(float(model.head.std()) - 0.02) < 0.003
    assert torch.all(model.pos_emb == 0) and torch.all(model.blocks[1].attn.k.b == 0)
    assert torch.all(model.blocks[0].ln2.scale == 1) and torch.all(model.ln_f.bias == 0)
    assert tgpt.TAMING_GPT_1_4B.head_dim == 104


def _pair(cache, weights="f32", vq=VQ_SAMPLE):
    cfg, params = jax_gpt_params(seed=3, weights=weights)
    vq_params = jvq.TamingVQGAN(jvq.VQGANConfig(**vq)).init(
        jax.random.PRNGKey(4), jnp.zeros((1, vq["resolution"], vq["resolution"], 3)))
    # a codebook with the spread of encoder outputs, so nearest() is no near tie
    vq_params["params"]["quantize"]["embedding"] = jnp.asarray(
        np.random.default_rng(6).standard_normal((vq["n_embed"], vq["embed_dim"])), jnp.float32)
    jw = jarmm.TamingARMM(params, cfg, vq_params, jvq.VQGANConfig(**vq),
                          cache_dtype=jnp.float32 if cache == "f32" else cache)
    tmodel = bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**vq)), jax.tree.map(np.asarray, vq_params))
    tw = tarmm.TamingARMM(port_gpt(params), tmodel, cache_dtype=torch.float32 if cache == "f32" else cache,
                          device="cpu")
    side = tw.codes_size
    jw.set_watermarker(JSpec.from_string(METHOD, vocab_size=vq["n_embed"], spatial_dim=side))
    tw.set_watermarker(TSpec.from_string(METHOD, vocab_size=vq["n_embed"], spatial_dim=side))
    return jw, tw


@pytest.mark.parametrize("cache,weights", [("f32", "f32"), ("f32", "int4"), ("packed4", "f32")])
def test_sample_fed_noise_tokens_equal(cache, weights):
    """Watermarked draws at top-k 20 / top-p 0.92, the port fed JAX's
    per-step noise (``gumbel(fold_in(rng, step))``): tokens equal, on the
    f32 cache (f32 and int4 weights) and on the packed4 cache, where JAX
    runs its Pallas kernel in interpret mode and the port the kernel's plain
    float32 version. Then decode (atol 1e-4), re-encode (codes equal) and
    detect (p-values at rtol 1e-4) on the f32 pair."""
    jw, tw = _pair(cache, weights)
    key = jax.random.PRNGKey(5)
    steps = tw.codes_size**2
    want = np.asarray(jw.sample(CLASSES, jarmm.GenParams(top_k=20, top_p=0.92), apply_watermark=True, rng=key))
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (len(CLASSES), 20), jnp.float32))
                      for s in range(steps)])
    got = tw.sample(CLASSES, tarmm.GenParams(top_k=20, top_p=0.92), apply_watermark=True,
                    noise=torch.as_tensor(noise))
    assert tw.is_codes_shaped(got) and got.shape == (len(CLASSES), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    if (cache, weights) != ("f32", "f32"):
        return
    jimgs = jw.codes_to_images(jnp.asarray(want))
    timgs = tw.codes_to_images(got)
    assert tw.is_images_shaped(timgs) and float(timgs.abs().max()) <= 1.0
    np.testing.assert_allclose(timgs.numpy(), np.asarray(jimgs), atol=1e-4, rtol=0)
    jre = np.asarray(jw.images_to_codes(jimgs))
    tre = tw.images_to_codes(timgs)
    np.testing.assert_array_equal(tre.numpy(), jre)
    for cj, ct in ((want, got), (jre, tre)):
        pj = np.asarray(jax_detect(jw.watermark_spec, jw.greenlist, jnp.asarray(cj)), np.float64)
        np.testing.assert_allclose(port_detect(tw.watermark_spec, tw.greenlist, ct), pj, rtol=1e-4)


def test_codes_images_round_trip_tiny_vqgan():
    """``codes_to_images`` (clamped to [-1, 1]) and ``images_to_codes`` at the
    CLI's tiny VQGAN (32 px, attention at 16 px): images within 1e-4 of
    JAX's, codes equal; the wrapper's vocabulary is the codebook's."""
    jw, tw = _pair("f32", vq=VQ)
    assert tw.codes_size == 16 and tw.image_size == 32 and tw.get_total_vocab_size() == 64
    codes = np.random.default_rng(8).integers(0, 64, (2, 256))
    jimgs = np.asarray(jw.codes_to_images(jnp.asarray(codes)))
    timgs = tw.codes_to_images(torch.as_tensor(codes))
    assert float(timgs.min()) >= -1.0 and float(timgs.max()) <= 1.0
    np.testing.assert_allclose(timgs.numpy(), jimgs, atol=1e-4, rtol=0)
    imgs = np.random.default_rng(9).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(tw.images_to_codes(torch.as_tensor(imgs)).numpy(),
                                  np.asarray(jw.images_to_codes(jnp.asarray(imgs))))
    np.testing.assert_array_equal(tw.get_vq().embedding, np.asarray(jw.get_vq().embedding))


def test_packed_caches_take_the_attention_kernels_route():
    """Taming's single-token forwards (the class-token prefill included) over
    the packed caches go through the decode-attention wrappers: on the CPU
    their plain versions, so the launch counts stay 0, and the f32-cache
    logits are matched within the quantization noise (atol 5e-2)."""
    from wmar_tpu_torch.ops import flash_decode as fd

    _, params = jax_gpt_params(seed=7)
    model = port_gpt(params)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 64, (2, 6)))
    counts = (fd.packed4_decode_attention.launches, fd.packed_decode_attention_q8.launches, matmul_w4.launches)
    out = {}
    with torch.inference_mode():
        for kind in (torch.float32, "packed", "packed4"):
            logits, cache = tgpt.prefill(model, tokens[:, :1], max_len=8, dtype=kind)
            step = tgpt.make_step_fn(model, cond_len=1)
            for s in range(1, 6):
                logits, cache = step(cache, tokens[:, s], torch.tensor(s))
            out[str(kind)] = logits
        assert isinstance(cache, tkv.Packed4QuantKVCache)
    for kind in ("packed", "packed4"):
        np.testing.assert_allclose(out[kind].numpy(), out["torch.float32"].numpy(), atol=5e-2, rtol=0)
    assert counts == (fd.packed4_decode_attention.launches, fd.packed_decode_attention_q8.launches,
                      matmul_w4.launches)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generate_entry_point_result_tree(tmp_path):
    """``python -m wmar_tpu_torch.generate --model taming --tiny --no_augs
    --weight_dtype int4`` writes the same file names as JAX ``generate.py``
    with the same flags (the values differ: the two packages draw their
    random weights differently)."""
    argv = ["--model", "taming", "--tiny", "--no_augs", "--weight_dtype", "int4", "--conditioning", "0,3",
            "--num_samples_per_conditioning", "2", "--batch_size", "3", "--top_k", "50"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    run = subprocess.run([sys.executable, "-m", "wmar_tpu_torch.generate", *argv, "--device", "cpu",
                          "--outdir", str(port_out)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "wrote 8 records" in run.stdout
    sys.path.insert(0, REPO)
    try:
        import generate
    finally:
        sys.path.remove(REPO)
    generate.main(argv + ["--outdir", str(jax_out)])
    assert _tree(port_out) == _tree(jax_out)
    assert len(_tree(port_out)) == 4 * 2 * 3


def test_chip_smoke_taming_phases_on_cpu():
    """``chip_smoke.py``'s kernel #8 phase, its Taming-shape attention check
    and its Taming phase at a tiny size on the CPU, where the wrappers take
    their plain versions: every check of theirs passes before the card sees
    them."""
    import chip_smoke

    w4 = chip_smoke.phase_w4("cpu", cases=[("tiny", 3, 256, 40), ("ragged", 1, 128, 7)], timed=[])
    assert 0 < w4["max_abs_err"] < 2e-2
    attn = chip_smoke.phase_taming_attention("cpu", shape=(3, 4, 20, 2, 24), lens=(1, 2, 10, 20))
    assert set(attn) == {"packed4_decode_attention", "packed_decode_attention_q8"}
    wrapper = chip_smoke.build_taming("cpu", tgpt.GPTConfig(**{**GPT, "n_embd": 64}), tvq.VQGANConfig(**VQ_SAMPLE))
    assert "w_q4" in wrapper.gpt.blocks[0].mlp.fc.params() and float(wrapper.gpt.pos_emb.float().std()) > 0.01
    assert chip_smoke._w4_products_per_forward(wrapper.gpt) == 6 * 2 + 1
    res = chip_smoke.phase_taming("cpu", wrapper, classes=4)
    assert len(res["seconds"]) == 2 and set(res["launches"].values()) == {0}
    assert res["green_fraction"] > 0.4 and 0 <= res["median_raw_pvalue"] <= 1
