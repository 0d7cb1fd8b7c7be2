"""Port parity, the Chameleon text-to-image frontend end to end.

The tiny configuration of the JAX package's own Chameleon tests (and of
``generate.py --tiny``) goes through both packages: JAX weights from PRNG
keys, bridged into the port. Vocab tables and CFG prompts must be
identical; with an f32 cache and the port fed JAX's per-step Gumbel noise
(``gumbel(fold_in(rng, step))``), sampled tokens must be equal; images
within 1e-4 and re-encoded codes equal at f32.
"""

import json
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
from wmar_tpu.models import chameleon as jcham
from wmar_tpu.models import llama as jl
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.models.armm import GenParams as JGenParams
from wmar_tpu_torch import bridge
from wmar_tpu_torch.core.detect import detect as port_detect
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.models import chameleon as tcham
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.models.armm import GenParams as TGenParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LCFG = dict(dim=32, n_layers=2, n_heads=4, multiple_of=16, qk_normalization=True)
VQ = dict(resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32, n_embed=16,
          embed_dim=8)
PROMPTS = ["a cat", "a dog on a hill", "x"]


def tokenizer(text):
    return [6 + (ord(c) % 20) for c in text[:5]]


def _pair(cache_dtype=(jnp.float32, torch.float32)):
    jvocab = jcham.ChameleonVocab.synthetic(n_codes=16, n_text=20)
    tvocab = tcham.ChameleonVocab.synthetic(n_codes=16, n_text=20)
    jcfg = jl.LlamaConfig(vocab_size=jvocab.vocab_size, **LCFG)
    params = jl.init_llama_params(jax.random.PRNGKey(0), jcfg)
    vq_params = jvq.TamingVQGAN(jvq.VQGANConfig(**VQ)).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    jw = jcham.ChameleonARMM(params, jcfg, jvocab, vq_params, jvq.VQGANConfig(**VQ), tokenizer=tokenizer,
                             image_seq_len=16, cache_dtype=cache_dtype[0])
    tvq_model = bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**VQ)), jax.tree.map(np.asarray, vq_params))
    tw = tcham.ChameleonARMM(bridge.load_llama(jax.tree.map(np.asarray, params)),
                             tl.LlamaConfig(vocab_size=tvocab.vocab_size, **LCFG), tvocab, tvq_model,
                             tokenizer=tokenizer, image_seq_len=16, cache_dtype=cache_dtype[1], device="cpu")
    return jw, tw


def test_vocab_and_cfg_prompts_identical(tmp_path):
    """Tables, special ids and masks of the synthetic and the JSON vocab;
    the right-aligned 3B prompt matrix, its starts and lengths."""
    for n_codes, n_text in ((16, 20), (8192, 65536 - 8192 - 6)):
        jv = jcham.ChameleonVocab.synthetic(n_codes=n_codes, n_text=n_text)
        tv = tcham.ChameleonVocab.synthetic(n_codes=n_codes, n_text=n_text)
        assert tv.vocab_size == jv.vocab_size and tv.image_tokens == jv.image_tokens
        assert tv.special_tokens == jv.special_tokens and tv.text_tokens == jv.text_tokens
        np.testing.assert_array_equal(tv.bpe2img_table.numpy(), np.asarray(jv.bpe2img_table))
        np.testing.assert_array_equal(tv.img2bpe_table.numpy(), np.asarray(jv.img2bpe_table))
        np.testing.assert_array_equal(tv.image_token_mask.numpy(), np.asarray(jv.image_token_mask))
    codes = torch.arange(16)
    torch.testing.assert_close(tv.bpe_to_img(tv.img_to_bpe(codes)), codes)
    path = tmp_path / "text_tokenizer.json"
    path.write_text(json.dumps({"model": {"vocab": {"<s>": 0, "hello": 1, "IMGIMGBZ": 2, "IMGIMGAZ": 3}},
                                "added_tokens": [{"content": "<racm3:break>", "id": 4}, {"content": "<pad>", "id": 5}]}))
    jv, tv = jcham.ChameleonVocab.from_tokenizer_json(str(path)), tcham.ChameleonVocab.from_tokenizer_json(str(path))
    assert (tv.boi_id, tv.pad_id, tv.image_tokens) == (jv.boi_id, jv.pad_id, jv.image_tokens) == (4, 5, [2, 3])
    np.testing.assert_array_equal(tv.bpe2img_table.numpy(), np.asarray(jv.bpe2img_table))
    prompt_ids = [[0, 7, 8, 5], [0, 9], [0, 22, 7, 3, 9, 30, 31, 5]]
    for a, b in zip(tcham.build_cfg_prompts(tv, prompt_ids), jcham.build_cfg_prompts(jv, prompt_ids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("top_p", [0.9, 1.0])
def test_sample_fed_noise_tokens_equal(top_p):
    """f32 cache, watermarked draws: the port fed JAX's per-step noise
    samples JAX's tokens exactly; then decode (1e-4), re-encode (codes
    equal) and detect (p-values at rtol 1e-4)."""
    jw, tw = _pair()
    method = "linear-rand-h=1-d=2.0-g=0.25"
    jw.set_watermarker(JSpec.from_string(method, vocab_size=jw.vocab.vocab_size, spatial_dim=4))
    tw.set_watermarker(TSpec.from_string(method, vocab_size=tw.vocab.vocab_size, spatial_dim=4))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jw.sample(PROMPTS, JGenParams(temperature=0.7, top_p=top_p), apply_watermark=True, rng=key))
    v = jw.vocab.vocab_size
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (len(PROMPTS), v), jnp.float32))
                      for s in range(16)])
    got = tw.sample(PROMPTS, TGenParams(temperature=0.7, top_p=top_p), apply_watermark=True,
                    noise=torch.as_tensor(noise))
    assert got.shape == (3, 16) and bool(tw.vocab.image_token_mask[got].all())
    np.testing.assert_array_equal(got.numpy(), want)
    jimgs = jw.codes_to_images(jnp.asarray(want))
    timgs = tw.codes_to_images(got)
    assert tw.is_images_shaped(timgs) and tw.is_codes_shaped(got)
    np.testing.assert_allclose(timgs.numpy(), np.asarray(jimgs), atol=1e-4, rtol=0)
    jre = np.asarray(jw.images_to_codes(jimgs))
    tre = tw.images_to_codes(timgs)
    np.testing.assert_array_equal(tre.numpy(), jre)
    for cj, ct in ((want, got), (jre, tre)):
        pj = np.asarray(jax_detect(jw.watermark_spec, jw.greenlist, jnp.asarray(cj)), np.float64)
        np.testing.assert_allclose(port_detect(tw.watermark_spec, tw.greenlist, ct), pj, rtol=1e-4)


def test_watermark_detects():
    """As the JAX test does: a strong watermark (delta 12) on 16 tokens
    gives p < 0.05, and the round trip stays in image tokens."""
    _, tw = _pair()
    spec = TSpec.from_string("linear-rand-h=1-d=12.0-g=0.25", vocab_size=tw.vocab.vocab_size, spatial_dim=4)
    tw.set_watermarker(spec)
    codes = tw.sample([(0, "x")], TGenParams(temperature=1.0, top_p=1.0), apply_watermark=True,
                      generator=torch.Generator().manual_seed(1))
    assert (port_detect(spec, tw.greenlist, codes) < 0.05).all()
    imgs = tw.codes_to_images(codes)
    assert tw.is_images_shaped(imgs) and float(imgs.abs().max()) <= 1.0
    assert bool(tw.vocab.image_token_mask[tw.images_to_codes(imgs)].all())


@pytest.mark.parametrize("cache", ["packed", "packed4"])
def test_sample_packed_caches_greedy_agreement(cache):
    """The packed caches below 1024 slots: with a ragged start both
    packages take the plain attention on ``layer()``; greedy tokens agree
    on >= 90% of the positions (int4/int8 quantization noise in both)."""
    jw, tw = _pair((cache, cache))
    want = np.asarray(jw.sample(PROMPTS, JGenParams(greedy=True), rng=jax.random.PRNGKey(0)))
    got = tw.sample(PROMPTS, TGenParams(greedy=True)).numpy()
    assert float((got == want).mean()) >= 0.9


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generate_entry_point_result_tree(tmp_path):
    """``python -m wmar_tpu_torch.generate --model chameleon7b --tiny`` with
    a prompt file writes the same file names as JAX ``generate.py`` with
    the same flags."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na dog on a hill\n\n")
    argv = ["--model", "chameleon7b", "--tiny", "--no_augs", "--conditioning", str(prompts),
            "--num_samples_per_conditioning", "2", "--batch_size", "3", "--cache_dtype", "packed4"]
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
    assert len(_tree(port_out)) == 4 * 2 * 3 and any(p.startswith("c=a dog on a hill,idx=2/") for p in _tree(port_out))


def test_chip_smoke_chameleon_phases_on_cpu():
    """``chip_smoke.py``'s kernel #2-#4 phase and Chameleon phase at a tiny
    size on the CPU, where the wrappers take their plain versions: every
    check of theirs passes before the card sees them."""
    import chip_smoke

    out = chip_smoke.phase_packed_kernels("cpu", rar=(4, 10, 2, 20, 3), cham=(6, 300, 2, 16, 2), rar_lens=(1, 2, 10),
                                          cham_lens=(1, 128, 129, 300), sampler=(3, 200, 2, 16, 2),
                                          sampler_lens=(1, 129, 200), interleaved=(3, 5, 100))
    assert set(out) == {"packed_decode_attention_q8", "packed_decode_attention_q8_chunked",
                        "packed4_decode_attention_chunked"}
    assert all(0 < o["max_abs_err"] < 2e-2 for o in out.values())
    vocab = tcham.ChameleonVocab.synthetic(n_codes=64, n_text=40)
    wrapper = chip_smoke.build_chameleon(
        "cpu", tl.LlamaConfig(dim=64, n_layers=2, n_heads=4, vocab_size=vocab.vocab_size, multiple_of=16),
        tvq.VQGANConfig(**{**VQ, "resolution": 16, "n_embed": 64}), vocab)
    assert "q" in wrapper.llama_params["blocks"][0]["wq"]
    res = chip_smoke.phase_chameleon("cpu", wrapper)
    assert len(res["seconds"]) == 2 and set(res["launches"].values()) == {0}
    assert res["green_fraction"] > 0.35 and 0 <= res["median_raw_pvalue"] <= 1
