"""Port parity, Chameleon's ``--modelpath``: the reference's files through
both tools into one directory, then both packages' ``generate.load_wrapper``.

A tiny Chameleon (2 layers, width 32) is written in the reference's layout
(two tensor-parallel shards and a ``vqgan.ckpt``) with a synthetic
byte-level ``tokenizer/text_tokenizer.json``; ``CHAMELEON_7B`` and
``CHAMELEON_F16`` are patched small in both packages (the VQGAN at 32 x 32
codes, so JAX's default of 1024 image tokens fits). The JAX package
tokenizes with ``tokenizers``, the port with its own BPE reader. They must
agree on the prompts' ids (equal), the codes with the port fed JAX's
per-step noise (token for token, f32 caches), the images (1e-4), the
re-encoded codes (equal) and the p-values (rtol 1e-4). The port loads the
Llama in bf16; the source weights are bf16 values, so the parity wrapper
casts them back to float32 without loss. ``generate.main`` runs from the
directory, t2i and ``--interleaved``, and a directory without the
tokenizer JSON is refused by name.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_port_convert as ref
import test_torch_port_convert_cli as cli
from wmar_tpu import models as jmodels
from wmar_tpu.core.detect import detect as jax_detect
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.models.armm import GenParams as JGenParams
from wmar_tpu_torch import bridge
from wmar_tpu_torch import generate as tgen
from wmar_tpu_torch import models as tmodels
from wmar_tpu_torch.core.detect import detect as port_detect
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.models.armm import GenParams as TGenParams
from wmar_tpu_torch.tools import convert_ckpt as tool

tokenizers = pytest.importorskip("tokenizers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VOCAB, N_CODES = 512, 16
LLAMA = dict(ref.LLAMA, vocab_size=N_VOCAB)
VQ = dict(resolution=32, ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(), z_channels=32, n_embed=N_CODES,
          embed_dim=8)
PROMPTS = ["a cat", "a red fox at night", "x"]
METHOD = "linear-rand-h=1-d=2.0-g=0.25"


def _jax_generate():
    sys.path.insert(0, REPO)
    try:
        import generate
    finally:
        sys.path.remove(REPO)
    return generate


@pytest.fixture(scope="module")
def patched():
    """``CHAMELEON_7B`` / ``CHAMELEON_F16`` small in both packages, one
    torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for m in (jmodels, tmodels):
            mp.setattr(m, "CHAMELEON_7B", m.LlamaConfig(**LLAMA))
            mp.setattr(m, "CHAMELEON_F16", m.VQGANConfig(**VQ))
        yield mp
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(patched, tmp_path_factory):
    """The reference's files through both tools: the directories must be
    byte-equal; the port's one gets the tokenizer JSON and a config.json
    naming the alive ids (every id past the first four, as
    ``assets/chameleon_all_ids.txt`` lists them at full size)."""
    root = tmp_path_factory.mktemp("chameleon")
    sd = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in ref.llama_sd(LLAMA).items()}
    src = root / "src"
    src.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src / "full.pth")
    for r, shard in enumerate(ref.shard_llama_sd(sd, 2)):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in shard.items()},
                   src / f"consolidated.{r:02d}.pth")
    vq_sd = ref.taming_vqgan_sd(VQ, seed=11)
    vq_sd["quantize.embedding.weight"] = np.random.default_rng(12).standard_normal((N_CODES, 8)).astype(np.float32)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in vq_sd.items()}}, src / "vqgan.ckpt")
    jout, tout = root / "jax", root / "port"
    cli.JTOOL.main(["chameleon_llama", "--ckpt", str(src / "full.pth"), "--outdir", str(jout)])
    cli.JTOOL.main(["chameleon_vqgan", "--ckpt", str(src / "vqgan.ckpt"), "--outdir", str(jout)])
    tool.main(["chameleon_llama", "--ckpt", str(src / "consolidated.*.pth"), "--outdir", str(tout)])
    tool.main(["chameleon_vqgan", "--ckpt", str(src / "vqgan.ckpt"), "--outdir", str(tout)])
    for name in ("llama7b.msgpack", "vqgan.msgpack"):
        assert (jout / name).read_bytes() == (tout / name).read_bytes(), name
    (tout / "tokenizer").mkdir()
    (tout / "tokenizer" / "text_tokenizer.json").write_text(
        json.dumps(chip_smoke.synthetic_text_tokenizer(N_VOCAB, N_CODES, 0)))
    (root / "alive.txt").write_text(",".join(map(str, range(4, N_VOCAB))) + "\n")
    (tout / "config.json").write_text(json.dumps({"alive_ids": str(root / "alive.txt")}))
    return tout


def _args(model_dir, *extra):
    return tgen.get_parser().parse_args(["--model", "chameleon7b", "--modelpath", str(model_dir), "--outdir", "unused",
                                         *extra])


@pytest.fixture(scope="module")
def wrappers(model_dir):
    jw = _jax_generate().load_wrapper(_args(model_dir))
    tw = tgen.load_wrapper(_args(model_dir, "--device", "cpu"), torch.device("cpu"))
    return jw, tw


def test_load_wrapper_reads_the_files(wrappers):
    """The port's Llama is bf16 and equals JAX's float32 tree (the source
    is bf16-exact); vocabulary, alive ids and prompt ids agree."""
    jw, tw = wrappers
    jleaves = dict(bridge.flatten(jax.tree.map(np.asarray, jw.llama_params)))
    tleaves = dict(bridge.flatten(tw.llama_params))
    assert sorted(jleaves) == sorted(tleaves)
    for k, a in jleaves.items():
        assert tleaves[k].dtype == torch.bfloat16 and np.array_equal(tleaves[k].float().numpy(), a), k
    assert tw.vocab.image_tokens == jw.vocab.image_tokens and tw.vocab.text_tokens == jw.vocab.text_tokens
    np.testing.assert_array_equal(tw.alive_ids, np.asarray(jw.alive_ids))
    ids = tw.tokenize_prompts(PROMPTS)
    assert ids == [list(map(int, x)) for x in jw.tokenize_prompts(PROMPTS)]
    assert len({len(x) for x in ids}) == 3 and all(x[0] == 0 and x[-1] == 5 for x in ids)


def test_sample_decode_detect_match_jax(wrappers):
    """f32 caches, the port's weights cast back to float32, the port fed
    JAX's per-step Gumbel noise: tokens equal, images 1e-4, re-encoded
    codes equal, p-values rtol 1e-4."""
    jw, tw = wrappers
    jw.cache_dtype, tw.cache_dtype = jnp.float32, torch.float32
    tw.llama_params = bridge.load_llama(tw.llama_params, dtype=torch.float32)
    v = jw.vocab.vocab_size
    jw.set_watermarker(JSpec.from_string(METHOD, vocab_size=v, spatial_dim=jw.codes_size))
    tw.set_watermarker(TSpec.from_string(METHOD, vocab_size=v, spatial_dim=tw.codes_size))
    key = jax.random.PRNGKey(3)
    gen = JGenParams(temperature=0.7, top_p=0.9)
    want = np.asarray(jw.sample(PROMPTS, gen, apply_watermark=True, rng=key))
    noise = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, s), (len(PROMPTS), v), jnp.float32))
                      for s in range(jw.image_seq_len)])
    got = tw.sample(PROMPTS, TGenParams(temperature=0.7, top_p=0.9), apply_watermark=True,
                    noise=torch.as_tensor(noise))
    assert got.shape == (3, 1024) and bool(tw.vocab.image_token_mask[got].all())
    np.testing.assert_array_equal(got.numpy(), want)
    jimgs = jw.codes_to_images(jnp.asarray(want))
    timgs = tw.codes_to_images(got)
    np.testing.assert_allclose(timgs.numpy(), np.asarray(jimgs), atol=1e-4, rtol=0)
    jre = np.asarray(jw.images_to_codes(jimgs))
    tre = tw.images_to_codes(timgs)
    np.testing.assert_array_equal(tre.numpy(), jre)
    for cj, ct in ((want, got), (jre, tre)):
        pj = np.asarray(jax_detect(jw.watermark_spec, jw.greenlist, jnp.asarray(cj)), np.float64)
        np.testing.assert_allclose(port_detect(tw.watermark_spec, tw.greenlist, ct), pj, rtol=1e-4)


def test_generate_main_t2i_and_interleaved(model_dir, tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\na red fox\n")
    base = ["--model", "chameleon7b", "--modelpath", str(model_dir), "--device", "cpu"]
    records = tgen.main([*base, "--no_augs", "--conditioning", str(prompts), "--batch_size", "2",
                         "--cache_dtype", "packed4", "--weight_dtype", "int8", "--outdir", str(tmp_path / "t2i")])
    assert len(records) == 4 and all(0 <= r["pvalue"] <= 1 for r in records if "pvalue" in r)
    segs = tgen.main([*base, "--interleaved", str(prompts), "--text_gen_len", "4", "--max_images", "1",
                      "--outdir", str(tmp_path / "inter")])
    assert os.path.exists(tmp_path / "inter" / "p=1,idx=0" / "prompt.txt")
    assert all(0 <= r["pvalue_raw"] <= 1 for r in segs)


def test_a_directory_without_the_tokenizer_json_is_refused(model_dir, tmp_path):
    for name in ("llama7b.msgpack", "vqgan.msgpack"):
        (tmp_path / name).write_bytes((model_dir / name).read_bytes())
    with pytest.raises(SystemExit, match=r"tokenizer/text_tokenizer\.json not found"):
        tgen.load_wrapper(_args(tmp_path, "--device", "cpu"), torch.device("cpu"))


def test_chip_smoke_builds_chameleon_from_files_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke``'s file route at a tiny width with the full-size
    vocabulary (65,536 entries, 8192 codes, the repository's alive ids):
    bf16 shards, conversion, load, int8 linears, ragged prompt ids; then
    the Chameleon phase's checks."""
    monkeypatch.setattr(tmodels, "CHAMELEON_7B", tmodels.LlamaConfig(**dict(LLAMA, vocab_size=65536)))
    monkeypatch.setattr(tmodels, "CHAMELEON_F16", tmodels.VQGANConfig(**dict(VQ, resolution=8, ch_mult=(1, 2),
                                                                               n_embed=8192)))
    wrapper, report = chip_smoke.build_chameleon_from_files("cpu", str(tmp_path), n_layers=2)
    assert tmodels.CHAMELEON_7B.n_layers == 2 and wrapper.llama_cfg.n_layers == 2
    assert sorted(report["files"]) == ["consolidated.00.pth", "consolidated.01.pth", "llama7b.msgpack",
                                       "tokenizer/text_tokenizer.json", "vqgan.ckpt", "vqgan.msgpack"]
    assert "q" in wrapper.llama_params["blocks"][0]["wq"] and len(wrapper.vocab.image_tokens) == 8192
    lib = tokenizers.Tokenizer.from_file(str(tmp_path / "chameleon" / "tokenizer" / "text_tokenizer.json"))
    assert report["prompt_ids"] == [[0] + lib.encode(p).ids + [5] for p in chip_smoke.PROMPTS]
    res = chip_smoke.phase_chameleon("cpu", wrapper)
    assert res["green_fraction"] > 0.35 and 0 <= res["median_raw_pvalue"] <= 1
