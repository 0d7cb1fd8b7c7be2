"""Port parity, the interleaved Chameleon frontend.

The tiny configuration of the JAX package's own interleaved tests (2
layers, dim 32, 16 image tokens) goes through both packages: JAX weights
from PRNG keys, bridged into the port. With an f32 cache the fused
one-loop sampler gives JAX's tokens one for one, under greedy decoding and
under sampling when the port is fed JAX's Gumbel noise
(``gumbel(fold_in(rng, step), (1, V))``, step -1 for the first token),
on the plain attention route and, with a 2048-slot cache and
``USE_FLASH_DECODE`` forced in both packages, on the flash-decode route
(JAX's Pallas kernels in interpret mode, the port's plain versions).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.core.greenlist import HashGreenlist as JHashGreenlist
from wmar_tpu.core.spec import WatermarkSpec as JSpec
from wmar_tpu.models import chameleon as jcham
from wmar_tpu.models import chameleon_interleaved as jil
from wmar_tpu.models import llama as jl
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.models.armm import GenParams as JGenParams
from wmar_tpu_torch import bridge
from wmar_tpu_torch.core.greenlist import HashGreenlist as THashGreenlist
from wmar_tpu_torch.core.spec import WatermarkSpec as TSpec
from wmar_tpu_torch.models import chameleon as tcham
from wmar_tpu_torch.models import chameleon_interleaved as til
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.models.armm import GenParams as TGenParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LCFG = dict(dim=32, n_layers=2, n_heads=4, multiple_of=16, qk_normalization=True)
VQ = dict(resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32, n_embed=16,
          embed_dim=8)
WATERMARK = "linear-rand-h=1-d=2.0-g=0.25"


def tokenizer(text):
    return [6 + (ord(c) % 20) for c in text[:4]]


def _pair(seed=0, cache_dtype=(jnp.float32, torch.float32), port_only=False):
    """The same tiny Chameleon in both packages (a fresh JAX wrapper each
    time: its jit cache is keyed without the sampling options)."""
    jvocab = jcham.ChameleonVocab.synthetic(n_codes=16, n_text=20)
    tvocab = tcham.ChameleonVocab.synthetic(n_codes=16, n_text=20)
    jcfg = jl.LlamaConfig(vocab_size=jvocab.vocab_size, **LCFG)
    params = jl.init_llama_params(jax.random.PRNGKey(seed), jcfg)
    vq_params = jvq.TamingVQGAN(jvq.VQGANConfig(**VQ)).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    jw = None if port_only else jcham.ChameleonARMM(
        params, jcfg, jvocab, vq_params, jvq.VQGANConfig(**VQ), tokenizer=tokenizer, image_seq_len=16,
        cache_dtype=cache_dtype[0])
    tvq_model = bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**VQ)), jax.tree.map(np.asarray, vq_params))
    tw = tcham.ChameleonARMM(bridge.load_llama(jax.tree.map(np.asarray, params)),
                             tl.LlamaConfig(vocab_size=tvocab.vocab_size, **LCFG), tvocab, tvq_model,
                             tokenizer=tokenizer, image_seq_len=16, cache_dtype=cache_dtype[1], device="cpu")
    return jw, tw


def _lists(segs):
    return [(kind, np.asarray(toks).tolist()) for kind, toks in segs]


def _check_structure(segs, vocab, image_seq_len=16):
    text_ok = set(vocab.text_tokens) | {vocab.eos_id, vocab.boi_id, vocab.eoi_id}
    assert segs and all(kind in ("text_seg", "image_seg") for kind, _ in segs)
    for kind, toks in segs:
        arr = np.asarray(toks).reshape(-1)
        if kind == "image_seg":
            assert len(arr) <= image_seq_len and all(int(t) in set(vocab.image_tokens) for t in arr)
        else:
            assert all(int(t) in text_ok for t in arr)


def test_repetition_penalty_and_split_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 42)).astype(np.float32)
    counts = rng.integers(0, 3, (2, 42)).astype(np.int32)
    want = np.asarray(jil.repetition_penalty_mask(jnp.asarray(logits), jnp.asarray(counts), 1.2))
    got = til.repetition_penalty_mask(torch.as_tensor(logits), torch.as_tensor(counts), 1.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        til.repetition_penalty_mask(torch.tensor([[2.0, -2.0, 1.0]]), torch.tensor([[1, 1, 0]]), 2.0).numpy(),
        [[1.0, -4.0, 1.0]])
    boi, eoi = 2, 3
    for seq in ([7, 8, boi, 50, 51, eoi, 9], [boi, 50, eoi], [7, boi, 50, 51], [7, eoi, 8], [7, 8, 1]):
        seq = np.asarray([seq])
        assert _lists(til.split_token_sequence(seq, boi, eoi)) == _lists(jil.split_token_sequence(seq, boi, eoi))
    assert til.TextGenOptions() == til.TextGenOptions(64, 0.7, 0.9, 1.2, False)
    assert dataclasses.asdict(til.TextGenOptions()) == dataclasses.asdict(jil.TextGenOptions())


def test_text_watermark_hook_matches_jax():
    """``make_text_watermark``: the biased logits of both packages agree for
    a filled and for an underfull context window."""
    jspec = JSpec.from_string("linear-rand-h=2-d=3.0-g=0.5", vocab_size=42, spatial_dim=4)
    tspec = TSpec.from_string("linear-rand-h=2-d=3.0-g=0.5", vocab_size=42, spatial_dim=4)
    jhook = jil.make_text_watermark(jspec, JHashGreenlist(jspec))
    thook = til.make_text_watermark(tspec, THashGreenlist(tspec))
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 42)).astype(np.float32)
    buffer = rng.integers(6, 26, (2, 9)).astype(np.int32)
    for length in (1, 2, 5, 9):
        want = np.asarray(jhook(jnp.asarray(logits), jnp.asarray(buffer), jnp.int32(length)))
        got = thook(torch.as_tensor(logits), torch.as_tensor(buffer, dtype=torch.int64), length)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert not np.allclose(want, logits)


@pytest.mark.parametrize("case", ["boi_allowed", "boi_guard"])
def test_text_sampler_fed_noise_tokens_equal(case):
    """``ChameleonTextSampler`` with the text watermark hook, a left-padded
    second row and JAX's per-step noise fed: tokens and ``n_valid`` equal
    JAX's; only allowed tokens come out, pads after EOS or <boi>, and no
    <boi> where too few slots remain for an image (``max_seq_len``)."""
    jw, tw = _pair()
    jv, tv = jw.vocab, tw.vocab
    jspec = JSpec.from_string("linear-rand-h=1-d=2.0-g=0.5", vocab_size=jv.vocab_size, spatial_dim=4)
    tspec = TSpec.from_string("linear-rand-h=1-d=2.0-g=0.5", vocab_size=tv.vocab_size, spatial_dim=4)
    n = 10
    kwargs = dict(allow_image_start=True, max_seq_len=4096 if case == "boi_allowed" else 1000)
    jopts, topts = jil.TextGenOptions(max_gen_len=n, temp=1.0, top_p=0.95), til.TextGenOptions(n, 1.0, 0.95)
    js = jil.ChameleonTextSampler(jw.llama_params, jw.llama_cfg, jv, jopts,
                                  text_watermark=jil.make_text_watermark(jspec, JHashGreenlist(jspec)), **kwargs)
    ts = til.ChameleonTextSampler(tw.llama_params, tw.llama_cfg, tv, topts,
                                  text_watermark=til.make_text_watermark(tspec, THashGreenlist(tspec)), **kwargs)
    prompts = np.array([[jv.bos_id, 7, 8, 9], [jv.pad_id, jv.bos_id, 11, 12]], np.int32)
    start = np.array([0, 1], np.int32)
    key = jax.random.PRNGKey(5)
    want, want_n = js.generate(jnp.asarray(prompts), jnp.asarray(start), key)
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (2, jv.vocab_size), jnp.float32))
                      for s in range(n)])
    got, got_n = ts.generate(torch.as_tensor(prompts), torch.as_tensor(start), noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    allowed = set(tv.text_tokens) | {tv.eos_id, tv.pad_id} | ({tv.boi_id} if case == "boi_allowed" else set())
    for row in got.numpy():
        assert all(int(t) in allowed for t in row)
        stops = [i for i, t in enumerate(row) if t in (tv.eos_id, tv.boi_id)]
        if stops:
            assert (row[stops[0] + 1:] == tv.pad_id).all()


def _fed_noise(key, budget, v):
    """JAX's Gumbel noise of the fused loop: slice 0 for the first token
    (step -1), slice s + 1 for step s."""
    return torch.as_tensor(np.stack([
        np.array(jax.random.gumbel(jax.random.fold_in(key, jnp.int32(s)), (1, v), jnp.float32))
        for s in range(-1, budget - 1)]))


@pytest.mark.parametrize("case", ["greedy", "sampled_watermarked", "sampled_flash_route"])
def test_fused_tokens_equal_jax(case, monkeypatch):
    """``sample_interleaved_fused`` on the f32 cache: the port's segments
    equal JAX's token for token. ``sampled_flash_route`` gives the cache
    2048 slots and forces ``USE_FLASH_DECODE`` in both packages, so every
    decode step's attention takes the flash-decode route with the live
    ``key_mask`` (JAX's kernel in interpret mode, the port's plain version,
    both float32)."""
    jw, tw = _pair(seed=1 if case == "greedy" else 0)
    n_text = 6
    budget = 18 + 2 * n_text
    v = jw.vocab.vocab_size
    key = jax.random.PRNGKey(3)
    kwargs = {}
    if case == "greedy":
        jgen, tgen = JGenParams(greedy=True), TGenParams(greedy=True)
        jopts = jil.TextGenOptions(max_gen_len=n_text, greedy=True)
        topts = til.TextGenOptions(max_gen_len=n_text, greedy=True)
        noise = None
    else:
        jgen, tgen = JGenParams(temperature=1.0, top_p=0.95), TGenParams(temperature=1.0, top_p=0.95)
        jopts = jil.TextGenOptions(max_gen_len=n_text, temp=1.0, top_p=0.95)
        topts = til.TextGenOptions(max_gen_len=n_text, temp=1.0, top_p=0.95)
        noise = _fed_noise(key, budget, v)
        jw.set_watermarker(JSpec.from_string(WATERMARK, vocab_size=v, spatial_dim=4))
        tw.set_watermarker(TSpec.from_string(WATERMARK, vocab_size=v, spatial_dim=4))
    if case == "sampled_flash_route":
        monkeypatch.setattr(jl, "USE_FLASH_DECODE", True)
        monkeypatch.setattr(tl, "USE_FLASH_DECODE", True)
        kwargs["cache_budget"] = 2048
    wm = case != "greedy"
    want = jil.sample_interleaved_fused(jw, "a cat", jgen, text_opts=jopts, max_images=1, apply_watermark=wm,
                                        rng=key, **kwargs)
    got = til.sample_interleaved_fused(tw, "a cat", tgen, text_opts=topts, max_images=1, apply_watermark=wm,
                                       noise=noise, **kwargs)
    assert _lists(got) == _lists(want)
    _check_structure(got, tw.vocab)
    assert [np.asarray(t).shape[1] for kind, t in got if kind == "image_seg"] == [16]


def test_fused_flash_route_is_taken(monkeypatch):
    """With a 2048-slot cache the fused loop calls the flash-decode wrapper
    once per layer and step with the ``[3, t_max]`` key mask, without the
    flag forced; below 2048 slots it does not."""
    _, tw = _pair(port_only=True)
    calls = []
    real = tl.flash_decode_attention

    def spy(q, k, v, valid_len, start=None, key_mask=None):
        calls.append((tuple(k.shape), None if key_mask is None else tuple(key_mask.shape)))
        return real(q, k, v, valid_len, start=start, key_mask=key_mask)

    monkeypatch.setattr(tl, "flash_decode_attention", spy)
    opts = til.TextGenOptions(max_gen_len=2, greedy=True)
    til.sample_interleaved_fused(tw, "x", TGenParams(greedy=True), text_opts=opts, max_images=1)
    assert calls == []
    til.sample_interleaved_fused(tw, "x", TGenParams(greedy=True), text_opts=opts, max_images=1, cache_budget=2048)
    budget = 18 + 2 * 2
    assert len(calls) == (budget - 1) * 2 and set(calls) == {((3, 4, 2048, 8), (3, 2048))}


@pytest.mark.parametrize("cache", ["int8", "packed", "packed4"])
def test_fused_quantized_caches_structure(cache, monkeypatch):
    """The fused loop on the int8 cache (flash route forced, kernel #6's
    plain version) and on the packed caches at 1024 slots (the chunked
    kernels' masked route): valid segments with a whole image, and the
    first text segment of the f32 run (greedy; later tokens may part ways
    under the quantization noise of a tiny random model)."""
    _, tw = _pair(seed=1, port_only=True)
    opts = til.TextGenOptions(max_gen_len=4, greedy=True)
    gen = TGenParams(greedy=True)
    ref = til.sample_interleaved_fused(tw, "a cat", gen, text_opts=opts, max_images=1)
    tw.cache_dtype = torch.int8 if cache == "int8" else cache
    if cache == "int8":
        monkeypatch.setattr(tl, "USE_FLASH_DECODE", True)
    got = til.sample_interleaved_fused(tw, "a cat", gen, text_opts=opts, max_images=1,
                                       cache_budget=None if cache == "int8" else 1024)
    _check_structure(got, tw.vocab)
    assert [kind for kind, _ in got][:2] == ["text_seg", "image_seg"] and got[1][1].shape == (1, 16)
    if cache != "packed4":  # int4 noise moves a tiny model's first argmax
        assert got[0][1].tolist() == ref[0][1].tolist()


def test_fused_sp_mesh_raises():
    _, tw = _pair(port_only=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        til.sample_interleaved_fused(tw, "x", TGenParams(greedy=True), sp_mesh=object())


def test_fused_matches_reprefill_greedy():
    """As the JAX test of this name: with compacted per-row rope positions
    the fused one-loop path gives the tokens of the segment-wise re-prefill
    path (``sample_interleaved``) under greedy decoding."""
    opts = til.TextGenOptions(max_gen_len=64, greedy=True)
    gen = TGenParams(greedy=True)

    def flat(segs, eoi):
        out = []
        for kind, toks in segs:
            out += [int(t) for t in np.asarray(toks).reshape(-1)]
            if kind == "image_seg":
                out += [eoi]
        return out

    saw_image = False
    for seed in range(8):
        _, tw = _pair(seed=seed, port_only=True)
        tw.tokenizer = lambda s: [6 + (ord(c) % 20) for c in s[:4]]
        segs_ref = til.sample_interleaved(tw, "ab", gen, text_opts=opts, max_images=1)
        segs_fused = til.sample_interleaved_fused(tw, "ab", gen, text_opts=opts, max_images=1)
        a, b = flat(segs_ref, tw.vocab.eoi_id), flat(segs_fused, tw.vocab.eoi_id)
        n = min(len(a), len(b))
        assert n > 0 and a[:n] == b[:n], (seed, a[:n], b[:n])
        if any(kind == "image_seg" for kind, _ in segs_ref):
            saw_image = True
            break
    assert saw_image, "no greedy run emitted an image segment in 8 seeds"


def test_fused_watermarked_image_is_green():
    """A strong watermark (delta 8, gamma 0.5, one fixed greenlist) inside
    the fused loop: at least 90% of the image segment's tokens are green."""
    from wmar_tpu_torch.core.spec import SeedStrategy, SplitStrategy

    _, tw = _pair(port_only=True)
    spec = TSpec(vocab_size=tw.vocab.vocab_size, seed_strategy=SeedStrategy.FIXED, split_strategy=SplitStrategy.RANDOM,
                 context_size=0, delta=8.0, gamma=0.5)
    tw.set_watermarker(spec)
    img = []
    for seed in range(12):  # whether <boi> comes is up to a random model
        segs = til.sample_interleaved_fused(tw, "a dog", TGenParams(temperature=1.0, top_p=1.0),
                                            text_opts=til.TextGenOptions(max_gen_len=6, temp=1.0, top_p=0.95),
                                            max_images=1, apply_watermark=True,
                                            generator=torch.Generator().manual_seed(seed))
        img = [t for kind, t in segs if kind == "image_seg" and np.asarray(t).shape[1] == 16]
        if img:
            break
    assert img, "no image segment generated in 12 seeds"
    codes = torch.as_tensor(np.asarray(img[0]).reshape(-1))
    green = tw.greenlist.green_mask(torch.zeros((1,), dtype=torch.int64))[0][codes]
    assert green.float().mean() >= 0.9


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generate_entry_point_interleaved_tree(tmp_path):
    """``python -m wmar_tpu_torch.generate --model chameleon7b --tiny
    --device cpu --interleaved <file>`` writes the JAX CLI's tree:
    ``p=<i>,idx=<s>/`` with ``prompt.txt``, ``seg<k>_text.{txt,npy}`` and
    ``seg<k>_img.{png,npy,json}``, the json with both p-values."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\n\na dog on a hill\n")
    out = tmp_path / "out"
    run = subprocess.run([sys.executable, "-m", "wmar_tpu_torch.generate", "--model", "chameleon7b", "--tiny",
                          "--device", "cpu", "--interleaved", str(prompts), "--num_samples_per_conditioning", "2",
                          "--text_gen_len", "5", "--max_images", "1", "--outdir", str(out)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "interleaved image segments" in run.stdout
    tree = _tree(out)
    dirs = sorted({p.split(os.sep)[0] for p in tree})
    assert dirs == ["p=0,idx=0", "p=0,idx=1", "p=1,idx=0", "p=1,idx=1"]
    assert (out / "p=1,idx=0" / "prompt.txt").read_text() == "a dog on a hill\n"
    for d in dirs:
        names = [os.path.basename(p) for p in tree if p.startswith(d + os.sep)]
        assert "prompt.txt" in names and any(n.startswith("seg") for n in names)
        for n in names:
            if n.endswith("_img.json"):
                stem = n[: -len(".json")]
                assert {stem + ".png", stem + ".npy"} <= set(names)
                rec = json.loads((out / d / n).read_text())
                assert set(rec) == {"prompt", "segment", "pvalue_raw", "pvalue_roundtrip"}
                assert 0 <= rec["pvalue_raw"] <= 1 and 0 <= rec["pvalue_roundtrip"] <= 1
                assert np.load(out / d / (stem + ".npy")).shape == (1, 16)
            elif n.endswith("_text.txt"):
                toks = np.load(out / d / n.replace(".txt", ".npy"))
                assert (out / d / n).read_text().split() == [str(t) for t in toks[0]]
    assert any(n.endswith("_img.json") for n in tree)


def test_chip_smoke_interleaved_phases_on_cpu():
    """``chip_smoke.py``'s phases for kernels #5-#7 and #9, the microbench's
    bounds and masks, and the two interleaved phases at a tiny size on the
    CPU, where the wrappers take their plain versions: every check of
    theirs passes before the card sees them, and no launch is counted."""
    import chip_smoke
    from wmar_tpu_torch.tools import bench_attention as ba

    errs = chip_smoke.phase_flash_kernels("cpu", shapes=(("tiny3", 3, 2, 40, 16), ("tiny", 4, 2, 40, 20)),
                                          lens=(1, 2, 17, 40), interleaved=(3, 4, 16))
    assert set(errs) == {"flash_decode_attention", "flash_decode_attention_q8"}
    assert all(0 < e < 2e-2 for e in errs.values())
    errs = chip_smoke.phase_probes("cpu", shapes=(("tiny", 4, 10, 2, 20),), rows_list=(1, 5))
    assert errs["_packed_dma_probe"] == 0.0 and 0 <= errs["row_mean_probe"] < 4e-3
    # the bound counts the slots that take part: row 0 sees 60, rows 1 and 2 <s> and the image span 7..24
    km = ba.interleaved_masks(1024, 60, 3, 4, 16, "cpu")
    assert km.sum(1).tolist() == [60, 19, 19]
    assert ba.slots_taking_part(3, 1024, 60, key_mask=km) == 98
    assert ba.slots_taking_part(3, 1024, 60, start=torch.tensor([0, 10, 59])) == 60 + 50 + 1
    ms, by = ba.attention_bound(3, 2, 1024, 16, 60, 2, False, torch.bfloat16, torch.bfloat16, key_mask=km)
    assert by == "bytes" and ms == pytest.approx((98 * 2 * 64 + 180 + 2 * 3 * 2 * 16 * 2) / 3.35e12 * 1e3)
    ms8, _ = ba.attention_bound(3, 2, 1024, 16, 60, 1, True, torch.bfloat16, torch.int8, key_mask=km)
    assert ms8 == pytest.approx((98 * 2 * (32 + 4) + 180 + 2 * 3 * 2 * 16 * 2) / 3.35e12 * 1e3)
    assert ba.bound(1e3, 1e12, torch.float32) == (pytest.approx(1e12 / 67e12 * 1e3), "operations")
    vocab = tcham.ChameleonVocab.synthetic(n_codes=64, n_text=40)
    wrapper = chip_smoke.build_chameleon(
        "cpu", tl.LlamaConfig(dim=64, n_layers=2, n_heads=4, vocab_size=vocab.vocab_size, multiple_of=16),
        tvq.VQGANConfig(**{**VQ, "resolution": 16, "n_embed": 64}), vocab)
    # 2 text tokens a segment: a 40-word random model would often draw </s> within the default 64
    res = chip_smoke.phase_interleaved("cpu", wrapper, text_gen_len=2)
    assert set(res["launches"].values()) == {0} and set(res["runs"]) == {"bf16", "int8"}
    for run in res["runs"].values():
        assert "prompt.txt" in run["files"] and len(run["records"]) == 2
        assert all(f > 0.35 for f in run["green_fractions"])
    # as the script runs it, through a view of the wrapper's first layers (here all 2: the tiny random
    # model at 1 layer draws </s> before its image)
    res = chip_smoke.phase_interleaved_4k("cpu", chip_smoke.first_layers(wrapper, 2), cache_budget=2048,
                                          text_opts=til.TextGenOptions(max_gen_len=2))
    assert set(res["launches"].values()) == {0} and set(res["runs"]) == {"bf16", "int8", "packed4"}
    assert all(r["segments"].count("image_seg") == 1 for r in res["runs"].values())
