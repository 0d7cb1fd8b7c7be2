"""Port parity, the checkpoint converters (``wmar_tpu_torch.utils.convert``
against ``wmar_tpu.utils.convert``).

Random state dicts in the reference's own layouts (numpy from a seed, the
keys and shapes of the reference modules: Taming's ``net2net.ckpt`` and
``vqgan.ckpt``, MaskGit's tokenizer, RAR, Chameleon's ``consolidated.*.pth``)
go through both packages' converters. The converters only transpose, slice
and join, so the trees must be equal bit for bit: the same keys, shapes and
dtypes, and the same msgpack bytes. The port's modules loaded from the
port's trees then match JAX's forward at the tolerances of the existing
parity tests (decode 1e-4 and equal codes, logits 1e-4). The builders here
also serve the other converter test files.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from wmar_tpu import models as jmodels
from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.models import llama as jl
from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import taming_gpt as jgpt
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.utils import convert as jconv
from wmar_tpu_torch import bridge
from wmar_tpu_torch import models as tmodels
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.models import taming_gpt as tgpt
from wmar_tpu_torch.sync.wam_exact import taming_name
from wmar_tpu_torch.utils import checkpoint as tckpt
from wmar_tpu_torch.utils import convert as tconv

VQ_TAMING = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=32,
                 n_embed=16, embed_dim=8)
VQ_CHAMELEON = dict(VQ_TAMING, attn_resolutions=())
MASKGIT = dict(resolution=16, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16, n_embed=64,
               embed_dim=16)
GPT = dict(vocab_size=64, block_size=20, n_layer=2, n_head=2, n_embd=32)
RAR = dict(embed_dim=64, depth=2, num_heads=2, intermediate_size=128, image_seq_len=16, codebook_size=64,
           num_classes=10)
LLAMA = dict(dim=32, n_layers=2, n_heads=4, vocab_size=64, multiple_of=16, qk_normalization=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Reference layouts
# ---------------------------------------------------------------------------


def random_sd(names_shapes, seed: int) -> dict:
    """float32 arrays for (key, shape) pairs: 1-d weights (norm scales)
    near one, the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in names_shapes:
        a = rng.normal(0, 0.1, shape)
        if key.endswith(".weight") and len(shape) == 1:
            a = a + 1.0
        out[key] = a.astype(np.float32)
    return out


def _meta(build):
    with torch.device("meta"):
        return build()


def taming_vqgan_sd(kw=VQ_TAMING, seed=0, prefix="") -> dict:
    """A Taming / Chameleon ``VQModel`` state dict (``vqgan.ckpt``'s keys):
    the port's module names, renamed as taming names them."""
    model = _meta(lambda: tmodels.TamingVQGAN(tmodels.VQGANConfig(**kw)))

    def name(k):
        part, rest = k.split(".", 1)
        if part in ("encoder", "decoder"):
            return f"{part}.{taming_name(rest)}"
        return "quantize.embedding.weight" if k == "quantize.embedding" else k

    return random_sd([(prefix + name(k), tuple(v.shape)) for k, v in model.state_dict().items()], seed)


_MASKGIT_RENAMES = (
    (r"^(encoder|decoder)\.(down|up)_(\d+)_block_(\d+)\.GroupNorm_0\.", r"\1.\2.\3.block.\4.norm1."),
    (r"^(encoder|decoder)\.(down|up)_(\d+)_block_(\d+)\.GroupNorm_1\.", r"\1.\2.\3.block.\4.norm2."),
    (r"^(encoder|decoder)\.(down|up)_(\d+)_block_(\d+)\.", r"\1.\2.\3.block.\4."),
    (r"^(encoder|decoder)\.mid_block_(\d+)\.GroupNorm_0\.", r"\1.mid.\2.norm1."),
    (r"^(encoder|decoder)\.mid_block_(\d+)\.GroupNorm_1\.", r"\1.mid.\2.norm2."),
    (r"^(encoder|decoder)\.mid_block_(\d+)\.", r"\1.mid.\2."),
    (r"^decoder\.up_(\d+)_upsample_conv\.", r"decoder.up.\1.upsample_conv."),
    (r"^(encoder|decoder)\.GroupNorm_0\.", r"\1.norm_out."),
    (r"^embedding$", "quantize.embedding.weight"),
)


def _renamed(key, renames):
    for pat, rep in renames:
        new, n = re.subn(pat, rep, key)
        if n:
            return new
    return key


def maskgit_sd(kw=MASKGIT, seed=0) -> dict:
    """MaskGit-VQGAN's (``maskgit-vqgan-imagenet-f16-256.bin``) keys."""
    model = _meta(lambda: tmodels.MaskGitVQGAN(tmodels.MaskGitVQConfig(**kw)))
    return random_sd([(_renamed(k, _MASKGIT_RENAMES), tuple(v.shape)) for k, v in model.state_dict().items()], seed)


def _linear_tree_sd(model, top, renames, seed, prefix=""):
    """A tree-named module (``.w [in, out]``, ``.b``, ``.scale``) as the
    reference's Linear / LayerNorm keys; ``top`` maps the top-level leaves
    to (key, transposed, leading unit axis)."""
    items = []
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k in top:
            key, transposed, unit = top[k]
            shape = ((1,) if unit else ()) + (shape[::-1] if transposed else shape)
        else:
            mod, leaf = k.rsplit(".", 1)
            if leaf == "w":
                leaf, shape = "weight", shape[::-1]
            leaf = {"b": "bias", "scale": "weight"}.get(leaf, leaf)
            key = _renamed(f"{mod}.{leaf}", renames)
        items.append((prefix + key, shape))
    return random_sd(items, seed)


def taming_gpt_sd(kw=GPT, seed=1) -> dict:
    """``net2net.ckpt``'s ``transformer.*`` (minGPT's names)."""
    model = _meta(lambda: tmodels.GPT(tmodels.GPTConfig(**kw)))
    top = {"tok_emb": ("tok_emb.weight", False, False), "pos_emb": ("pos_emb", False, True),
           "head": ("head.weight", True, False)}
    renames = ((r"\.attn\.q\.", ".attn.query."), (r"\.attn\.k\.", ".attn.key."), (r"\.attn\.v\.", ".attn.value."),
               (r"\.mlp\.fc\.", ".mlp.0."), (r"\.mlp\.proj\.", ".mlp.2."))
    return _linear_tree_sd(model, top, renames, seed, prefix="transformer.")


def rar_sd(kw=RAR, seed=2) -> dict:
    """RAR's ``rar_*.bin`` keys."""
    model = _meta(lambda: tmodels.RAR(tmodels.RARConfig(**kw)))
    top = {"cls_token": ("cls_token", False, False), "embeddings": ("embeddings.weight", False, False),
           **{k: (k, False, True) for k in ("pos_embed", "target_aware_pos_embed", "timesteps_embeddings")}}
    renames = ((r"\.adaln\.", ".adaLN_modulation.1."), (r"^final_adaln\.", "adaln_before_head.adaLN_modulation.1."))
    return _linear_tree_sd(model, top, renames, seed)


def discriminator_sd(ndf=8, n_layers=3, seed=3, prefix="first_stage_model.loss.discriminator.main.") -> dict:
    """Taming's ``NLayerDiscriminator.main`` (conv, then conv + BatchNorm
    pairs without conv bias, then the last conv)."""
    items, idx, c_in = [(f"{prefix}0.weight", (ndf, 3, 4, 4)), (f"{prefix}0.bias", (ndf,))], 2, ndf
    for n in range(1, n_layers + 1):
        c_out = ndf * min(2**n, 8)
        items += [(f"{prefix}{idx}.weight", (c_out, c_in, 4, 4))]
        items += [(f"{prefix}{idx + 1}.{name}", (c_out,)) for name in ("weight", "bias", "running_mean")]
        items += [(f"{prefix}{idx + 1}.running_var", (c_out,))]
        idx, c_in = idx + 3, c_out
    items += [(f"{prefix}{idx}.weight", (1, c_in, 4, 4)), (f"{prefix}{idx}.bias", (1,))]
    sd = random_sd(items, seed)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    return sd


def llama_sd(kw=LLAMA, seed=4, fused=False) -> dict:
    """A Chameleon transformer state dict, unfused (the published shards'
    layout) or fused (``wqkv`` / ``w13``, the reference after loading)."""
    cfg = tl.LlamaConfig(**kw)
    d, hd, kvd, ffn, v = cfg.dim, cfg.head_dim, cfg.kv_heads * cfg.head_dim, cfg.ffn_hidden, cfg.vocab_size
    items = [("tok_embeddings.weight", (v, d)), ("norm.weight", (d,)), ("output.weight", (v, d))]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        if fused:
            items += [(p + "attention.wqkv.weight", (d + 2 * kvd, d)), (p + "feed_forward.w13.weight", (2 * ffn, d))]
        else:
            items += [(p + "attention.wq.weight", (d, d)), (p + "attention.wk.weight", (kvd, d)),
                      (p + "attention.wv.weight", (kvd, d)), (p + "feed_forward.w1.weight", (ffn, d)),
                      (p + "feed_forward.w3.weight", (ffn, d))]
        items += [(p + "attention.wo.weight", (d, d)), (p + "feed_forward.w2.weight", (d, ffn)),
                  (p + "attention_norm.weight", (d,)), (p + "ffn_norm.weight", (d,))]
        if cfg.qk_normalization:
            items += [(p + f"attention.{x}_normalization.{n}", (hd,)) for x in "qk" for n in ("weight", "bias")]
    return random_sd(items, seed)


def shard_llama_sd(sd: dict, n: int) -> list:
    """``n`` tensor-parallel shards as the reference writes them: column-
    parallel weights split on dim 0, row-parallel ones on dim 1, a fused
    ``wqkv`` / ``w13`` as each rank's slices of its parts stacked, norms
    replicated."""
    shards = [{} for _ in range(n)]
    for key, a in sd.items():
        if "wqkv" in key or "w13" in key:
            parts = np.split(a, 3 if "wqkv" in key else 2, axis=0)
            for r in range(n):
                shards[r][key] = np.concatenate([np.split(p, n, axis=0)[r] for p in parts], axis=0)
        elif any(t in key for t in (".wq.", ".wk.", ".wv.", ".w1.", ".w3.", "output.weight", "tok_embeddings")):
            for r, piece in enumerate(np.split(a, n, axis=0)):
                shards[r][key] = piece
        elif any(t in key for t in (".wo.", ".w2.")):
            for r, piece in enumerate(np.split(a, n, axis=1)):
                shards[r][key] = piece
        else:
            for r in range(n):
                shards[r][key] = a
    return shards


def tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def assert_same_tree(got, want) -> None:
    """Equal keys, shapes, dtypes and bits, and the msgpack bytes that the
    JAX package's ``save_pytree`` writes for JAX's tree."""
    g, w = dict(bridge.flatten(got)), dict(bridge.flatten(want))
    assert sorted(g) == sorted(w)
    for k, a in w.items():
        a = np.asarray(a)
        t = g[k]
        assert isinstance(t, torch.Tensor), k
        assert str(t.dtype).replace("torch.", "") == a.dtype.name and tuple(t.shape) == a.shape, k
        assert np.array_equal(t.numpy(), a), k
    assert tckpt.to_bytes(got) == serialization.to_bytes(jax.device_get(want))


# ---------------------------------------------------------------------------
# Converters: equal trees
# ---------------------------------------------------------------------------


def _cases():
    tam = dict(VQ_TAMING)
    return {
        "taming_gpt": (taming_gpt_sd(), lambda c, m, sd: c.convert_taming_gpt(sd, m.GPTConfig(**GPT))),
        "taming_vqgan": (taming_vqgan_sd(prefix="first_stage_model."),
                         lambda c, m, sd: c.convert_taming_vqgan(sd, m.VQGANConfig(**tam), prefix="first_stage_model.")),
        "chameleon_vqgan": (taming_vqgan_sd(VQ_CHAMELEON, seed=5),
                            lambda c, m, sd: c.convert_taming_vqgan(sd, m.VQGANConfig(**VQ_CHAMELEON))),
        "maskgit_vqgan": (maskgit_sd(), lambda c, m, sd: c.convert_maskgit_vqgan(sd, m.MaskGitVQConfig(**MASKGIT))),
        "rar": (rar_sd(), lambda c, m, sd: c.convert_rar(sd, m.RARConfig(**RAR))),
        "chameleon_llama": (llama_sd(), lambda c, m, sd: c.convert_chameleon_llama(sd, m.LlamaConfig(**LLAMA))),
        "chameleon_llama_fused": (llama_sd(fused=True),
                                  lambda c, m, sd: c.convert_chameleon_llama(sd, m.LlamaConfig(**LLAMA))),
    }


def _convert_both(sd, fn):
    """(the port's tree from tensors, JAX's tree from numpy)."""
    return fn(tconv, tmodels, tensors(sd)), fn(jconv, jmodels, sd)


@pytest.mark.parametrize("name", ["taming_gpt", "taming_vqgan", "chameleon_vqgan", "maskgit_vqgan", "rar",
                                  "chameleon_llama", "chameleon_llama_fused"])
def test_converter_trees_equal_jax(name):
    sd, fn = _cases()[name]
    got, want = _convert_both(sd, fn)
    assert_same_tree(got, want)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_merge_chameleon_shards(n, fused):
    """1, 2 and 4 shards merge back to the full state dict in both
    packages, and the merged one converts to JAX's tree."""
    full = llama_sd(dict(LLAMA, dim=64, n_heads=4), fused=fused)
    shards = shard_llama_sd(full, n)
    want = jconv.merge_chameleon_shards(shards)
    got = tconv.merge_chameleon_shards([tensors(s) for s in shards])
    assert sorted(got) == sorted(want) == sorted(full)
    for k in full:
        np.testing.assert_array_equal(got[k].numpy(), full[k])
        np.testing.assert_array_equal(np.asarray(want[k]), full[k])
    cfg = dict(LLAMA, dim=64, n_heads=4)
    assert_same_tree(tconv.convert_chameleon_llama(got, tl.LlamaConfig(**cfg)),
                     jconv.convert_chameleon_llama(want, jl.LlamaConfig(**cfg)))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_chameleon_merge_and_convert_pop_their_sources(fused):
    """The shards' merge and the Llama conversion take each tensor out of
    their input as they use it (the tool then holds about one copy of the
    7B's weights), and the result is the tree of the untouched input."""
    cfg = dict(LLAMA, dim=64, n_heads=4)
    full = llama_sd(cfg, fused=fused)
    shards = [tensors(s) for s in shard_llama_sd(full, 2)]
    merged = tconv.merge_chameleon_shards(shards)
    assert shards == [{}, {}]
    tree = tconv.convert_chameleon_llama(merged, tl.LlamaConfig(**cfg))
    assert merged == {}
    assert_same_tree(tree, jconv.convert_chameleon_llama(full, jl.LlamaConfig(**cfg)))


_DELTAS = {
    "taming": (lambda: taming_vqgan_sd(prefix="first_stage_model."), "first_stage_model.",
               lambda c, m: lambda s: c.convert_taming_vqgan(s, m.VQGANConfig(**VQ_TAMING), prefix="first_stage_model.")),
    "chameleon": (lambda: taming_vqgan_sd(VQ_CHAMELEON, seed=5), "",
                  lambda c, m: lambda s: c.convert_taming_vqgan(s, m.VQGANConfig(**VQ_CHAMELEON))),
    "maskgit": (lambda: maskgit_sd(), "", lambda c, m: lambda s: c.convert_maskgit_vqgan(s, m.MaskGitVQConfig(**MASKGIT))),
}


def delta_sd(base: dict, part: str, stage: str, seed: int = 9) -> dict:
    """An RCC delta of ``part`` with keys relative to it, as the reference publishes."""
    rng = np.random.default_rng(seed)
    pre = f"{stage}{part}."
    return {k[len(pre):]: rng.normal(0, 0.01, v.shape).astype(np.float32) for k, v in base.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("part", ["encoder", "decoder"])
@pytest.mark.parametrize("kind", list(_DELTAS))
def test_convert_vqgan_delta(kind, part):
    """``convert(base + delta) - convert(base)`` bit for bit against JAX's,
    and a delta key without a base weight raises in both."""
    make, stage, fn = _DELTAS[kind]
    base = make()
    delta = delta_sd(base, part, stage)
    want = jconv.convert_vqgan_delta(base, delta, part, fn(jconv, jmodels), stage_prefix=stage)
    got = tconv.convert_vqgan_delta(tensors(base), tensors(delta), part, fn(tconv, tmodels), stage_prefix=stage)
    assert_same_tree(got, want)
    with pytest.raises(KeyError, match="no base weight"):
        tconv.convert_vqgan_delta(tensors(base), {"nope.weight": torch.zeros(1)}, part, fn(tconv, tmodels),
                                  stage_prefix=stage)


def test_load_torch_state_dict_keeps_dtypes_and_unwraps(tmp_path):
    """Pickles (wrapped in ``state_dict`` / ``model``), TorchScript archives
    and ``.safetensors`` come back as tensors of their own dtype, bf16
    included (the JAX loader turns them into numpy and raises on bf16)."""
    from safetensors.torch import save_file

    sd = {"a.weight": torch.randn(3, 2, dtype=torch.bfloat16), "b": torch.arange(4)}
    for wrap, name in ((lambda s: s, "plain.pt"), (lambda s: {"state_dict": s}, "lightning.ckpt"),
                       (lambda s: {"model": s, "epoch": 3}, "mimi.pth")):
        torch.save(wrap(sd), tmp_path / name)
        got = tconv.load_torch_state_dict(str(tmp_path / name))
        assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) and got[k].dtype == sd[k].dtype
                                                 for k in sd)
    save_file(sd, str(tmp_path / "w.safetensors"))
    got = tconv.load_torch_state_dict(str(tmp_path / "w.safetensors"))
    assert all(torch.equal(got[k], sd[k]) and got[k].dtype == sd[k].dtype for k in sd)
    torch.jit.save(torch.jit.script(torch.nn.Linear(2, 3)), str(tmp_path / "m.jit.pt"))
    assert sorted(tconv.load_torch_state_dict(str(tmp_path / "m.jit.pt"))) == ["bias", "weight"]
    with pytest.raises(TypeError):
        jconv.load_torch_state_dict(str(tmp_path / "plain.pt"))


def test_load_torch_state_dict_unpickles_in_full_only_when_allowed(tmp_path):
    """A pickle that holds more than tensors and plain containers (a
    Lightning checkpoint's hyper-parameters) loads by a full unpickling,
    as in JAX; with ``weights_only=True`` (the codecs' files) it is refused."""
    import argparse
    import pickle

    sd = {"a.weight": torch.randn(3, 2)}
    path = str(tmp_path / "lightning.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    got = tconv.load_torch_state_dict(path)
    assert sorted(got) == ["a.weight"] and torch.equal(got["a.weight"], sd["a.weight"])
    with pytest.raises(pickle.UnpicklingError):
        tconv.load_torch_state_dict(path, weights_only=True)
    torch.save({"state_dict": sd}, tmp_path / "plain.ckpt")
    assert sorted(tconv.load_torch_state_dict(str(tmp_path / "plain.ckpt"), weights_only=True)) == ["a.weight"]


# ---------------------------------------------------------------------------
# The port's modules from the port's trees against JAX's forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["taming_vqgan", "maskgit_vqgan"])
def test_tokenizers_from_converted_trees_match_jax(name):
    """Decode at atol 1e-4, encode to equal codes."""
    sd, fn = _cases()[name]
    if name == "taming_vqgan":
        sd["first_stage_model.quantize.embedding.weight"] = np.random.default_rng(6).standard_normal(
            (VQ_TAMING["n_embed"], VQ_TAMING["embed_dim"])).astype(np.float32)
    got, want = _convert_both(sd, fn)
    if name == "taming_vqgan":
        cfg = jvq.VQGANConfig(**VQ_TAMING)
        jm = jvq.TamingVQGAN(cfg)
        tm = bridge.load_taming_vqgan(tmodels.TamingVQGAN(tmodels.VQGANConfig(**VQ_TAMING)), got)
        decode, encode = jvq.TamingVQGAN.decode_codes, jvq.TamingVQGAN.encode_codes
        lo = -1.0
    else:
        cfg = jmg.MaskGitVQConfig(**MASKGIT)
        jm = jmg.MaskGitVQGAN(cfg)
        tm = bridge.load_maskgit(tmodels.MaskGitVQGAN(tmodels.MaskGitVQConfig(**MASKGIT)), got)
        decode, encode = jmg.MaskGitVQGAN.decode_codes, jmg.MaskGitVQGAN.encode_codes
        lo = 0.0
    rng = np.random.default_rng(7)
    codes = rng.integers(0, cfg.n_embed, size=(2, cfg.codes_per_side**2))
    imgs = rng.uniform(lo, 1, (2, cfg.resolution, cfg.resolution, 3)).astype(np.float32)
    with torch.inference_mode():
        np.testing.assert_allclose(tm.decode_codes(torch.as_tensor(codes)).numpy(),
                                   np.asarray(jm.apply(want, jnp.asarray(codes), method=decode)), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tm.encode_codes(torch.as_tensor(imgs)).numpy(),
                                      np.asarray(jm.apply(want, jnp.asarray(imgs), method=encode)))


def test_gpt_and_llama_from_converted_trees_match_jax():
    """minGPT's and Chameleon's converted trees: the port's logits against
    JAX's at atol 1e-4."""
    got, want = _convert_both(*_cases()["taming_gpt"])
    tokens = np.random.default_rng(8).integers(0, GPT["vocab_size"], size=(2, 7))
    jlogits, _ = jgpt.gpt_forward(want, jgpt.GPTConfig(**GPT), jnp.asarray(tokens, jnp.int32))
    model = bridge.load_gpt(tgpt.GPT(tgpt.GPTConfig(**GPT)), got)
    with torch.inference_mode():
        tlogits, _ = tgpt.gpt_forward(model, torch.as_tensor(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)

    got, want = _convert_both(*_cases()["chameleon_llama"])
    jcfg, tcfg = jl.LlamaConfig(**LLAMA), tl.LlamaConfig(**LLAMA)
    tokens = np.random.default_rng(9).integers(0, LLAMA["vocab_size"], size=(1, 6))
    positions = np.arange(6)[None]
    jlogits, _ = jl.llama_forward(want, jcfg, jnp.asarray(tokens), jkv.KVCache.zeros(2, 1, 4, 8, 8), 0,
                                  jnp.asarray(positions))
    with torch.inference_mode():
        tlogits, _ = tl.llama_forward(bridge.load_llama(got), tcfg, torch.as_tensor(tokens, dtype=torch.int64),
                                      tkv.KVCache.zeros(2, 1, 4, 8, 8), 0, torch.as_tensor(positions))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
