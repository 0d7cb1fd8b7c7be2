"""Port parity, checkpoints: the msgpack codec, ``utils.checkpoint``, the
bridge's inverse, ``tools/apply_deltas``, ``generate``'s ``--modelpath``
and RCC deltas, and ``precompute_imagenet_codes`` against the JAX package
on the CPU.

The codec is held to flax byte for byte: the port reads what
``flax.serialization.to_bytes`` / ``msgpack_serialize`` write (float32,
float16, bfloat16, int8/32, uint8, numpy scalars, nested dicts and lists,
chunked leaves with ``MAX_CHUNK_SIZE`` set small), flax reads what the port
writes, and both write the same bytes for the same tree. Values read are
exact. Deltas add in float32, so base + delta equals the trained weights
within float32 rounding: 4 ulps of the largest weight (``DELTA_ULPS``).
"""

import argparse
import importlib
import os
import sys

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from wmar_tpu.models import maskgit_vqgan as jmg
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.utils import checkpoint as jckpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch.models import maskgit_vqgan as tmg
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.utils import checkpoint as tckpt
from wmar_tpu_torch.utils import msgpack_codec as codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAMING_VQ = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), z_channels=32,
                 n_embed=64, embed_dim=16)
MASKGIT_VQ = dict(resolution=16, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16,
                  n_embed=64, embed_dim=16)
DELTA_ULPS = 4


def _root_module(name):
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(REPO)


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"kernel": rng.normal(size=(3, 4)).astype(np.float32), "half": rng.normal(size=(5,)).astype(np.float16)},
        "bf": np.asarray(jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)),
        "ints": {"i8": rng.integers(-128, 127, (7,), dtype=np.int8), "i32": rng.integers(-2**31, 2**31 - 1, (2, 2),
                                                                                         dtype=np.int32),
                 "u8": rng.integers(0, 255, (300,), dtype=np.uint8)},
        "scalars": {"f": np.float32(3.5), "i": np.int32(-7), "b": np.bool_(True)},
        "layers": [rng.normal(size=(2,)).astype(np.float32) for _ in range(12)],  # "10" < "2" as strings
        "empty": np.zeros((0, 3), np.float32),
        "big": rng.normal(size=(70_000,)).astype(np.float32),  # bin32
    }


def _as_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype.name == "bfloat16" else t


def _assert_tree_equal(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_tree_equal(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_tree_equal(a, b)
    else:
        ref = np.asarray(ref)
        got = _as_np(port)
        assert got.shape == ref.shape
        if ref.dtype.name == "bfloat16":
            assert str(port.dtype) in ("torch.bfloat16", "bfloat16")
            ref = ref.astype(np.float32)
        else:
            assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def test_codec_reads_and_writes_flax_to_bytes():
    """``to_bytes(device_get(tree))``: the port writes the same bytes, reads
    them back exactly (numpy scalars became 0-d arrays, lists maps), and
    flax reads the port's bytes into the tree."""
    tree = _mixed_tree()
    want = fs.to_bytes(jax.device_get(tree))
    got = tckpt.to_bytes(tree)
    assert got == want
    back = codec.restore(want)
    assert set(back["layers"]) == {str(i) for i in range(12)}
    _assert_tree_equal(back, fs.msgpack_restore(want))
    _assert_tree_equal(fs.from_bytes(tree, got), tree)


def test_codec_reads_and_writes_msgpack_serialize():
    """``msgpack_serialize`` keeps lists as msgpack arrays and numpy scalars
    as ext type 3: the same bytes from the port, the same values both ways."""
    tree = dict(_mixed_tree(1), meta={"name": "x" * 40, "steps": [1, 300, 70_000, -5, -200], "lr": 1.5e-4,
                                      "none": None, "flag": False})
    want = fs.msgpack_serialize(tree)
    assert codec.serialize(tree) == want
    back = codec.restore(want)
    assert isinstance(back["scalars"]["f"], np.float32) and back["scalars"]["f"] == np.float32(3.5)
    assert back["meta"] == tree["meta"] and isinstance(back["layers"], list)
    _assert_tree_equal(back, fs.msgpack_restore(want))
    _assert_tree_equal(fs.msgpack_restore(codec.serialize(tree)), fs.msgpack_restore(want))


def test_codec_torch_leaves_write_numpy_bytes():
    """Tensors (bf16 included) write as the numpy arrays of the same values."""
    tree = _mixed_tree(2)
    as_torch = {k: v for k, v in tree.items() if k != "scalars"}
    as_torch = jax.tree.map(lambda a: bridge.to_tensor(a), as_torch)
    ref = {k: v for k, v in tree.items() if k != "scalars"}
    assert tckpt.to_bytes(as_torch) == fs.to_bytes(jax.device_get(ref))


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_codec_chunked_leaves(monkeypatch, chunk):
    """Arrays over ``MAX_CHUNK_SIZE`` bytes go as flax's chunked maps: equal
    bytes, and each side reads the other's back into the whole array."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(3)
    tree = {"big": rng.normal(size=(70, 100)).astype(np.float32),
            "bf": np.asarray(jnp.asarray(rng.normal(size=(3000,)), jnp.bfloat16)),
            "small": np.arange(5, dtype=np.int32)}
    want = fs.msgpack_serialize(tree)
    got = codec.serialize(jax.tree.map(bridge.to_tensor, tree))
    assert got == want
    _assert_tree_equal(codec.restore(want), tree)
    _assert_tree_equal(fs.msgpack_restore(got), fs.msgpack_restore(want))


@pytest.mark.parametrize("value", [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
                                   -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 0.5, -1e300, True, False,
                                   None, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000, b"", b"x" * 300,
                                   b"y" * 70000, list(range(15)), list(range(16)), list(range(70000)),
                                   {str(i): i for i in range(15)}, {str(i): i for i in range(16)}])
def test_codec_plain_types_match_msgpack(value):
    """Every plain form (fix/8/16/32/64 ints, floats, str, bin, arrays and
    maps at their boundaries) is written as ``msgpack.packb`` writes it and
    read back."""
    want = msgpack.packb(value, use_bin_type=True)
    assert codec.serialize(value, sort_keys=False) == want
    back = codec.restore(want)
    assert (bytes(back) if isinstance(value, bytes) else back) == value


def test_codec_reads_float32_and_rejects_trailing_bytes():
    assert codec.restore(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        codec.restore(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError):
        codec.restore(msgpack.packb([1, 2])[:-1])


# ---------------------------------------------------------------------------
# save / load and deltas
# ---------------------------------------------------------------------------


def _trees():  # the cases of tests/test_apply_deltas.py
    base = {"encoder": {"w": np.ones((3, 2), np.float32), "b": np.zeros((2,), np.float32)},
            "decoder": {"w": np.full((2, 2), 2.0, np.float32)}}
    return base, {"w": np.full((2, 2), 2.5, np.float32)}


def test_save_load_pytree_both_ways(tmp_path):
    """A file either package saves, the other loads; ``like`` restores lists
    and checks shapes and dtypes."""
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "layers": [np.ones((2,), np.float32)] * 3}
    jp, tp = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_pytree(jp, tree)
    tckpt.save_pytree(tp, jax.tree.map(bridge.to_tensor, tree))
    assert open(jp, "rb").read() == open(tp, "rb").read()
    got = tckpt.load_pytree(jp, like=tree)
    assert isinstance(got["layers"], list)
    _assert_tree_equal(got, tree)
    _assert_tree_equal(jckpt.load_pytree(tp, tree), tree)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(jp, like={"a": {"w": np.zeros((3, 2), np.float32)}, "layers": tree["layers"]})
    with pytest.raises(ValueError, match="dtype"):
        tckpt.load_pytree(jp, like={"a": {"w": np.zeros((2, 3), np.float16)}, "layers": tree["layers"]})
    with pytest.raises(ValueError, match="keys"):
        tckpt.load_pytree(jp, like={"a": {"v": np.zeros((2, 3), np.float32)}, "layers": tree["layers"]})


def test_deltas_against_jax(tmp_path):
    """compute/apply/save/load_and_apply_delta: the port's delta file is
    JAX's bytes; each package applies the other's; base + delta equals the
    new weights within float32 rounding (never asserted bitwise)."""
    rng = np.random.default_rng(4)
    orig = {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)}}
    new = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 1e-3).astype(np.float32), orig)
    jp, tp = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_delta(jp, new, orig)
    tckpt.save_delta(tp, new, orig)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    ulp = np.spacing(np.float32(max(np.abs(new["conv"]["kernel"]).max(), 1e-30)))
    for got in (tckpt.load_and_apply_delta(jp, orig), jckpt.load_and_apply_delta(tp, orig)):
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(_as_np(got["conv"][k]), new["conv"][k], rtol=0, atol=DELTA_ULPS * ulp)
    # the cast back: a bf16 target takes the float32 sum rounded to bf16
    bf = {"w": torch.tensor([1.0, 2.0, -3.0], dtype=torch.bfloat16)}
    out = tckpt.apply_delta(bf, {"w": np.array([1e-3, 0.5, 0.25], np.float32)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.tensor([1.0 + 1e-3, 2.5, -2.75]).to(torch.bfloat16))


def test_apply_deltas_tool_matches_jax_cases(tmp_path):
    """The cases of ``tests/test_apply_deltas.py`` through the port's tool,
    on files the JAX package wrote; the outputs are the JAX tool's bytes."""
    from wmar_tpu_torch.tools import apply_deltas as tool

    jtool = _root_module("tools.apply_deltas")
    base, ft_dec = _trees()
    bp, dp = str(tmp_path / "base.msgpack"), str(tmp_path / "dec_delta.msgpack")
    jckpt.save_pytree(bp, base)
    jckpt.save_delta(dp, ft_dec, base["decoder"])
    out = tool.apply_deltas(bp, [(dp, "decoder")], str(tmp_path / "out.msgpack"))
    np.testing.assert_allclose(_as_np(out["decoder"]["w"]), ft_dec["w"])
    np.testing.assert_allclose(_as_np(out["encoder"]["w"]), base["encoder"]["w"])
    jtool.apply_deltas(bp, [(dp, "decoder")], str(tmp_path / "jout.msgpack"))
    assert open(tmp_path / "out.msgpack", "rb").read() == open(tmp_path / "jout.msgpack", "rb").read()
    _assert_tree_equal(jckpt.load_pytree(str(tmp_path / "out.msgpack"), base),
                       {**base, "decoder": ft_dec})

    new = {"encoder": {"w": base["encoder"]["w"] + 1, "b": base["encoder"]["b"] - 1},
           "decoder": {"w": base["decoder"]["w"] * 3}}
    wp = str(tmp_path / "delta.msgpack")
    jckpt.save_delta(wp, new, base)
    tool.main(["--base", bp, "--delta", wp, "--output", str(tmp_path / "whole.msgpack")])
    _assert_tree_equal(tckpt.load_pytree(str(tmp_path / "whole.msgpack"), base), new)
    with pytest.raises(KeyError, match="nonexistent"):
        tool.apply_deltas(bp, [(dp, "nonexistent")], str(tmp_path / "o.msgpack"))


# ---------------------------------------------------------------------------
# The bridge's inverse
# ---------------------------------------------------------------------------


def _jax_taming(cfg=TAMING_VQ, seed=0):
    model = jvq.TamingVQGAN(jvq.VQGANConfig(**cfg))
    r = cfg["resolution"]
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, r, r, 3))))


def _jax_maskgit(cfg=MASKGIT_VQ, seed=0):
    model = jmg.MaskGitVQGAN(jmg.MaskGitVQConfig(**cfg))
    r = cfg["resolution"]
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, r, r, 3))))


@pytest.mark.parametrize("kind", ["taming", "maskgit"])
def test_flax_tree_inverts_the_bridge(tmp_path, kind):
    """``flax_tree`` of a bridged tokenizer is JAX's tree, leaf for leaf
    (kernels HWIO, GroupNorm ``scale``), and a file of it is the file JAX
    saves of its own tree."""
    if kind == "taming":
        variables = _jax_taming()
        model = bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**TAMING_VQ)), variables)
    else:
        variables = _jax_maskgit()
        model = bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**MASKGIT_VQ)), variables)
    tree = bridge.flax_tree(model)
    _assert_tree_equal(tree, variables["params"])
    jckpt.save_pytree(str(tmp_path / "j.msgpack"), variables["params"])
    tckpt.save_pytree(str(tmp_path / "t.msgpack"), tree)
    assert open(tmp_path / "j.msgpack", "rb").read() == open(tmp_path / "t.msgpack", "rb").read()
    again = bridge.load_flax_file(type(model), model.cfg, str(tmp_path / "j.msgpack"))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# generate: RCC deltas and --modelpath
# ---------------------------------------------------------------------------


def test_generate_tiny_applies_deltas_where_jax_ignores_them(tmp_path):
    """Fault (a) of the JAX package, pinned: its ``load_wrapper`` returns
    from the ``--tiny`` branch before the delta block, so ``--tiny
    --decoder_ft_ckpt`` keeps the original decoder. The port applies the
    delta (and an encoder delta) whatever built the wrapper."""
    jgen = _root_module("generate")
    from wmar_tpu_torch import generate as tgen

    jw = jgen.load_wrapper(argparse.Namespace(model="taming", tiny=True, modelpath=None, rar_size="rar_xl",
                                              encoder_ft_ckpt=None, decoder_ft_ckpt=None))
    dec = jax.tree.map(np.asarray, jw.vq_params["params"]["decoder"])
    rng = np.random.default_rng(5)
    delta = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32), dec)
    dp = str(tmp_path / "dec_delta.msgpack")
    jckpt.save_pytree(dp, delta)
    jw2 = jgen.load_wrapper(argparse.Namespace(model="taming", tiny=True, modelpath=None, rar_size="rar_xl",
                                               encoder_ft_ckpt=None, decoder_ft_ckpt=dp))
    _assert_tree_equal(jax.tree.map(np.asarray, jw2.vq_params["params"]["decoder"]), dec)  # the delta is ignored

    args = tgen.get_parser().parse_args(["--model", "taming", "--tiny", "--device", "cpu", "--outdir", str(tmp_path)])
    base = tgen.load_wrapper(args, torch.device("cpu"))
    args.decoder_ft_ckpt = dp
    enc_delta = jax.tree.map(lambda a: np.full(a.shape, 0.5, np.float32),
                             jax.tree.map(np.asarray, bridge.flax_tree(base.vq.encoder)))
    args.encoder_ft_ckpt = str(tmp_path / "enc_delta.msgpack")
    jckpt.save_pytree(args.encoder_ft_ckpt, enc_delta)
    tuned = tgen.load_wrapper(args, torch.device("cpu"))
    want_dec = jax.tree.map(lambda a, d: a + d, jax.tree.map(np.asarray, bridge.flax_tree(base.vq.decoder)), delta)
    got_dec = jax.tree.map(np.asarray, bridge.flax_tree(tuned.vq.decoder))
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), got_dec, want_dec)
    got_enc = bridge.flax_tree(tuned.vq.encoder)["conv_in"]["kernel"]
    np.testing.assert_array_equal(got_enc.numpy(), bridge.flax_tree(base.vq.encoder)["conv_in"]["kernel"].numpy() + 0.5)
    tgen.main(["--model", "taming", "--tiny", "--device", "cpu", "--no_augs", "--conditioning", "0",
               "--decoder_ft_ckpt", dp, "--outdir", str(tmp_path / "out")])


def test_generate_modelpath_reads_jax_files(tmp_path):
    """``--modelpath`` on files the JAX package saves: ``config.json``'s
    ``gpt`` geometry (a 2-layer GPT) and ``alive_ids``, ``gpt.msgpack``, a
    full-size ``vqgan.msgpack`` (random values) and a decoder delta. The
    port's wrapper holds JAX's weights exactly (base + delta as JAX's
    ``load_and_apply_delta`` gives it) and, fed JAX's noise, samples JAX's
    codes."""
    import json

    from wmar_tpu.models import armm as jarmm
    from wmar_tpu.models import taming_gpt as jgpt
    from wmar_tpu_torch import generate as tgen
    from wmar_tpu_torch.models import armm as tarmm

    jgen = _root_module("generate")
    gpt_cfg = dict(vocab_size=16384, block_size=300, n_layer=2, n_head=2, n_embd=32)
    gpt_params = jax.tree.map(np.asarray, jgpt.init_gpt_params(jax.random.PRNGKey(1), jgpt.GPTConfig(**gpt_cfg)))
    rng = np.random.default_rng(6)
    like = jax.eval_shape(lambda: jvq.TamingVQGAN(jvq.TAMING_IMAGENET_F16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3))))
    vq = jax.tree.map(lambda s: (rng.standard_normal(s.shape, dtype=np.float32) * 0.02), like)
    (tmp_path / "alive.txt").write_text(",".join(str(i) for i in range(0, 16384, 2)) + "\n")
    (tmp_path / "config.json").write_text(json.dumps({"gpt": gpt_cfg, "alive_ids": str(tmp_path / "alive.txt")}))
    jckpt.save_pytree(str(tmp_path / "gpt.msgpack"), gpt_params)
    jckpt.save_pytree(str(tmp_path / "vqgan.msgpack"), vq)
    dec_delta = jax.tree.map(lambda a: (rng.standard_normal(a.shape, dtype=np.float32) * 1e-3),
                             vq["params"]["decoder"])
    dp = str(tmp_path / "dec_delta.msgpack")
    jckpt.save_pytree(dp, dec_delta)

    ns = dict(model="taming", tiny=False, modelpath=str(tmp_path), rar_size="rar_xl", encoder_ft_ckpt=None,
              decoder_ft_ckpt=dp)
    jw = jgen.load_wrapper(argparse.Namespace(**ns))
    args = tgen.get_parser().parse_args(["--model", "taming", "--modelpath", str(tmp_path), "--decoder_ft_ckpt", dp,
                                         "--device", "cpu", "--outdir", str(tmp_path)])
    tw = tgen.load_wrapper(args, torch.device("cpu"))
    np.testing.assert_array_equal(tw.alive_ids, np.arange(0, 16384, 2))
    _assert_tree_equal(bridge.flax_tree(tw.vq), jax.tree.map(np.asarray, jw.vq_params["params"]))
    assert tw.gpt.tok_emb.dtype == torch.float32 and tw.gpt.cfg.n_layer == 2
    np.testing.assert_array_equal(tw.gpt.tok_emb.numpy(), gpt_params["tok_emb"])
    # top-k draws with JAX's Gumbel noise fed: a random 2-layer GPT has logits within 3e-8 of a tie
    # (greedy at this seed, step 201), which float32 summation order may break either way
    key = jax.random.PRNGKey(5)
    want = np.asarray(jw.sample(np.array([3, 5]), jarmm.GenParams(top_k=20, top_p=0.92), rng=key))
    noise = np.stack([np.array(jax.random.gumbel(jax.random.fold_in(key, s), (2, 20), jnp.float32))
                      for s in range(256)])
    got = tw.sample([3, 5], tarmm.GenParams(top_k=20, top_p=0.92), noise=torch.as_tensor(noise)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# precompute_imagenet_codes
# ---------------------------------------------------------------------------


def test_precompute_writes_encode_codes_of_pil_images(tmp_path):
    """Per image, one ``<class>_<stem>.npy`` with the codes of the port
    tokenizer's ``encode_codes`` on the image as JAX's ``load_image``
    prepares it (PIL centre crop and bicubic resize, equal floats);
    ``--per_class``, ``--split_file`` and chunks select as JAX's does."""
    from PIL import Image

    from wmar_tpu_torch import precompute_imagenet_codes as tpre
    from wmar_tpu_torch.generate import load_wrapper

    jpre = _root_module("precompute_imagenet_codes")
    rng = np.random.default_rng(7)
    for cls in ("n01", "n02"):
        os.makedirs(tmp_path / "data" / cls)
        for i, (w, h) in enumerate([(40, 50), (64, 30), (20, 20)]):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(tmp_path / "data" / cls / f"im{i}.png")
    (tmp_path / "split.txt").write_text("im0\nim2.png\n")
    out = tmp_path / "codes"
    argv = ["--model", "rar", "--tiny", "--device", "cpu", "--datapath", str(tmp_path / "data"), "--outdir", str(out),
            "--per_class", "2", "--split_file", str(tmp_path / "split.txt"), "--batch_size", "3"]
    tpre.main(argv)
    assert sorted(os.listdir(out)) == ["n01_im0.npy", "n01_im2.npy", "n02_im0.npy", "n02_im2.npy"]
    wrapper = load_wrapper(argparse.Namespace(model="rar", tiny=True, modelpath=None, seed=0, rar_size="rar_xl",
                                              encoder_ft_ckpt=None, decoder_ft_ckpt=None), torch.device("cpu"))
    for name in sorted(os.listdir(out)):
        cls, stem = name[:-4].split("_")
        path = str(tmp_path / "data" / cls / f"{stem}.png")
        img = tpre.load_image(path, wrapper.image_size)
        np.testing.assert_array_equal(img, jpre.load_image(path, wrapper.image_size))
        want = wrapper.images_to_codes(torch.from_numpy(img[None])).numpy()[0]
        np.testing.assert_array_equal(np.load(out / name), want)
    chunk = tpre.select_files(tpre.get_parser().parse_args(argv + ["--total_chunks", "2", "--chunk_idx", "1"]))
    assert [os.path.basename(f) for f in chunk] == ["im2.png", "im2.png"]


def test_precompute_and_finetune_need_a_card_by_default(tmp_path):
    """Both entry points default to ``--device cuda`` and exit without a
    card rather than moving to the CPU."""
    from wmar_tpu_torch import precompute_imagenet_codes as tpre
    from wmar_tpu_torch.finetune import cli

    assert tpre.get_parser().get_default("device") == "cuda" == cli.get_parser().get_default("device")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="no CUDA"):
        tpre.main(["--tiny", "--datapath", str(tmp_path), "--outdir", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="no CUDA"):
        cli.main(["--tiny", "--synthetic", "8", "--outdir", str(tmp_path / "o")])
