"""Port parity of DiffPure and upfirdn against the JAX package, on the CPU.

The same numpy-seeded inputs and weights go through both packages:

* ``upfirdn2d`` / ``fused_bias_act``: float32, within 1e-6 (one grouped
  convolution against XLA's dilated one, summed in another order).
* The ADM UNet at a reduced config (32 px, ``model_channels`` 32,
  ``channel_mult`` (1, 2, 2), attention at 16 and 8, heads of 16), every
  parameter drawn from numpy with a fan-in scale (no zero-initialised
  layer, so the output is not trivially 0): within 1e-5 of the output's
  scale (~40 float32 convolutions, GroupNorms and attention).
* The ``DiffPure`` chain at steps 0.01 and 0.05 (10 and 50 UNet calls) on
  16 px images, fed JAX's noise: within 1e-5 of the image (each step adds ``coef * eps``
  with ``coef`` <= 0.02, so the UNet's 1e-5 does not grow).
* Weights: guided-diffusion's ``.pt`` through the port, JAX's
  ``convert_adm_unet`` through ``bridge.load_adm_unet`` and a flax-written
  ``.msgpack`` give the same UNet, bit for bit; the converters' trees are
  equal bit for bit.
* ``generate --include_diffpure``: the manager's cells in JAX's order, the
  refusal without weights in JAX's words, and a ``--tiny`` run of both
  packages with ``GUIDED_DIFFUSION_256_UNCOND`` patched to a small config:
  the classic cells' records equal JAX's (as ``test_torch_port_attacks``
  holds them), the five DiffPure cells present and labelled.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import wmar_tpu.augmentations as jaug  # noqa: E402
from wmar_tpu.augmentations import diffpure as jdp  # noqa: E402
from wmar_tpu.augmentations import manager as jman  # noqa: E402
from wmar_tpu.models import armm as jarmm  # noqa: E402
from wmar_tpu.models import maskgit_vqgan as jmg  # noqa: E402
from wmar_tpu.models import rar as jrar  # noqa: E402
from wmar_tpu.ops import upfirdn as jup  # noqa: E402
from wmar_tpu_torch import bridge  # noqa: E402
from wmar_tpu_torch import generate as tgen  # noqa: E402
from wmar_tpu_torch.augmentations import diffpure as tdp  # noqa: E402
from wmar_tpu_torch.augmentations import manager as tman  # noqa: E402
from wmar_tpu_torch.models import armm as tarmm  # noqa: E402
from wmar_tpu_torch.models import maskgit_vqgan as tmg  # noqa: E402
from wmar_tpu_torch.models import rar as trar  # noqa: E402
from wmar_tpu_torch.ops import upfirdn as tup  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the fast tier runs six test workers at once, and a
    thread per core in each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS_TOL = 1e-6
UNET_REL = 1e-5
CHAIN_TOL = 1e-5
SMALL = dict(image_size=32, model_channels=32, channel_mult=(1, 2, 2), attention_resolutions=(16, 8),
             num_head_channels=16)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_params(kw, seed=0):
    """Every leaf of the JAX ADMUNet's tree of config ``kw`` from numpy:
    kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    cfg = jdp.ADMConfig(**kw)
    like = jax.eval_shape(lambda: jdp.ADMUNet(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                                         jnp.zeros((1,), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) * float(np.prod(s.shape[:-1])) ** -0.5).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, like)


def _trees_equal(a, b):
    return jax.tree.structure(a) == jax.tree.structure(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.fixture(scope="module")
def small():
    params = _random_params(SMALL)
    return params, bridge.load_adm_unet(params, tdp.ADMConfig(**SMALL))


# ---------------------------------------------------------------------------
# upfirdn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("up,down,pad", [(1, 1, (0, 0)), (2, 1, (1, 0)), (2, 1, (2, 1)), (1, 2, (0, 0)),
                                         (1, 2, (1, 1)), (2, 2, (1, 2)), (1, 1, (-1, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(up * 10 + down)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    k = np.outer([1, 3, 3, 1], [1, 2, 1]).astype(np.float32)
    k /= k.sum()
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad))
    got = _nhwc(tup.upfirdn2d(_nchw(x), k, up=up, down=down, pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OPS_TOL, rtol=0)


@pytest.mark.parametrize("act", ["lrelu", "relu", "linear"])
def test_fused_bias_act_matches_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    for bias, gain in ((b, 2**0.5), (None, 1.0)):
        want = np.asarray(jup.fused_bias_act(jnp.asarray(x), None if bias is None else jnp.asarray(bias), act=act,
                                             gain=gain))
        got = _nhwc(tup.fused_bias_act(_nchw(x), None if bias is None else torch.from_numpy(bias), act=act, gain=gain))
        np.testing.assert_allclose(got, want, atol=OPS_TOL, rtol=0)
    with pytest.raises(ValueError):
        tup.fused_bias_act(_nchw(x), act="gelu")


# ---------------------------------------------------------------------------
# The ADM UNet and the chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("updown", [True, False])
def test_adm_unet_matches_jax(updown, small):
    """Resblock up/down (the released model) and strided convs + nearest
    resize (``resblock_updown=False``, Flax's SAME padding)."""
    kw = dict(SMALL, resblock_updown=updown)
    params, model = small if updown else (lambda p: (p, bridge.load_adm_unet(p, tdp.ADMConfig(**kw))))(
        _random_params(kw, seed=1))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    want = np.asarray(jax.jit(jdp.ADMUNet(jdp.ADMConfig(**kw)).apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = _nhwc(model(_nchw(x), torch.from_numpy(t)))
    assert got.shape == want.shape == (2, 32, 32, 6) and np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= UNET_REL * np.abs(want).max()


@pytest.mark.parametrize("steps", [0.01, 0.05])
def test_diffpure_chain_matches_jax_fed_its_noise(steps, small):
    params, model = small
    x01 = np.random.default_rng(3).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdp.DiffPure(jdp.ADMUNet(jdp.ADMConfig(**SMALL)), params)(jnp.asarray(x01), steps, key))
    t_star = int(steps * 1000)
    k_noise, k_loop = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k_noise, x01.shape))]
                     + [np.asarray(jax.random.normal(jax.random.fold_in(k_loop, i), x01.shape)) for i in range(t_star)])
    dp = tdp.DiffPure(model)
    got = dp(torch.from_numpy(x01), steps, noise=noise).numpy()
    assert dp.unet_calls == t_star
    assert np.abs(want - x01).max() > 0.05  # the chain moved the image
    np.testing.assert_allclose(got, want, atol=CHAIN_TOL, rtol=0)


def test_diffpure_draws_from_the_generator(small):
    """The cell's generator decides the noise; ``steps`` sets the calls."""
    dp = tdp.DiffPure(small[1], steps=0.003)
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    a, b = (dp(x, generator=torch.Generator().manual_seed(s)) for s in (1, 1))
    c = dp(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and dp.unet_calls == 9
    assert a.shape == x.shape and a.min() >= 0 and a.max() <= 1
    assert torch.equal(dp(x), dp(x)) and dp(x, 0.0001).shape == x.shape and dp.unet_calls == 9 + 3 + 3 + 1
    np.testing.assert_array_equal(tdp.linear_betas(1000), jdp.linear_betas(1000))


# ---------------------------------------------------------------------------
# Weights: the three routes, the converters, the template
# ---------------------------------------------------------------------------


def test_three_weight_routes_give_one_unet(tmp_path, small):
    from flax import serialization

    params, model = small
    cfg = tdp.ADMConfig(**SMALL)
    np_params = jax.tree.map(np.asarray, params)
    sd = tdp.to_guided_diffusion(np_params, cfg)
    assert sd["input_blocks.1.0.in_layers.2.weight"].shape == (32, 32, 3, 3)
    assert sd["middle_block.1.qkv.weight"].shape == (192, 64, 1)
    jax_tree = jdp.convert_adm_unet(sd, jdp.ADMConfig(**SMALL))
    assert _trees_equal(jax_tree, np_params)  # the inverse writes what JAX's converter reads back
    assert _trees_equal(tdp.convert_adm_unet(sd, cfg), jax_tree)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "adm.pt")
    (tmp_path / "adm.msgpack").write_bytes(serialization.to_bytes(jax_tree))
    x = _nchw(np.random.default_rng(4).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([250])
    with torch.no_grad():
        outs = [m(x, t) for m in (
            tdp.load_adm_weights(str(tmp_path / "adm.pt"), cfg),
            bridge.load_adm_unet(jax_tree, cfg),
            tdp.load_adm_weights(str(tmp_path / "adm.msgpack"), cfg),
            model,
        )]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    with pytest.raises(ValueError):  # a file of another width is refused by the template's shapes
        tdp.load_adm_weights(str(tmp_path / "adm.msgpack"), tdp.ADMConfig(**dict(SMALL, model_channels=64)))


def test_full_width_template_is_jax_tree():
    """``GUIDED_DIFFUSION_256_UNCOND``'s template (meta tensors) has JAX's
    tree, shapes and dtypes: 552,814,086 parameters."""
    cfg = tdp.GUIDED_DIFFUSION_256_UNCOND
    assert cfg == tdp.ADMConfig(**{f.name: getattr(jdp.GUIDED_DIFFUSION_256_UNCOND, f.name)
                                   for f in jdp.ADMConfig.__dataclass_fields__.values()})
    like = jax.eval_shape(lambda: jdp.ADMUNet(jdp.GUIDED_DIFFUSION_256_UNCOND).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,), jnp.int32)))
    tmpl = tdp.flax_template(cfg)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), tmpl, is_leaf=lambda t: isinstance(t, torch.Tensor))
    want = jax.tree.map(lambda s: (tuple(s.shape), "torch." + str(s.dtype)), like)
    assert got == want
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(like)) == 552_814_086


def test_load_flax_takes_dense_kernels():
    """``bridge.load_flax`` now maps a 2-d ``kernel`` to a Linear's weight
    (transposed), and ``adm_unet_tree`` is its inverse."""
    cfg = tdp.ADMConfig(**dict(SMALL, channel_mult=(1,), attention_resolutions=()))
    tree = jax.tree.map(np.asarray, _random_params(dict(SMALL, channel_mult=(1,), attention_resolutions=())))
    model = bridge.load_adm_unet(tree, cfg)
    np.testing.assert_array_equal(model.time1.weight.detach().numpy(), tree["params"]["time1"]["kernel"].T)
    assert _trees_equal(jax.tree.map(lambda t: t.numpy(), bridge.adm_unet_tree(model),
                                     is_leaf=lambda t: isinstance(t, torch.Tensor)), tree["params"])


# ---------------------------------------------------------------------------
# The manager and generate
# ---------------------------------------------------------------------------


class _Codec:
    random_weights = True


def test_manager_cells_in_jax_order():
    purifier = lambda x, steps, generator=None: x  # noqa: E731
    want = jman.AugmentationManager(include_neural_compress=True, include_diffpure=True,
                                    nc_models={"b": _Codec(), "a": _Codec()}, diffpure=purifier)
    got = tman.AugmentationManager(nc_models={"b": _Codec(), "a": _Codec()}, diffpure=purifier)
    assert [(n, list(p)) for n, _, p in got.augs] == [(n, list(p)) for n, _, p in want.augs]
    assert got.names()[-2:] == ["neural-compress", "diffpure"]
    assert [n for n, _, _ in tman.AugmentationManager().augs] == \
           [n for n, _, _ in jman.AugmentationManager(include_diffpure=True).augs]
    seen = []
    tman.AugmentationManager(diffpure=lambda x, s, generator=None: seen.append((s, generator))).augs[-1][1](
        torch.zeros(1), 0.2, "gen")
    assert seen == [(0.2, "gen")]  # the cell's generator reaches the purifier


@pytest.fixture
def jax_generate():
    sys.path.insert(0, REPO)
    try:
        import generate
    finally:
        sys.path.remove(REPO)
    return generate


# the generate run: tiny RAR wrappers sharing one MaskGit tokenizer, fixed codes and images
RAR = dict(embed_dim=32, depth=2, num_heads=2, intermediate_size=64, image_seq_len=16, codebook_size=32, num_classes=4)
RAR_VQ = dict(resolution=8, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=16, n_embed=32,
              embed_dim=16)
TINY_ADM = dict(image_size=8, model_channels=32, channel_mult=(1,), num_res_blocks=1, attention_resolutions=())
CLASSIC_TOL = 1e-4  # p-values of equal codes (JAX's float32 betainc against the port's float64)


def _fixed_codes(n):
    return np.random.default_rng(5).integers(0, RAR["codebook_size"], (n, RAR["image_seq_len"]))


def _fixed_images(n):
    return np.random.default_rng(6).uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)


def _eager_manager(cls):
    """JAX's manager with an eager jit cache (no 62 compiles)."""

    class Eager(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self._jit_cache = {(name, repr(p)): (lambda x, r, fn=fn, p=p: fn(x, p, r))
                               for name, fn, params in self.augs for p in params}

    return Eager


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    out[rel] = json.load(fh)
            elif f.endswith(".npy"):
                out[rel] = np.load(os.path.join(d, f))
    return out


@pytest.fixture
def shared_wrappers(monkeypatch, jax_generate):
    """Both packages' ``load_wrapper`` give tiny RAR wrappers that share one
    MaskGit tokenizer; both sample the same fixed codes and decode any codes
    to the same fixed images."""
    vq_cfg = jmg.MaskGitVQConfig(**RAR_VQ)
    vq_params = jmg.MaskGitVQGAN(vq_cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 3)))
    tvq = bridge.load_maskgit(tmg.MaskGitVQGAN(tmg.MaskGitVQConfig(**RAR_VQ)), jax.tree.map(np.asarray, vq_params))
    monkeypatch.setattr(jax_generate, "load_wrapper",
                        lambda args: jarmm.RarARMM(None, jrar.RARConfig(**RAR), vq_params, vq_cfg))
    monkeypatch.setattr(tgen, "load_wrapper", lambda args, device: tarmm.RarARMM(
        trar.RAR(trar.RARConfig(**RAR)), tvq, cache_dtype=torch.float32, device="cpu"))
    monkeypatch.setattr(jarmm.RarARMM, "sample", lambda self, inputs, *a, **k: jnp.asarray(_fixed_codes(len(inputs))))
    monkeypatch.setattr(tarmm.RarARMM, "sample",
                        lambda self, inputs, *a, **k: torch.as_tensor(_fixed_codes(len(inputs))))
    monkeypatch.setattr(jarmm.RarARMM, "codes_to_images", lambda self, c: jnp.asarray(_fixed_images(c.shape[0])))
    monkeypatch.setattr(tarmm.RarARMM, "codes_to_images", lambda self, c: torch.from_numpy(_fixed_images(c.shape[0])))
    return jax_generate


def test_generate_refuses_diffpure_without_weights_as_jax_does(tmp_path, shared_wrappers):
    argv = ["--model", "rar", "--tiny", "--include_diffpure", "true", "--conditioning", "0", "--batch_size", "1"]
    with pytest.raises(SystemExit) as want:
        shared_wrappers.main(argv + ["--outdir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit) as got:
        tgen.main(argv + ["--device", "cpu", "--outdir", str(tmp_path / "port")])
    assert str(got.value) == str(want.value) and "requires --diffpure_weights" in str(got.value)
    parser = tgen.get_parser()
    assert not any(a.dest in ("include_diffpure", "diffpure_weights") and a.help and "not ported" in a.help
                   for a in parser._actions)


def test_generate_tiny_include_diffpure_matches_jax(tmp_path, monkeypatch, shared_wrappers):
    """``generate --tiny --include_diffpure true --diffpure_weights adm.pt``
    in both packages, the ADM config patched to ``TINY_ADM`` and the same
    random weights; both wrappers share one tokenizer and decode the same
    fixed codes to the same fixed images. The classic cells: the same
    files, codes equal on >= 99% of the tokens, and where a row's codes
    are equal its p-value within 1e-4 and its L0 equal to JAX's (noise
    cells draw their own noise). The five diffpure cells: present, labelled
    with JAX's params, 660 UNet calls a batch in the port."""
    monkeypatch.setattr(jaug, "AugmentationManager", _eager_manager(jaug.AugmentationManager))
    monkeypatch.setattr(jdp, "GUIDED_DIFFUSION_256_UNCOND", jdp.ADMConfig(**TINY_ADM))
    monkeypatch.setattr(tdp, "GUIDED_DIFFUSION_256_UNCOND", tdp.ADMConfig(**TINY_ADM))
    sd = tdp.to_guided_diffusion(jax.tree.map(np.asarray, _random_params(TINY_ADM, seed=3)),
                                 tdp.ADMConfig(**TINY_ADM))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "adm.pt")
    purifiers = []

    class Counted(tdp.DiffPure):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            purifiers.append(self)

    monkeypatch.setattr(tdp, "DiffPure", Counted)
    argv = ["--model", "rar", "--tiny", "--conditioning", "0,1", "--batch_size", "2", "--include_diffpure", "true",
            "--diffpure_weights", str(tmp_path / "adm.pt")]
    want = shared_wrappers.main(argv + ["--outdir", str(tmp_path / "jax")])
    got = tgen.main(argv + ["--device", "cpu", "--outdir", str(tmp_path / "port")])
    assert len(purifiers) == 1 and purifiers[0].unet_calls == 660

    def by_cell(records):
        return {(r["conditioning"], r["idx"], r["transform"], repr(r["param"])): r for r in records}

    got, want = by_cell(got), by_cell(want)
    assert set(got) == set(want) and len(got) == 2 * (2 + 62 + 5)
    assert sorted({k[3] for k in got if k[2] == "diffpure"}) == ["0.01", "0.05", "0.1", "0.2", "0.3"]
    jtree, ttree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(ttree) == sorted(jtree)
    agree = []
    for rel, codes in ttree.items():
        if not rel.endswith(".npy"):
            continue
        transform = rel.split("_")[2]
        rec = ttree[rel[:-4] + ".json"]
        assert set(rec) == set(jtree[rel[:-4] + ".json"]) and 0 <= rec["pvalue"] <= 1
        if transform in ("gaussian-noise", "diffpure"):
            assert codes.shape == jtree[rel].shape and codes.min() >= 0 and codes.max() < RAR["codebook_size"]
            continue
        agree.append(codes == jtree[rel])
        if (codes == jtree[rel]).all():
            want_rec = jtree[rel[:-4] + ".json"]
            assert rec["pvalue"] == pytest.approx(want_rec["pvalue"], rel=CLASSIC_TOL) and rec["l0"] == want_rec["l0"]
    assert np.mean(agree) >= 0.99


def test_chip_smoke_diffpure_and_fid_phases_on_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s "DiffPure" and "FID" phases on the CPU: the CLI's
    tiny RAR, the ADM config patched to ``TINY_ADM``, the Inception at 1/8
    width; every gate of theirs passes with no kernel launch."""
    import chip_smoke

    monkeypatch.setattr(tdp, "GUIDED_DIFFUSION_256_UNCOND", tdp.ADMConfig(**TINY_ADM))
    tf32 = torch.backends.cudnn.allow_tf32
    out = chip_smoke.phase_diffpure("cpu", str(tmp_path), tiny=True, check_size=8)
    n = chip_smoke.DIFFPURE_CLASSES * (2 + 62 + 5)
    assert out["unet_calls"] == 660 and out["records"] == n and set(out["launches"].values()) == {0}
    assert sorted(out["cell_s"]) == ["0.01", "0.05", "0.1", "0.2", "0.3"] and out["unet_err"] == 0
    assert torch.backends.cudnn.allow_tf32 == tf32  # the phase put the switch back
    fid = chip_smoke.phase_fid("cpu", str(tmp_path), out["outdir"], div=8, n_synth=8, synth_size=80, min_images=8)
    assert fid["fid"] > 0 and fid["images"]["dir"][0] == n and fid["features_err"] == 0
