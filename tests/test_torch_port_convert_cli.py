"""Port parity, the checkpoint tools: ``python -m wmar_tpu_torch.tools.
convert_ckpt`` and ``convert_lpips`` against the JAX package's
``tools/convert_ckpt.py`` and ``tools/convert_lpips.py``.

For every one of the 17 kinds a small float32 source file in the
reference's layout goes through both tools into two directories, and every
file they write must be byte-equal, except ``config.json``'s ``n_head``:
the JAX tool defaults ``--gpt_heads`` to 24, which does not divide the cin
transformer's 1664 (fault (o)), the port to 16. Kinds that the tools wire
to a published configuration run with that configuration patched to a
small one in both packages' modules. A bfloat16 source makes the JAX
tool's reader raise (numpy has no bfloat16, fault (n)) and converts in the
port to the float32 conversion's tree cast to bfloat16.
"""

import filecmp
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_convert as ref
from wmar_tpu import models as jmodels
from wmar_tpu.models import taming_gpt as jgpt
from wmar_tpu_torch import bridge
from wmar_tpu_torch import models as tmodels
from wmar_tpu_torch.models import taming_gpt as tgpt
from wmar_tpu_torch.tools import convert_ckpt as tool
from wmar_tpu_torch.tools import convert_lpips as tlpips
from wmar_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JTOOL, JLPIPS = _jax_tool("convert_ckpt"), _jax_tool("convert_lpips")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save(path, sd, wrap=None, dtype=None):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if dtype is not None:
        t = {k: v.to(dtype) for k, v in t.items()}
    torch.save({wrap: t} if wrap else t, path)
    return str(path)


def _both_models(mp, name, cls, kw):
    mp.setattr(jmodels, name, getattr(jmodels, cls)(**kw))
    mp.setattr(tmodels, name, getattr(tmodels, cls)(**kw))


# ---------------------------------------------------------------------------
# The kinds: each writes its source and patches, and returns the tool's flags
# ---------------------------------------------------------------------------


def _taming(tmp, mp):
    _both_models(mp, "TAMING_IMAGENET_F16", "VQGANConfig", ref.VQ_TAMING)
    sd = {**ref.taming_gpt_sd(), **ref.taming_vqgan_sd(prefix="first_stage_model."), **ref.discriminator_sd()}
    return ["--ckpt", _save(tmp / "net2net.ckpt", sd, "state_dict"), "--gpt_layers", "2", "--gpt_embd", "32",
            "--gpt_block", "20"]


def _rar(tmp, mp):
    mp.setattr(jmodels, "rar_config", lambda size: jmodels.RARConfig(**ref.RAR))
    mp.setattr(tmodels, "rar_config", lambda size: tmodels.RARConfig(**ref.RAR))
    _both_models(mp, "MASKGIT_IMAGENET_F16", "MaskGitVQConfig", ref.MASKGIT)
    return ["--ckpt", _save(tmp / "rar_b.bin", ref.rar_sd()), "--size", "rar_b",
            "--vq", _save(tmp / "maskgit.bin", ref.maskgit_sd())]


def _maskgit_vqgan(tmp, mp):
    _both_models(mp, "MASKGIT_IMAGENET_F16", "MaskGitVQConfig", ref.MASKGIT)
    return ["--ckpt", _save(tmp / "maskgit.bin", ref.maskgit_sd(seed=3))]


def _chameleon_vqgan(tmp, mp):
    _both_models(mp, "CHAMELEON_F16", "VQGANConfig", ref.VQ_CHAMELEON)
    return ["--ckpt", _save(tmp / "vqgan.ckpt", ref.taming_vqgan_sd(ref.VQ_CHAMELEON, seed=5), "state_dict")]


def _chameleon_llama(tmp, mp, dtype=None):
    """Two tensor-parallel shards for the port's glob, and the same weights
    in one file (``full.pth``) for the JAX tool, which loads ``--ckpt``
    before it looks at the kind and so cannot take a glob (fault (p))."""
    _both_models(mp, "CHAMELEON_7B", "LlamaConfig", ref.LLAMA)
    sd = ref.llama_sd()
    _save(tmp / "full.pth", sd, dtype=dtype)
    for r, shard in enumerate(ref.shard_llama_sd(sd, 2)):
        _save(tmp / f"consolidated.{r:02d}.pth", shard, dtype=dtype)
    return ["--ckpt", str(tmp / "consolidated.*.pth")]


def _jax_argv(argv):
    return [a.replace("consolidated.*.pth", "full.pth") for a in argv]


def _delta(kind, part):
    def case(tmp, mp):
        if kind == "taming_delta":
            _both_models(mp, "TAMING_IMAGENET_F16", "VQGANConfig", ref.VQ_TAMING)
            base, stage = ref.taming_vqgan_sd(prefix="first_stage_model."), "first_stage_model."
        elif kind == "chameleon_delta":
            _both_models(mp, "CHAMELEON_F16", "VQGANConfig", ref.VQ_CHAMELEON)
            base, stage = ref.taming_vqgan_sd(ref.VQ_CHAMELEON, seed=5), ""
        else:
            _both_models(mp, "MASKGIT_IMAGENET_F16", "MaskGitVQConfig", ref.MASKGIT)
            base, stage = ref.maskgit_sd(), ""
        return ["--ckpt", _save(tmp / f"{part}.pth", ref.delta_sd(base, part, stage)), "--part", part,
                "--base", _save(tmp / "base.ckpt", base, "state_dict")]

    return case


SMALL_VIT = dict(img_size=32, patch_size=8, embed_dim=16, out_chans=16, depth=2, num_heads=2, window_size=2,
                 global_attn_indexes=(1,))
SMALL_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))


def _wam(tmp, mp):
    from wmar_tpu.sync import wam_exact as jwam
    from wmar_tpu_torch.sync import wam_exact as twam

    for m in (jwam, twam):
        mp.setattr(m.convert_wam, "__defaults__", (m.SAMViTConfig(**SMALL_VIT), (4, 2, 2), m.WAM_ENC_CFG, m.WAM_DEC_CFG))
    model = twam.init_wam(0, vit_cfg=twam.SAMViTConfig(**SMALL_VIT))
    sd = {k: v.numpy() for k, v in twam.to_wam_state_dict(model).items()}
    return ["--ckpt", _save(tmp / "wam_mit.pth", sd)]


def _syncseal(tmp, mp):
    from wmar_tpu.sync import syncseal_models as jsm
    from wmar_tpu_torch.sync import syncseal as tss
    from wmar_tpu_torch.sync import syncseal_models as tsm

    for m in (jsm, tsm):
        mp.setattr(m.convert_convnext, "__defaults__", (m.ConvNeXtConfig(**SMALL_CONVNEXT), "convnext.", "head."))
    model = tss.init_syncseal_ref(0, convnext_cfg=tsm.ConvNeXtConfig(**SMALL_CONVNEXT))
    return ["--ckpt", _save(tmp / "syncmodel.pth", {k: v.numpy() for k, v in model.state_dict().items()})]


def _moshi(tmp, mp):
    import test_torch_audio_lm as tal
    from wmar_tpu.audio import lm as jlm
    from wmar_tpu_torch.audio import lm as tlm

    mp.setattr(jlm, "MOSHI_V01", jlm.MoshiConfig(**tal.MULTI))
    mp.setattr(tlm, "MOSHI_V01", tlm.MoshiConfig(**tal.MULTI))
    return ["--ckpt", _save(tmp / "moshi.pth", tal._moshi_sd(jlm.MoshiConfig(**tal.MULTI)))]


def _mimi(tmp, mp):
    import test_torch_audio_mimi as tam
    from wmar_tpu.audio import mimi as jmimi
    from wmar_tpu_torch.audio import mimi as tmimi

    mp.setattr(jmimi, "MIMI_V0_1", jmimi.MimiConfig(**tam.TINY))
    mp.setattr(tmimi, "MIMI_V0_1", tmimi.MimiConfig(**tam.TINY))
    return ["--ckpt", _save(tmp / "mimi.pth", tam._mimi_sd(jmimi.MimiConfig(**tam.TINY)))]


def _adm(tmp, mp):
    import chip_smoke
    import test_torch_port_diffpure as tpd
    from wmar_tpu.augmentations import diffpure as jdp
    from wmar_tpu_torch.augmentations import diffpure as tdp

    mp.setattr(jdp, "GUIDED_DIFFUSION_256_UNCOND", jdp.ADMConfig(**tpd.SMALL))
    mp.setattr(tdp, "GUIDED_DIFFUSION_256_UNCOND", tdp.ADMConfig(**tpd.SMALL))
    cfg = tdp.ADMConfig(**tpd.SMALL)
    pt, _ = chip_smoke.write_adm_files(chip_smoke.random_adm_unet(cfg, "cpu", 0), cfg, str(tmp))
    return ["--ckpt", pt]


def _compressai(tmp, mp):
    from tests import test_compressai_parity as oracle

    torch.manual_seed(0)
    torch.save(oracle.FactorizedPrior(8, 12).state_dict(), tmp / "bmshj.pth")
    return ["--ckpt", str(tmp / "bmshj.pth"), "--name", "bmshj2018-factorized-q=3"]


def _diffusers_vae(tmp, mp):
    from tests import test_diffusers_vae_parity as kl_oracle
    from wmar_tpu.augmentations import diffusers_vae as jdv
    from wmar_tpu_torch.augmentations import diffusers_vae as tdv

    kw = dict(block_out_channels=(8, 16), layers_per_block=2, latent_channels=4, norm_num_groups=kl_oracle.GROUPS,
              use_quant_conv=True)
    mp.setattr(jdv.KLVAEConfig, "for_name", staticmethod(lambda name, tiny=False: jdv.KLVAEConfig(**kw)))
    mp.setattr(tdv.KLVAEConfig, "for_name", staticmethod(lambda name: tdv.KLVAEConfig(**kw)))
    torch.manual_seed(1)
    torch.save(kl_oracle.TinyAutoencoderKL(tdv.KLVAEConfig(**kw)).state_dict(), tmp / "vae.pth")
    return ["--ckpt", str(tmp / "vae.pth"), "--name", "diffusers-sd-vae-ft-ema"]


def _codec(name):
    def case(tmp, mp):
        from tests import test_audio_codecs_parity as oracle
        from wmar_tpu.audio import codecs as jc
        from wmar_tpu_torch.audio import codecs as tc

        jcfg = oracle.TINY_ENC if name == "encodec" else oracle.TINY_DAC
        tcls = tc.EncodecConfig if name == "encodec" else tc.DACConfig
        attr = "ENCODEC_24K" if name == "encodec" else "DAC_24K"
        mp.setattr(jc, attr, jcfg)
        mp.setattr(tc, attr, tcls(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}))
        torch.manual_seed(2)
        model = oracle.EncodecOracle(jcfg) if name == "encodec" else oracle.DACOracle(jcfg)
        torch.save(model.state_dict(), tmp / f"{name}.pth")
        return ["--ckpt", str(tmp / f"{name}.pth")]

    return case


KINDS = {
    "taming": _taming, "rar": _rar, "chameleon_vqgan": _chameleon_vqgan, "maskgit_vqgan": _maskgit_vqgan,
    "chameleon_llama": _chameleon_llama, "wam": _wam, "syncseal": _syncseal, "moshi": _moshi, "mimi": _mimi,
    "adm": _adm, "compressai": _compressai, "diffusers_vae": _diffusers_vae, "encodec": _codec("encodec"),
    "dac": _codec("dac"), "taming_delta": _delta("taming_delta", "decoder"),
    "chameleon_delta": _delta("chameleon_delta", "encoder"), "maskgit_delta": _delta("maskgit_delta", "decoder"),
}


def _run_both(tmp, kind, argv):
    jout, tout = tmp / "jax", tmp / "port"
    JTOOL.main([kind, *_jax_argv(argv), "--outdir", str(jout)])
    tool.main([kind, *argv, "--outdir", str(tout)])
    return jout, tout


def _same_files(jout, tout) -> list:
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(tout))
    for name in names:
        if name == "config.json":
            want, got = (json.loads((d / name).read_text()) for d in (jout, tout))
            assert (want["gpt"].pop("n_head"), got["gpt"].pop("n_head")) == (24, 16)  # fault (o)
            assert got == want
        else:
            assert filecmp.cmp(jout / name, tout / name, shallow=False), name
    return names


def test_the_tools_take_the_same_kinds(capsys):
    with pytest.raises(SystemExit):
        JTOOL.main(["none", "--ckpt", "x", "--outdir", "y"])
    listed = capsys.readouterr().err.split("choose from ")[1]
    assert set(KINDS) == set(tool.KINDS) == {k.strip(" '()\n") for k in listed.split(",")}
    assert len(tool.KINDS) == 17


@pytest.mark.parametrize("kind", list(KINDS))
def test_kind_writes_the_jax_tools_bytes(kind, tmp_path, monkeypatch):
    argv = KINDS[kind](tmp_path, monkeypatch)
    names = _same_files(*_run_both(tmp_path, kind, argv))
    want = {"taming": ["config.json", "discriminator.msgpack", "gpt.msgpack", "vqgan.msgpack"],
            "rar": ["maskgit_vqgan.msgpack", "rar_b.msgpack"], "chameleon_llama": ["llama7b.msgpack"],
            "compressai": ["bmshj2018-factorized-q=3.msgpack"], "diffusers_vae": ["diffusers-sd-vae-ft-ema.msgpack"],
            "taming_delta": ["decoder_delta.msgpack"], "chameleon_delta": ["encoder_delta.msgpack"],
            "maskgit_delta": ["decoder_delta.msgpack"], "moshi": ["moshi_lm.msgpack"], "adm": ["adm_unet.msgpack"],
            "encodec": ["encodec24k.msgpack"], "dac": ["dac24k.msgpack"], "chameleon_vqgan": ["vqgan.msgpack"],
            "maskgit_vqgan": ["maskgit_vqgan.msgpack"]}.get(kind, [f"{kind}.msgpack"])
    assert names == want


def test_convert_lpips_writes_the_jax_tools_bytes(tmp_path):
    """Numeric Sequential order (``features.10`` after ``features.2``), the
    lin heads, the ``{"params": ...}`` file ``finetune.perceptual.load_lpips``
    reads; the JAX tool takes the files because the ``lpips`` package is
    absent here."""
    rng = np.random.default_rng(0)
    chans = [3, 4, 4, 6, 6, 8, 8, 8, 10, 10, 10, 10, 10, 10]
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {}
    for j, i in enumerate(idx):
        vgg[f"features.{i}.weight"] = rng.normal(0, 0.1, (chans[j + 1], chans[j], 3, 3)).astype(np.float32)
        vgg[f"features.{i}.bias"] = rng.normal(0, 0.1, (chans[j + 1],)).astype(np.float32)
    lins = {f"lin{k}.model.1.weight": rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
            for k, c in enumerate((4, 6, 8, 10, 10))}
    argv = ["--vgg_ckpt", _save(tmp_path / "vgg16.pth", vgg), "--lpips_ckpt", _save(tmp_path / "vgg.pth", lins)]
    assert JLPIPS.main([*argv, "--out", str(tmp_path / "jax.msgpack")]) == 0
    assert tlpips.main([*argv, "--out", str(tmp_path / "port.msgpack")]) == 0
    assert filecmp.cmp(tmp_path / "jax.msgpack", tmp_path / "port.msgpack", shallow=False)
    params = tckpt.load_pytree(str(tmp_path / "port.msgpack"))["params"]
    assert params["vgg"]["conv2_0"]["kernel"].shape == (3, 3, 6, 8)  # features.10, not features.2's successor
    assert sorted(params) == ["lin0", "lin1", "lin2", "lin3", "lin4", "vgg"]


def test_bf16_shards_convert_in_the_port_and_raise_in_jax(tmp_path, monkeypatch):
    """Fault (n): Chameleon's shards in bfloat16. JAX's reader raises; the
    port writes the float32 conversion's tree cast to bfloat16."""
    (tmp_path / "f32").mkdir()
    (tmp_path / "bf16").mkdir()
    f32 = _chameleon_llama(tmp_path / "f32", monkeypatch)
    bf16 = _chameleon_llama(tmp_path / "bf16", monkeypatch, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="BFloat16"):
        JTOOL.main(["chameleon_llama", *_jax_argv(bf16), "--outdir", str(tmp_path / "jax_bf16")])
    JTOOL.main(["chameleon_llama", *_jax_argv(f32), "--outdir", str(tmp_path / "jax_f32")])
    tool.main(["chameleon_llama", *bf16, "--outdir", str(tmp_path / "port_bf16")])
    want = dict(bridge.flatten(tckpt.load_pytree(str(tmp_path / "jax_f32" / "llama7b.msgpack"))))
    got = dict(bridge.flatten(tckpt.load_pytree(str(tmp_path / "port_bf16" / "llama7b.msgpack"))))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], w.to(torch.bfloat16)), k


def test_gpt_heads_default_runs_where_jaxs_cannot(tmp_path, monkeypatch):
    """Fault (o): the JAX tool's default of 24 heads does not divide the
    width, so its config.json builds a GPT that cannot split its heads;
    the port's default of 16 runs, and the port refuses a head count that
    does not divide the width, naming both."""
    argv = _taming(tmp_path, monkeypatch)
    jout, tout = _run_both(tmp_path, "taming", argv)
    jcfg = jgpt.GPTConfig(**json.loads((jout / "config.json").read_text())["gpt"])
    tcfg = tgpt.GPTConfig(**json.loads((tout / "config.json").read_text())["gpt"])
    assert (jcfg.n_head, tcfg.n_head, jcfg.n_embd) == (24, 16, 32)
    tokens = np.array([[1, 5, 9]])
    params = jax.tree.map(np.asarray, tckpt.load_pytree(str(jout / "gpt.msgpack")))
    with pytest.raises(Exception):
        jgpt.gpt_forward(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(tokens, jnp.int32))
    model = bridge.load_gpt(tgpt.GPT(tcfg), tckpt.load_pytree(str(tout / "gpt.msgpack")))
    with torch.inference_mode():
        logits, _ = tgpt.gpt_forward(model, torch.as_tensor(tokens))
    assert logits.shape == (1, 3, 64) and bool(torch.isfinite(logits).all())
    with pytest.raises(SystemExit, match="--gpt_heads 24 does not divide --gpt_embd 32"):
        tool.main(["taming", *argv, "--gpt_heads", "24", "--outdir", str(tmp_path / "refused")])


def test_chameleon_shards_glob(tmp_path, monkeypatch):
    """Fault (p): the JAX tool reads ``--ckpt`` as one file before the
    kind's branch, so a glob of shards raises there; the port merges the
    glob's shards into the tree of the same weights in one file."""
    argv = _chameleon_llama(tmp_path, monkeypatch)
    with pytest.raises(FileNotFoundError):
        JTOOL.main(["chameleon_llama", *argv, "--outdir", str(tmp_path / "jax")])
    tool.main(["chameleon_llama", *argv, "--outdir", str(tmp_path / "glob")])
    tool.main(["chameleon_llama", *_jax_argv(argv), "--outdir", str(tmp_path / "one")])
    assert filecmp.cmp(tmp_path / "glob" / "llama7b.msgpack", tmp_path / "one" / "llama7b.msgpack", shallow=False)
    with pytest.raises(SystemExit, match="no shard matches"):
        tool.main(["chameleon_llama", "--ckpt", str(tmp_path / "none.*.pth"), "--outdir", str(tmp_path / "x")])
