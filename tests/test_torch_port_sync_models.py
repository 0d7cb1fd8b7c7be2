"""Port parity, sync models: SyncSeal's UNet embedder and ConvNeXt + Head
extractor, WAM's SAM encoder, pixel decoder, embed and detect, and the Flax
SyncSealModel's ConvNeXtEmbedder / ViTExtractor, against the JAX package
on the CPU at tiny widths.

Each model reads the same weights in both packages, two ways: JAX's
``init_*_params`` trees through the port's ``bridge``, and one file (a
torch state dict in the released layout, or a msgpack tree) that each
package's own loader reads. Inputs are drawn from a numpy seed. Float32
throughout; outputs in [0, 1] (or logits of the same scale) agree within
``ATOL`` = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.models.vqgan import VQGANConfig as JVQGANConfig
from wmar_tpu.sync import syncseal as jss
from wmar_tpu.sync import syncseal_models as jsm
from wmar_tpu.sync import wam_exact as jwx
from wmar_tpu_torch import bridge
from wmar_tpu_torch.models.vqgan import VQGANConfig
from wmar_tpu_torch.sync import syncseal as tss
from wmar_tpu_torch.sync import syncseal_models as tsm
from wmar_tpu_torch.sync import wam_exact as twx

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the fast tier runs six workers on the
    machine's cores, where torch's default of a thread per core
    oversubscribes them and the tiny models' many small ops wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

J_UNET = jsm.UNetConfig(z_channels=8, num_blocks=2, z_channels_mults=(1, 2), norm_groups=4)
T_UNET = tsm.UNetConfig(z_channels=8, num_blocks=2, z_channels_mults=(1, 2), norm_groups=4)
J_CN = jsm.ConvNeXtConfig(depths=(1, 2), dims=(8, 16))
T_CN = tsm.ConvNeXtConfig(depths=(1, 2), dims=(8, 16))

# WAM at 32 px: patch 8 -> a 4 x 4 grid, windows of 2, block 1 global; 4 bits
VIT = dict(img_size=32, patch_size=8, embed_dim=16, out_chans=16, depth=2, num_heads=2, window_size=2,
           global_attn_indexes=(1,))
NBITS = 4
ENC = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=4, n_embed=1,
           embed_dim=4)
DEC = dict(ENC, z_channels=4 + 2 * NBITS, embed_dim=4 + 2 * NBITS)
STAGES = (2, 2, 2)
T_WAM = dict(vit_cfg=twx.SAMViTConfig(**VIT), enc_cfg=VQGANConfig(**ENC), dec_cfg=VQGANConfig(**DEC), nbits=NBITS,
             upscale_stages=STAGES)


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _jax_ref(seed):
    unet = jsm.init_unet_params(seed, J_UNET)
    cn = jsm.init_convnext_params(seed + 1, J_CN)
    rng = np.random.default_rng(seed)
    # GroupNorm and LayerNorm at random scales and shifts, so the norms' parameters count
    for tree in (unet, cn):
        for leaf in jax.tree.leaves(tree):
            if leaf.ndim == 1 or leaf.ndim == 4 and leaf.shape[:3] == (1, 1, 1):
                leaf += rng.normal(0, 0.3, leaf.shape).astype(np.float32)
    return unet, cn


@pytest.mark.parametrize("route", ["bridge", "file"])
def test_unet_and_convnext_match_jax(route, tmp_path):
    """The UNet (on one luma channel) and the ConvNeXt + Head forward."""
    unet, cn = _jax_ref(3)
    model = tss.SyncSealRef(unet_cfg=T_UNET, convnext_cfg=T_CN)
    if route == "bridge":
        model.load_state_dict(bridge.syncseal_ref_state_dict(unet, cn, T_UNET, T_CN), strict=True)
    else:  # a released-layout .pt file: the port's writer, both packages' readers
        model.load_state_dict(bridge.syncseal_ref_state_dict(unet, cn, T_UNET, T_CN), strict=True)
        path = str(tmp_path / "syncseal_tiny.pt")
        torch.save(model.state_dict(), path)
        model = tss.SyncSealRef.load_torch(path, unet_cfg=T_UNET, convnext_cfg=T_CN)
        from wmar_tpu.utils.convert import load_torch_state_dict

        sd = load_torch_state_dict(path)  # JAX's reader and converters, as its load_torch runs them
        unet = jsm.convert_unet(sd, J_UNET, "embedder.unet.")
        cn = jsm.convert_convnext(sd, J_CN, "extractor.convnext.", "extractor.head.")
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    want = jsm.unet_forward(jax.tree.map(jnp.asarray, unet), J_UNET, jnp.asarray(x))
    with torch.no_grad():
        got = model.embedder.unet(torch.as_tensor(x))
    _close(got, want)
    x3 = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jsm.convnext_forward(jax.tree.map(jnp.asarray, cn), J_CN, jnp.asarray(x3))
    with torch.no_grad():
        got = model.extractor(torch.as_tensor(x3))
    _close(got, want)


def test_syncseal_ref_embed_detect_and_msgpack_match_jax(tmp_path):
    """``SyncSealRef``'s embed01 / detect01 / add_sync / remove_sync, with the
    weights through JAX's msgpack ``save`` -> the port's ``load``, and the
    port's ``save`` -> JAX's ``load_pytree`` giving the same tree."""
    unet, cn = _jax_ref(7)
    jmodel = jss.SyncSealRef(unet, cn, unet_cfg=J_UNET, convnext_cfg=J_CN)
    # a well-posed head: corners near the frame's, in TV order
    jmodel.convnext_params["head"]["w"] = jmodel.convnext_params["head"]["w"] * 1e-3
    jmodel.convnext_params["head"]["b"] = jnp.asarray(
        [0.0, -0.9, -0.95, 0.92, -0.9, 0.95, 0.9, -0.92, 0.97], jnp.float32)
    path = str(tmp_path / "ref.msgpack")
    jmodel.save(path)
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    tree = load_pytree(path)
    tmodel = tss.SyncSealRef(unet_cfg=T_UNET, convnext_cfg=T_CN)
    tmodel.load_state_dict(bridge.syncseal_ref_state_dict(tree["unet"], tree["convnext"], T_UNET, T_CN), strict=True)
    out = str(tmp_path / "ref_port.msgpack")
    tmodel.save(out)
    from wmar_tpu.utils import checkpoint as jckpt

    back = jckpt.load_pytree(out, {"unet": jmodel.unet_params, "convnext": jmodel.convnext_params})
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), back,
                 {"unet": jmodel.unet_params, "convnext": jmodel.convnext_params})

    x01 = _images(8, (2, 32, 32, 3))
    with torch.no_grad():
        _close(tmodel.embed01(torch.as_tensor(x01)), jmodel.embed01(jmodel.unet_params, jnp.asarray(x01)), 1e-4)
        _close(tmodel.detect01(torch.as_tensor(x01)), jmodel.detect01(jmodel.convnext_params, jnp.asarray(x01)))
    imgs = x01 * 2 - 1
    _close(tmodel.add_sync(torch.as_tensor(imgs)), jmodel.add_sync(jnp.asarray(imgs)), 2e-4)
    _close(tmodel.remove_sync(torch.as_tensor(imgs)), jmodel.remove_sync(jnp.asarray(imgs)), 2e-4)


def _jax_wam(seed):
    params = jwx.init_wam_params(seed, jwx.SAMViTConfig(**VIT), JVQGANConfig(**ENC), JVQGANConfig(**DEC), NBITS,
                                 STAGES)
    rng = np.random.default_rng(seed)
    for blk in params["vit"]["blocks"]:  # nonzero relative positions, so the lookup counts
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = rng.normal(0, 0.3, blk["attn"][k].shape).astype(np.float32)
    params["vit"]["pos_embed"] = rng.normal(0, 0.3, params["vit"]["pos_embed"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("route", ["bridge", "file"])
def test_wam_encoder_decoder_embed_detect_match_jax(route, tmp_path):
    """The SAM encoder, the pixel decoder, ``msg_concat``, the JND
    heatmaps, and ``WamExact.embed`` / ``detect``."""
    params = _jax_wam(11)
    tmodel = twx.WamExact(**T_WAM)
    tmodel.load_state_dict(bridge.wam_state_dict(params, T_WAM["vit_cfg"], STAGES), strict=True)
    if route == "file":  # wam_mit.pth's layout: the port writes it, both packages read it
        path = str(tmp_path / "wam_tiny.pth")
        torch.save(twx.to_wam_state_dict(tmodel), path)
        tmodel = twx.WamExact.load(path, **T_WAM)
        from wmar_tpu.utils.convert import load_torch_state_dict

        params = jwx.convert_wam(load_torch_state_dict(path), jwx.SAMViTConfig(**VIT), STAGES, JVQGANConfig(**ENC),
                                 JVQGANConfig(**DEC))
    jmodel = jwx.WamExact(params, jwx.SAMViTConfig(**VIT), JVQGANConfig(**ENC), JVQGANConfig(**DEC))
    x01 = _images(12, (2, 32, 32, 3))
    feats = jwx.sam_encoder(jmodel.params["vit"], jmodel.vit_cfg, jnp.asarray((x01 - 0.45) / 0.22))
    with torch.no_grad():
        got = tmodel.detector.image_encoder(torch.as_tensor((x01 - 0.45) / 0.22))
    _close(got.permute(0, 2, 3, 1), feats)
    want = jwx.pixel_decoder(jmodel.params["pixel_decoder"], feats, jmodel.factors)
    with torch.no_grad():
        got = tmodel.detector.pixel_decoder(torch.as_tensor(np.array(feats)).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)
    _close(twx.jnd_heatmaps(torch.as_tensor(x01)), jwx.jnd_heatmaps(jnp.asarray(x01)), 1e-6)
    msgs = np.random.default_rng(13).integers(0, 2, (2, NBITS))
    _close(tmodel.embed(torch.as_tensor(x01), torch.as_tensor(msgs)), jmodel.embed(jnp.asarray(x01),
                                                                                  jnp.asarray(msgs)))
    _close(tmodel.detect(torch.as_tensor(x01)), jmodel.detect(jnp.asarray(x01)))


def test_taming_names_cover_the_vae():
    """Every VAE key of the port's ``WamExact`` has its taming name in the
    file the JAX converter reads, and the renames are one to one."""
    from wmar_tpu.utils.convert import _convert_taming_decoder, _convert_taming_encoder

    tmodel = twx.WamExact(**T_WAM)
    keys = [k for k in twx.to_wam_state_dict(tmodel) if k.startswith("embedder.e") or k.startswith("embedder.d")]
    assert len(set(keys)) == len(keys) == sum(1 for k in tmodel.state_dict() if k.startswith(("embedder.e",
                                                                                              "embedder.d")))
    sd = {k: v.numpy() for k, v in twx.to_wam_state_dict(tmodel).items()}
    enc = _convert_taming_encoder(sd, JVQGANConfig(**ENC), "embedder.encoder.")
    dec = _convert_taming_decoder(sd, JVQGANConfig(**DEC), "embedder.decoder.")
    assert len(jax.tree.leaves(enc)) + len(jax.tree.leaves(dec)) == len(keys)


@pytest.mark.parametrize("part", ["embedder", "extractor"])
def test_flax_syncseal_modules_match_jax(part):
    """The Flax design's ConvNeXtEmbedder and ViTExtractor at tiny widths,
    random weights from the port written as the Flax tree
    (``syncseal.flax_tree``) and applied by JAX's modules."""
    x01 = _images(21, (2, 32, 32, 3))
    if part == "embedder":
        jmod = jss.ConvNeXtEmbedder(depths=(1, 1), dims=(8, 16))
        tmod = tss.ConvNeXtEmbedder(depths=(1, 1), dims=(8, 16))
    else:
        jmod = jss.ViTExtractor(patch=8, dim=16, depth=2, heads=2)
        tmod = tss.ViTExtractor(image_size=32, patch=8, dim=16, depth=2, heads=2)
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for p in tmod.parameters():  # random values everywhere, norms and gamma included
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    holder = torch.nn.Module()
    holder.embedder, holder.extractor = (tmod, torch.nn.Module()) if part == "embedder" else (torch.nn.Module(), tmod)
    variables = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tss.flax_tree(holder)[part])
    with torch.no_grad():
        got = tmod(torch.as_tensor(x01))
    _close(got, jmod.apply(variables, jnp.asarray(x01)))


def test_syncseal_model_files_cross_both_ways(tmp_path):
    """``SyncSealModel`` at 32 px: the port's Flax tree has the structure
    and shapes of JAX's ``init``; JAX's ``save`` (msgpack + ``.json``) read
    by the port's ``load`` gives JAX's add_sync / detect / remove_sync, and
    flax reads the port's ``save`` back into the same tree."""
    from wmar_tpu.utils import checkpoint as jckpt

    cfg = jss.SyncSealConfig(image_size=32, scaling_w=0.3)
    x = jnp.zeros((1, 32, 32, 3))
    like = {"embedder": jax.eval_shape(lambda: jss.ConvNeXtEmbedder().init(jax.random.PRNGKey(0), x)),
            "extractor": jax.eval_shape(lambda: jss.ViTExtractor().init(jax.random.PRNGKey(0), x))}
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), like)
    src = tss.SyncSealModel.init(1, tss.SyncSealConfig(image_size=32, scaling_w=0.3))
    assert float(src.embedder.out.weight.detach().abs().max()) == 0.0  # Flax's zero-init output conv
    with torch.no_grad():
        src.embedder.out.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    tree = jax.tree.map(lambda t: t.numpy(), tss.flax_tree(src))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, like)

    jmodel = jss.SyncSealModel(tree["embedder"], tree["extractor"], cfg)
    path = str(tmp_path / "sync_flax.msgpack")
    jmodel.save(path)
    tmodel = tss.SyncSealModel.load(path, device="cpu")
    assert tmodel.cfg == tss.SyncSealConfig(image_size=32, scaling_w=0.3)
    imgs = _images(3, (2, 32, 32, 3)) * 2 - 1
    _close(tmodel.add_sync(torch.as_tensor(imgs)), jmodel.add_sync(jnp.asarray(imgs)), 2e-4)
    _close(tmodel.detect(torch.as_tensor(imgs)), jmodel.detect(jnp.asarray(imgs)))
    _close(tmodel.remove_sync(torch.as_tensor(imgs)), jmodel.remove_sync(jnp.asarray(imgs)), 2e-4)
    out = str(tmp_path / "sync_port.msgpack")
    tmodel.save(out)
    back = jckpt.load_pytree(out, like)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
