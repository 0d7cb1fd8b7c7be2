"""Port parity, sync: the homography solve / warp / unwarp, WAM's quadrant
logic (positions, the brute-force fit, the revert, ``WamSync`` over a mock
pixel watermark), ``fill_batch_log`` with a sync manager, the manager's
dispatch on file names with its refusals and the ``.safetensors`` reader,
and ``generate --sync``, against the JAX package on the CPU.

Tolerances: the homography paths agree within 1e-4 on [0, 1] images; the
integer and host paths (positions, the fit, the estimate) are equal; the
slice's codes are equal and its images within 1e-4.

``MockEmbedder`` is the twin of JAX's (``tests/test_sync.py``): it writes
the message id as a quantized blue level and reads it back, so a geometric
attack moves the quadrant ids with the pixels as a real pixel watermark
would; random WAM weights give too little coverage to reach the fit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.augmentations import AugmentationManager as JManager
from wmar_tpu.eval import pipeline as jpipe
from wmar_tpu.models import armm as jarmm
from wmar_tpu.models import taming_gpt as jgpt
from wmar_tpu.models import vqgan as jvq
from wmar_tpu.sync import homography as jh
from wmar_tpu.sync import manager as jman
from wmar_tpu.sync import syncseal as jss
from wmar_tpu.sync import syncseal_models as jsm
from wmar_tpu.sync import wam_logic as jwl
from wmar_tpu_torch import bridge
from wmar_tpu_torch.augmentations import AugmentationManager as TManager
from wmar_tpu_torch.augmentations import geometric as TG
from wmar_tpu_torch.eval import pipeline as tpipe
from wmar_tpu_torch.models import armm as tarmm
from wmar_tpu_torch.models import taming_gpt as tgpt
from wmar_tpu_torch.models import vqgan as tvq
from wmar_tpu_torch.sync import homography as th
from wmar_tpu_torch.sync import manager as tman
from wmar_tpu_torch.sync import syncseal as tss
from wmar_tpu_torch.sync import syncseal_models as tsm
from wmar_tpu_torch.sync import wam_logic as twl

ATOL = 1e-4
MSGS = jwl.quadrant_messages()


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


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Homography
# ---------------------------------------------------------------------------


def _warps(b, seed):
    """Corner targets (normalized, TL TR BL BR): a perspective jitter, a
    rotation about the centre, a zoom and a flip."""
    rng = np.random.default_rng(seed)
    canon = np.asarray(jss.CANON_CORNERS)
    out = [canon + rng.uniform(-0.2, 0.2, (4, 2))]
    t = np.deg2rad(12.0)
    out.append((canon - 0.5) @ np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]).T + 0.5)
    out.append((canon - 0.5) / 0.8 + 0.5)
    out.append(np.stack([1 - canon[:, 0], canon[:, 1]], 1))
    return np.stack(out[:b]).astype(np.float32)


def test_solve_homography_maps_the_corners_as_jax():
    """The 8 x 8 solve: H maps each source corner onto its target (pixels)
    and equals JAX's H."""
    src = np.tile(np.asarray(jss.CANON_CORNERS)[None] * 31.0, (4, 1, 1)).astype(np.float32)
    dst = _warps(4, 0) * 31.0
    got = th.solve_homography(torch.as_tensor(src), torch.as_tensor(dst))
    _close(got, jh.solve_homography(jnp.asarray(src), jnp.asarray(dst)), 1e-4)
    pts = torch.cat([torch.as_tensor(src), torch.ones(4, 4, 1)], -1) @ got.transpose(1, 2)
    _close(pts[..., :2] / pts[..., 2:], dst, 1e-3)


def test_warp_and_unwarp_known_warps_match_jax():
    """``apply_corner_warp`` (and its TV-order twin) and
    ``unwarp_from_corners`` on four known warps of 32 px images: equal to
    JAX's within 1e-4, and unwarping the warp's own corners gives back the
    original away from the border (bilinear twice)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    corners = _warps(4, 2)
    warped = tss.apply_corner_warp(torch.as_tensor(x), torch.as_tensor(corners))
    _close(warped, jss.apply_corner_warp(jnp.asarray(x), jnp.asarray(corners)))
    tv = corners[:, [0, 1, 3, 2]]
    _close(tss.apply_tv_corner_warp(torch.as_tensor(x), torch.as_tensor(tv)), warped, 0)
    back = th.unwarp_from_corners(warped, torch.as_tensor(corners))
    _close(back, jh.unwarp_from_corners(jnp.asarray(np.asarray(warped)), jnp.asarray(corners)))
    # the flip is exact: a pure permutation of the pixels
    _close(back[3], x[3], 1e-5)
    _close(th.warp_perspective(torch.as_tensor(x), torch.eye(3).expand(4, 3, 3)), x, 1e-6)


# ---------------------------------------------------------------------------
# WAM quadrant logic
# ---------------------------------------------------------------------------


class MockEmbedder:
    """JAX's test mock (``tests/test_sync.py``) in torch: the message id as
    a quantized blue level, detected exactly and locally."""

    LEVELS = np.array([0.15, 0.38, 0.62, 0.85])

    def embed(self, img01, msg):
        mid = int(np.flatnonzero((MSGS == np.asarray(msg.cpu())[0]).all(axis=1))[0])
        out = img01.clone()
        out[..., 2] = self.LEVELS[mid]
        return out

    def detect(self, img01):
        blue = img01[..., 2].cpu().numpy()
        d = np.abs(blue[..., None] - self.LEVELS[None, None, None, :])
        bits = MSGS[d.argmin(-1)].transpose(0, 3, 1, 2).astype(np.float32) * 2 - 1
        mask_logit = np.where(d.min(-1) < 0.05, 8.0, -8.0)[:, None]
        return torch.as_tensor(np.concatenate([mask_logit, bits], axis=1), device=img01.device)


class JMockEmbedder(MockEmbedder):
    def embed(self, img01, msg):
        mid = int(np.flatnonzero((MSGS == np.asarray(msg)[0]).all(axis=1))[0])
        return img01.at[..., 2].set(jnp.full(img01.shape[:3], self.LEVELS[mid], img01.dtype))

    def detect(self, img01):
        return jnp.asarray(super().detect(torch.as_tensor(np.array(img01))).numpy())


def _mock_syncs(size=64):
    return (twl.WamSync(MockEmbedder(), image_size=size, conf=twl.SyncConfidence(coverage=0.12)),
            jwl.WamSync(JMockEmbedder(), image_size=size, conf=jwl.SyncConfidence(coverage=0.12)))


def test_positions_from_predictions_equal_jax():
    rng = np.random.default_rng(3)
    mask = rng.normal(0, 2, (24, 24)).astype(np.float32)
    bits = rng.normal(0, 1, (32, 24, 24)).astype(np.float32)
    bits[:, :12] = MSGS[rng.integers(0, 4, (12, 24))].transpose(2, 0, 1) * 2 - 1 + bits[:, :12] * 0.4
    got = twl.positions_from_predictions(torch.as_tensor(mask), torch.as_tensor(bits), torch.as_tensor(MSGS))
    want = np.asarray(jwl.positions_from_predictions(jnp.asarray(mask), jnp.asarray(bits), jnp.asarray(MSGS)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 50 and (want == -1).sum() > 50


@pytest.mark.parametrize("attack", ["identity", "flip", "rotation", "crop"])
def test_mock_wam_estimate_fit_and_revert_equal_jax(attack):
    """``WamSync.estimate`` on a synced 64 px image after each attack gives
    JAX's (angle, cut_i, cut_j, flipped) and positions exactly; the fit on
    those positions is JAX's; ``remove_sync`` is JAX's within 1e-4."""
    tsync, jsync = _mock_syncs()
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    x[..., 2] = 0.0  # a neutral blue: no collision with the mock's levels
    synced = tsync.add_sync(torch.as_tensor(x))
    _close(synced, jsync.add_sync(jnp.asarray(x)), 1e-6)
    s01 = (synced + 1) / 2
    attacked = {"identity": s01, "flip": TG.hflip(s01), "rotation": TG.rotate(s01, 10.0),
                "crop": TG.upper_left_crop_resize_back(s01, 0.75)}[attack]
    t_info, t_pos = tsync.estimate(attacked[0])
    j_info, j_pos = jsync.estimate(jnp.asarray(attacked[0].numpy()))
    np.testing.assert_array_equal(t_pos, j_pos)
    assert tuple(map(int, t_info)) == tuple(map(int, j_info))
    assert tuple(map(int, twl.fit_best_aug(t_pos))) == tuple(map(int, jwl.fit_best_aug(j_pos)))
    if attack == "flip":
        assert t_info[3]
    _close(tsync.remove_sync(attacked * 2 - 1), jsync.remove_sync(jnp.asarray(attacked.numpy() * 2 - 1)))


@pytest.mark.parametrize("size,info", [(64, (0, 48, 58, False)), (64, (1, 60, 32, False)), (256, (0, 150, 200, False)),
                                       (256, (-7, 128, 128, False)), (64, (0, 32, 32, True))])
def test_revert_augmentation_pad_then_shrink_matches_jax(size, info):
    """The crop revert pads bottom and right and shrinks back with an
    antialiased linear resize (``resize_linear``, JAX's ``jax.image.resize``
    "linear"): at the pad-then-shrink shapes of 64 and 256 px, and the
    rotation and flip branches, within 1e-4."""
    x = np.random.default_rng(5).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    got = twl.revert_augmentation(torch.as_tensor(x), info)
    want = jwl.revert_augmentation(jnp.asarray(x), info)
    assert got.shape == want.shape
    _close(got, want)


def test_quadrant_masks_and_messages_equal_jax():
    for size in (64, 256):
        np.testing.assert_array_equal(twl.create_grid_mask(size), jwl.create_grid_mask(size))
    np.testing.assert_array_equal(twl.quadrant_messages(), MSGS)


# ---------------------------------------------------------------------------
# The slice: fill_batch_log with a sync manager
# ---------------------------------------------------------------------------

GPT = dict(vocab_size=64, block_size=300, n_layer=2, n_head=2, n_embd=32)
VQ = dict(resolution=64, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32,
          n_embed=64, embed_dim=16)
J_UNET = jsm.UNetConfig(z_channels=8, num_blocks=2, z_channels_mults=(1, 2), norm_groups=4)
T_UNET = tsm.UNetConfig(z_channels=8, num_blocks=2, z_channels_mults=(1, 2), norm_groups=4)
J_CN = jsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16))
T_CN = tsm.ConvNeXtConfig(depths=(1, 1), dims=(8, 16))
KEEP = {"rotation": (10,), "flip-h": (1,), "upperleft-crop": (0.75,), "brightness": (1.5,)}


def _taming_pair():
    vq_params = jvq.TamingVQGAN(jvq.VQGANConfig(**VQ)).init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3)))
    vq_params["params"]["quantize"]["embedding"] = jnp.asarray(
        np.random.default_rng(6).standard_normal((64, 16)), jnp.float32)
    jw = jarmm.TamingARMM(None, jgpt.GPTConfig(**GPT), vq_params, jvq.VQGANConfig(**VQ))
    tw = tarmm.TamingARMM(tgpt.GPT(tgpt.GPTConfig(**GPT)),
                          bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**VQ)),
                                                   jax.tree.map(np.asarray, vq_params)),
                          cache_dtype=torch.float32, device="cpu")
    return jw, tw


def _managers():
    jm, tm = JManager(), TManager()
    for m in (jm, tm):
        m.augs = [(name, fn, list(KEEP[name])) for name, fn, _ in m.augs if name in KEEP]
    jm._jit_cache = {(name, repr(p)): (lambda x, r, fn=fn, p=p: fn(x, p, r)) for name, fn, ps in jm.augs for p in ps}
    return jm, tm


def _syncseal_pair():
    unet = jsm.init_unet_params(0, J_UNET)
    cn = jsm.init_convnext_params(1, J_CN)
    jmodel = jss.SyncSealRef(unet, cn, cfg=jss.SyncSealConfig(scaling_w=0.2), unet_cfg=J_UNET, convnext_cfg=J_CN)
    tmodel = tss.SyncSealRef(unet_cfg=T_UNET, convnext_cfg=T_CN)
    tmodel.load_state_dict(bridge.syncseal_ref_state_dict(unet, cn, T_UNET, T_CN), strict=True)
    tss.well_posed_head_(tmodel, seed=3)
    jmodel.convnext_params["head"] = {"w": jnp.asarray(tmodel.extractor.head.linear.weight.detach().numpy().T),
                                      "b": jnp.asarray(tmodel.extractor.head.linear.bias.detach().numpy())}
    jmodel.add_sync, jmodel.remove_sync = jax.jit(jmodel.add_sync), jax.jit(jmodel.remove_sync)  # JAX's eager ops are slow
    return jman.SyncManager(jmodel), tman.SyncManager(tmodel)


class _JaxDecoder:
    """The port's wrapper with JAX's decoder, so both loops start from the
    same images (the decoders agree within 1e-4 on their own,
    ``test_torch_port_taming.py``)."""

    def __init__(self, port, jax_wrapper):
        self.port, self.jax_wrapper = port, jax_wrapper

    def __getattr__(self, name):
        return getattr(self.port, name)

    def codes_to_images(self, codes):
        return torch.as_tensor(np.array(self.jax_wrapper.codes_to_images(jnp.asarray(np.asarray(codes), jnp.int32))))


@pytest.mark.parametrize("sync", ["syncseal", "wam-mock"])
def test_fill_batch_log_with_sync_matches_jax(sync):
    """The same codes through both packages' ``fill_batch_log`` with a sync
    manager (a tiny SyncSealRef, or WamSync over the mock): the synced
    original, one round trip and four attack cells, each re-tokenized after
    ``remove_sync``. Codes equal, images within 1e-4; the synced original
    differs from the plain decode."""
    jw, tw = _taming_pair()
    if sync == "syncseal":
        jsync, tsync = _syncseal_pair()
    else:
        t, j = _mock_syncs(64)
        jsync, tsync = jman.SyncManager(j), tman.SyncManager(t)
    codes = np.random.default_rng(7).integers(0, 64, (2, tw.codes_size ** 2))
    jm, tm = _managers()
    params = dict(max_roundtrips=1)
    jlog = jpipe.fill_batch_log(jw, jnp.asarray(codes, jnp.int32), jm, jpipe.EvalParams(**params),
                                jax.random.PRNGKey(9), jsync)
    tlog = tpipe.fill_batch_log(_JaxDecoder(tw, jw), torch.as_tensor(codes), tm, tpipe.EvalParams(**params),
                                seed=9, sync_manager=tsync)
    assert list(tlog) == list(jlog) == ["roundtrips", *(name for name, _, _ in jm.augs)]
    for transform in jlog:
        for (jp, jc, ji), (tp, tc, ti) in zip(jlog[transform], tlog[transform], strict=True):
            assert repr(tp) == repr(jp)
            np.testing.assert_array_equal(tc, jc, err_msg=f"{transform} {tp}")
            _close(ti, ji)
    plain = np.asarray(jw.codes_to_images(jnp.asarray(codes, jnp.int32)))
    assert np.abs(tlog["roundtrips"][0][2] - plain).max() > 1e-3


# ---------------------------------------------------------------------------
# The manager and the entry point
# ---------------------------------------------------------------------------


def test_safetensors_reader_matches_safetensors(tmp_path):
    """The port's own reader (the card machine has no ``safetensors``)
    against ``safetensors``'s writer, every dtype it reads."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(8)
    tensors = {"f32": torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32)),
               "f16": torch.as_tensor(rng.normal(size=(5,)).astype(np.float16)),
               "bf16": torch.as_tensor(rng.normal(size=(2, 3)).astype(np.float32)).to(torch.bfloat16),
               "f64": torch.as_tensor(rng.normal(size=(2,))),
               "i64": torch.as_tensor(rng.integers(-9, 9, (4,))),
               "i32": torch.as_tensor(rng.integers(-9, 9, (2, 2)).astype(np.int32)),
               "i8": torch.as_tensor(rng.integers(-9, 9, (3,)).astype(np.int8)),
               "u8": torch.as_tensor(rng.integers(0, 255, (6,)).astype(np.uint8)),
               "bool": torch.as_tensor(rng.integers(0, 2, (5,)).astype(bool)),
               "scalar": torch.tensor(3.5)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tman.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_from_path_dispatch_and_refusals(tmp_path, monkeypatch):
    """The file name picks the model, as in JAX: "wam" -> WamSync (a
    missing file, or no path, refused with JAX's message), a "sync" ``.pt``
    / ``.safetensors`` -> SyncSealRef (both read the same weights), another
    "sync" file -> SyncSealModel, anything else refused. A TorchScript
    archive reads as the pickled state dict does."""
    for path in (None, str(tmp_path / "wam_missing.pth")):
        with pytest.raises(ValueError) as jerr:
            jman.SyncManager.from_path(path)
        with pytest.raises(ValueError) as terr:
            tman.SyncManager.from_path(path, device="cpu")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="Cannot infer"):
        tman.SyncManager.from_path(str(tmp_path / "model.pt"), device="cpu")
    assert isinstance(tman.SyncManager.from_path("wam.pth", embedder=MockEmbedder(), device="cpu").impl,
                      twl.WamSync)

    ref = tss.SyncSealRef(unet_cfg=T_UNET, convnext_cfg=T_CN)
    tss.well_posed_head_(ref)
    torch.save(ref.state_dict(), tmp_path / "syncseal.pt")
    from safetensors.torch import save_file

    save_file({k: v.contiguous() for k, v in ref.state_dict().items()}, str(tmp_path / "syncseal.safetensors"))
    # a TorchScript archive (the released syncmodel.jit.pt is one): its state dict is read
    holder = torch.nn.Module()
    holder.embedder, holder.extractor = ref.embedder, ref.extractor
    holder.forward = lambda x: holder.extractor(x)
    torch.jit.save(torch.jit.trace(holder, torch.zeros(1, 32, 32, 3)), str(tmp_path / "syncseal.jit.pt"))
    small = dict(unet_cfg=T_UNET, convnext_cfg=T_CN)
    load = tss.SyncSealRef.load_torch
    monkeypatch.setattr(tss.SyncSealRef, "load_torch", staticmethod(lambda p, device=None: load(p, device=device,
                                                                                                 **small)))
    x = torch.as_tensor(np.random.default_rng(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    outs = []
    for name in ("syncseal.pt", "syncseal.safetensors", "syncseal.jit.pt"):
        m = tman.SyncManager.from_path(str(tmp_path / name), device="cpu")
        assert isinstance(m.impl, tss.SyncSealRef)
        outs.append(m.remove_sync(m.add_sync(x)))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])

    flax = tss.SyncSealModel.init(0, tss.SyncSealConfig(image_size=32))
    flax.save(str(tmp_path / "sync_flax.msgpack"))
    m = tman.SyncManager.from_path(str(tmp_path / "sync_flax.msgpack"), device="cpu")
    assert isinstance(m.impl, tss.SyncSealModel) and m.impl.cfg.image_size == 32


def test_generate_sync_writes_the_same_tree(tmp_path):
    """``generate --tiny --sync true --syncpath <.pt>`` (the released
    SyncSeal's layout and widths, random weights, a well-posed head) writes
    the record tree of the run without ``--sync``, with the synced image as
    the original; ``--sync true`` without a path is refused as JAX refuses
    it."""
    from wmar_tpu_torch import generate as tgen

    model = tss.init_syncseal_ref(0)
    path = str(tmp_path / "syncseal_tiny.pt")
    torch.save(model.state_dict(), path)
    base = ["--model", "taming", "--tiny", "--device", "cpu", "--conditioning", "0", "--batch_size", "1"]
    plain = tgen.main([*base, "--outdir", str(tmp_path / "plain")])
    synced = tgen.main([*base, "--sync", "true", "--syncpath", path, "--outdir", str(tmp_path / "sync")])
    assert len(plain) == len(synced) == 64
    files = {d: sorted(os.path.relpath(os.path.join(r, f), tmp_path / d) for r, _, fs in os.walk(tmp_path / d)
                       for f in fs) for d in ("plain", "sync")}
    assert files["plain"] == files["sync"] and len(files["sync"]) == 3 * 64
    a = np.load(tmp_path / "plain" / "c=0,idx=1" / f"0001_{plain[0]['method']}_roundtrips_0.npy")
    b = np.load(tmp_path / "sync" / "c=0,idx=1" / f"0001_{synced[0]['method']}_roundtrips_0.npy")
    np.testing.assert_array_equal(a, b)  # the same codes, then sync on their image
    from PIL import Image

    png = [np.asarray(Image.open(tmp_path / d / "c=0,idx=1" / f"0001_{r[0]['method']}_roundtrips_0.png"), np.float32)
           for d, r in (("plain", plain), ("sync", synced))]
    assert 0 < np.abs(png[0] - png[1]).max() <= 0.2 * 255 * 2  # the synced image moves by at most the sync's scale
    with pytest.raises(ValueError) as jerr:
        jman.SyncManager.from_path(None)
    with pytest.raises(ValueError) as terr:
        tgen.main([*base, "--no_augs", "--sync", "true", "--outdir", str(tmp_path / "refused")])
    assert str(terr.value) == str(jerr.value)
