"""SyncSeal: active geometric synchronization, the inference half
(PyTorch port of ``wmar_tpu.sync.syncseal``).

An embedder writes an imperceptible synchronization signal (JND-attenuated),
an extractor predicts the 8 normalized corner coordinates of the original
frame after a geometric attack, and ``remove_sync`` inverts the homography
those corners give before the watermark is detected.

* :class:`SyncSealModel`: the JAX package's own Flax design (a ConvNeXt
  embedder with a pixel decoder, a ViT extractor with a corner head, a
  Laplacian JND), read and written as JAX's msgpack file with its ``.json``
  config sidecar. Flax's defaults are kept: the tanh GELU, LayerNorm eps
  1e-6, SAME padding, nearest and bilinear resizes with half-pixel centres.
* :class:`SyncSealRef`: the reference's released model (the UNet embedder
  on the luma channel and the ConvNeXtV2 extractor of ``syncseal_models``,
  ``jnd_1_1`` attenuation), read from the released ``.pt`` state dict or
  TorchScript archive, or from JAX's msgpack layout.

Images enter NHWC in [-1, 1] (the ``SyncManager`` interface) or [0, 1] (the
``*01`` functions); ``embed01``, ``detect01`` and the corner warps carry
gradients, ``add_sync``/``remove_sync`` do not.

Training (``train_sync.py:250-405``): :func:`make_ref_train_steps` gives the
reference-spec model step (perceptual + hinge-G + detection BCE + corner
MSE through the valuemetric bank and a geometric corner warp) and the
discriminator step, on :func:`init_ref_train_state`'s two AdamW optimizers;
:func:`make_train_step` trains the Flax design. Every draw (branch ids,
noise, corners) can be fed: the tests feed JAX's. Evaluation
(``evals/eval_sync.py``): :func:`evaluate_sync_ref` with :func:`ssim` and
the SIFT+RANSAC baseline (OpenCV, imported when called),
:func:`wam_corner_baseline`, and :func:`evaluate_sync`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wmar_tpu_torch.augmentations import valuemetric as V
from wmar_tpu_torch.sync import syncseal_models as sm
from wmar_tpu_torch.sync.homography import solve_homography, unwarp_from_corners, warp_perspective
from wmar_tpu_torch.sync.wam_exact import jnd_heatmaps

CANON_CORNERS = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], dtype=np.float32)  # TL TR BL BR
# torchvision perspective corner order (geometricunified.py startpoints)
TV_CORNERS = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], dtype=np.float32)  # TL TR BR BL
TV_TO_SOLVER = [0, 1, 3, 2]


# ---------------------------------------------------------------------------
# The Flax design (SyncSealModel)
# ---------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class ConvNeXtBlock(nn.Module):
    """NCHW; depthwise 7x7, LayerNorm, Dense x4, GELU, Dense, ``gamma``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.pw2(_gelu(self.pw1(self.norm(self.dwconv(x).permute(0, 2, 3, 1)))))
        return x + (self.gamma * h).permute(0, 3, 1, 2)


class ConvNeXtEmbedder(nn.Module):
    """ConvNeXt trunk and an upsampling pixel decoder -> a 3-channel signal
    delta. NHWC [0, 1] in, NHWC out; sides divisible by 4 * 2^(stages-1)."""

    def __init__(self, depths: Sequence[int] = (2, 2, 4), dims: Sequence[int] = (48, 96, 192)):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.stem = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = sm.ChannelsFirstLN(dims[0])
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                self.add_module(f"down_norm{si}", sm.ChannelsFirstLN(dims[si - 1]))
                self.add_module(f"down{si}", nn.Conv2d(dims[si - 1], dim, 2, stride=2))
            for bi in range(depth):
                self.add_module(f"block{si}_{bi}", ConvNeXtBlock(dim))
        for si in reversed(range(len(dims) - 1)):
            self.add_module(f"up{si}", nn.Conv2d(dims[si + 1], dims[si], 3, padding=1))
        self.out = nn.Conv2d(dims[0], 3, 3, padding=1)

    def forward(self, x01):
        h = self.stem_norm(self.stem((x01 * 2.0 - 1.0).permute(0, 3, 1, 2)))
        feats = []
        for si, depth in enumerate(self.depths):
            if si > 0:
                h = getattr(self, f"down{si}")(getattr(self, f"down_norm{si}")(h))
            for bi in range(depth):
                h = getattr(self, f"block{si}_{bi}")(h)
            feats.append(h)
        h = feats[-1]
        for si in reversed(range(len(self.dims) - 1)):
            h = getattr(self, f"up{si}")(F.interpolate(h, scale_factor=2, mode="nearest"))
            h = _gelu(h + feats[si])
        h = F.interpolate(h, scale_factor=4, mode="bilinear", align_corners=False)
        return self.out(h).permute(0, 2, 3, 1)


class FlaxMHA(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    Linear query / key / value / out with the heads flattened."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, x):
        b, n, d = x.shape
        nh, hd = self.num_heads, d // self.num_heads
        q, k, v = (p(x).reshape(b, n, nh, hd).transpose(1, 2) for p in (self.query, self.key, self.value))
        attn = torch.softmax((q / hd**0.5) @ k.transpose(-2, -1), dim=-1)
        return self.out((attn @ v).transpose(1, 2).reshape(b, n, d))


class ViTExtractor(nn.Module):
    """Patch ViT -> mean-pool -> the 8 normalized corner coordinates
    ``[B, 4, 2]`` (TL TR BL BR), NHWC [0, 1] in."""

    def __init__(self, image_size: int = 256, patch: int = 8, dim: int = 192, depth: int = 4, heads: int = 4):
        super().__init__()
        self.depth = depth
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.pos = nn.Parameter(torch.zeros(1, (image_size // patch) ** 2, dim))
        for li in range(depth):
            self.add_module(f"ln1_{li}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"attn_{li}", FlaxMHA(dim, heads))
            self.add_module(f"ln2_{li}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"fc1_{li}", nn.Linear(dim, 4 * dim))
            self.add_module(f"fc2_{li}", nn.Linear(4 * dim, dim))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, 8)

    def forward(self, x01):
        h = self.patch_embed((x01 * 2.0 - 1.0).permute(0, 3, 1, 2))
        b, c = h.shape[:2]
        h = h.flatten(2).transpose(1, 2) + self.pos
        for li in range(self.depth):
            h = h + getattr(self, f"attn_{li}")(getattr(self, f"ln1_{li}")(h))
            h = h + getattr(self, f"fc2_{li}")(_gelu(getattr(self, f"fc1_{li}")(getattr(self, f"ln2_{li}")(h))))
        out = self.head(self.ln_f(h).mean(dim=1))
        # offsets around the canonical corners; the sigmoid keeps them in frame
        canon = torch.as_tensor(CANON_CORNERS, device=out.device)
        return torch.sigmoid(out.reshape(b, 4, 2) + canon * 4.0 - 2.0)


def jnd_heatmap(x01: torch.Tensor) -> torch.Tensor:
    """Just-noticeable-difference attenuation (``modules/jnd.py``) of NHWC
    images: higher where luminance masking tolerates change."""
    lum = x01.mean(-1, keepdim=True)
    k = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=x01.dtype, device=x01.device)[None, None]
    act = torch.abs(F.conv2d(lum.permute(0, 3, 1, 2), k, padding=1)).permute(0, 2, 3, 1)
    lum_mask = 0.5 + torch.abs(lum - 0.5)  # more headroom near black and white
    return torch.clamp(0.3 * lum_mask + 2.0 * act, 0.05, 1.0)


def _quantize_st(x: torch.Tensor) -> torch.Tensor:
    """8-bit rounding with a straight-through gradient, JAX's expression."""
    q = torch.round(torch.clamp(x, 0, 1) * 255.0) / 255.0
    return x + (q - x).detach()


@dataclasses.dataclass(frozen=True)
class SyncSealConfig:
    image_size: int = 256
    scaling_w: float = 0.4  # embedding strength (reference scaling_w)


def _init_like_flax(model: nn.Module, gen: torch.Generator, zero=()) -> None:
    """Flax's default initializers: kernels normal with variance 1/fan-in,
    biases zero, norms one; ``zero`` names parameters that start at zero."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in zero or name.endswith("bias"):
                p.zero_()
            elif name == "pos" or name.endswith(".pos"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("gamma"):
                p.fill_(1e-6)
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * p[0].numel() ** -0.5)


class SyncSealModel(nn.Module):
    """embed / detect / unwarp of the Flax design; the reference's
    ``SyncModel`` + ``SyncModelJIT`` surface."""

    def __init__(self, cfg: SyncSealConfig = SyncSealConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        with torch.device(device or "cpu"):
            self.embedder = ConvNeXtEmbedder()
            self.extractor = ViTExtractor(image_size=cfg.image_size)
        self.eval()

    @staticmethod
    def init(seed: int = 0, cfg: SyncSealConfig = SyncSealConfig(), device=None) -> "SyncSealModel":
        """Random weights from ``seed`` (drawn on the CPU), with Flax's
        initial values: the output conv zero, ``gamma`` 1e-6."""
        model = SyncSealModel(cfg)
        _init_like_flax(model, torch.Generator().manual_seed(seed), zero=("embedder.out.weight",))
        return model.to(device)

    @staticmethod
    def load(path: str, cfg: Optional[SyncSealConfig] = None, device=None) -> "SyncSealModel":
        """JAX's msgpack file (``{"embedder": {"params"}, "extractor":
        {"params"}}``); the config from ``path + ".json"`` when there is one."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.utils.checkpoint import load_pytree

        if cfg is None:
            cfg = SyncSealConfig()
            if os.path.exists(path + ".json"):
                with open(path + ".json") as f:
                    cfg = SyncSealConfig(**json.load(f))
        model = SyncSealModel(cfg, device="meta")
        model.load_state_dict(bridge.syncseal_model_state_dict(load_pytree(path)), strict=True, assign=True)
        return model.to(device).eval()

    def save(self, path: str) -> None:
        from wmar_tpu_torch.utils.checkpoint import save_pytree

        save_pytree(path, flax_tree(self))
        with open(path + ".json", "w") as f:
            json.dump(dataclasses.asdict(self.cfg), f)

    @property
    def device(self) -> torch.device:
        return self.extractor.pos.device

    def embed01(self, imgs01: torch.Tensor) -> torch.Tensor:
        out = imgs01 + self.cfg.scaling_w * jnd_heatmap(imgs01) * self.embedder(imgs01)
        return _quantize_st(out)

    def detect01(self, imgs01: torch.Tensor) -> torch.Tensor:
        return self.extractor(imgs01)  # [B, 4, 2]

    @torch.no_grad()
    def add_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.embed01((imgs + 1.0) / 2.0) * 2.0 - 1.0, -1.0, 1.0)

    @torch.no_grad()
    def detect(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.detect01((imgs + 1.0) / 2.0)

    @torch.no_grad()
    def remove_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        out01 = unwarp_from_corners((imgs + 1.0) / 2.0, self.detect(imgs))
        return torch.clamp(out01 * 2.0 - 1.0, -1.0, 1.0)


def flax_tree(model: SyncSealModel) -> dict:
    """``model`` as JAX's ``SyncSealModel.save`` writes it: the inverse of
    ``bridge.syncseal_model_state_dict``."""
    tree: dict = {"embedder": {"params": {}}, "extractor": {"params": {}}}
    for key, t in model.state_dict().items():
        part, rest = key.split(".", 1)
        mod, name = rest.rsplit(".", 1) if "." in rest else ("", rest)
        sub = model.get_submodule(f"{part}.{mod}") if mod else None
        t = t.detach()
        if name == "weight" and t.dim() == 4:
            name, t = "kernel", t.permute(2, 3, 1, 0)
        elif name == "weight" and isinstance(sub, nn.LayerNorm | sm.ChannelsFirstLN):
            name = "scale"
        elif name == "weight" and mod.endswith((".query", ".key", ".value", ".out")):
            heads = model.get_submodule(f"{part}.{mod.rsplit('.', 1)[0]}").num_heads
            name = "kernel"
            t = t.T.reshape(-1, heads, t.shape[0] // heads) if not mod.endswith(".out") else \
                t.T.reshape(heads, t.shape[1] // heads, -1)
        elif name == "bias" and mod.endswith((".query", ".key", ".value")):
            heads = model.get_submodule(f"{part}.{mod.rsplit('.', 1)[0]}").num_heads
            t = t.reshape(heads, -1)
        elif name == "weight" and t.dim() == 2:
            name, t = "kernel", t.T
        node = tree[part]["params"]
        for p in mod.split(".") if mod else ():
            node = node.setdefault(p, {})
        node[name] = t.contiguous()
    return tree


# ---------------------------------------------------------------------------
# Corner warps
# ---------------------------------------------------------------------------


def apply_corner_warp(imgs01: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """Warp so the canonical frame corners land at ``corners`` ([B, 4, 2]
    normalized, TL TR BL BR); the inverse-warp convention of
    ``warp_perspective``."""
    b, h, w, _ = imgs01.shape
    scale = torch.tensor([w - 1.0, h - 1.0], device=imgs01.device)
    canon_px = torch.as_tensor(CANON_CORNERS, device=imgs01.device) * scale
    # output pixel p (in the attacked frame) samples the source at H(p),
    # with H mapping the dst corners to the canonical ones
    h_inv = solve_homography(corners.float() * scale, canon_px.expand(b, 4, 2))
    return warp_perspective(imgs01, h_inv)


def apply_tv_corner_warp(imgs01: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """:func:`apply_corner_warp` for corners in torchvision's TL TR BR BL order."""
    return apply_corner_warp(imgs01, corners[:, TV_TO_SOLVER])


# ---------------------------------------------------------------------------
# The reference's released model (SyncSealRef)
# ---------------------------------------------------------------------------


class _Embedder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.unet = sm.UNet(cfg)


class SyncSealRef(nn.Module):
    """The reference's shipped SyncModel: the ``unet_small2_yuv`` embedder
    on the Y channel and the ``convnext_tiny`` extractor predicting (the
    detection logit, 8 corner coordinates in [-1, 1] in TL TR BR BL order),
    ``jnd_1_1`` attenuation, the scaling_w blend and 8-bit rounding
    (``syncseal/models/sync_model.py:84-270``). Parameter names are the
    released checkpoint's."""

    def __init__(self, cfg: Optional[SyncSealConfig] = None, unet_cfg=None, convnext_cfg=None, device=None):
        super().__init__()
        self.cfg = cfg or SyncSealConfig(scaling_w=0.2)
        self.unet_cfg = unet_cfg or sm.UNET_SMALL2_YUV
        self.convnext_cfg = convnext_cfg or sm.CONVNEXT_TINY
        with torch.device(device or "cpu"):
            self.embedder = _Embedder(self.unet_cfg)
            self.extractor = sm.ConvNeXtExtractor(self.convnext_cfg)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.extractor.head.linear.weight.device

    @staticmethod
    def load_torch(path: str, cfg=None, device=None, **cfgs) -> "SyncSealRef":
        """The released state dict (``.pt``/``.pth`` pickle, TorchScript
        archive or ``.safetensors``): ``embedder.unet.*`` and
        ``extractor.{convnext,head}.*`` keys, or the bare ``unet.*`` /
        ``convnext.*`` / ``head.*`` ones. Other keys are not read."""
        from wmar_tpu_torch.sync.manager import load_state_dict_file

        sd = load_state_dict_file(path)
        unet = "embedder.unet." if any(k.startswith("embedder.unet.") for k in sd) else "unet."
        ext = "extractor." if any(k.startswith("extractor.") for k in sd) else ""
        model = SyncSealRef(cfg, device="meta", **cfgs)
        names = {k: ("embedder.unet." + k[len(unet):] if k.startswith(unet) else "extractor." + k[len(ext):])
                 for k in sd}
        own = {names[k]: torch.as_tensor(v) for k, v in sd.items() if names[k] in model.state_dict()}
        model.load_state_dict(own, strict=True, assign=True)
        return model.to(device).eval()

    @staticmethod
    def init(seed: int = 0, cfg=None, unet_cfg=None, convnext_cfg=None, device=None) -> "SyncSealRef":
        """JAX's ``SyncSealRef.init(seed)``: the UNet from numpy seed
        ``seed``, the ConvNeXt from ``seed + 1``, weight for weight."""
        from wmar_tpu_torch import bridge

        unet_cfg, convnext_cfg = unet_cfg or sm.UNET_SMALL2_YUV, convnext_cfg or sm.CONVNEXT_TINY
        model = SyncSealRef(cfg, unet_cfg, convnext_cfg, device="meta")
        sd = bridge.syncseal_ref_state_dict(sm.init_unet_params(seed, unet_cfg),
                                            sm.init_convnext_params(seed + 1, convnext_cfg), unet_cfg, convnext_cfg)
        model.load_state_dict(sd, strict=True, assign=True)
        return model.to(device).eval()

    @staticmethod
    def load(path: str, cfg=None, device=None, unet_cfg=None, convnext_cfg=None) -> "SyncSealRef":
        """JAX's ``SyncSealRef.save`` file (msgpack, ``{"unet", "convnext"}``);
        the released widths unless ``unet_cfg``/``convnext_cfg`` say others."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.utils.checkpoint import load_pytree

        tree = load_pytree(path)
        model = SyncSealRef(cfg, unet_cfg, convnext_cfg, device="meta")
        model.load_state_dict(bridge.syncseal_ref_state_dict(tree["unet"], tree["convnext"], model.unet_cfg,
                                                             model.convnext_cfg), strict=True, assign=True)
        return model.to(device).eval()

    def save(self, path: str) -> None:
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.utils.checkpoint import save_pytree

        pairs = bridge.syncseal_ref_pairs(self.unet_cfg, self.convnext_cfg)
        save_pytree(path, bridge.state_dict_to_tree(self.state_dict(), pairs))

    def embed01(self, imgs01: torch.Tensor, scaling_w: Optional[float] = None) -> torch.Tensor:
        sw = self.cfg.scaling_w if scaling_w is None else scaling_w
        y = sm.rgb_to_yuv(imgs01)[..., :1]
        imgs_w = imgs01 + sw * self.embedder.unet(y * 2.0 - 1.0)  # scaling_i 1, the 1-channel delta broadcast
        # jnd_1_1: imgs + hmaps * (imgs_w - imgs), on the luminance heatmap
        imgs_w = imgs01 + jnd_heatmaps(imgs01, blue=False)[..., :1] * (imgs_w - imgs01)
        return _quantize_st(V.clip01(imgs_w))

    def detect01(self, imgs01: torch.Tensor) -> torch.Tensor:
        return self.extractor(imgs01 * 2.0 - 1.0)

    @torch.no_grad()
    def add_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.embed01((imgs + 1.0) / 2.0) * 2.0 - 1.0, -1.0, 1.0)

    @torch.no_grad()
    def remove_sync(self, imgs: torch.Tensor) -> torch.Tensor:
        preds = self.detect01((imgs + 1.0) / 2.0)
        corners01 = (preds[:, 1:].reshape(-1, 4, 2) + 1.0) / 2.0  # [-1, 1] -> [0, 1]
        out01 = unwarp_from_corners((imgs + 1.0) / 2.0, corners01[:, TV_TO_SOLVER])
        return torch.clamp(out01 * 2.0 - 1.0, -1.0, 1.0)


def well_posed_head_(model: SyncSealRef, seed: int = 0, jitter: float = 0.02, weight_scale: float = 1e-3) -> None:
    """Set a random model's corner head so its corners sit near the frame's
    corners: the weight scaled down, the bias at the frame corners in TV
    order ([-1, -1, 1, -1, 1, 1, -1, 1]) plus ``jitter``. With random
    weights the head puts every corner near the centre otherwise, where the
    homography's 8 x 8 system is near-singular."""
    lin = model.extractor.head.linear
    gen = torch.Generator().manual_seed(seed)
    corners = torch.tensor([-1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0, 1.0])
    with torch.no_grad():
        lin.weight.mul_(weight_scale)
        bias = torch.cat([torch.zeros(1), corners + jitter * (2 * torch.rand(8, generator=gen) - 1)])
        lin.bias.copy_(bias.to(lin.bias.device))


def init_syncseal_ref(seed: int = 0, cfg=None, unet_cfg=None, convnext_cfg=None, device=None) -> SyncSealRef:
    """A ``SyncSealRef`` with random weights from ``seed`` (drawn on the
    CPU): convolutions and linears He-normal, depthwise kernels and GRN
    as JAX's ``init_*_params`` draw them, norms one and zero, and the
    corner head made well posed (:func:`well_posed_head_`)."""
    model = SyncSealRef(cfg, unet_cfg, convnext_cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("dwconv.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif "grn" in name or name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / p[0].numel()) ** 0.5)
    well_posed_head_(model, seed)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# The Flax design's training and evaluation
# ---------------------------------------------------------------------------

_FLIP_SIGNS = np.asarray([[1, 1], [-1, 1], [1, -1], [-1, -1]], np.float32)  # TL TR BL BR, inward


def random_corner_homography(batch: int, generator: Optional[torch.Generator] = None, strength: float = 0.25,
                             jitter: Optional[torch.Tensor] = None, flip: Optional[torch.Tensor] = None):
    """Target corners ``[B, 4, 2]`` (TL TR BL BR) of a random perspective /
    crop: each corner jittered inward or outward by ``jitter`` (``[B, 4, 2]``
    in [-strength, strength]), then mirrored in x where ``flip`` (``[B]``,
    drawn with probability 1/4). Both are drawn from ``generator`` unless fed."""
    if jitter is None:
        jitter = (torch.rand(batch, 4, 2, generator=generator) * 2 - 1) * strength
    if flip is None:
        flip = torch.rand(batch, generator=generator) < 0.25
    corners = torch.as_tensor(CANON_CORNERS) + jitter.float().cpu() * torch.as_tensor(_FLIP_SIGNS)
    flipped = torch.stack([1.0 - corners[..., 0], corners[..., 1]], dim=-1)
    return torch.where(torch.as_tensor(flip).cpu().reshape(-1, 1, 1), flipped, corners)


def make_train_step(model: SyncSealModel, optimizer: torch.optim.Optimizer, perceptual=None,
                    corner_weight: float = 5.0):
    """The Flax design's step: corner MAE + perceptual drift
    (``losses/sync_loss.py`` without the GAN term), through 0.02 noise and a
    random corner warp. ``train_step(imgs01, generator=None, noise=None,
    corners=None)`` returns the metrics; ``noise``/``corners`` feed the draws."""
    from wmar_tpu_torch.finetune.perceptual import PerceptualLoss

    perceptual = perceptual or PerceptualLoss()

    def train_step(imgs01, generator=None, noise=None, corners=None):
        dev = imgs01.device
        if noise is None:
            noise = torch.randn(imgs01.shape, generator=generator)
        if corners is None:
            corners = random_corner_homography(imgs01.shape[0], generator)
        embedded = model.embed01(imgs01)
        p_loss = perceptual(imgs01 * 2 - 1, embedded * 2 - 1).mean()
        noisy = V.clip01(embedded + noise.to(dev) * 0.02)
        corners = corners.to(dev)
        pred = model.detect01(apply_corner_warp(noisy, corners))
        corner_mae = (pred - corners).abs().mean()
        loss = p_loss + corner_weight * corner_mae
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "perceptual": p_loss.detach(), "corner_mae": corner_mae.detach()}

    return train_step


@torch.no_grad()
def evaluate_sync(model: SyncSealModel, imgs01: torch.Tensor, generator=None, strengths=(0.05, 0.15, 0.25),
                  corners=None) -> dict:
    """The Flax design's corner-error grid (``evals/eval_sync.py``): embed,
    warp by known corners at each strength (``corners[i]`` feeds them),
    detect; the mean corner error (normalized units) and the embedding PSNR."""
    embedded = model.embed01(imgs01)
    mse = float(((embedded - imgs01) ** 2).mean())
    rows = []
    for si, s in enumerate(strengths):
        c = (corners[si] if corners is not None else random_corner_homography(imgs01.shape[0], generator, s))
        c = torch.as_tensor(c, device=imgs01.device)
        pred = model.detect01(apply_corner_warp(embedded, c))
        rows.append({"strength": s, "corner_mae": float((pred - c).abs().mean())})
    return {"psnr": float(10 * np.log10(1.0 / max(mse, 1e-12))), "grid": rows}


# ---------------------------------------------------------------------------
# Training to the reference spec (train_sync.py:250-405)
# ---------------------------------------------------------------------------

NOISE_BRANCH = 9  # the index of gaussian_noise in valuemetric_branches()


def valuemetric_branches():
    """The in-training valuemetric bank (``syncseal/augmentation/
    valuemetric.py``) in JAX's order, a few discrete strengths per family.
    Each branch takes a batch; the noise branch also takes its noise."""
    return [
        lambda x: x,  # identity
        lambda x: V.jpeg_diff(x, 60),
        lambda x: V.jpeg_diff(x, 85),
        lambda x: V.gaussian_blur(x, 5),
        lambda x: V.median_filter(x, 3),
        lambda x: V.clip01(V.brightness(x, 1.5)),
        lambda x: V.contrast(x, 1.5),
        lambda x: V.saturation(x, 1.5),
        lambda x: V.hue(x, 0.1),
        lambda x, noise: V.gaussian_noise(x, 0.05, noise=noise),
        lambda x: V.grayscale(x),
    ]


def apply_valuemetric(imgs01: torch.Tensor, aug_ids: torch.Tensor, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Each image through its branch of :func:`valuemetric_branches`, the
    batch grouped by branch id. ``noise``: ``[k, H, W, C]`` for the ``k``
    images of the noise branch, in batch order (drawn from ``generator``
    when not fed)."""
    ids = aug_ids.to(imgs01.device)
    parts, rows = [], []
    for k, branch in enumerate(valuemetric_branches()):
        idx = torch.nonzero(ids == k).flatten()
        if idx.numel() == 0:
            continue
        if k == NOISE_BRANCH:
            if noise is None:
                noise = torch.randn((idx.numel(), *imgs01.shape[1:]), generator=generator)
            parts.append(branch(imgs01[idx], noise.to(imgs01.device)))
        else:
            parts.append(branch(imgs01[idx]))
        rows.append(idx)
    order = torch.argsort(torch.cat(rows))
    return torch.cat(parts)[order]


GEOMETRIC_FAMILIES = ("identity", "rotate", "crop", "perspective", "hflip")
_INWARD_TV = np.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)  # TL TR BR BL


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its [0, 1) draw."""
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def sample_geometric_corners(batch: int, generator: Optional[torch.Generator] = None,
                             perspective_strength: float = 0.25, probs=None, family: Optional[torch.Tensor] = None,
                             uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One geometric attack per image as the target corners ``[B, 4, 2]`` in
    [0, 1], TV order: identity / rotation (+-30 degrees) / zoom-crop (0.5 to
    0.95) / perspective / hflip, the families of
    ``syncseal/augmentation/geometricunified.py:41-349``. ``probs`` weights
    the family (``all_augs.yaml``; None = uniform). ``family`` ``[B]`` and
    ``uniforms`` ``[B, 4, 2]`` in [0, 1) feed the draws: a rotation or a crop
    reads ``uniforms[:, 0, 0]``, a perspective all eight."""
    if family is None:
        if probs is None:
            family = torch.randint(0, len(GEOMETRIC_FAMILIES), (batch,), generator=generator)
        else:
            family = torch.multinomial(torch.as_tensor(probs, dtype=torch.float64), batch, replacement=True,
                                       generator=generator)
    if uniforms is None:
        uniforms = torch.rand(batch, 4, 2, generator=generator)
    u = uniforms.float().cpu()
    canon = torch.as_tensor(TV_CORNERS).expand(batch, 4, 2)
    center = torch.tensor([0.5, 0.5])
    theta = _uniform(u[:, 0, 0], -np.pi / 6, np.pi / 6)
    c, s = torch.cos(theta), torch.sin(theta)
    rm = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [B, 2, 2]
    rot = (canon - center) @ rm.transpose(1, 2) + center
    crop = (canon - center) / _uniform(u[:, 0, 0], 0.5, 0.95)[:, None, None] + center
    persp = canon + _uniform(u, -perspective_strength, perspective_strength) * torch.as_tensor(_INWARD_TV)
    flip = torch.stack([1.0 - canon[..., 0], canon[..., 1]], -1)
    options = torch.stack([canon, rot, crop, persp, flip])  # [5, B, 4, 2]
    return options[torch.as_tensor(family).cpu().long(), torch.arange(batch)]


@dataclasses.dataclass
class RefTrainConfig:
    scaling_w: float = 0.2
    scaling_w_min: Optional[float] = None  # linear schedule target
    schedule_epochs: int = 100
    lambda_i: float = 1.0  # perceptual
    lambda_d: float = 1.0  # GAN
    lambda_det: float = 1.0  # detection BCE
    lambda_sync: float = 10.0  # corner regression
    disc_start: int = 0
    finetune_detector_start: int = 10**9


def scaling_w_at(cfg: RefTrainConfig, epoch: int) -> float:
    """Linear scaling_w schedule (``uoptim.ScalingScheduler`` semantics)."""
    if cfg.scaling_w_min is None:
        return cfg.scaling_w
    t = min(max(epoch, 0), cfg.schedule_epochs) / cfg.schedule_epochs
    return cfg.scaling_w + t * (cfg.scaling_w_min - cfg.scaling_w)


@dataclasses.dataclass
class RefDraws:
    """The random draws of one model step: a valuemetric branch id per
    image ``[B]``, the noise of the noise branch's images ``[k, H, W, C]``
    (batch order), the target corners ``[B, 4, 2]`` (TV order, [0, 1])."""

    aug_ids: torch.Tensor
    noise: torch.Tensor
    corners: torch.Tensor


def sample_ref_draws(imgs_shape, generator: Optional[torch.Generator] = None, aug_weights=None) -> RefDraws:
    """A step's draws on the CPU from ``generator``; ``aug_weights`` (a
    ``configs.AugWeights``) weights both samplers, None = uniform."""
    b = imgs_shape[0]
    n = len(valuemetric_branches())
    if aug_weights is None:
        aug_ids = torch.randint(0, n, (b,), generator=generator)
    else:
        aug_ids = torch.multinomial(torch.as_tensor(aug_weights.valuemetric, dtype=torch.float64), b,
                                    replacement=True, generator=generator)
    k = int((aug_ids == NOISE_BRANCH).sum())
    noise = torch.randn((k, *imgs_shape[1:]), generator=generator)
    corners = sample_geometric_corners(b, generator, probs=None if aug_weights is None else aug_weights.geometric)
    return RefDraws(aug_ids, noise, corners)


# optax.adamw's defaults, which torch.optim.AdamW does not share (its decay is 1e-2)
ADAMW_BETAS, ADAMW_EPS, ADAMW_DECAY = (0.9, 0.999), 1e-8, 1e-4


def cosine_decay(total_steps: int, alpha: float = 1e-2):
    """``optax.cosine_decay_schedule(lr, total_steps, alpha)`` as a factor
    of ``lr`` at the optimizer's step count (a ``LambdaLR`` lambda)."""
    def factor(count: int) -> float:
        t = min(count, total_steps) / total_steps
        return float((1 - alpha) * 0.5 * (1 + np.cos(np.pi * t)) + alpha)
    return factor


def make_adamw(params, lr: float, total_steps: Optional[int] = None, weight_decay: float = ADAMW_DECAY):
    """``optax.adamw(cosine_decay_schedule(lr, total_steps, 1e-2))``: AdamW
    with optax's betas, eps and decay, and its schedule (None: constant)."""
    opt = torch.optim.AdamW(params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(total_steps)) if total_steps else None
    return opt, sched


@dataclasses.dataclass
class RefTrainState:
    """The model, the discriminator and an optimizer (with its schedule) for
    each: what JAX's ``(params, opt_state, disc_params, disc_opt_state)``
    holds."""

    model: SyncSealRef
    disc: sm.SyncSealDiscriminator
    opt: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    sched: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    sched_d: Optional[torch.optim.lr_scheduler.LRScheduler] = None

    def state_dict(self) -> dict:
        return {k: getattr(self, k).state_dict() for k in ("model", "disc", "opt", "opt_d", "sched", "sched_d")
                if getattr(self, k) is not None}

    def load_state_dict(self, sd: dict) -> None:
        for k, v in sd.items():
            getattr(self, k).load_state_dict(v)


def init_ref_train_state(model: SyncSealRef, lr: float, total_steps: Optional[int] = None, seed: int = 0,
                         weight_decay: float = ADAMW_DECAY) -> RefTrainState:
    """JAX's ``init_ref_train_state`` with ``optax.adamw`` under the cosine
    schedule for both: the discriminator from ``init_discriminator_params(seed)``."""
    disc = sm.init_discriminator(seed, device=model.device)
    opt, sched = make_adamw(list(model.parameters()), lr, total_steps, weight_decay)
    opt_d, sched_d = make_adamw(list(disc.parameters()), lr, total_steps, weight_decay)
    return RefTrainState(model.train(), disc.train(), opt, opt_d, sched, sched_d)


def ref_model_loss(state: RefTrainState, imgs01, draws: RefDraws, scaling_w, disc_factor, detector_only: bool,
                   cfg: RefTrainConfig, perceptual):
    """JAX's ``model_loss``: (total, metrics). In a detector-only step the
    embedding is computed without a graph, so the UNet gets no gradient and
    the perceptual and GAN terms are weighted 0."""
    model, dev = state.model, imgs01.device
    with torch.set_grad_enabled(torch.is_grad_enabled() and not detector_only):
        imgs_w = model.embed01(imgs01, scaling_w)
    imgs_aug = apply_valuemetric(imgs_w, draws.aug_ids, draws.noise)
    corners = draws.corners.to(dev)
    preds = model.detect01(apply_tv_corner_warp(imgs_aug, corners))
    target = corners.reshape(-1, 8) * 2.0 - 1.0
    active = 0.0 if detector_only else 1.0
    p_loss = perceptual(imgs01 * 2 - 1, imgs_w * 2 - 1).mean()
    g_loss = -state.disc(imgs_w).mean()
    det_loss = F.binary_cross_entropy_with_logits(preds[:, 0], torch.ones_like(preds[:, 0]))
    sync_loss = ((preds[:, 1:] - target) ** 2).mean()
    total = (cfg.lambda_i * active * p_loss + cfg.lambda_d * active * disc_factor * g_loss
             + cfg.lambda_det * det_loss + cfg.lambda_sync * sync_loss)
    return total, {"loss": total, "percep": p_loss, "gan_g": g_loss, "detect": det_loss, "transform": sync_loss}


def ref_disc_loss(state: RefTrainState, imgs01, scaling_w, disc_factor):
    """JAX's ``disc_loss``: hinge D on (real, the detached embedding)."""
    with torch.no_grad():
        imgs_w = state.model.embed01(imgs01, scaling_w)
    logits_real, logits_fake = state.disc(imgs01), state.disc(imgs_w)
    d = disc_factor * sm.hinge_d_loss(logits_real, logits_fake)
    return d, {"disc_loss": d, "logits_real": logits_real.mean(), "logits_fake": logits_fake.mean()}


def make_ref_train_steps(state: RefTrainState, cfg: RefTrainConfig = RefTrainConfig(), perceptual=None,
                         aug_weights=None):
    """The two steps of ``SyncLoss.forward`` (optimizer_idx 0 and 1) on
    ``state``, each one optimizer step:

    * ``model_step(imgs01, scaling_w, disc_factor, detector_only, draws=None,
      generator=None)``: perceptual + hinge-G + detection BCE + corner MSE
      (predictions in [-1, 1], TV order) through the valuemetric bank and the
      corner warp; ``draws`` (a :class:`RefDraws`) feeds them, else they come
      from ``generator`` (weighted by ``aug_weights``). A detector-only step
      gives the UNet no gradient, so AdamW leaves it, its moments and its
      decay alone (JAX's adamw still decays it: fault (e)).
    * ``disc_step(imgs01, scaling_w, disc_factor)``: hinge D.

    Each returns its metrics as detached tensors."""
    from wmar_tpu_torch.finetune.perceptual import PerceptualLoss

    perceptual = perceptual or PerceptualLoss()

    def model_step(imgs01, scaling_w, disc_factor, detector_only, draws=None, generator=None):
        if draws is None:
            draws = sample_ref_draws(imgs01.shape, generator, aug_weights)
        state.disc.requires_grad_(False)
        try:
            total, metrics = ref_model_loss(state, imgs01, draws, scaling_w, disc_factor, bool(detector_only), cfg,
                                            perceptual)
            state.opt.zero_grad(set_to_none=True)
            total.backward()
        finally:
            state.disc.requires_grad_(True)
        state.opt.step()
        if state.sched is not None:
            state.sched.step()
        return {k: v.detach() for k, v in metrics.items()}

    def disc_step(imgs01, scaling_w, disc_factor):
        d, metrics = ref_disc_loss(state, imgs01, scaling_w, disc_factor)
        state.opt_d.zero_grad(set_to_none=True)
        d.backward()
        state.opt_d.step()
        if state.sched_d is not None:
            state.sched_d.step()
        return {k: v.detach() for k, v in metrics.items()}

    return model_step, disc_step


# ---------------------------------------------------------------------------
# Evaluation (evals/eval_sync.py: corner error, PSNR / SSIM / LPIPS, baselines)
# ---------------------------------------------------------------------------


def ssim(a01: torch.Tensor, b01: torch.Tensor, window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Single-scale SSIM of NHWC [0, 1] images (a Gaussian window, VALID),
    one value per image."""
    half = window // 2
    x = torch.arange(window, dtype=torch.float32, device=a01.device) - half
    g = torch.exp(-(x**2) / (2 * sigma**2))
    k2d = g[:, None] * g[None, :] / (g.sum() ** 2)
    c = a01.shape[-1]

    def filt(v):
        return F.conv2d(v.permute(0, 3, 1, 2), k2d.expand(c, 1, window, window), groups=c)

    mu_a, mu_b = filt(a01), filt(b01)
    saa = filt(a01 * a01) - mu_a**2
    sbb = filt(b01 * b01) - mu_b**2
    sab = filt(a01 * b01) - mu_a * mu_b
    c1, c2 = 0.01**2, 0.03**2
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / ((mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2))
    return s.mean(dim=(1, 2, 3))


def sift_ransac_corners(orig01: np.ndarray, attacked01: np.ndarray):
    """The SIFT+RANSAC baseline (``syncseal/models/sync_model.py:273-360``):
    the homography original -> attacked from OpenCV's SIFT matches (ratio
    0.75, RANSAC 5 px), and where the original frame's corners land
    (normalized [0, 1], TV order); None without enough matches. On the host;
    OpenCV is imported here."""
    import cv2

    def to_u8(x):
        return np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)

    g1 = cv2.cvtColor(to_u8(orig01), cv2.COLOR_RGB2GRAY)
    g2 = cv2.cvtColor(to_u8(attacked01), cv2.COLOR_RGB2GRAY)
    sift = cv2.SIFT_create()
    kp1, des1 = sift.detectAndCompute(g1, None)
    kp2, des2 = sift.detectAndCompute(g2, None)
    if des1 is None or des2 is None or len(kp1) < 4 or len(kp2) < 4:
        return None
    matches = cv2.BFMatcher().knnMatch(des1, des2, k=2)
    good = [m for m, n in matches if m.distance < 0.75 * n.distance]
    if len(good) < 4:
        return None
    src = np.float32([kp1[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
    dst = np.float32([kp2[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
    hm, _ = cv2.findHomography(src, dst, cv2.RANSAC, 5.0)
    if hm is None:
        return None
    h, w = g1.shape
    corners_px = np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]).reshape(-1, 1, 2)
    return cv2.perspectiveTransform(corners_px, hm).reshape(4, 2) / np.float32([w - 1, h - 1])


EVAL_STRENGTHS = (0.05, 0.15, 0.25)


@torch.no_grad()
def evaluate_sync_ref(model: SyncSealRef, imgs01: torch.Tensor, generator: Optional[torch.Generator] = None,
                      perceptual=None, with_sift_baseline: bool = True, corners=None,
                      noise: Optional[torch.Tensor] = None) -> dict:
    """The reference's ``evals/eval_sync.py`` grid: embed, attack with each
    of three geometric strengths x four valuemetrics (none, JPEG 60, blur 5,
    noise 0.05), detect; the mean corner error (in [-1, 1] units) a cell,
    the SIFT+RANSAC baseline's where asked, the embedding's PSNR and SSIM
    (and the perceptual distance where one is given). ``corners`` (one
    ``[B, 4, 2]`` a strength) and ``noise`` (``[B, H, W, C]``) feed the draws."""
    imgs_w = model.embed01(imgs01)
    mse = float(((imgs_w - imgs01) ** 2).mean())
    quality = {"psnr": float(10 * np.log10(1.0 / max(mse, 1e-12))), "ssim": float(ssim(imgs_w, imgs01).mean())}
    if perceptual is not None:
        quality["lpips"] = float(perceptual(imgs01 * 2 - 1, imgs_w * 2 - 1).mean())
    b = imgs01.shape[0]
    if noise is None:
        noise = torch.randn(imgs01.shape, generator=generator)
    noise = noise.to(imgs01.device)
    valuemetrics = [("none", lambda x: x), ("jpeg60", lambda x: V.jpeg_diff(x, 60)),
                    ("blur5", lambda x: V.gaussian_blur(x, 5)),
                    ("noise05", lambda x: V.gaussian_noise(x, 0.05, noise=noise))]
    rows = []
    for gi, strength in enumerate(EVAL_STRENGTHS):
        c = corners[gi] if corners is not None else sample_geometric_corners(b, generator, strength)
        c = torch.as_tensor(c, device=imgs01.device)
        target = c.reshape(b, 8) * 2.0 - 1.0
        for vname, vfn in valuemetrics:
            attacked = apply_tv_corner_warp(V.clip01(vfn(imgs_w)), c)
            preds = model.detect01(attacked)
            row = {"strength": strength, "valuemetric": vname,
                   "corner_mae": float((preds[:, 1:] - target).abs().mean())}
            if with_sift_baseline:
                errs = []
                w_host, a_host, t_host = imgs_w.cpu().numpy(), attacked.cpu().numpy(), target.cpu().numpy()
                for i in range(b):
                    est = sift_ransac_corners(w_host[i], a_host[i])
                    if est is not None:
                        errs.append(np.abs(est * 2 - 1 - t_host[i].reshape(4, 2)).mean())
                row["sift_corner_mae"] = float(np.mean(errs)) if errs else None
            rows.append(row)
    return {"quality": quality, "grid": rows}


def wam_corner_baseline(wam_sync, imgs: torch.Tensor, image_size: int = 256) -> np.ndarray:
    """The WAM corner baseline (``syncseal/models/sync_model.py:363-448``,
    ``WAMSyncModel.detect``): ``WamSync``'s (rotation, cut_i, cut_j, flip)
    estimate of each [-1, 1] NHWC image as the 8 corner coordinates in
    [-1, 1], TV order, ``[B, 8]``."""
    b, H, W, _ = imgs.shape
    s = image_size
    out = np.zeros((b, 8), np.float32)
    img01 = (imgs + 1.0) / 2.0
    for i in range(b):
        (angle, cuti, cutj, flipped), _ = wam_sync.estimate(img01[i])
        cuti = min(max(int(cuti), 0), s - 1)
        cutj = min(max(int(cutj), 0), s - 1)
        crop_applied = (cuti != (s - 1) // 2 or cutj != (s - 1) // 2) and not flipped
        corners = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]], np.float32)
        cuti = int((H - 1) * cuti / (s - 1))
        cutj = int((W - 1) * cutj / (s - 1))
        if crop_applied:
            pad_i = 2 * cuti - (H - 1)
            pad_j = 2 * cutj - (W - 1)
            corners = np.array([[0, 0], [(W - 1) - pad_j, 0], [(W - 1) - pad_j, (H - 1) - pad_i],
                                [0, (H - 1) - pad_i]], np.float32)
        if abs(angle) > 1e-2:
            center = np.array([W / 2, H / 2])
            theta = -np.deg2rad(angle)
            rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
            corners = (corners - center) @ rot.T + center
        if flipped:
            corners[:, 0] = W - 1 - corners[:, 0]
        out[i] = ((corners - np.array([W / 2, H / 2])) / np.array([W / 2, H / 2])).reshape(8)
    return out
