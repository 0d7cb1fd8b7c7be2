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
``*01`` functions). The training loops are not ported here.
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
    def load(path: str, cfg=None, device=None) -> "SyncSealRef":
        """JAX's ``SyncSealRef.save`` file (msgpack, ``{"unet", "convnext"}``)."""
        from wmar_tpu_torch import bridge
        from wmar_tpu_torch.utils.checkpoint import load_pytree

        tree = load_pytree(path)
        model = SyncSealRef(cfg, device="meta")
        model.load_state_dict(bridge.syncseal_ref_state_dict(tree["unet"], tree["convnext"]), strict=True,
                              assign=True)
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
        return _quantize_st(torch.clamp(imgs_w, 0.0, 1.0))

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
