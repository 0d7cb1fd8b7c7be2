"""DiffPure adversarial purification: the ADM UNet and the DDPM noise and
denoise chain (PyTorch port of ``wmar_tpu.augmentations.diffpure``).

The reference wraps ``deps/saberi_wmr`` (``wmar/augmentations/diffpure.py``
and ``utils.py:563-645``): it noises the image to step ``t* = steps * T``
with the DDPM schedule, then runs the reverse chain back to 0 with OpenAI's
256x256 unconditional ImageNet model (the ADM UNet: scale-shift GroupNorm
ResBlocks, attention at 32/16/8, resblock up/down, a learned-range variance
output). The UNet is plain PyTorch (cuDNN convolutions, ``torch.matmul``
for the attention's products), NCHW inside; its parameter names follow the
JAX package's Flax tree, so :func:`wmar_tpu_torch.bridge.load_adm_unet`
copies that tree in. The chain keeps the JAX package's math: ``eps`` is
the first three output channels (the learned variance is dropped), the
mean is ``(x - coef * eps) / sqrt(alpha_t)`` and ``sigma = sqrt(beta_t)``,
no noise at t = 0, no clip of the predicted x0 (ROADMAP queue 3).

Weights: ``256x256_diffusion_uncond.pt`` (guided-diffusion's layout,
through :func:`convert_adm_unet`) or a converted ``.msgpack``, both through
:func:`load_adm_weights`. None is in the repository, and a random purifier
is not DiffPure, so ``generate`` refuses ``--include_diffpure`` without a
file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    image_size: int = 256
    in_channels: int = 3
    model_channels: int = 256
    out_channels: int = 6  # learn_sigma
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (32, 16, 8)
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4)
    num_head_channels: int = 64
    resblock_updown: bool = True
    use_scale_shift_norm: bool = True
    diffusion_steps: int = 1000


GUIDED_DIFFUSION_256_UNCOND = ADMConfig()


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-5)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _SameConv(nn.Conv2d):
    """A strided 3x3 convolution with Flax's "SAME" padding (the extra row
    and column go after), for ``resblock_updown=False``."""

    def forward(self, x):
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, stride=2)


def _resample(z: torch.Tensor, up: bool, down: bool) -> torch.Tensor:
    if up:
        return F.interpolate(z, scale_factor=2.0, mode="nearest")
    if down:
        return F.avg_pool2d(z, 2)
    return z


class ADMResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.GroupNorm_0 = _norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.emb = nn.Linear(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch)
        self.GroupNorm_1 = _norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.skip = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, emb):
        h = _resample(F.silu(self.GroupNorm_0(x)), self.up, self.down)
        x = _resample(x, self.up, self.down)
        h = self.conv1(h)
        emb_out = self.emb(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.GroupNorm_1(h) * (1 + scale) + shift)
        else:
            h = F.silu(self.GroupNorm_1(h + emb_out))
        h = self.conv2(h)
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class ADMAttention(nn.Module):
    """Self-attention over the positions, heads of ``num_head_channels``;
    ``qkv``'s output is ``[q, k, v][head][head_dim]``, the layout of
    :func:`convert_adm_unet` (which permutes guided-diffusion's legacy
    ``[head][q, k, v][head_dim]``)."""

    def __init__(self, ch: int, num_head_channels: int):
        super().__init__()
        self.heads = max(1, ch // num_head_channels)
        self.GroupNorm_0 = _norm(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        hd = c // self.heads
        hn = self.GroupNorm_0(x).reshape(b, c, hh * ww).transpose(1, 2)
        qkv = self.qkv(hn).reshape(b, hh * ww, 3, self.heads, hd).permute(2, 0, 3, 1, 4)  # [3, b, h, n, d]
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5, dim=-1)
        out = torch.matmul(a, v).transpose(1, 2).reshape(b, hh * ww, c)
        return x + self.proj(out).transpose(1, 2).reshape(b, c, hh, ww)


class ADMUNet(nn.Module):
    """The ADM UNet, ``(x [B, 3, H, W] in [-1, 1], t [B]) -> [B, 6, H, W]``
    (eps, then the learned variance). Blocks carry the JAX package's names
    (``down_{level}_{block}``, ``down_attn_*``, ``down_{level}_ds``,
    ``mid_1``, ``mid_attn``, ``mid_2``, ``up_{level}_{block}``,
    ``up_attn_*``, ``up_{level}_us``) and run in its order."""

    def __init__(self, cfg: ADMConfig = GUIDED_DIFFUSION_256_UNCOND):
        super().__init__()
        self.cfg = cfg
        mc, emb_ch = cfg.model_channels, 4 * cfg.model_channels
        self.time1 = nn.Linear(mc, emb_ch)
        self.time2 = nn.Linear(emb_ch, emb_ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, mc, 3, padding=1)
        self.order = []  # (name, kind): the forward's sequence of blocks
        ssn, ds, cur, skips = cfg.use_scale_shift_norm, 1, mc, [mc]

        def add(name, kind, module=None):
            if module is not None:
                self.add_module(name, module)
            self.order.append((name, kind))

        for li, mult in enumerate(cfg.channel_mult):
            ch = mc * mult
            for bi in range(cfg.num_res_blocks):
                add(f"down_{li}_{bi}", "res", ADMResBlock(cur, ch, emb_ch, ssn))
                cur = ch
                if cfg.image_size // ds in cfg.attention_resolutions:
                    add(f"down_attn_{li}_{bi}", "attn", ADMAttention(ch, cfg.num_head_channels))
                add(f"skip_{li}_{bi}", "push")
                skips.append(ch)
            if li != len(cfg.channel_mult) - 1:
                if cfg.resblock_updown:
                    add(f"down_{li}_ds", "res", ADMResBlock(ch, ch, emb_ch, ssn, down=True))
                else:
                    add(f"down_{li}_ds", "conv", _SameConv(ch, ch, 3))
                ds *= 2
                add(f"skip_{li}_ds", "push")
                skips.append(ch)
        ch = mc * cfg.channel_mult[-1]
        add("mid_1", "res", ADMResBlock(cur, ch, emb_ch, ssn))
        add("mid_attn", "attn", ADMAttention(ch, cfg.num_head_channels))
        add("mid_2", "res", ADMResBlock(ch, ch, emb_ch, ssn))
        cur = ch
        for li, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = mc * mult
            for bi in range(cfg.num_res_blocks + 1):
                add(f"up_{li}_{bi}", "pop_res", ADMResBlock(cur + skips.pop(), ch, emb_ch, ssn))
                cur = ch
                if cfg.image_size // ds in cfg.attention_resolutions:
                    add(f"up_attn_{li}_{bi}", "attn", ADMAttention(ch, cfg.num_head_channels))
            if li != 0:
                if cfg.resblock_updown:
                    add(f"up_{li}_us", "res", ADMResBlock(ch, ch, emb_ch, ssn, up=True))
                else:
                    add(f"up_{li}_us", "up_conv", nn.Conv2d(ch, ch, 3, padding=1))
                ds //= 2
        self.GroupNorm_0 = _norm(cur)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, x, t):
        emb = timestep_embedding(t, self.cfg.model_channels)
        emb = self.time2(F.silu(self.time1(emb)))
        h = self.conv_in(x)
        skips = [h]
        for name, kind in self.order:
            if kind == "push":
                skips.append(h)
                continue
            block = getattr(self, name)
            if kind == "pop_res":
                h = block(torch.cat([h, skips.pop()], dim=1), emb)
            elif kind == "res":
                h = block(h, emb)
            elif kind == "up_conv":
                h = block(F.interpolate(h, scale_factor=2.0, mode="nearest"))
            else:
                h = block(h)
        return self.conv_out(F.silu(self.GroupNorm_0(h)))


# ---------------------------------------------------------------------------
# DDPM schedule + purification
# ---------------------------------------------------------------------------


def linear_betas(n: int) -> np.ndarray:
    scale = 1000.0 / n
    return np.linspace(scale * 1e-4, scale * 0.02, n, dtype=np.float64)


class DiffPure:
    """``steps`` in (0, 1]: noise to ``t* = max(1, int(steps * T))``, then
    denoise back with ``unet``. Images NHWC in [0, 1] on the UNet's device
    (the reference converts to [-1, 1] around the purifier,
    ``diffpure.py:15-39``). ``unet_calls`` counts the UNet's forwards.

    The schedule is JAX's: the float64 numpy betas cast to float32, and every
    coefficient computed in float32 from them. On a CUDA device each UNet
    forward replays a CUDA graph captured at the first call of a shape: the
    chain makes up to 300 forwards of one shape a cell, and an eager forward
    makes ~1,400 launches, which leaves the card waiting on the host at small
    batches (the JAX package compiles the chain into one program)."""

    def __init__(self, unet: ADMUNet, steps: float = 0.1):
        self.unet = unet.eval()
        self.cfg = unet.cfg
        betas = linear_betas(self.cfg.diffusion_steps)
        alphas = 1.0 - betas
        self.alphas_cumprod = torch.from_numpy(np.cumprod(alphas).astype(np.float32))
        self.betas = torch.from_numpy(betas.astype(np.float32))
        self.alphas = torch.from_numpy(alphas.astype(np.float32))
        self.default_steps = steps
        self.unet_calls = 0
        self._graphs = {}

    @torch.inference_mode()
    def __call__(self, imgs01: torch.Tensor, steps_override: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, noise=None) -> torch.Tensor:
        """Purify ``imgs01 [B, H, W, 3]``. The noise comes from ``generator``
        (the attack cell's; seed 0 without one): first the forward noise,
        then one draw a step but the last (t = 0 adds none). ``noise`` feeds
        those draws instead, ``[t*, B, H, W, 3]`` or longer (a test passes
        the JAX package's: ``normal(k_noise)``, then ``normal(fold_in(k_loop,
        i))`` for step ``i``)."""
        steps = steps_override if steps_override is not None else self.default_steps
        t_star = max(1, int(steps * self.cfg.diffusion_steps))
        x = imgs01.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        if noise is None and generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)

        def draw(i):
            if noise is not None:
                z = torch.as_tensor(noise[i], dtype=torch.float32, device=x.device)
            else:
                z = torch.randn(imgs01.shape, generator=generator, device=x.device)
            return z.permute(0, 3, 1, 2)

        f32 = lambda v: float(v.to(torch.float32))  # noqa: E731  (a float32 value, exact as a float)
        a_bar = self.alphas_cumprod[t_star - 1]
        x = f32(torch.sqrt(a_bar)) * x + f32(torch.sqrt(1 - a_bar)) * draw(0)
        tb = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
        for i in range(t_star):
            t = t_star - 1 - i
            eps = self._eps(x, tb.fill_(t))
            self.unet_calls += 1
            a_t, ab_t = self.alphas[t], self.alphas_cumprod[t]
            mean = (x - f32((1 - a_t) / torch.sqrt(1 - ab_t)) * eps) / f32(torch.sqrt(a_t))
            x = mean + f32(torch.sqrt(self.betas[t])) * draw(1 + i) if t > 0 else mean
        return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    def _eps(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The UNet's eps for ``(x, t)``; on a CUDA device from the graph of
        ``x``'s shape (its output buffer: read it before the next call)."""
        if x.device.type != "cuda":
            return self.unet(x, t)[:, : self.cfg.in_channels]
        key = (tuple(x.shape), x.device)
        if key not in self._graphs:
            sx, st = x.clone(), t.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                for _ in range(2):  # cuDNN and cuBLAS choose and set up their kernels outside the capture
                    self.unet(sx, st)
            torch.cuda.current_stream(x.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.unet(sx, st)[:, : self.cfg.in_channels]
            self._graphs[key] = (graph, sx, st, out)
        graph, sx, st, out = self._graphs[key]
        sx.copy_(x)
        st.copy_(t)
        graph.replay()
        return out


# ---------------------------------------------------------------------------
# Checkpoints: guided-diffusion's ``256x256_diffusion_uncond.pt`` layout
# ---------------------------------------------------------------------------


def _adm_lin(sd, p):
    return {"kernel": np.ascontiguousarray(sd[p + ".weight"].T), "bias": np.asarray(sd[p + ".bias"])}


def _adm_conv(sd, p):
    return {
        "kernel": np.ascontiguousarray(np.transpose(sd[p + ".weight"], (2, 3, 1, 0))),
        "bias": np.asarray(sd[p + ".bias"]),
    }


def _adm_gn(sd, p):
    return {"scale": np.asarray(sd[p + ".weight"]), "bias": np.asarray(sd[p + ".bias"])}


def _adm_resblock(sd, p):
    """guided-diffusion ResBlock: in_layers.[0 norm, 2 conv], emb_layers.1,
    out_layers.[0 norm, 3 conv], optional skip_connection (unet.py ResBlock)."""
    out = {
        "GroupNorm_0": _adm_gn(sd, p + ".in_layers.0"),
        "conv1": _adm_conv(sd, p + ".in_layers.2"),
        "emb": _adm_lin(sd, p + ".emb_layers.1"),
        "GroupNorm_1": _adm_gn(sd, p + ".out_layers.0"),
        "conv2": _adm_conv(sd, p + ".out_layers.3"),
    }
    if p + ".skip_connection.weight" in sd:
        out["skip"] = _adm_conv(sd, p + ".skip_connection")
    return out


def _adm_attention(sd, p, num_head_channels):
    """AttentionBlock with QKVAttentionLegacy head layout.

    Legacy qkv channels are [head-major][q,k,v][head_dim]; the Dense here
    expects [q,k,v][head-major][head_dim], so the rows are permuted. The 1x1
    conv1d weights [3C, C, 1] become Dense kernels [C, 3C].
    """
    w = np.asarray(sd[p + ".qkv.weight"])[:, :, 0]  # [3C, C]
    b = np.asarray(sd[p + ".qkv.bias"])
    c = w.shape[1]
    heads = max(1, c // num_head_channels)
    hd = c // heads
    w = w.reshape(heads, 3, hd, c).transpose(1, 0, 2, 3).reshape(3 * c, c)
    b = b.reshape(heads, 3, hd).transpose(1, 0, 2).reshape(3 * c)
    proj = np.asarray(sd[p + ".proj_out.weight"])[:, :, 0]
    return {
        "GroupNorm_0": _adm_gn(sd, p + ".norm"),
        "qkv": {"kernel": np.ascontiguousarray(w.T), "bias": b},
        "proj": {"kernel": np.ascontiguousarray(proj.T), "bias": np.asarray(sd[p + ".proj_out.bias"])},
    }


def _gd_blocks(cfg: ADMConfig):
    """(Flax name, guided-diffusion prefix, kind) of every block, in the
    numbering of guided_diffusion/unet.py's UNetModel."""
    out = [("time1", "time_embed.0", "lin"), ("time2", "time_embed.2", "lin"), ("conv_in", "input_blocks.0.0", "conv"),
           ("GroupNorm_0", "out.0", "gn"), ("conv_out", "out.2", "conv"), ("mid_1", "middle_block.0", "res"),
           ("mid_attn", "middle_block.1", "attn"), ("mid_2", "middle_block.2", "res")]
    nlev, ds, n = len(cfg.channel_mult), 1, 1
    for li in range(nlev):
        for bi in range(cfg.num_res_blocks):
            out.append((f"down_{li}_{bi}", f"input_blocks.{n}.0", "res"))
            if cfg.image_size // ds in cfg.attention_resolutions:
                out.append((f"down_attn_{li}_{bi}", f"input_blocks.{n}.1", "attn"))
            n += 1
        if li != nlev - 1:
            out.append((f"down_{li}_ds", f"input_blocks.{n}.0", "res"))
            n += 1
            ds *= 2
    n = 0
    for li in reversed(range(nlev)):
        for bi in range(cfg.num_res_blocks + 1):
            out.append((f"up_{li}_{bi}", f"output_blocks.{n}.0", "res"))
            j = 1
            if cfg.image_size // ds in cfg.attention_resolutions:
                out.append((f"up_attn_{li}_{bi}", f"output_blocks.{n}.1", "attn"))
                j = 2
            if li != 0 and bi == cfg.num_res_blocks:
                out.append((f"up_{li}_us", f"output_blocks.{n}.{j}", "res"))
                ds //= 2
            n += 1
    return out


def convert_adm_unet(sd, cfg: ADMConfig) -> dict:
    """``256x256_diffusion_uncond.pt`` layout -> the ADMUNet's Flax tree
    (``{"params": ...}``), as the JAX package converts it.

    Mirrors guided_diffusion/unet.py UNetModel construction: input_blocks.0
    is conv_in; each level appends num_res_blocks TimestepEmbedSequentials
    (ResBlock [+ Attention]) and, except the last level, a downsample block;
    output_blocks hold ResBlock [+ Attention] [+ upsample ResBlock as the
    trailing submodule of the level's last block].
    """
    conv = {"lin": _adm_lin, "conv": _adm_conv, "gn": _adm_gn, "res": _adm_resblock,
            "attn": lambda sd, p: _adm_attention(sd, p, cfg.num_head_channels)}
    return {"params": {name: conv[kind](sd, prefix) for name, prefix, kind in _gd_blocks(cfg)}}


def to_guided_diffusion(variables: dict, cfg: ADMConfig) -> dict:
    """The inverse of :func:`convert_adm_unet`: an ADMUNet Flax tree (numpy
    leaves) as a state dict in guided-diffusion's layout, the attention's
    ``qkv`` rows back in the legacy head-major order. Writes checkpoints of
    the released file's layout from random trees."""
    params = variables.get("params", variables)
    sd = {}

    def lin(p, leaf):
        sd[p + ".weight"], sd[p + ".bias"] = np.ascontiguousarray(leaf["kernel"].T), leaf["bias"]

    def conv(p, leaf):
        sd[p + ".weight"] = np.ascontiguousarray(np.transpose(leaf["kernel"], (3, 2, 0, 1)))
        sd[p + ".bias"] = leaf["bias"]

    def gn(p, leaf):
        sd[p + ".weight"], sd[p + ".bias"] = leaf["scale"], leaf["bias"]

    def res(p, leaf):
        gn(p + ".in_layers.0", leaf["GroupNorm_0"])
        conv(p + ".in_layers.2", leaf["conv1"])
        lin(p + ".emb_layers.1", leaf["emb"])
        gn(p + ".out_layers.0", leaf["GroupNorm_1"])
        conv(p + ".out_layers.3", leaf["conv2"])
        if "skip" in leaf:
            conv(p + ".skip_connection", leaf["skip"])

    def attn(p, leaf):
        c = leaf["qkv"]["kernel"].shape[0]
        heads = max(1, c // cfg.num_head_channels)
        hd = c // heads
        w = leaf["qkv"]["kernel"].T.reshape(3, heads, hd, c).transpose(1, 0, 2, 3).reshape(3 * c, c, 1)
        gn(p + ".norm", leaf["GroupNorm_0"])
        sd[p + ".qkv.weight"] = np.ascontiguousarray(w)
        sd[p + ".qkv.bias"] = np.ascontiguousarray(leaf["qkv"]["bias"].reshape(3, heads, hd).transpose(1, 0, 2)
                                                   .reshape(3 * c))
        sd[p + ".proj_out.weight"] = np.ascontiguousarray(leaf["proj"]["kernel"].T[:, :, None])
        sd[p + ".proj_out.bias"] = leaf["proj"]["bias"]

    write = {"lin": lin, "conv": conv, "gn": gn, "res": res, "attn": attn}
    for name, prefix, kind in _gd_blocks(cfg):
        write[kind](prefix, params[name])
    return sd


def flax_template(cfg: ADMConfig) -> dict:
    """The ADMUNet's Flax tree with meta tensors for leaves: shapes and
    dtypes only, what a ``.msgpack`` is checked against (nothing drawn)."""
    from wmar_tpu_torch import bridge

    with torch.device("meta"):
        return {"params": bridge.adm_unet_tree(ADMUNet(cfg))}


def load_adm_weights(path: str, cfg: ADMConfig = GUIDED_DIFFUSION_256_UNCOND, device="cpu") -> ADMUNet:
    """The ADMUNet of ``cfg`` on ``device`` with the weights of ``path``:
    ``.pt`` / ``.pth`` in guided-diffusion's layout (``torch.load(...,
    weights_only=True)``, then :func:`convert_adm_unet`) or a converted
    ``.msgpack`` (the port's reader, its shapes checked against
    :func:`flax_template`)."""
    from wmar_tpu_torch import bridge

    if path.endswith((".pt", ".pth")):
        from wmar_tpu_torch.augmentations.neural import read_state_dict

        variables = convert_adm_unet(read_state_dict(path), cfg)
    else:
        from wmar_tpu_torch.utils.checkpoint import load_pytree

        variables = load_pytree(path, flax_template(cfg))
    return bridge.load_adm_unet(variables, cfg, device)
