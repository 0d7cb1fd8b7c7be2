"""upfirdn2d and the fused bias + activation (PyTorch port of
``wmar_tpu.ops.upfirdn``).

The reference vendors two CUDA extensions
(``deps/saberi_wmr/DiffPure/score_sde/op/{upfirdn2d,fused_bias_act}``) for
the StyleGAN2-style layers of its score-SDE DiffPure variant. Here
upsample (zero insertion), FIR filter and downsample are one grouped
convolution over the zero-inserted input, and bias + activation + gain is
one expression. Nothing on the port's paths calls them yet: the ADM UNet
that DiffPure runs has no FIR layer.

Layout: NCHW, the reference op's own; kernel ``[kh, kw]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Upsample by ``up`` (zero insertion: ``n * up`` samples), FIR filter
    with ``kernel`` per channel, downsample by ``down``. ``x [B, C, H, W]``;
    ``pad = (pad0, pad1)`` pads (a negative value crops) both spatial dims
    before filtering, as the reference's ``upfirdn2d`` op does."""
    b, c, h, w = x.shape
    k = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    kh, kw = k.shape
    pad0, pad1 = pad
    y = x.float()
    if up > 1:
        z = y.new_zeros((b, c, h * up, w * up))
        z[:, :, ::up, ::up] = y
        y = z
    y = F.pad(y, (pad0, pad1, pad0, pad1))
    weight = k.flip(0, 1).expand(c, 1, kh, kw)  # correlation with the flipped kernel is convolution
    return F.conv2d(y, weight, stride=down, groups=c).to(x.dtype)


def fused_bias_act(x: torch.Tensor, bias=None, act: str = "lrelu", alpha: float = 0.2,
                   gain: float = 2**0.5) -> torch.Tensor:
    """bias + activation + gain; ``bias [C]`` is added along dim 1 (NCHW)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    if act == "lrelu":
        x = torch.where(x >= 0, x, alpha * x)
    elif act == "relu":
        x = torch.clamp(x, min=0)
    elif act != "linear":
        raise ValueError(act)
    return x * gain if gain != 1.0 else x
