"""w4a16 matrix product over grouped int4 weights (PyTorch + CUDA).

Kernel #8 of the JAX package, ``wmar_tpu/ops/w4_matmul.py:_w4_kernel``,
has a hand-written sm_90a counterpart, ``csrc/w4_matmul.cu``, launched by
:func:`matmul_w4`. The weights keep the layout of
``wquant.quantize_matrix_int4``: ``packed uint8 [gc, G/2, N]`` in the
group-halves encoding (byte row ``i`` of a group holds rows ``i``, low
nibble, and ``i + G/2``, high nibble, offset by 8) and ``scales bf16 [gc,
N]``, one per (group, output column).

On a CUDA tensor :func:`matmul_w4` launches the kernel or raises; on a CPU
tensor it runs :func:`matmul_w4_plain`, the same math in float32 (the JAX
package's default route, ``wquant.matmul4_xla``). Nothing falls back from
one to the other, and there is no switch: the JAX package keeps its kernel
opt-in for a reason of the TPU's, which does not hold on Hopper, where the
int4 bytes only pay off if the nibbles are unpacked on chip.
``matmul_w4.launches`` counts the kernel's launches.

The kernel is bound by instruction issue on the CUDA cores, not by the
bytes it reads (see the source).
"""

from __future__ import annotations

import torch

GROUPS = (128, 64, 32)  # the group sizes the quantizer makes, largest first, and the kernel takes
_MAX_GRID_Y = 65535
_ROWS_PER_BLOCK = 8  # csrc/w4_matmul.cu: kRows


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """``[gc, G/2, N]`` packed nibbles -> ``[gc, G, N]`` int32 in [-8, 7]:
    low nibbles are rows ``[0, G/2)`` of a group, high nibbles ``[G/2, G)``."""
    b = q4.to(torch.int32)
    return torch.cat([(b & 15) - 8, (b >> 4) - 8], dim=1)


def matmul_w4_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x[..., K] @ dequant(packed, scales) -> [..., N]`` in x's dtype.

    One float32 product per group, each scaled by its group's scales in
    float32, then summed over the groups: ``wquant.matmul4_xla``'s math with
    float32 operands."""
    qf = unpack_int4(packed).to(torch.float32)  # [gc, G, N]
    gc, group, n = qf.shape
    lead = x.shape[:-1]
    xg = x.reshape(-1, gc, group).transpose(0, 1).to(torch.float32)  # [gc, M, G]
    yg = torch.bmm(xg, qf)  # [gc, M, N] float32 partials
    y = (yg * scales.to(torch.float32)[:, None, :]).sum(dim=0)
    return y.to(x.dtype).reshape(*lead, n)


def _check(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> tuple:
    """Device, type, shape and contiguity checks; returns ``(M, N, K, G)``."""
    if not (x.is_cuda and packed.is_cuda and scales.is_cuda) or not (x.device == packed.device == scales.device):
        raise ValueError("x, packed and scales must lie on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"packed must be uint8 and scales bf16, got {packed.dtype}, {scales.dtype}")
    if packed.dim() != 3 or scales.dim() != 2:
        raise ValueError(f"packed must be [gc, G/2, N] and scales [gc, N], got {tuple(packed.shape)}, "
                         f"{tuple(scales.shape)}")
    gc, half, n = packed.shape
    group = 2 * half
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    if tuple(scales.shape) != (gc, n):
        raise ValueError(f"scales {tuple(scales.shape)} do not match packed {tuple(packed.shape)}")
    k = gc * group
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not end in K = {k}")
    if not (x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("x, packed and scales must be contiguous")
    m = x.numel() // k
    if m < 1 or n < 1:
        raise ValueError(f"empty product: M = {m}, N = {n}")
    if (m + _ROWS_PER_BLOCK - 1) // _ROWS_PER_BLOCK > _MAX_GRID_Y:
        raise ValueError(f"M = {m} rows exceed the kernel's grid")
    return m, n, k, group


def matmul_w4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel #8: ``x[..., K] @ dequant(packed, scales) -> [..., N]`` in x's
    dtype, leading dimensions flattened. ``x`` bf16 or f32 and contiguous;
    ``packed uint8 [K/G, G/2, N]`` and ``scales bf16 [K/G, N]`` with ``G``
    in 128, 64, 32. A CPU ``x`` takes :func:`matmul_w4_plain`."""
    if x.device.type == "cpu":
        return matmul_w4_plain(x, packed, scales)
    m, n, k, group = _check(x, packed, scales)
    from wmar_tpu_torch.ops import build

    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    rc = build.load().wmar_w4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), m, n, k, group,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"w4 matmul kernel failed to launch: cudaError {rc}")
    matmul_w4.launches += 1
    return out


matmul_w4.launches = 0
