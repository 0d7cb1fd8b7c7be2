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

The source holds two kernels, routed by what they are given: a bf16 ``x``
(with ``N`` a multiple of 8) goes to the tensor cores (``mma.sync`` on the
unpacked nibbles, bound by the weight bytes), where :func:`w4_splits` cuts
``K`` over enough blocks (one thread-block cluster per column tile) to fill
the card and the cluster adds the splits in split order; an f32 ``x`` (or
an ``N`` no multiple of 8) goes to the CUDA cores, whose float32 products
hold f32's tolerance. :func:`matmul_w4_split_plain` is the tensor-core
kernel's order of summation in plain torch.
"""

from __future__ import annotations

import torch

from wmar_tpu_torch.ops.flash_decode import _sm_count

GROUPS = (128, 64, 32)  # the group sizes the quantizer makes, largest first, and the kernel takes
_MAX_GRID_Y = 65535
_FMA_ROWS = 8  # csrc/w4_matmul.cu: kFmaRows, rows of x a block of the CUDA-core kernel takes
_TILE_N = 128  # kTileN: columns a block of the tensor-core kernel takes
_CHUNK_K = 128  # kChunkK: the unit of the split of K (64 byte rows of q)
_MAX_SPLITS = 8  # kMaxSplits: the splits of a column tile are one thread-block cluster


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


def _tile_rows(m: int) -> int:
    """Rows of x a block of the tensor-core kernel takes: one m16 tile up to
    16 rows, two above."""
    return 16 if m <= 16 else 32


def w4_splits(m: int, n: int, k: int, group: int, sm_count: int) -> int:
    """How many blocks share the K axis of one output tile in the
    tensor-core kernel: a function of the shapes and the card's SM count
    only, so that a CUDA graph may replay the launch. One where the output
    tiles alone nearly cover the SMs (9 in 10); else the largest power of
    two that keeps the grid within three blocks an SM, at most one per chunk
    of 128 k (the chunks are dealt evenly, so no split is empty) and at most
    8 (a cluster). On 132 SMs: 8 at Taming's 32 x 1664 x 1664 (13 column
    tiles) and 32 x 6656 x 1664, 4 at 32 x 1664 x 6656 (52 tiles) and at
    Chameleon's 24 x 4096 x 11008 (86), 1 at the 32 x 1664 x 16384 head (128
    tiles): the best of the forced counts 1-8 at each of these shapes
    (``tools/bench_w4.py --splits``). ``group`` is no argument of the rule
    (a chunk holds whole groups of any size) but names the call it plans."""
    del group
    tiles = -(-n // _TILE_N) * -(-m // _tile_rows(m))
    if 10 * tiles >= 9 * sm_count:
        return 1
    most = min(-(-k // _CHUNK_K), _MAX_SPLITS)
    splits = 1
    while 2 * splits <= most and 2 * splits * tiles <= 3 * sm_count:
        splits *= 2
    return splits


def matmul_w4_split_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, splits: int) -> torch.Tensor:
    """The tensor-core kernel's order of summation in plain torch, float32:
    ``K`` cut into chunks of 128 (whole groups), the chunks dealt to
    ``splits`` runs as the kernel deals them (split ``s`` takes chunks
    ``[s * chunks // splits, (s + 1) * chunks // splits)``); within a split
    each group's float32 partial is scaled and added in group order, and the
    splits are added in split order. Equal to :func:`matmul_w4_plain` up to
    float32 rounding. Returns float32 ``[..., N]``. For tests."""
    qf = unpack_int4(packed).to(torch.float32)  # [gc, G, N]
    gc, group, n = qf.shape
    k = gc * group
    chunks = -(-k // _CHUNK_K)
    if not 1 <= splits <= chunks:
        raise ValueError(f"splits {splits} outside [1, {chunks}]")
    lead = x.shape[:-1]
    xg = x.reshape(-1, gc, group).to(torch.float32)  # [M, gc, G]
    sf = scales.to(torch.float32)
    per_chunk = _CHUNK_K // group
    total = torch.zeros((xg.shape[0], n), dtype=torch.float32)
    for sp in range(splits):
        acc = torch.zeros_like(total)
        for c in range(sp * chunks // splits, (sp + 1) * chunks // splits):
            for g in range(c * per_chunk, min((c + 1) * per_chunk, gc)):
                acc = acc + sf[g] * (xg[:, g] @ qf[g])
        total = total + acc
    return total.reshape(*lead, n)


def _tensor_cores(x: torch.Tensor, n: int) -> bool:
    """The route: the tensor-core kernel for a bf16 x whose N is a multiple
    of 8 (whole 8-byte loads of q and 16-byte ones of the scales), the
    CUDA-core kernel for an f32 x (bf16 operands would not hold f32's
    tolerance) and for any other N."""
    return x.dtype == torch.bfloat16 and n % 8 == 0


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
    rows = _tile_rows(m) if _tensor_cores(x, n) else _FMA_ROWS
    if -(-m // rows) > _MAX_GRID_Y:
        raise ValueError(f"M = {m} rows exceed the kernel's grid")
    if _tensor_cores(x, n):
        for name, t, align in (("x", x, 16), ("scales", scales, 16), ("packed", packed, 16 if n % 16 == 0 else 8)):
            if t.data_ptr() % align:
                raise ValueError(f"{name} must be {align}-byte aligned: the kernel copies it in {align}-byte pieces")
    return m, n, k, group


def _launch(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, splits=None) -> torch.Tensor:
    """Launch ``csrc/w4_matmul.cu`` on its route (see :func:`_tensor_cores`);
    on the tensor cores with ``splits`` blocks along K (None lets
    :func:`w4_splits` choose; at most 8 and the chunks of 128 k). The
    CUDA-core kernel takes ``splits`` 1 or None only."""
    m, n, k, group = _check(x, packed, scales)
    tensor_cores = _tensor_cores(x, n)
    most = min(-(-k // _CHUNK_K), _MAX_SPLITS) if tensor_cores else 1
    if splits is None:
        splits = w4_splits(m, n, k, group, _sm_count(x.device.index)) if tensor_cores else 1
    if not 1 <= splits <= most:
        raise ValueError(f"splits {splits} outside [1, {most}] on this route")
    from wmar_tpu_torch.ops import build

    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    rc = build.load().wmar_w4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), m, n, k, group,
        int(x.dtype == torch.bfloat16), int(tensor_cores), splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"w4 matmul kernel failed to launch: cudaError {rc}")
    return out


def matmul_w4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel #8: ``x[..., K] @ dequant(packed, scales) -> [..., N]`` in x's
    dtype, leading dimensions flattened. ``x`` bf16 or f32 and contiguous;
    ``packed uint8 [K/G, G/2, N]`` and ``scales bf16 [K/G, N]`` with ``G``
    in 128, 64, 32. A CPU ``x`` takes :func:`matmul_w4_plain`."""
    if x.device.type == "cpu":
        return matmul_w4_plain(x, packed, scales)
    out = _launch(x, packed, scales)
    matmul_w4.launches += 1
    return out


matmul_w4.launches = 0
