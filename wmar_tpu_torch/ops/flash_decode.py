"""Decode attention over the packed int4 KV cache (PyTorch + CUDA).

:func:`packed4_decode_attention` replaces the TPU kernel
``wmar_tpu/ops/flash_decode.py:_packed4_attn_kernel`` (the single-block
path of the JAX wrapper of the same name). On a CUDA tensor it launches the
hand-written sm_90a kernel in ``wmar_tpu_torch/csrc/packed4_decode_attention.cu``
or raises; on a CPU tensor it runs :func:`packed4_decode_attention_plain`,
the same math in plain torch. Nothing falls back from one to the other.

The kernel is bound by the bytes it reads: B*T*H*D cache bytes plus
4*B*H*T bytes of scales per call, about 43 MB per layer at RAR-XL with 128
rows. The source explains how its design keeps that stream coalesced.

Not ported yet (ROADMAP queue 2): the chunked online-softmax kernel that
the JAX wrapper takes at ``T >= 1024`` and for ``start``/``key_mask``.
"""

from __future__ import annotations

import torch

_MAX_D = 256
_SMEM_BYTES = 48 * 1024  # scores [T] + q [D] + 4 partials, as float32, without opt-in
_CHUNKED = (
    "the chunked packed4 kernel (T >= 1024, start, key_mask) is not ported yet: "
    "ROADMAP queue 2, kernel 4"
)


def packed4_decode_attention_plain(q, kv_all, scale_all, layer: int, valid_len) -> torch.Tensor:
    """Plain torch version of the kernel, computed in float32.

    ``q [B, H, 1, D]``; ``kv_all uint8 [L, B, T, H*D]`` (K low, V high
    nibbles, offset 8); ``scale_all bf16 [L, B, 2H, T]``. Slots ``t <
    valid_len`` take part; the output is ``[B, H, 1, D]`` in q's dtype.
    """
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    u = kv_all[layer].to(torch.int32).reshape(b, t, h, d).transpose(1, 2)  # [B, H, T, D]
    k = ((u & 0xF) - 8).to(torch.float32)
    v = ((u >> 4) - 8).to(torch.float32)
    sc = scale_all[layer].to(torch.float32)
    k_scale, v_scale = sc[:, :h], sc[:, h:]  # [B, H, T]
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].to(torch.float32), k) * k_scale * d**-0.5
    valid = torch.arange(t, device=q.device) < torch.as_tensor(valid_len, device=q.device).reshape(-1)
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1) * v_scale
    o = torch.einsum("bht,bhtd->bhd", p, v)
    return o[:, :, None].to(q.dtype)


def _check(q, kv_all, scale_all, layer: int):
    if not (q.is_cuda and kv_all.is_cuda and scale_all.is_cuda) or not (
        q.device == kv_all.device == scale_all.device
    ):
        raise ValueError("q, kv_all and scale_all must lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if kv_all.dtype != torch.uint8 or scale_all.dtype != torch.bfloat16:
        raise TypeError(f"kv must be uint8 and scale bf16, got {kv_all.dtype}, {scale_all.dtype}")
    if q.dim() != 4 or kv_all.dim() != 4 or scale_all.dim() != 4:
        raise ValueError("q, kv_all and scale_all must be 4-d")
    b, h, tq, d = q.shape
    n_layers, _, t, _ = kv_all.shape
    if tq != 1:
        raise ValueError(f"single-token decode only, got {tq} query tokens")
    if kv_all.shape[1:] != (b, t, h * d) or scale_all.shape != (n_layers, b, 2 * h, t):
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, kv {tuple(kv_all.shape)}, scale {tuple(scale_all.shape)}")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"head dim {d} outside (0, {_MAX_D}]")
    if (t + d + 4) * 4 > _SMEM_BYTES:
        raise ValueError(f"{t} slots need more than the kernel's {_SMEM_BYTES} bytes of shared memory")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    if not (q.is_contiguous() and kv_all.is_contiguous() and scale_all.is_contiguous()):
        raise ValueError("q, kv_all and scale_all must be contiguous")


def packed4_decode_attention(q, kv_all, scale_all, layer: int, valid_len, start=None, key_mask=None) -> torch.Tensor:
    """Fused decode attention over a ``Packed4QuantKVCache`` layer.

    Shapes as in :func:`packed4_decode_attention_plain`. On CUDA,
    ``valid_len`` is best a device int32 tensor of one element, which the
    kernel reads on the device; a Python int is filled into one. Slots
    beyond ``valid_len`` never take part; ``valid_len`` must be in [1, T].
    """
    if start is not None or key_mask is not None or kv_all.shape[2] >= 1024:
        raise NotImplementedError(_CHUNKED)
    layer = int(layer)
    if q.device.type == "cpu":
        return packed4_decode_attention_plain(q, kv_all, scale_all, layer, valid_len)
    _check(q, kv_all, scale_all, layer)
    from wmar_tpu_torch.ops import build

    b, h, _, d = q.shape
    t = kv_all.shape[2]
    if isinstance(valid_len, torch.Tensor):
        if valid_len.device != q.device or valid_len.numel() != 1:
            raise ValueError("valid_len must be one element on q's device")
        lens = valid_len.reshape(1).to(torch.int32).contiguous()
    else:
        lens = torch.full((1,), int(valid_len), dtype=torch.int32, device=q.device)
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    kv_layer, scale_layer = kv_all[layer], scale_all[layer]  # views: the kernel reads in place
    rc = build.load().wmar_packed4_decode_attention(
        q.data_ptr(), kv_layer.data_ptr(), scale_layer.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, t, d, int(q.dtype == torch.bfloat16), d**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"packed4 decode attention kernel failed to launch: cudaError {rc}")
    packed4_decode_attention.launches += 1
    return out


packed4_decode_attention.launches = 0
