"""Decode attention over the packed KV caches (PyTorch + CUDA).

Four TPU kernels of ``wmar_tpu/ops/flash_decode.py`` have hand-written
sm_90a counterparts here, reached through the JAX package's two wrappers:

* :func:`packed4_decode_attention` (the int4 ``Packed4QuantKVCache``):
  below 1024 slots ``_packed4_attn_kernel`` (kernel #1,
  ``csrc/packed4_decode_attention.cu``); from 1024 slots on the chunked
  ``_packed4_attn_kernel_chunked{,_km}`` (#4), here
  :func:`packed4_decode_attention_chunked`.
* :func:`packed_decode_attention_q8` (the int8 ``PackedQuantKVCache``):
  below 1024 slots ``_packed_attn_kernel_q8`` (#2); from 1024 slots on the
  chunked ``_packed_attn_kernel_q8_chunked{,_km}`` (#3), here
  :func:`packed_decode_attention_q8_chunked`.

Kernels #2-#4 are one payload-templated CUDA kernel
(``csrc/packed_decode_attention.cu``) that streams a row's slots
``[start_b, valid_len)`` with an online softmax and skips masked slots.
The routing keeps JAX's rule: ``start``/``key_mask`` are taken only by the
chunked path (``T >= 1024``); at shorter ``T`` the wrappers raise
``ValueError`` as JAX's do.

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it runs the plain torch version of the same math in float32
(:func:`packed4_decode_attention_plain`,
:func:`packed_decode_attention_q8_plain`). Nothing falls back from one to
the other. Each kernel's wrapper counts its launches in ``.launches``.

The kernels are bound by the bytes they read: the payload of the slots
that take part plus 4 bytes of scales per (slot, head), about 43 MB per
layer at RAR-XL (int4, 128 rows) and 105 MB at Chameleon-7B (int4, 24
rows, a full cache of 1043 slots).
"""

from __future__ import annotations

import torch

_MAX_D = 256
_SMEM_BYTES = 48 * 1024  # kernel #1: scores [T] + q [D] + 4 partials, as float32, without opt-in
_CHUNK_MIN_T = 1024  # JAX's shape-aware default: the chunked kernels from 1024 slots on
_MASKS_NEED_CHUNKED = (
    "start/key_mask support requires the chunked path (T >= 1024); "
    "the dispatcher only routes masked calls at long contexts")


def _attention_plain(q, k, v, k_scale, v_scale, valid_len, start, key_mask) -> torch.Tensor:
    """Masked attention of ``q [B, H, 1, D]`` over integer-valued ``k, v [B,
    H, T, D]`` with per-(slot, head) scales ``[B, H, T]``, in float32."""
    d = q.shape[-1]
    t = k.shape[2]
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].to(torch.float32), k) * k_scale * d**-0.5
    pos = torch.arange(t, device=q.device)
    valid = (pos < torch.as_tensor(valid_len, device=q.device).reshape(-1))[None, None, :]
    if start is not None:
        valid = valid & (pos[None, :] >= torch.as_tensor(start, device=q.device).reshape(-1, 1))[:, None, :]
    if key_mask is not None:
        valid = valid & torch.as_tensor(key_mask, device=q.device).to(torch.bool)[:, None, :]
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1) * v_scale
    o = torch.einsum("bht,bhtd->bhd", p, v)
    return o[:, :, None].to(q.dtype)


def packed4_decode_attention_plain(q, kv_all, scale_all, layer: int, valid_len, start=None,
                                   key_mask=None) -> torch.Tensor:
    """Plain torch version of kernels #1 and #4, computed in float32.

    ``q [B, H, 1, D]``; ``kv_all uint8 [L, B, T, H*D]`` (K low, V high
    nibbles, offset 8); ``scale_all bf16 [L, B, 2H, T]``. Slots ``start[b]
    <= t < valid_len`` whose ``key_mask [B, T]`` is set take part; the
    output is ``[B, H, 1, D]`` in q's dtype.
    """
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    u = kv_all[layer].to(torch.int32).reshape(b, t, h, d).transpose(1, 2)  # [B, H, T, D]
    sc = scale_all[layer].to(torch.float32)
    return _attention_plain(q, ((u & 0xF) - 8).to(torch.float32), ((u >> 4) - 8).to(torch.float32),
                            sc[:, :h], sc[:, h:], valid_len, start, key_mask)


def packed_decode_attention_q8_plain(q, kv_all, scale_all, layer: int, valid_len, start=None,
                                     key_mask=None) -> torch.Tensor:
    """Plain torch version of kernels #2 and #3, computed in float32.

    ``kv_all int8 [L, B, T, 2*H*D]`` (lanes ``[:HD]`` K, ``[HD:]`` V);
    everything else as in :func:`packed4_decode_attention_plain`.
    """
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    kv = kv_all[layer].to(torch.float32).reshape(b, t, 2, h, d)
    sc = scale_all[layer].to(torch.float32)
    return _attention_plain(q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2),
                            sc[:, :h], sc[:, h:], valid_len, start, key_mask)


def _check(q, kv_all, scale_all, layer: int, kv_dtype, lanes_per_head: int):
    """Device, type, shape and contiguity checks shared by the kernels."""
    if not (q.is_cuda and kv_all.is_cuda and scale_all.is_cuda) or not (
        q.device == kv_all.device == scale_all.device
    ):
        raise ValueError("q, kv_all and scale_all must lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if kv_all.dtype != kv_dtype or scale_all.dtype != torch.bfloat16:
        raise TypeError(f"kv must be {kv_dtype} and scale bf16, got {kv_all.dtype}, {scale_all.dtype}")
    if q.dim() != 4 or kv_all.dim() != 4 or scale_all.dim() != 4:
        raise ValueError("q, kv_all and scale_all must be 4-d")
    b, h, tq, d = q.shape
    n_layers, _, t, _ = kv_all.shape
    if tq != 1:
        raise ValueError(f"single-token decode only, got {tq} query tokens")
    if kv_all.shape[1:] != (b, t, lanes_per_head * h * d) or scale_all.shape != (n_layers, b, 2 * h, t):
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, kv {tuple(kv_all.shape)}, scale {tuple(scale_all.shape)}")
    if not 0 < d <= _MAX_D:
        raise ValueError(f"head dim {d} outside (0, {_MAX_D}]")
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer {layer} outside [0, {n_layers})")
    if not (q.is_contiguous() and kv_all.is_contiguous() and scale_all.is_contiguous()):
        raise ValueError("q, kv_all and scale_all must be contiguous")


def _device_lens(valid_len, device) -> torch.Tensor:
    """``valid_len`` as one int32 element on ``device`` (never read back)."""
    if isinstance(valid_len, torch.Tensor):
        if valid_len.device != device or valid_len.numel() != 1:
            raise ValueError("valid_len must be one element on q's device")
        return valid_len.reshape(1).to(torch.int32).contiguous()
    return torch.full((1,), int(valid_len), dtype=torch.int32, device=device)


def _chunked_route(kv_all, start, key_mask) -> bool:
    """JAX's rule: the chunked kernel from 1024 slots on; masks only there."""
    chunked = kv_all.shape[2] >= _CHUNK_MIN_T
    if (start is not None or key_mask is not None) and not chunked:
        raise ValueError(_MASKS_NEED_CHUNKED)
    return chunked


def _launch_packed(q, kv_all, scale_all, layer: int, valid_len, start, key_mask, int4: bool) -> torch.Tensor:
    """Launch ``csrc/packed_decode_attention.cu`` (kernels #2-#4)."""
    _check(q, kv_all, scale_all, layer, torch.uint8 if int4 else torch.int8, 1 if int4 else 2)
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4 (the kernel reads 32-bit words)")
    kv_layer, scale_layer = kv_all[layer], scale_all[layer]  # views: the kernel reads in place
    if kv_layer.data_ptr() % 4:
        raise ValueError("the cache payload must be 4-byte aligned")
    lens = _device_lens(valid_len, q.device)
    start_ptr = mask_ptr = None
    if start is not None:
        if not isinstance(start, torch.Tensor) or start.device != q.device or start.shape != (b,):
            raise ValueError(f"start must be a [{b}] tensor on q's device")
        start = start.to(torch.int32).contiguous()
        start_ptr = start.data_ptr()
    if key_mask is not None:
        if not isinstance(key_mask, torch.Tensor) or key_mask.device != q.device or key_mask.shape != (b, t):
            raise ValueError(f"key_mask must be a [{b}, {t}] tensor on q's device")
        key_mask = (key_mask.view(torch.uint8) if key_mask.dtype == torch.bool
                    else key_mask.to(torch.uint8)).contiguous()
        mask_ptr = key_mask.data_ptr()
    from wmar_tpu_torch.ops import build

    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    rc = build.load().wmar_packed_decode_attention(
        q.data_ptr(), kv_layer.data_ptr(), scale_layer.data_ptr(), lens.data_ptr(), start_ptr, mask_ptr,
        out.data_ptr(), b, h, t, d, int(int4), int(q.dtype == torch.bfloat16), d**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"packed decode attention kernel failed to launch: cudaError {rc}")
    return out


def packed4_decode_attention_chunked(q, kv_all, scale_all, layer: int, valid_len, start=None,
                                     key_mask=None) -> torch.Tensor:
    """Kernel #4: the chunked int4 kernel, with ``start [B]`` and ``key_mask
    [B, T]`` (bool or uint8) on the device. Shapes as in
    :func:`packed4_decode_attention_plain`. :func:`packed4_decode_attention`
    routes here from 1024 slots on; called directly it takes any ``T``."""
    layer = int(layer)
    if q.device.type == "cpu":
        return packed4_decode_attention_plain(q, kv_all, scale_all, layer, valid_len, start, key_mask)
    out = _launch_packed(q, kv_all, scale_all, layer, valid_len, start, key_mask, int4=True)
    packed4_decode_attention_chunked.launches += 1
    return out


def packed_decode_attention_q8_chunked(q, kv_all, scale_all, layer: int, valid_len, start=None,
                                       key_mask=None) -> torch.Tensor:
    """Kernel #3: the chunked int8 kernel; as
    :func:`packed4_decode_attention_chunked` over the int8 cache."""
    layer = int(layer)
    if q.device.type == "cpu":
        return packed_decode_attention_q8_plain(q, kv_all, scale_all, layer, valid_len, start, key_mask)
    out = _launch_packed(q, kv_all, scale_all, layer, valid_len, start, key_mask, int4=False)
    packed_decode_attention_q8_chunked.launches += 1
    return out


def packed_decode_attention_q8(q, kv_all, scale_all, layer: int, valid_len, start=None,
                               key_mask=None) -> torch.Tensor:
    """Fused decode attention over a ``PackedQuantKVCache`` layer.

    Below 1024 slots kernel #2 (no masks: ``start``/``key_mask`` raise
    ``ValueError``), from 1024 on :func:`packed_decode_attention_q8_chunked`.
    ``valid_len`` is best a device int32 tensor of one element.
    """
    layer = int(layer)
    if _chunked_route(kv_all, start, key_mask):
        return packed_decode_attention_q8_chunked(q, kv_all, scale_all, layer, valid_len, start, key_mask)
    if q.device.type == "cpu":
        return packed_decode_attention_q8_plain(q, kv_all, scale_all, layer, valid_len)
    out = _launch_packed(q, kv_all, scale_all, layer, valid_len, None, None, int4=False)
    packed_decode_attention_q8.launches += 1
    return out


def _check_single_block(q, kv_all, scale_all, layer: int):
    _check(q, kv_all, scale_all, layer, torch.uint8, 1)
    t, d = kv_all.shape[2], q.shape[3]
    if (t + d + 4) * 4 > _SMEM_BYTES:
        raise ValueError(f"{t} slots need more than the kernel's {_SMEM_BYTES} bytes of shared memory")


def packed4_decode_attention(q, kv_all, scale_all, layer: int, valid_len, start=None, key_mask=None) -> torch.Tensor:
    """Fused decode attention over a ``Packed4QuantKVCache`` layer.

    Below 1024 slots kernel #1 (no masks: ``start``/``key_mask`` raise
    ``ValueError``), from 1024 on :func:`packed4_decode_attention_chunked`.
    On CUDA, ``valid_len`` is best a device int32 tensor of one element,
    which the kernel reads on the device; a Python int is filled into one.
    Slots beyond ``valid_len`` never take part; it must be in [1, T].
    """
    layer = int(layer)
    if _chunked_route(kv_all, start, key_mask):
        return packed4_decode_attention_chunked(q, kv_all, scale_all, layer, valid_len, start, key_mask)
    if q.device.type == "cpu":
        return packed4_decode_attention_plain(q, kv_all, scale_all, layer, valid_len)
    _check_single_block(q, kv_all, scale_all, layer)
    from wmar_tpu_torch.ops import build

    b, h, _, d = q.shape
    t = kv_all.shape[2]
    lens = _device_lens(valid_len, q.device)
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
packed4_decode_attention_chunked.launches = 0
packed_decode_attention_q8.launches = 0
packed_decode_attention_q8_chunked.launches = 0
