"""Decode attention over the KV caches, and two measuring kernels (PyTorch + CUDA).

Every TPU kernel of ``wmar_tpu/ops/flash_decode.py`` (and the per-call
probe of ``tools/bench_call_floor.py``) has a hand-written sm_90a
counterpart here, reached through the JAX package's wrappers:

* :func:`packed4_decode_attention` (the int4 ``Packed4QuantKVCache``):
  below 1024 slots ``_packed4_attn_kernel`` (kernel #1,
  ``csrc/packed4_decode_attention.cu``); from 1024 slots on the chunked
  ``_packed4_attn_kernel_chunked{,_km}`` (#4), here
  :func:`packed4_decode_attention_chunked`.
* :func:`packed_decode_attention_q8` (the int8 ``PackedQuantKVCache``):
  below 1024 slots ``_packed_attn_kernel_q8`` (#2); from 1024 slots on the
  chunked ``_packed_attn_kernel_q8_chunked{,_km}`` (#3), here
  :func:`packed_decode_attention_q8_chunked`.
* :func:`flash_decode_attention` (a bf16 or f32 ``KVCache`` layer,
  ``_decode_attn_kernel{,_km}``, #5) and :func:`flash_decode_attention_q8`
  (a ``QuantKVCache`` layer, ``_decode_attn_kernel_q8{,_km}``, #6): one
  payload-templated kernel, ``csrc/flash_decode_attention.cu``, with
  ``start`` and ``key_mask`` at any cache length.
* :func:`_packed_dma_probe` (``_dma_probe_kernel``, #7) and
  :func:`row_mean_probe` (the per-call floor probe, #9),
  ``csrc/probes.cu``: what the int8 decode kernel's loads alone cost, and
  what one small launch costs.

Kernels #2-#4 are one payload-templated CUDA kernel
(``csrc/packed_decode_attention.cu``) that streams a row's slots
``[start_b, valid_len)`` with an online softmax and skips masked slots;
#5/#6 take the same design over the unpacked layouts. The packed routing
keeps JAX's rule: ``start``/``key_mask`` are taken only by the chunked path
(``T >= 1024``); at shorter ``T`` the packed wrappers raise ``ValueError``
as JAX's do.

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it runs the plain torch version of the same math in float32 (the
``*_plain`` functions). Nothing falls back from one to the other. Each
kernel's wrapper counts its launches in ``.launches``.

The attention kernels are bound by the bytes they read: the payload of the
slots that take part plus the scales, about 43 MB per layer at RAR-XL
(int4, 128 rows), 105 MB at Chameleon-7B text-to-image (int4, 24 rows, a
full cache of 1043 slots) and 53 MB at the end of an interleaved run (bf16,
3 rows over one history of ~1160 slots).
"""

from __future__ import annotations

import torch

_MAX_D = 256
_FLASH_MAX_D = 128  # kernels #5 and #6: one warp reads a slot in one load
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


def _device_masks(q, t: int, start, key_mask):
    """``start`` as int32 ``[B]`` and ``key_mask`` as bytes ``[B, T]`` on q's
    device (bool is viewed, never copied); returns the tensors, which the
    caller keeps alive over the launch, and their pointers (None if absent)."""
    b = q.shape[0]
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
    return start, key_mask, start_ptr, mask_ptr


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
    start, key_mask, start_ptr, mask_ptr = _device_masks(q, t, start, key_mask)
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


def _flash_check(q, k, v, kv_dtypes):
    """Device, type, shape and contiguity checks of kernels #5 and #6."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise TypeError(f"k and v must both be one of {kv_dtypes}, got {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d")
    b, h, tq, d = q.shape
    t = k.shape[2]
    if tq != 1:
        raise ValueError(f"single-token decode only, got {tq} query tokens")
    if k.shape != (b, h, t, d) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 < d <= _FLASH_MAX_D or d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4 in (0, {_FLASH_MAX_D}] (32 lanes load 4 values each)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    quad = 4 * k.element_size()
    if k.data_ptr() % quad or v.data_ptr() % quad:
        raise ValueError(f"k and v must be {quad}-byte aligned")


_KV_TYPE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _launch_flash(q, k, v, k_scale, v_scale, valid_len, start, key_mask) -> torch.Tensor:
    """Launch ``csrc/flash_decode_attention.cu`` (kernels #5 and #6)."""
    b, h, _, d = q.shape
    t = k.shape[2]
    lens = _device_lens(valid_len, q.device)
    start, key_mask, start_ptr, mask_ptr = _device_masks(q, t, start, key_mask)
    from wmar_tpu_torch.ops import build

    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    rc = build.load().wmar_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(), None if v_scale is None else v_scale.data_ptr(),
        lens.data_ptr(), start_ptr, mask_ptr, out.data_ptr(), b, h, t, d, _KV_TYPE[k.dtype],
        int(q.dtype == torch.bfloat16), d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash decode attention kernel failed to launch: cudaError {rc}")
    return out


def flash_decode_attention_plain(q, k_cache, v_cache, valid_len, start=None, key_mask=None) -> torch.Tensor:
    """Plain torch version of kernel #5, computed in float32: ``q [B, H, 1,
    D]`` against ``k_cache, v_cache [B, H, T, D]``; slots ``start[b] <= t <
    valid_len`` whose ``key_mask [B, T]`` is set take part. Returns ``[B, H,
    1, D]`` in q's dtype."""
    ones = torch.ones((), dtype=torch.float32, device=q.device)
    return _attention_plain(q, k_cache.to(torch.float32), v_cache.to(torch.float32), ones, ones, valid_len, start,
                            key_mask)


def flash_decode_attention_q8_plain(q, k_int8, v_int8, k_scale, v_scale, valid_len, start=None,
                                    key_mask=None) -> torch.Tensor:
    """Plain torch version of kernel #6, computed in float32: int8 payloads
    ``[B, H, T, D]`` with ``k_scale, v_scale [B, H, T]``; the score takes
    ``k_scale`` and the probability ``v_scale``, as the kernel does."""
    return _attention_plain(q, k_int8.to(torch.float32), v_int8.to(torch.float32), k_scale.to(torch.float32),
                            v_scale.to(torch.float32), valid_len, start, key_mask)


def flash_decode_attention(q, k_cache, v_cache, valid_len, start=None, key_mask=None) -> torch.Tensor:
    """Kernel #5: fused decode attention of ``q [B, H, 1, D]`` (bf16 or f32)
    over one ``KVCache`` layer ``k_cache, v_cache [B, H, T, D]`` (bf16 or
    f32, read in place), at any ``T``.

    ``valid_len``: count of valid slots, best a device int32 tensor of one
    element; ``start [B]``: first valid slot per row; ``key_mask [B, T]``
    (bool or uint8): per-row per-slot validity, read on the device. Every
    row must keep one slot that takes part (a row with none gets zeros).
    Returns ``[B, H, 1, D]`` in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, valid_len, start, key_mask)
    _flash_check(q, k_cache, v_cache, (torch.bfloat16, torch.float32))
    out = _launch_flash(q, k_cache, v_cache, None, None, valid_len, start, key_mask)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention_q8(q, k_int8, v_int8, k_scale, v_scale, valid_len, start=None,
                              key_mask=None) -> torch.Tensor:
    """Kernel #6: as :func:`flash_decode_attention` over one ``QuantKVCache``
    layer: ``k_int8, v_int8`` int8 ``[B, H, T, D]``, ``k_scale, v_scale``
    bf16 ``[B, H, T]``, dequantized inside the kernel."""
    if q.device.type == "cpu":
        return flash_decode_attention_q8_plain(q, k_int8, v_int8, k_scale, v_scale, valid_len, start, key_mask)
    _flash_check(q, k_int8, v_int8, (torch.int8,))
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.device != q.device or sc.dtype != torch.bfloat16 or sc.shape != k_int8.shape[:3] \
                or not sc.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 {tuple(k_int8.shape[:3])} tensor on q's device")
    out = _launch_flash(q, k_int8, v_int8, k_scale, v_scale, valid_len, start, key_mask)
    flash_decode_attention_q8.launches += 1
    return out


def _packed_dma_probe_plain(q, kv_all, scale_all, layer: int) -> torch.Tensor:
    """Plain torch version of kernel #7's output: ``kv[b, 0, :H*D] +
    scale[b, 0, 0]`` as ``[B, H, 1, D]`` in q's dtype."""
    b, h, _, d = q.shape
    row = kv_all[layer][:, 0, : h * d].to(torch.float32) + scale_all[layer][:, 0, 0].to(torch.float32)[:, None]
    return row.to(q.dtype).reshape(b, h, 1, d)


def _packed_dma_probe(q, kv_all, scale_all, layer: int) -> torch.Tensor:
    """Kernel #7: the bandwidth probe of the int8 packed decode kernels.

    Same grid, block and loads as kernel #2 over all ``T`` slots of
    ``kv_all int8 [L, B, T, 2*H*D]`` and ``scale_all bf16 [L, B, 2H, T]``,
    with no attention math; only ``q``'s shape and dtype are used. Its time
    is what those loads alone cost. Returns ``kv[b, 0, :H*D] + scale[b, 0,
    0]`` as ``[B, H, 1, D]``.
    """
    layer = int(layer)
    if q.device.type == "cpu":
        return _packed_dma_probe_plain(q, kv_all, scale_all, layer)
    _check(q, kv_all, scale_all, layer, torch.int8, 2)
    b, h, _, d = q.shape
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4 (the kernel reads 32-bit words)")
    kv_layer, scale_layer = kv_all[layer], scale_all[layer]
    if kv_layer.data_ptr() % 4:
        raise ValueError("the cache payload must be 4-byte aligned")
    from wmar_tpu_torch.ops import build

    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    rc = build.load().wmar_dma_probe(kv_layer.data_ptr(), scale_layer.data_ptr(), out.data_ptr(), b, h,
                                     kv_all.shape[2], d, int(q.dtype == torch.bfloat16),
                                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dma probe kernel failed to launch: cudaError {rc}")
    _packed_dma_probe.launches += 1
    return out


ROW_MEAN_OUT_COLS = 128


def row_mean_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel #9: float32 row means of ``x [rows,
    cols]``, rounded to bf16, in all 128 columns of ``[rows, 128]``."""
    mean = x.to(torch.float32).mean(dim=1, keepdim=True).to(torch.bfloat16)
    return mean.expand(x.shape[0], ROW_MEAN_OUT_COLS).contiguous()


def row_mean_probe(x: torch.Tensor) -> torch.Tensor:
    """Kernel #9: the per-call floor probe. ``x bf16 [rows, cols]`` (``cols``
    a multiple of 8) -> ``bf16 [rows, 128]`` holding each row's float32
    mean. At one row its time is the cost of a launch."""
    if x.device.type == "cpu":
        return row_mean_probe_plain(x)
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-d bf16 tensor, got {x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if rows == 0 or cols == 0 or cols % 8 or x.data_ptr() % 16:
        raise ValueError(f"x needs rows > 0, cols a positive multiple of 8 and 16-byte alignment, got {tuple(x.shape)}")
    from wmar_tpu_torch.ops import build

    out = torch.empty((rows, ROW_MEAN_OUT_COLS), dtype=torch.bfloat16, device=x.device)
    rc = build.load().wmar_row_mean_probe(x.data_ptr(), out.data_ptr(), rows, cols, ROW_MEAN_OUT_COLS,
                                          torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row mean probe kernel failed to launch: cudaError {rc}")
    row_mean_probe.launches += 1
    return out


flash_decode_attention.launches = 0
flash_decode_attention_q8.launches = 0
_packed_dma_probe.launches = 0
row_mean_probe.launches = 0
