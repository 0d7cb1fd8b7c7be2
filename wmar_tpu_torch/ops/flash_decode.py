"""Decode attention over the KV caches, and two measuring kernels (PyTorch + CUDA).

Every TPU kernel of ``wmar_tpu/ops/flash_decode.py`` (and the per-call
probe of ``tools/bench_call_floor.py``) has a hand-written sm_90a
counterpart here, reached through the JAX package's wrappers:

* :func:`packed4_decode_attention` (the int4 ``Packed4QuantKVCache``):
  below 1024 slots ``_packed4_attn_kernel`` (kernel #1), launched on the
  tiled kernel of ``csrc/packed_chunked_attention.cu`` without ``start``
  and ``key_mask``; from 1024 slots on the chunked
  ``_packed4_attn_kernel_chunked{,_km}`` (#4), here
  :func:`packed4_decode_attention_chunked`, the same source.
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

Kernel #2 is a payload-templated CUDA kernel
(``csrc/packed_decode_attention.cu``): a block per (head, row) streams the
row's slots with an online softmax, slot by slot. The packed routing keeps
JAX's rule: ``start``/``key_mask`` are taken only by the chunked path (``T
>= 1024``); at shorter ``T`` the packed wrappers raise ``ValueError`` as
JAX's do.

Kernels #1 and #3-#6 are designed for the card's 132 SMs (#5/#6:
``csrc/flash_decode_attention.cu``; #1, #3 and #4, over the packed layouts
where a head's bytes of a slot lie ``H*D`` or ``2*H*D`` bytes apart:
``csrc/packed_chunked_attention.cu``): the grid is ``(H, B, S)``, the ``S``
blocks of a (row, head) each take a share of ``[start_b, valid_len)`` in
whole tiles (:func:`flash_decode_tile` / :func:`packed_decode_tile` slots)
and the block that finishes last merges the partial ``(max, sum, acc)`` in
split order, inside the same launch. :func:`flash_decode_splits` and
:func:`packed_decode_splits` pick ``S`` from the shapes alone, so a CUDA
graph may replay the launch while the fill grows. A lane loads 16 bytes at
a time into a cp.async ring, the softmax runs by the tile, masks and scales
are read by the tile, and a masked slot costs no payload bytes.
:func:`flash_decode_attention_split_plain` (and, over the packed layouts,
:func:`packed_decode_attention_split_plain`) is the same arithmetic in
plain torch. The scratch for the partials and the arrival counters belong
to this module, one set per device (see :func:`_flash_workspace` for what
that costs).

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it runs the plain torch version of the same math in float32 (the
``*_plain`` functions). Nothing falls back from one to the other. Each
kernel's wrapper counts its launches in ``.launches``: one per call,
whatever ``S`` is.

The attention kernels are bound by the bytes they read: the payload of the
slots that take part plus the scales, about 43 MB per layer at RAR-XL
(int4, 128 rows), 105 MB at Chameleon-7B text-to-image (int4, 24 rows, a
full cache of 1043 slots) and 53 MB at the end of an interleaved run (bf16,
3 rows over one history of ~1160 slots).
"""

from __future__ import annotations

import functools

import torch

_MAX_D = 256
_FLASH_MAX_D = 128  # kernels #5 and #6: at most 32 lanes of 4 float32 values to a slot
_FLASH_PASSES = 8  # a tile is 8 loads of a warp (csrc/flash_decode_attention.cu: kPasses)
_FLASH_MAX_SPLITS = 16  # the kernel's limit on S (kMaxSplits)
_FLASH_MIN_SHARE = 128  # slots of the cache a split should at least stand for
_FLASH_BLOCKS_PER_SM = 3  # blocks of kernels #5/#6 that fit one SM (64 KB of shared memory each)
_PACKED_MAX_SPLITS = 16  # kernels #3/#4: the kernel's limit on S (kMaxSplits)
_WARP_HEAD_PER_SM = 12  # (row, head) pairs an SM from which kernels #1/#3/#4 give each pair a warp of its own
_PACKED_BLOCKS_PER_SM = 3  # blocks an SM that the planner of kernels #3/#4 counts on: the int8 kernel's (64 KB of
# ring each at D = 128). The int4 kernel fits six, but its sweep prefers the same S (tools/bench_flash_splits --packed)
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


def _check_packed(q, kv_all, scale_all, layer: int, int4: bool):
    """The checks of kernels #2-#4 and #7: :func:`_check`, a head dim of
    whole 32-bit words and a payload aligned to them. Returns the layer's
    views, which the kernel reads in place."""
    _check(q, kv_all, scale_all, layer, torch.uint8 if int4 else torch.int8, 1 if int4 else 2)
    d = q.shape[3]
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4 (the kernel reads 32-bit words)")
    kv_layer, scale_layer = kv_all[layer], scale_all[layer]
    if kv_layer.data_ptr() % 4:
        raise ValueError("the cache payload must be 4-byte aligned")
    return kv_layer, scale_layer


def _launch_packed_stream(q, kv_all, scale_all, layer: int, valid_len, start, key_mask, int4: bool,
                          any_d: bool = False) -> torch.Tensor:
    """Launch ``csrc/packed_decode_attention.cu``: kernel #2, and kernels #1,
    #3 and #4 at the head dims their tiled kernel does not take. ``any_d``
    (kernel #1 only): an int4 head dim that is no multiple of 4, or a payload
    off 4-byte alignment, which the kernel reads byte by byte."""
    if any_d:
        _check(q, kv_all, scale_all, layer, torch.uint8, 1)
        kv_layer, scale_layer = kv_all[layer], scale_all[layer]
    else:
        kv_layer, scale_layer = _check_packed(q, kv_all, scale_all, layer, int4)
    b, h, _, d = q.shape
    t = kv_all.shape[2]
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


def _packed_load_bytes(d: int) -> int:
    """Bytes of one lane's load in kernels #3 and #4: a head's slot is ``d``
    bytes of nibbles, or ``d`` bytes of K and ``d`` of V; 16 where ``d`` is a
    multiple of 16, else 8, else 4 (the kernel's rule)."""
    return 16 if d % 16 == 0 else 8 if d % 8 == 0 else 4


def packed_decode_tile(d: int) -> int:
    """Slots of one tile of kernels #1, #3 and #4 (the unit of the split over
    T and of the softmax), or 0 where a slot of ``d`` values does not fit a
    warp: the lanes of a slot are the next power of two above ``d`` / (bytes
    of one load), at least 8; a warp reads ``32 / lanes`` slots at once and a
    tile is 8 such passes. 32 up to ``d = 128`` (16 at 88 and 104, whose
    loads are 8 bytes), 16 above; 0 for ``d = 132, 140, ...``, which are no
    multiple of 8. A slot of exactly five loads (``d = 80`` at 16 bytes, 40
    at 8, 20 at 4) takes groups of five lanes instead, six slots a pass and
    five passes: 30."""
    if d == 5 * _packed_load_bytes(d):
        return 30
    lanes = _FLASH_PASSES
    while lanes * _packed_load_bytes(d) < d:
        lanes *= 2
    return _FLASH_PASSES * 32 // lanes if lanes <= 32 else 0


def packed_decode_splits(b: int, h: int, t: int, sm_count: int) -> int:
    """How many blocks ``S`` share one (row, head) in kernels #3 and #4: a
    function of the shapes and the card's SM count only, never of the fill
    (see :func:`flash_decode_splits`). As many as keep the whole grid on the
    card at once, at most one per 128 slots of the cache and at most 16:
    1 at 24 rows x 32 heads over 1043 slots on 132 SMs, 4 at 3 rows x 32
    heads over 4096."""
    resident = _PACKED_BLOCKS_PER_SM * sm_count
    return max(1, min(resident // (b * h), t // _FLASH_MIN_SHARE, _PACKED_MAX_SPLITS))


def packed_decode_warp_head(b: int, h: int, splits: int, sm_count: int) -> bool:
    """Whether kernels #1, #3 and #4 give each (row, head) one warp (a block
    is four heads of a row) instead of a block of four warps: with one split
    and at least 12 pairs an SM, where blocks of four warps would each see
    only a few tiles of a short cache and wait on their first loads (RAR-XL,
    128 rows x 16 heads; not Taming's 32 x 16 or Chameleon's 24 x 32, whose
    pairs alone would leave SMs with too few warps)."""
    return splits == 1 and b * h >= _WARP_HEAD_PER_SM * sm_count


def _launch_packed(q, kv_all, scale_all, layer: int, valid_len, start, key_mask, int4: bool,
                   splits=None, warp_head=None) -> torch.Tensor:
    """Launch ``csrc/packed_chunked_attention.cu`` (kernels #1, #3 and #4)
    with ``splits`` blocks per (row, head); None lets
    :func:`packed_decode_splits` choose, and ``warp_head`` None lets
    :func:`packed_decode_warp_head` choose the warp-per-(row, head) layout. A
    head dim whose slot does not fit a warp's lanes (no multiple of 8 above
    128) goes to the slot-by-slot kernel instead."""
    kv_layer, scale_layer = _check_packed(q, kv_all, scale_all, layer, int4)
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    if not packed_decode_tile(d):
        return _launch_packed_stream(q, kv_all, scale_all, layer, valid_len, start, key_mask, int4)
    if kv_layer.data_ptr() % _packed_load_bytes(d):
        raise ValueError(f"the cache payload must be {_packed_load_bytes(d)}-byte aligned: a lane loads that many "
                         f"bytes of a slot of {d} values")
    if splits is None:
        splits = packed_decode_splits(b, h, t, _sm_count(q.device.index))
    if not 1 <= splits <= _PACKED_MAX_SPLITS:
        raise ValueError(f"splits {splits} outside [1, {_PACKED_MAX_SPLITS}]")
    if warp_head is None:
        warp_head = packed_decode_warp_head(b, h, splits, _sm_count(q.device.index))
    if warp_head and splits != 1:
        raise ValueError("the warp-per-(row, head) layout takes one split")
    lens = _device_lens(valid_len, q.device)
    start, key_mask, start_ptr, mask_ptr = _device_masks(q, t, start, key_mask)
    partial_ptr = counters_ptr = None
    if splits > 1:
        partial, counters = _flash_workspace(q.device, b * h, b * h * splits * (d + 2))
        partial_ptr, counters_ptr = partial.data_ptr(), counters.data_ptr()
    from wmar_tpu_torch.ops import build

    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    rc = build.load().wmar_packed_chunked_attention(
        q.data_ptr(), kv_layer.data_ptr(), scale_layer.data_ptr(), lens.data_ptr(), start_ptr, mask_ptr,
        out.data_ptr(), partial_ptr, counters_ptr, b, h, t, d, splits, int(warp_head), int(int4),
        int(q.dtype == torch.bfloat16), d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"packed chunked attention kernel failed to launch: cudaError {rc}")
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
    out = _launch_packed_stream(q, kv_all, scale_all, layer, valid_len, None, None, int4=False)
    packed_decode_attention_q8.launches += 1
    return out


def packed4_decode_attention(q, kv_all, scale_all, layer: int, valid_len, start=None, key_mask=None) -> torch.Tensor:
    """Fused decode attention over a ``Packed4QuantKVCache`` layer.

    Below 1024 slots kernel #1 (no masks: ``start``/``key_mask`` raise
    ``ValueError``), from 1024 on :func:`packed4_decode_attention_chunked`.
    Kernel #1 is the tiled kernel of kernels #3 and #4 launched without
    masks (any ``T``; the planner's split count), counted here; a head dim
    that is no multiple of 4, or a payload that is not aligned to its loads,
    takes the slot-by-slot kernel (byte by byte where it must).
    On CUDA, ``valid_len`` is best a device int32 tensor of one element,
    which the kernel reads on the device; a Python int is filled into one.
    Slots beyond ``valid_len`` never take part; it must be in [1, T].
    """
    layer = int(layer)
    if _chunked_route(kv_all, start, key_mask):
        return packed4_decode_attention_chunked(q, kv_all, scale_all, layer, valid_len, start, key_mask)
    if q.device.type == "cpu":
        return packed4_decode_attention_plain(q, kv_all, scale_all, layer, valid_len)
    d = q.shape[-1]
    if d % 4 or kv_all[layer].data_ptr() % _packed_load_bytes(d):
        # a head dim that is no multiple of 4 (no model of the repo has one), or a payload view that is not aligned
        # to the tiled kernel's loads: the slot-by-slot kernel reads any
        out = _launch_packed_stream(q, kv_all, scale_all, layer, valid_len, None, None, int4=True, any_d=True)
    else:
        out = _launch_packed(q, kv_all, scale_all, layer, valid_len, None, None, int4=True)
    packed4_decode_attention.launches += 1
    return out


packed4_decode_attention.launches = 0
packed4_decode_attention_chunked.launches = 0
packed_decode_attention_q8.launches = 0
packed_decode_attention_q8_chunked.launches = 0


def _flash_load_bytes(d: int, kv_dtype) -> int:
    """Bytes of one lane's load in kernels #5 and #6: 16 where a slot's ``d``
    values are a multiple of 16 bytes, else 8, else 4 (the kernel's rule)."""
    slot = d * kv_dtype.itemsize
    return 16 if slot % 16 == 0 else 8 if slot % 8 == 0 else 4


def flash_decode_tile(d: int, kv_dtype) -> int:
    """Slots of one tile of kernels #5 and #6 (the unit of the split over T
    and of the softmax): the lanes of a slot are the next power of two above
    ``d`` / (values of one load), at least 8; a warp reads ``32 / lanes``
    slots at once and a tile is 8 such passes. 16 for bf16, 32 for int8 and
    8 for f32 at ``d = 128``."""
    values = _flash_load_bytes(d, kv_dtype) // kv_dtype.itemsize
    lanes = _FLASH_PASSES
    while lanes * values < d:
        lanes *= 2
    return _FLASH_PASSES * 32 // lanes


def flash_decode_splits(b: int, h: int, t: int, sm_count: int) -> int:
    """How many blocks ``S`` share one (row, head) in kernels #5 and #6: a
    function of the shapes and the card's SM count only, never of the fill,
    so that a captured launch can be replayed while ``valid_len`` grows.

    As many as keep the whole grid on the card at once (three blocks fit
    an SM; a second wave of blocks costs more than it hides), so 1 where
    ``b * h`` alone gives every SM three blocks; at most 8, and at most one
    split per 128 slots of the cache (3 rows x 32 heads over 4096 slots on
    132 SMs: 4, a grid of 384 blocks)."""
    resident = _FLASH_BLOCKS_PER_SM * sm_count
    return max(1, min(resident // (b * h), t // _FLASH_MIN_SHARE, 8))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_flash_workspaces: dict = {}  # device index -> [(partial, counters), ...], the last one in use


def _flash_workspace(device, rows: int, floats: int):
    """The scratch of kernels #5 and #6 on ``device``: ``partial`` (float32,
    at least ``floats`` elements: ``S`` x ``(max, sum, acc[D])`` per (row,
    head)) and ``counters`` (int32 zeros, at least ``rows``: how many of a
    (row, head)'s blocks have arrived; the last one sets it back to 0).

    One set per device, allocated on first use and grown when a larger
    shape comes (never freed: a captured graph may still point into an old
    one), so a call costs no allocation, no ``torch.zeros`` and no second
    launch. The price: launches that may run at the same time (two streams,
    or two graphs replayed side by side) must not share it, and the first
    call at a shape must come before a graph capture, not inside one."""
    sets = _flash_workspaces.setdefault(device.index, [])
    if not sets or sets[-1][0].numel() < floats or sets[-1][1].numel() < rows:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the flash-decode scratch must be allocated before a CUDA graph capture: "
                               "call the wrapper once at this shape first")
        sets.append((torch.empty(max(floats, 1 << 20), dtype=torch.float32, device=device),
                     torch.zeros(max(rows, 4096), dtype=torch.int32, device=device)))
    return sets[-1]


def _flash_check(q, k, v, kv_dtypes):
    """Device, type, shape, contiguity and alignment checks of kernels #5
    and #6."""
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
        raise ValueError(f"head dim {d} must be a multiple of 4 in (0, {_FLASH_MAX_D}] (a slot is read in loads of "
                         f"16, 8 or 4 bytes by at most 32 lanes)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    load = _flash_load_bytes(d, k.dtype)
    if k.data_ptr() % load or v.data_ptr() % load:
        raise ValueError(f"k and v must be {load}-byte aligned: a lane loads {load} bytes of a slot of {d} {k.dtype} "
                         f"values")


_KV_TYPE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _launch_flash(q, k, v, k_scale, v_scale, valid_len, start, key_mask, splits=None) -> torch.Tensor:
    """Launch ``csrc/flash_decode_attention.cu`` (kernels #5 and #6) with
    ``splits`` blocks per (row, head); None lets :func:`flash_decode_splits`
    choose."""
    b, h, _, d = q.shape
    t = k.shape[2]
    if splits is None:
        splits = flash_decode_splits(b, h, t, _sm_count(q.device.index))
    if not 1 <= splits <= _FLASH_MAX_SPLITS:
        raise ValueError(f"splits {splits} outside [1, {_FLASH_MAX_SPLITS}]")
    lens = _device_lens(valid_len, q.device)
    start, key_mask, start_ptr, mask_ptr = _device_masks(q, t, start, key_mask)
    partial_ptr = counters_ptr = None
    if splits > 1:
        partial, counters = _flash_workspace(q.device, b * h, b * h * splits * (d + 2))
        partial_ptr, counters_ptr = partial.data_ptr(), counters.data_ptr()
    from wmar_tpu_torch.ops import build

    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    rc = build.load().wmar_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(), None if v_scale is None else v_scale.data_ptr(),
        lens.data_ptr(), start_ptr, mask_ptr, out.data_ptr(), partial_ptr, counters_ptr, b, h, t, d, splits,
        _KV_TYPE[k.dtype], int(q.dtype == torch.bfloat16), d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash decode attention kernel failed to launch: cudaError {rc}")
    return out


def flash_decode_attention_split_plain(q, k, v, valid_len, start, key_mask, splits: int, k_scale=None,
                                       v_scale=None, tile=None) -> torch.Tensor:
    """Plain torch version of the arithmetic of kernels #5 and #6 as the
    card does it, in float32: the slots ``[start_b, valid_len)`` of a row
    are cut into tiles of ``tile`` slots (None: :func:`flash_decode_tile`), the tiles dealt
    to ``splits`` shares in runs of ``ceil(tiles / splits)`` (a share may be
    empty), every share gives its ``(max, sum of exp, acc)``, and the
    shares are merged in split order. ``k_scale``/``v_scale`` ``[B, H, T]``
    make it kernel #6 (the score takes ``k_scale``, the probability
    ``v_scale``). Equal to :func:`flash_decode_attention_plain` up to
    float32 rounding; a row with no slot that takes part gets zeros. For
    tests: it reads ``valid_len`` on the host."""
    b, h, _, d = q.shape
    t = k.shape[2]
    dev = q.device
    tile = tile or flash_decode_tile(d, k.dtype)
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].to(torch.float32), k.to(torch.float32))
    if k_scale is not None:
        s = s * k_scale.to(torch.float32)
    s = s * d**-0.5
    n = min(max(int(torch.as_tensor(valid_len).reshape(-1)[0]), 1), t)
    lo = (torch.zeros(b, dtype=torch.int64, device=dev) if start is None
          else torch.as_tensor(start, device=dev).to(torch.int64).clamp(0, n))
    pos = torch.arange(t, device=dev)
    live = (pos[None, :] < n) & (pos[None, :] >= lo[:, None])
    if key_mask is not None:
        live = live & torch.as_tensor(key_mask, device=dev).to(torch.bool)
    n_tiles = (n - lo + tile - 1) // tile
    per_split = ((n_tiles + splits - 1) // splits).clamp(min=1)
    split_of = ((pos[None, :] - lo[:, None]) // tile) // per_split[:, None]  # [B, T]
    vf = v.to(torch.float32)
    minus_inf = torch.tensor(float("-inf"), device=dev)
    parts = []
    for si in range(splits):
        on = (live & (split_of == si))[:, None, :]
        ss = torch.where(on, s, minus_inf)
        top = ss.amax(dim=-1)  # -inf for an empty share
        p = torch.where(on, torch.exp(ss - torch.where(torch.isinf(top), 0.0, top)[..., None]), 0.0)
        pv = p if v_scale is None else p * v_scale.to(torch.float32)
        parts.append((top, p.sum(dim=-1), torch.einsum("bht,bhtd->bhd", pv, vf)))
    top = torch.stack([part[0] for part in parts]).amax(dim=0)
    top = torch.where(torch.isinf(top), 0.0, top)
    num = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
    den = torch.zeros((b, h), dtype=torch.float32, device=dev)
    for part_top, part_sum, part_acc in parts:  # split order
        f = torch.where(torch.isinf(part_top), 0.0, torch.exp(part_top - top))
        num = num + part_acc * f[..., None]
        den = den + part_sum * f
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-38)[..., None], 0.0)
    return out[:, :, None].to(q.dtype)


def packed_decode_attention_split_plain(q, kv_all, scale_all, layer: int, valid_len, start, key_mask, splits: int,
                                        int4: bool) -> torch.Tensor:
    """Plain torch version of the arithmetic of kernels #3 (``int4`` False)
    and #4 as the card does it: the layer unpacked to integer-valued ``k, v
    [B, H, T, D]``, then :func:`flash_decode_attention_split_plain` with
    tiles of :func:`packed_decode_tile` slots. For tests."""
    b, h, _, d = q.shape
    t = kv_all.shape[2]
    sc = scale_all[layer].to(torch.float32)
    if int4:
        u = kv_all[layer].to(torch.int32).reshape(b, t, h, d).transpose(1, 2)
        k, v = ((u & 0xF) - 8).to(torch.float32), ((u >> 4) - 8).to(torch.float32)
    else:
        kv = kv_all[layer].to(torch.float32).reshape(b, t, 2, h, d)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    return flash_decode_attention_split_plain(q, k, v, valid_len, start, key_mask, splits, sc[:, :h], sc[:, h:],
                                              tile=packed_decode_tile(d))


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
    kv_layer, scale_layer = _check_packed(q, kv_all, scale_all, layer, int4=False)
    b, h, _, d = q.shape
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
