"""Preallocated KV caches for autoregressive decoding (PyTorch).

Port of ``wmar_tpu.engine.kvcache`` with the same layouts, so caches bridge
1:1 and payload and scale bytes match the JAX package exactly. JAX updates
its caches functionally; here ``write`` updates the buffers in place (the
memory a decode loop would otherwise copy per step) and returns ``self``.
``pos`` may be a Python int or a device tensor, so a decode loop never has
to read the position back to the host.

Not ported yet: ``PackedQuantKVCache`` (int8 packed, waits with its decode
kernel, ROADMAP queue 2) and ``CacheSpec`` (multi-GPU sharding).
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def _slots(pos, t: int, device) -> torch.Tensor:
    """Cache slots ``[pos, pos + t)`` as an int64 index tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(torch.int64) + torch.arange(t, device=device)
    return torch.arange(int(pos), int(pos) + t, device=device)


class KVCache:
    """Stacked per-layer float cache. k, v: ``[L, B, H, T, D]``."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              dtype=torch.float32, device: Device = "cpu"):
        if dtype in (torch.int8, "int8"):
            return QuantKVCache.zeros(n_layers, batch, n_heads, max_len, head_dim, device=device)
        if dtype == "packed4":
            return Packed4QuantKVCache.zeros(n_layers, batch, n_heads, max_len, head_dim, device=device)
        if dtype == "packed":
            raise NotImplementedError(
                "the int8 packed cache waits with its decode kernel (ROADMAP queue 2, kernel 2)")
        shape = (n_layers, batch, n_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def write(self, layer: int, pos, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write ``[B, H, t, D]`` keys/values for ``layer`` at slot ``pos``."""
        idx = _slots(pos, k_new.shape[2], self.k.device)
        self.k[layer].index_copy_(2, idx, k_new.to(self.k.dtype))
        self.v[layer].index_copy_(2, idx, v_new.to(self.v.dtype))
        return self

    def layer(self, layer: int):
        """Full-length K/V for one layer: ``([B, H, T, D], [B, H, T, D])``."""
        return self.k[layer], self.v[layer]


class QuantKVCache:
    """int8 cache with per-(token, head) absmax scales.

    k, v: int8 ``[L, B, H, T, D]``; k_scale, v_scale: bf16 ``[L, B, H, T]``.
    """

    def __init__(self, k, v, k_scale, v_scale):
        self.k, self.v, self.k_scale, self.v_scale = k, v, k_scale, v_scale

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              device: Device = "cpu"):
        shape = (n_layers, batch, n_heads, max_len, head_dim)
        sshape = shape[:-1]
        return cls(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
            torch.zeros(sshape, dtype=torch.bfloat16, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @staticmethod
    def _quantize(x: torch.Tensor):
        """[B, H, t, D] -> (int8 payload, bf16 per-(token, head) scale)."""
        x = x.to(torch.float32)
        scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-8) / 127.0
        q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale.to(torch.bfloat16)

    def write(self, layer: int, pos, k_new: torch.Tensor, v_new: torch.Tensor) -> "QuantKVCache":
        kq, ks = self._quantize(k_new)
        vq, vs = self._quantize(v_new)
        idx = _slots(pos, k_new.shape[2], self.k.device)
        self.k[layer].index_copy_(2, idx, kq)
        self.v[layer].index_copy_(2, idx, vq)
        self.k_scale[layer].index_copy_(2, idx, ks)
        self.v_scale[layer].index_copy_(2, idx, vs)
        return self

    def layer(self, layer: int):
        """Dequantized full-length K/V for one layer, in bf16."""
        k = self.k[layer].to(torch.bfloat16) * self.k_scale[layer][..., None]
        v = self.v[layer].to(torch.bfloat16) * self.v_scale[layer][..., None]
        return k, v


class Packed4QuantKVCache:
    """int4 cache in the packed-heads layout.

    kv: uint8 ``[L, B, T, H*D]``, each byte the K nibble (low) and V nibble
    (high) of one (token, head, dim), stored offset by 8 in [1, 15];
    scale: bf16 ``[L, B, 2*H, T]``, rows ``[:H]`` K scales and ``[H:]`` V.
    Single-token decode reads it through
    :func:`wmar_tpu_torch.ops.flash_decode.packed4_decode_attention`.
    """

    def __init__(self, kv: torch.Tensor, scale: torch.Tensor, head_dim: int):
        self.kv = kv
        self.scale = scale
        self.head_dim = head_dim

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              device: Device = "cpu"):
        return cls(
            torch.zeros((n_layers, batch, max_len, n_heads * head_dim), dtype=torch.uint8, device=device),
            torch.zeros((n_layers, batch, 2 * n_heads, max_len), dtype=torch.bfloat16, device=device),
            head_dim,
        )

    @property
    def max_len(self) -> int:
        return self.kv.shape[2]

    @property
    def n_heads(self) -> int:
        return self.scale.shape[2] // 2

    @staticmethod
    def _quantize4(x: torch.Tensor):
        """[B, H, t, D] -> (nibble values in [1, 15] as uint8, bf16 scale)."""
        x = x.to(torch.float32)
        scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-8) / 7.0
        q = torch.clamp(torch.round(x / scale[..., None]), -7, 7)
        return (q + 8.0).to(torch.uint8), scale.to(torch.bfloat16)

    def write(self, layer: int, pos, k_new: torch.Tensor, v_new: torch.Tensor) -> "Packed4QuantKVCache":
        kq, ks = self._quantize4(k_new)  # [B, H, t, D], [B, H, t]
        vq, vs = self._quantize4(v_new)
        b, h, t, d = kq.shape
        payload = (kq | (vq << 4)).transpose(1, 2).reshape(b, t, h * d)
        scales = torch.cat([ks, vs], dim=1)  # [B, 2H, t]
        idx = _slots(pos, t, self.kv.device)
        self.kv[layer].index_copy_(1, idx, payload)
        self.scale[layer].index_copy_(2, idx, scales)
        return self

    def layer(self, layer: int):
        """Dequantized ``[B, H, T, D]`` bf16 K/V."""
        b, t, _ = self.kv.shape[1:]
        h, d = self.n_heads, self.head_dim
        u = self.kv[layer]
        sc = self.scale[layer]

        def unpack(nib, scale):  # nib [B, T, H*D] in [1, 15], scale [B, H, T]
            x = (nib.to(torch.bfloat16) - 8.0).reshape(b, t, h, d).transpose(1, 2)
            return x * scale[..., None]

        return unpack(u & 0xF, sc[:, :h]), unpack(u >> 4, sc[:, h:])
