"""Preallocated KV caches for autoregressive decoding (PyTorch).

Port of ``wmar_tpu.engine.kvcache`` with the same layouts, so caches bridge
1:1 and payload and scale bytes match the JAX package exactly. JAX updates
its caches functionally; here ``write`` updates the buffers in place (the
memory a decode loop would otherwise copy per step) and returns ``self``.
``pos`` may be a Python int or a device tensor, so a decode loop never has
to read the position back to the host.

Multi-GPU runs hand a :class:`CacheSpec` to :meth:`KVCache.zeros` where a
dtype goes: on a rank of a tensor-parallel grid the cache then holds this
rank's heads only, and a packed cache carries the rank's ``mesh``, so that
decode attention runs the unchanged kernel on it
(:func:`wmar_tpu_torch.ops.flash_decode.sharded_packed_decode_attention`).
The packed caches' ``tp_groups`` lane order is JAX's, byte for byte: lane
group ``g`` of a grouped cache is the plain packed cache of that group's
heads, which is what a rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """A ``cache_dtype`` value that carries a rank's place in a multi-GPU
    grid (:class:`wmar_tpu_torch.parallel.Mesh`).

    Wrappers pass ``cache_dtype`` to :meth:`KVCache.zeros` as they get it,
    so a spec in that slot hands the grid to the caches without touching
    every constructor, as in JAX. With ``tp_axis`` the cache holds
    ``n_heads / tp`` heads, this rank's; its rows are whatever the caller
    gives (a dp rank's own)."""

    dtype: object = "packed"
    mesh: object = None
    dp_axis: object = None
    tp_axis: object = None

    @property
    def tp(self) -> int:
        return self.mesh.shape[self.tp_axis] if (self.mesh is not None and self.tp_axis) else 1


class _Fields:
    """``replace`` over the tensors of ``FIELDS`` and the constructor's other arguments."""

    FIELDS: tuple = ()
    STATIC: tuple = ()

    def replace(self, **kw):
        args = {f: getattr(self, f) for f in self.FIELDS + self.STATIC}
        args.update(kw)
        return type(self)(**args)


def _slots(pos, t: int, device) -> torch.Tensor:
    """Cache slots ``[pos, pos + t)`` as an int64 index tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(torch.int64) + torch.arange(t, device=device)
    return torch.arange(int(pos), int(pos) + t, device=device)


class KVCache(_Fields):
    """Stacked per-layer float cache. k, v: ``[L, B, H, T, D]``."""

    FIELDS = ("k", "v")

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              dtype=torch.float32, device: Device = "cpu"):
        """A zero cache; ``dtype`` a torch dtype, ``"int8"``, ``"packed"``,
        ``"packed4"`` or a :class:`CacheSpec` of one (``n_heads`` then the
        model's, of which a tp rank's cache holds its share)."""
        spec = dtype if isinstance(dtype, CacheSpec) else CacheSpec(dtype)
        dtype = spec.dtype
        if n_heads % spec.tp:
            raise ValueError(f"{n_heads} heads do not split over tp={spec.tp}")
        n_heads //= spec.tp
        if dtype in (torch.int8, "int8"):
            return QuantKVCache.zeros(n_layers, batch, n_heads, max_len, head_dim, device=device)
        if dtype in ("packed", "packed4"):
            cls = PackedQuantKVCache if dtype == "packed" else Packed4QuantKVCache
            cache = cls.zeros(n_layers, batch, n_heads, max_len, head_dim, device=device)
            if spec.mesh is None:
                return cache
            return cache.replace(tp_groups=spec.tp, mesh=spec.mesh, dp_axis=spec.dp_axis, tp_axis=spec.tp_axis)
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


class QuantKVCache(_Fields):
    """int8 cache with per-(token, head) absmax scales.

    k, v: int8 ``[L, B, H, T, D]``; k_scale, v_scale: bf16 ``[L, B, H, T]``.
    """

    FIELDS = ("k", "v", "k_scale", "v_scale")

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


class _PackedCache(_Fields):
    """What the two packed layouts share: the payload ``kv``, the scale rows
    ``[L, B, 2*H, T]`` and the tensor-parallel context.

    ``tp_groups = g``: the lanes and scale rows are ordered by head group,
    ``[K_g0 | V_g0 | K_g1 | V_g1 | ...]`` (the int4 payload is head-major
    already, so only its scale rows are grouped), where group ``i`` holds
    heads ``[i*H/g, (i+1)*H/g)``; ``g = 1`` is the plain layout. A cache with
    ``mesh`` and ``tp_axis`` is one rank's shard of such a cache: its arrays
    hold one group, its own heads, which is byte for byte the plain cache of
    those heads. A grouped cache without that context must not reach a
    kernel, which reads the plain layout (:mod:`wmar_tpu_torch.engine.attention`).
    """

    FIELDS = ("kv", "scale")
    STATIC = ("head_dim", "tp_groups", "mesh", "dp_axis", "tp_axis")

    def __init__(self, kv: torch.Tensor, scale: torch.Tensor, head_dim: int, tp_groups: int = 1, mesh=None,
                 dp_axis=None, tp_axis=None):
        self.kv = kv
        self.scale = scale
        self.head_dim = head_dim
        self.tp_groups = tp_groups
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis

    @property
    def max_len(self) -> int:
        return self.kv.shape[2]

    @property
    def n_heads(self) -> int:
        return self.scale.shape[2] // 2

    @property
    def lane_groups(self) -> int:
        """Head groups of the arrays this object holds: one on a tp rank."""
        return 1 if (self.mesh is not None and self.tp_axis) else self.tp_groups

    def _grouped_scales(self, ks: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
        """``[B, H, t]`` K and V scales -> ``[B, 2H, t]`` rows in group order."""
        b, h, t = ks.shape
        g = self.lane_groups
        return torch.cat([ks.reshape(b, g, h // g, t), vs.reshape(b, g, h // g, t)], dim=2).reshape(b, 2 * h, t)

    def _scales(self, layer: int):
        """The layer's K and V scales, ``[B, H, T]`` each, in head order."""
        _, b, h2, t = self.scale.shape
        g = self.lane_groups
        sc = self.scale[layer].reshape(b, g, 2, h2 // (2 * g), t)
        return sc[:, :, 0].reshape(b, h2 // 2, t), sc[:, :, 1].reshape(b, h2 // 2, t)

    def _store(self, layer: int, pos, payload: torch.Tensor, scales: torch.Tensor):
        idx = _slots(pos, payload.shape[1], self.kv.device)
        self.kv[layer].index_copy_(1, idx, payload)
        self.scale[layer].index_copy_(2, idx, scales)
        return self


class PackedQuantKVCache(_PackedCache):
    """int8 cache in the packed-heads layout.

    kv: int8 ``[L, B, T, 2*H*D]``, lanes ``[:H*D]`` the K payload and
    ``[H*D:]`` the V payload of one token (head-major; by group with
    ``tp_groups``); scale: bf16 ``[L, B, 2*H, T]``, rows ``[:H]`` K scales
    and ``[H:]`` V. The quantization is :meth:`QuantKVCache._quantize`, so
    dequantized values equal that cache's. Single-token decode reads it
    through :func:`wmar_tpu_torch.ops.flash_decode.packed_decode_attention_q8`.
    """

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              device: Device = "cpu", tp_groups: int = 1):
        if n_heads % tp_groups:
            raise ValueError(f"{n_heads} heads do not split into {tp_groups} groups")
        return cls(
            torch.zeros((n_layers, batch, max_len, 2 * n_heads * head_dim), dtype=torch.int8, device=device),
            torch.zeros((n_layers, batch, 2 * n_heads, max_len), dtype=torch.bfloat16, device=device),
            head_dim, tp_groups,
        )

    def write(self, layer: int, pos, k_new: torch.Tensor, v_new: torch.Tensor) -> "PackedQuantKVCache":
        kq, ks = QuantKVCache._quantize(k_new)  # [B, H, t, D], [B, H, t]
        vq, vs = QuantKVCache._quantize(v_new)
        b, h, t, d = kq.shape
        g = self.lane_groups
        # per group [K_gi | V_gi] lane blocks (one group: plain [K | V])
        payload = torch.cat([kq.transpose(1, 2).reshape(b, t, g, h * d // g),
                             vq.transpose(1, 2).reshape(b, t, g, h * d // g)], dim=-1).reshape(b, t, 2 * h * d)
        return self._store(layer, pos, payload, self._grouped_scales(ks, vs))

    def layer(self, layer: int):
        """Dequantized ``[B, H, T, D]`` bf16 K/V, equal to :class:`QuantKVCache`'s."""
        b, t, _ = self.kv.shape[1:]
        h, d, g = self.n_heads, self.head_dim, self.lane_groups
        pay = self.kv[layer].reshape(b, t, g, 2, h // g, d)
        ks, vs = self._scales(layer)

        def unpack(x, scale):  # x [B, T, g, H/g, D] int8, scale [B, H, T]
            return x.reshape(b, t, h, d).to(torch.bfloat16).transpose(1, 2) * scale[..., None]

        return unpack(pay[:, :, :, 0], ks), unpack(pay[:, :, :, 1], vs)


class Packed4QuantKVCache(_PackedCache):
    """int4 cache in the packed-heads layout.

    kv: uint8 ``[L, B, T, H*D]``, each byte the K nibble (low) and V nibble
    (high) of one (token, head, dim), stored offset by 8 in [1, 15];
    scale: bf16 ``[L, B, 2*H, T]``, rows ``[:H]`` K scales and ``[H:]`` V
    (by group with ``tp_groups``). Single-token decode reads it through
    :func:`wmar_tpu_torch.ops.flash_decode.packed4_decode_attention`.
    """

    @classmethod
    def zeros(cls, n_layers: int, batch: int, n_heads: int, max_len: int, head_dim: int,
              device: Device = "cpu", tp_groups: int = 1):
        if n_heads % tp_groups:
            raise ValueError(f"{n_heads} heads do not split into {tp_groups} groups")
        return cls(
            torch.zeros((n_layers, batch, max_len, n_heads * head_dim), dtype=torch.uint8, device=device),
            torch.zeros((n_layers, batch, 2 * n_heads, max_len), dtype=torch.bfloat16, device=device),
            head_dim, tp_groups,
        )

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
        return self._store(layer, pos, payload, self._grouped_scales(ks, vs))

    def layer(self, layer: int):
        """Dequantized ``[B, H, T, D]`` bf16 K/V."""
        b, t, _ = self.kv.shape[1:]
        h, d = self.n_heads, self.head_dim
        u = self.kv[layer]
        ks, vs = self._scales(layer)

        def unpack(nib, scale):  # nib [B, T, H*D] in [1, 15], scale [B, H, T]
            x = (nib.to(torch.bfloat16) - 8.0).reshape(b, t, h, d).transpose(1, 2)
            return x * scale[..., None]

        return unpack(u & 0xF, ks), unpack(u >> 4, vs)
