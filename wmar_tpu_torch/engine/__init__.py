"""Decode engine: KV caches, attention, and the watermarked sampling loop."""

from wmar_tpu_torch.engine.attention import cached_decode_attention, decode_attention, prefill_attention
from wmar_tpu_torch.engine.decode import SamplerConfig, WatermarkRuntime, decode_tokens
from wmar_tpu_torch.engine.kvcache import CacheSpec, KVCache, Packed4QuantKVCache, PackedQuantKVCache, QuantKVCache

__all__ = [
    "CacheSpec",
    "KVCache",
    "Packed4QuantKVCache",
    "PackedQuantKVCache",
    "QuantKVCache",
    "SamplerConfig",
    "WatermarkRuntime",
    "cached_decode_attention",
    "decode_attention",
    "decode_tokens",
    "prefill_attention",
]
