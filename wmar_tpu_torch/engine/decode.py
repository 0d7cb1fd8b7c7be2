"""The decode engine: one sampling loop for every model family (PyTorch).

Port of ``wmar_tpu.engine.decode``. JAX runs the loop as one ``lax.scan``;
here it is a Python loop whose step index is a device tensor, so the loop
never waits on the host (no ``.item()``, no host-built index) and a CUDA
graph can later capture one step and replay it.

The engine owns the watermark bias, the top-k/top-p warps and the draw,
and the past-token buffer that is the watermark's context. The Gumbel
noise of the draw comes from an explicit ``torch.Generator`` or, for tests
that hold the port against JAX, from a ``noise [num_steps, B, k]`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from wmar_tpu_torch.core.sampling import apply_watermark_bias, context_keys_at_step, warp_and_sample
from wmar_tpu_torch.core.spec import WatermarkSpec


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyperparameters."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False


@dataclasses.dataclass(frozen=True)
class WatermarkRuntime:
    """A greenlist source bound to a spec, ready to fuse into the sampler."""

    spec: WatermarkSpec
    greenlist: Any

    def bias(self, logits, buffer, length, image_pos):
        keys, valid = context_keys_at_step(self.spec, buffer, length, image_pos)
        return apply_watermark_bias(self.spec, self.greenlist, logits, keys, valid)


# step_fn: (cache, tokens [B], step index as a 0-d device tensor) -> (logits [B, V], cache)
StepFn = Callable[[Any, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Any]]


def decode_tokens(
    step_fn: StepFn,
    cache: Any,
    init_logits: torch.Tensor,
    num_steps: int,
    sampler: SamplerConfig,
    watermark: Optional[WatermarkRuntime] = None,
    cond_tokens: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """Sample ``num_steps`` tokens autoregressively.

    Args:
      step_fn: model adapter; receives the freshly sampled tokens and the
        step index of the *next* logits it must produce.
      cache: model state after prefill.
      init_logits: ``[B, V]`` logits of the first token (from prefill).
      num_steps: number of tokens to generate.
      sampler: sampling config.
      watermark: optional fused watermark.
      cond_tokens: ``[B, c]`` tokens that open the watermark context buffer
        (Taming-style models); ``None`` for RAR.
      generator: source of the Gumbel noise when ``noise`` is not given.
      noise: optional ``[num_steps, B, k]`` Gumbel noise, one slice per step.

    Returns:
      ``(tokens [B, num_steps] int64, final cache)``.
    """
    b = init_logits.shape[0]
    dev = init_logits.device
    c = 0 if cond_tokens is None else cond_tokens.shape[1]
    buffer = torch.zeros((b, c + num_steps), dtype=torch.int64, device=dev)
    if cond_tokens is not None:
        buffer[:, :c] = cond_tokens
    steps = torch.arange(num_steps, device=dev)  # steps[s] is a 0-d device view

    def sample_one(logits, s: int):
        logits = logits.to(torch.float32)
        if watermark is not None:
            logits = watermark.bias(logits, buffer, c + steps[s], steps[s])
        return warp_and_sample(
            logits,
            temperature=sampler.temperature,
            top_k=sampler.top_k,
            top_p=sampler.top_p,
            greedy=sampler.greedy,
            noise=None if noise is None else noise[s],
            generator=generator,
        )

    token = sample_one(init_logits, 0)
    buffer[:, c] = token
    for s in range(1, num_steps):
        logits, cache = step_fn(cache, token, steps[s])
        token = sample_one(logits, s)
        buffer[:, c + s] = token
    return buffer[:, c:], cache
