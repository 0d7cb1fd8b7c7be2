"""Weight-only int8 quantization for decode-path linears (PyTorch).

Port of ``wmar_tpu.ops.wquant``: per-output-channel absmax int8 with the
scale factored out of the contraction, ``x @ w == (x @ q) * s``. Weights
keep the JAX layout ``w [n_in, n_out]``, so parameter trees map 1:1 and the
payloads and scales are bit-identical to the JAX package's (both compute
in float32 and round half to even).

``x @ w_q.to(x.dtype) * s + b`` is a plain ``torch.matmul``: the JAX
package left it to XLA, outside any Pallas kernel. Grouped int4 weights
are not ported yet (ROADMAP queue 2, kernel 8, the w4a16 matmul).
"""

from __future__ import annotations

import torch
from torch import nn

_INT4 = "int4 weights are not ported yet: ROADMAP queue 2, kernel 8 (w4a16 matmul)"


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion (torch refuses mixed dtypes)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def quantize_matrix_int8(w: torch.Tensor) -> dict:
    """Bare matrix ``[n_in, n_out]`` -> ``{"q": int8, "s": bf16 [n_out]}``."""
    w = w.detach().to(torch.float32)
    scale = w.abs().amax(dim=0) / 127.0
    q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-12)), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def quantize_linear_int8(p: dict, compute_dtype=None) -> dict:
    """``{"w","b"}`` -> ``{"w_q","w_scale","b"}``."""
    qs = quantize_matrix_int8(p["w"])
    b = p["b"].detach()
    if compute_dtype is not None:
        b = b.to(compute_dtype)
    return {"w_q": qs["q"], "w_scale": qs["s"], "b": b}


def quantize_linear(p: dict, bits: int = 8, compute_dtype=None) -> dict:
    if bits == 4:
        raise NotImplementedError(_INT4)
    return quantize_linear_int8(p, compute_dtype=compute_dtype)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Linear layer on ``{"w","b"}`` or int8 ``{"w_q","w_scale","b"}``."""
    if "w_q4" in p:
        raise NotImplementedError(_INT4)
    if "w_q" in p:
        y = x @ p["w_q"].to(x.dtype)
        return y * p["w_scale"].to(x.dtype) + p["b"]
    return _matmul(x, p["w"]) + p["b"]


def cast_float_leaves(tree, compute_dtype):
    """Cast floating tensors of a nested dict/list tree; int8 leaves untouched."""
    if isinstance(tree, dict):
        return {k: cast_float_leaves(v, compute_dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_float_leaves(v, compute_dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(compute_dtype)
    return tree


class Linear(nn.Module):
    """A linear layer whose buffers are the JAX dict's leaves: ``w [n_in,
    n_out]`` and ``b``, or after :meth:`quantize_int8` ``w_q``, ``w_scale``
    and ``b``. ``state_dict`` keys therefore match the JAX tree's paths."""

    def __init__(self, n_in: int, n_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.register_buffer("w", torch.zeros((n_in, n_out), dtype=dtype, device=device))
        self.register_buffer("b", torch.zeros((n_out,), dtype=dtype, device=device))

    def params(self) -> dict:
        return dict(self.named_buffers(recurse=False))

    def set_int8(self, w_q: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor) -> None:
        """Swap the float weight for an int8 payload and its scales."""
        self._buffers.pop("w", None)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.b = b

    def quantize_int8(self, compute_dtype=None) -> None:
        p = quantize_linear_int8(self.params(), compute_dtype=compute_dtype)
        self.set_int8(p["w_q"], p["w_scale"], p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.params())
