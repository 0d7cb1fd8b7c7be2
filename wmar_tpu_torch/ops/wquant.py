"""Weight-only int8 and grouped-int4 quantization for decode-path linears
(PyTorch).

Port of ``wmar_tpu.ops.wquant``. Weights keep the JAX layout ``w [n_in,
n_out]``, so parameter trees map 1:1, and payloads and scales are
bit-identical to the JAX package's (both compute in float32 and round half
to even):

* int8, per output channel, with the scale factored out of the
  contraction: ``x @ w == (x @ q) * s``. ``x @ w_q.to(x.dtype) * s + b`` is
  a plain ``torch.matmul``: the JAX package left it to XLA, outside any
  Pallas kernel.
* int4 in groups of ``G`` rows of the contraction (128, else 64 or 32),
  two nibbles per byte in the group-halves layout ``[gc, G/2, n_out]`` with
  a bf16 scale per (group, output channel). The product goes through the
  w4a16 kernel (:func:`wmar_tpu_torch.ops.w4_matmul.matmul_w4`, kernel #8)
  on a CUDA tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from wmar_tpu_torch.ops.w4_matmul import GROUPS, matmul_w4, unpack_int4  # noqa: F401  (unpack_int4: public API)

INT4_GROUP = GROUPS[0]


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


def quantize_matrix_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """Bare matrix ``[n_in, n_out]`` -> ``{"q4": uint8 [gc, G/2, n_out],
    "s4": bf16 [gc, n_out]}``: values in [-7, 7] stored offset by 8, byte row
    ``i`` of a group holding rows ``i`` (low nibble) and ``i + G/2`` (high)."""
    w = w.detach().to(torch.float32)
    n_in, n_out = w.shape
    if n_in % group or group % 2:
        raise ValueError(f"n_in={n_in} must be divisible by even group={group}")
    wg = w.reshape(n_in // group, group, n_out)
    scale = wg.abs().amax(dim=1) / 7.0  # [gc, n_out]
    q = torch.clamp(torch.round(wg / torch.clamp_min(scale[:, None, :], 1e-12)), -7, 7)
    u = (q + 8).to(torch.uint8)  # [gc, G, n_out] in [1, 15]
    half = group // 2
    return {"q4": u[:, :half] | (u[:, half:] << 4), "s4": scale.to(torch.bfloat16)}


def _int4_group_for(n_in: int):
    """Largest supported group size dividing ``n_in`` (None: use int8)."""
    for g in GROUPS:
        if n_in % g == 0:
            return g
    return None


def quantize_matrix(w: torch.Tensor, bits: int = 8) -> dict:
    """``bits=8`` -> ``{"q","s"}``; ``bits=4`` -> grouped ``{"q4","s4"}``,
    or int8 where no supported group divides the contraction dim."""
    if bits == 4:
        g = _int4_group_for(int(w.shape[0]))
        if g is not None:
            return quantize_matrix_int4(w, group=g)
    return quantize_matrix_int8(w)


def quantize_linear_int4(p: dict, compute_dtype=None, group: int = INT4_GROUP) -> dict:
    """``{"w","b"}`` -> ``{"w_q4","w_s4","b"}``."""
    qs = quantize_matrix_int4(p["w"], group=group)
    b = p["b"].detach()
    if compute_dtype is not None:
        b = b.to(compute_dtype)
    return {"w_q4": qs["q4"], "w_s4": qs["s4"], "b": b}


def quantize_linear(p: dict, bits: int = 8, compute_dtype=None) -> dict:
    """Bits-dispatching ``{"w","b"}`` quantizer; int4 falls back to int8 on
    an indivisible input dim, as :func:`quantize_matrix` does."""
    if bits == 4:
        g = _int4_group_for(int(p["w"].shape[0]))
        if g is not None:
            return quantize_linear_int4(p, compute_dtype=compute_dtype, group=g)
    return quantize_linear_int8(p, compute_dtype=compute_dtype)


def matmul4(x: torch.Tensor, w: dict) -> torch.Tensor:
    """``x @ dequant(w)`` for a ``{"q4","s4"}`` grouped-int4 dict: kernel #8
    on a CUDA tensor, its plain version on a CPU tensor."""
    return matmul_w4(x, w["q4"], w["s4"])


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a bare matrix, an int8 ``{"q","s"}`` dict or a grouped
    int4 ``{"q4","s4"}`` dict."""
    if isinstance(w, dict):
        if "q4" in w:
            return matmul4(x, w)
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return _matmul(x, w)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Linear layer on ``{"w","b"}``, int8 ``{"w_q","w_scale","b"}`` or
    grouped int4 ``{"w_q4","w_s4","b"}``."""
    if "w_q4" in p:
        return matmul_w4(x, p["w_q4"], p["w_s4"]) + p["b"]
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
    n_out]`` and ``b``, after :meth:`quantize_int8` ``w_q``, ``w_scale`` and
    ``b``, after :meth:`quantize_int4` ``w_q4``, ``w_s4`` and ``b``.
    ``state_dict`` keys therefore match the JAX tree's paths."""

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

    def set_int4(self, w_q4: torch.Tensor, w_s4: torch.Tensor, b: torch.Tensor) -> None:
        """Swap the float weight for a grouped-int4 payload and its scales."""
        self._buffers.pop("w", None)
        self.register_buffer("w_q4", w_q4)
        self.register_buffer("w_s4", w_s4)
        self.b = b

    def quantize_int8(self, compute_dtype=None) -> None:
        p = quantize_linear_int8(self.params(), compute_dtype=compute_dtype)
        self.set_int8(p["w_q"], p["w_scale"], p["b"])

    def quantize_int4(self, compute_dtype=None) -> None:
        """Grouped int4 as :func:`quantize_linear` with ``bits=4``: int8 where
        no supported group divides ``n_in``."""
        p = quantize_linear(self.params(), bits=4, compute_dtype=compute_dtype)
        if "w_q4" in p:
            self.set_int4(p["w_q4"], p["w_s4"], p["b"])
        else:
            self.set_int8(p["w_q"], p["w_scale"], p["b"])

    def quantize(self, bits: int = 8, compute_dtype=None) -> None:
        (self.quantize_int4 if bits == 4 else self.quantize_int8)(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.params())
