"""Weight and cache bridge from the JAX package to the port.

Takes JAX parameter trees whose leaves are numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so it imports no JAX:

* RAR dict trees map 1:1: the port's modules store ``w [n_in, n_out]`` as
  the tree does, so a leaf's path joined by dots is its ``state_dict`` key.
  Quantized linears (``w_q``, ``w_scale``, ``b``) switch the module to int8.
* MaskGit Flax trees: conv ``kernel`` goes from HWIO to OIHW as
  ``weight``; GroupNorm ``scale``/``bias`` become ``weight``/``bias``.
* A JAX ``Packed4QuantKVCache`` (``kv``, ``scale``) becomes the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from wmar_tpu_torch.engine.kvcache import Packed4QuantKVCache
from wmar_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from wmar_tpu_torch.models.rar import RAR


def to_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> a torch tensor of its own."""
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def load_rar(model: RAR, params: Dict) -> RAR:
    """Load a JAX RAR tree (float or int8-quantized) into ``model`` in place."""
    leaves = dict(flatten(params))
    dev = model.embeddings.device
    for base in [p[: -len(".w_q")] for p in leaves if p.endswith(".w_q")]:
        model.get_submodule(base).set_int8(
            *(to_tensor(leaves[f"{base}.{n}"], device=dev) for n in ("w_q", "w_scale", "b")))
    own = dict(model.named_buffers())
    missing = sorted(set(own) - set(leaves))
    unexpected = sorted(set(leaves) - set(own))
    if missing or unexpected:
        raise KeyError(f"RAR tree mismatch: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for path, leaf in leaves.items():
        t = to_tensor(leaf)
        if own[path].shape != t.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {tuple(own[path].shape)}")
        mod_name, name = path.rsplit(".", 1) if "." in path else ("", path)
        setattr(model.get_submodule(mod_name), name, t.to(own[path].device))
    return model


@torch.no_grad()
def load_maskgit(model: MaskGitVQGAN, variables: Dict) -> MaskGitVQGAN:
    """Load Flax MaskGit variables (``{"params": ...}`` or the inner dict)."""
    params = variables.get("params", variables)
    own = dict(model.named_parameters())
    seen = set()
    for path, leaf in flatten(params):
        mod, name = path.rsplit(".", 1) if "." in path else ("", path)
        a = np.asarray(leaf)
        if name == "kernel":
            key, a = f"{mod}.weight", a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif name == "scale":
            key = f"{mod}.weight"
        else:
            key = path
        if key not in own:
            raise KeyError(f"Flax leaf {path} has no counterpart {key}")
        t = to_tensor(a)
        if own[key].shape != t.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(own[key].shape)}")
        own[key].copy_(t)
        seen.add(key)
    if seen != set(own):
        raise KeyError(f"parameters without a Flax leaf: {sorted(set(own) - seen)[:5]}")
    return model


def packed4_cache(kv, scale, head_dim: int, device=None) -> Packed4QuantKVCache:
    """A JAX ``Packed4QuantKVCache``'s ``kv`` and ``scale`` as the port's cache."""
    return Packed4QuantKVCache(to_tensor(kv, device=device), to_tensor(scale, device=device), head_dim)
