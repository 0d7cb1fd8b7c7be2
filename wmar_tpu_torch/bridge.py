"""Weight and cache bridge from the JAX package to the port.

Takes JAX parameter trees whose leaves are numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so it imports no JAX:

* RAR and Taming-GPT dict trees map 1:1: the port's modules store ``w
  [n_in, n_out]`` as the tree does, so a leaf's path joined by dots is its
  ``state_dict`` key. Quantized linears switch the module to int8 (``w_q``,
  ``w_scale``, ``b``) or grouped int4 (``w_q4``, ``w_s4``, ``b``), and a
  quantized Taming head (``q``/``s`` or ``q4``/``s4``) becomes a
  quantized matrix; payloads keep their bytes.
* Llama trees (the Chameleon backbone) stay dict trees: every leaf,
  ``{"q", "s"}`` int8 matrices included, becomes a tensor in place.
* Flax conv trees (MaskGit and Taming VQGAN, the LPIPS VGG, the PatchGAN
  discriminator): conv ``kernel`` goes from HWIO to OIHW as ``weight``;
  GroupNorm and BatchNorm ``scale``/``bias`` become ``weight``/``bias``,
  BatchNorm ``mean``/``var`` the ``running_*`` buffers. :func:`flax_tree`
  is the inverse: a module's ``state_dict`` as the Flax tree, so files the
  port writes (RCC deltas, trainables) have the JAX package's layout.
* A JAX ``KVCache`` (``k``, ``v``), ``QuantKVCache`` (``k``, ``v``,
  ``k_scale``, ``v_scale``), ``PackedQuantKVCache`` or
  ``Packed4QuantKVCache`` (``kv``, ``scale``) becomes the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from wmar_tpu_torch.engine.kvcache import KVCache, Packed4QuantKVCache, PackedQuantKVCache, QuantKVCache
from wmar_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from wmar_tpu_torch.models.rar import RAR
from wmar_tpu_torch.models.taming_gpt import GPT
from wmar_tpu_torch.models.vqgan import TamingVQGAN


def to_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> a torch tensor of its own; a
    tensor (as the msgpack reader returns them) is moved and cast."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
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


def _load_module(model, leaves: Dict[str, Any], what: str):
    """Switch ``model``'s linears to the tree's quantized forms, then copy
    every leaf into the buffer of the same dotted name."""
    dev = next(model.buffers()).device
    for suffix, names, setter in ((".w_q", ("w_q", "w_scale", "b"), "set_int8"),
                                  (".w_q4", ("w_q4", "w_s4", "b"), "set_int4")):
        for base in [p[: -len(suffix)] for p in leaves if p.endswith(suffix)]:
            getattr(model.get_submodule(base), setter)(
                *(to_tensor(leaves[f"{base}.{n}"], device=dev) for n in names))
    own = dict(model.named_buffers())
    missing = sorted(set(own) - set(leaves))
    unexpected = sorted(set(leaves) - set(own))
    if missing or unexpected:
        raise KeyError(f"{what} tree mismatch: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for path, leaf in leaves.items():
        t = to_tensor(leaf)
        if own[path].shape != t.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {tuple(own[path].shape)}")
        mod_name, name = path.rsplit(".", 1) if "." in path else ("", path)
        setattr(model.get_submodule(mod_name), name, t.to(own[path].device))
    return model


@torch.no_grad()
def load_rar(model: RAR, params: Dict) -> RAR:
    """Load a JAX RAR tree (float, int8 or int4) into ``model`` in place."""
    return _load_module(model, dict(flatten(params)), "RAR")


@torch.no_grad()
def load_gpt(model: GPT, params: Dict) -> GPT:
    """Load a JAX Taming-GPT tree (float, int8 or int4) into ``model`` in
    place; a quantized head (``{"q","s"}`` or ``{"q4","s4"}``) replaces the
    float one."""
    leaves = dict(flatten(params))
    head = {n: to_tensor(leaves[f"head.{n}"], device=model.tok_emb.device)
            for n in ("q", "s", "q4", "s4") if f"head.{n}" in leaves}
    if head:
        model.set_head(head)
    return _load_module(model, leaves, "Taming GPT")


def load_llama(params: Any, dtype=None, device=None) -> Any:
    """A JAX llama tree (numpy leaves) as the same tree of tensors. ``dtype``
    casts the floating leaves; int8 payloads keep their type."""
    if isinstance(params, dict):
        return {k: load_llama(v, dtype, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [load_llama(v, dtype, device) for v in params]
    t = to_tensor(params, device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


@torch.no_grad()
def load_maskgit(model: MaskGitVQGAN, variables: Dict) -> MaskGitVQGAN:
    """Load Flax MaskGit variables (``{"params": ...}`` or the inner dict)."""
    return load_flax(model, variables)


@torch.no_grad()
def load_taming_vqgan(model: TamingVQGAN, variables: Dict) -> TamingVQGAN:
    """Load Flax Taming-VQGAN variables (``{"params": ...}`` or the inner dict)."""
    return load_flax(model, variables)


# Flax leaf names that are not the torch names (conv ``kernel`` is handled apart)
_FLAX_TO_TORCH = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_TORCH_TO_FLAX = {"running_mean": "mean", "running_var": "var"}


def _flax_state(model) -> Dict[str, torch.Tensor]:
    """Parameters and persistent buffers (BatchNorm statistics), by
    ``state_dict`` name."""
    return {k: v for k, v in model.state_dict(keep_vars=True).items() if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def load_flax(model, variables: Dict):
    """Copy a Flax tree (``{"params": ...}`` or the inner dict; numpy or
    tensor leaves) into ``model``'s parameters and BatchNorm statistics,
    casting to their dtype. Every tensor of the model needs a leaf."""
    params = variables.get("params", variables)
    own = _flax_state(model)
    seen = set()
    for path, leaf in flatten(params):
        mod, name = path.rsplit(".", 1) if "." in path else ("", path)
        t = to_tensor(leaf)
        if name == "kernel":
            key, t = f"{mod}.weight", t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif name in _FLAX_TO_TORCH:
            key = f"{mod}.{_FLAX_TO_TORCH[name]}"
        else:
            key = path
        if key not in own:
            raise KeyError(f"Flax leaf {path} has no counterpart {key}")
        if own[key].shape != t.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(own[key].shape)}")
        own[key].copy_(t)
        seen.add(key)
    if seen != set(own):
        raise KeyError(f"parameters without a Flax leaf: {sorted(set(own) - seen)[:5]}")
    return model



def load_flax_file(cls, cfg, path: str, device="cpu"):
    """``cls(cfg)`` on ``device`` with the weights of a Flax-layout msgpack
    file (the port's own reader; shapes checked, float32), built without
    drawing random weights first."""
    from wmar_tpu_torch.utils.checkpoint import load_pytree

    with torch.device("meta"):
        model = cls(cfg)
    return load_flax(model.to_empty(device=device), load_pytree(path))


def flax_tree(named) -> Dict:
    """The Flax tree of a module (or of ``(state_dict name, tensor)`` pairs,
    such as its gradients): 4-d ``weight`` OIHW -> ``kernel`` HWIO, 1-d
    ``weight`` -> ``scale``, ``running_mean``/``running_var`` ->
    ``mean``/``var``; a ``ModuleList`` index becomes a key ``"0"``, ``"1"``,
    as flax writes a list. Leaves are contiguous tensors on their device."""
    items = _flax_state(named).items() if isinstance(named, torch.nn.Module) else named
    tree: Dict = {}
    for key, t in items:
        mod, name = key.rsplit(".", 1) if "." in key else ("", key)
        t = t.detach()
        if name == "weight" and t.dim() == 4:
            name, t = "kernel", t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif name == "weight" and t.dim() == 1:
            name = "scale"
        name = _TORCH_TO_FLAX.get(name, name)
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        node[name] = t.contiguous()
    return tree


def kv_cache(k, v, device=None) -> KVCache:
    """A JAX ``KVCache``'s ``k`` and ``v`` (f32 or bf16) as the port's cache."""
    return KVCache(to_tensor(k, device=device), to_tensor(v, device=device))


def quant_cache(k, v, k_scale, v_scale, device=None) -> QuantKVCache:
    """A JAX ``QuantKVCache``'s payloads and scales as the port's cache."""
    return QuantKVCache(*(to_tensor(x, device=device) for x in (k, v, k_scale, v_scale)))


def packed_cache(kv, scale, head_dim: int, device=None) -> PackedQuantKVCache:
    """A JAX ``PackedQuantKVCache``'s ``kv`` and ``scale`` as the port's cache."""
    return PackedQuantKVCache(to_tensor(kv, device=device), to_tensor(scale, device=device), head_dim)


def packed4_cache(kv, scale, head_dim: int, device=None) -> Packed4QuantKVCache:
    """A JAX ``Packed4QuantKVCache``'s ``kv`` and ``scale`` as the port's cache."""
    return Packed4QuantKVCache(to_tensor(kv, device=device), to_tensor(scale, device=device), head_dim)
