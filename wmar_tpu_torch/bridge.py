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
* Moshi trees (the audio LM) stay dict trees as the Llama ones do
  (:func:`load_moshi`); Mimi's Flax tree loads into the port's module by
  :func:`load_mimi`, each kernel turned into torch's layout
  (:func:`mimi_tree` is the inverse), and a JAX ``MimiFTWrapper``'s
  frozen and trainable trees into the port's by :func:`load_mimi_ft`
  (:func:`mimi_ft_tree` the inverse).
* The neural codecs' trees (compressai, KL-VAE, DC-AE: the JAX package's
  converters' and ``init_*_params``' layout, copied in the port) load by
  :func:`load_codec_tree` into modules whose child names follow the tree:
  an HWIO kernel becomes a Conv2d's OIHW weight (a ConvTranspose2d's
  unflipped), a ``[in, out]`` matrix a Linear's weight
  (:func:`load_compressai`, :func:`load_kl_vae`, :func:`load_dcae`). The
  audio codecs and AudioSeal the same way, with 1-D kernels ``[K, I, O]``
  and LSTMs (:func:`load_encodec`, :func:`load_dac`,
  :func:`load_audioseal`); Moshi's LUT conditioners by
  :func:`load_conditioners`.
* DiffPure's ADM UNet takes its Flax tree by :func:`load_adm_unet` (conv
  kernels HWIO, Dense kernels ``[in, out]``; :func:`adm_unet_tree` is the
  inverse); the FID InceptionV3 the JAX package's ``convert_inception``
  tree by :func:`load_inception`.
* A JAX ``KVCache`` (``k``, ``v``), ``QuantKVCache`` (``k``, ``v``,
  ``k_scale``, ``v_scale``), ``PackedQuantKVCache`` or
  ``Packed4QuantKVCache`` (``kv``, ``scale``) becomes the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

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


def load_moshi(params: Any, device=None) -> Any:
    """A JAX Moshi tree (``wmar_tpu.audio.lm``: numpy leaves, float or with
    the int8 ``{"q", "s"}`` matrices of ``quantize_moshi_params_int8``) as
    the same tree of tensors, which :class:`wmar_tpu_torch.audio.lm.MoshiGen`
    takes: a Llama-style dict tree, loaded as :func:`load_llama` loads one."""
    return load_llama(params, device=device)


def _mimi_to_torch(model, path: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """A Flax Mimi leaf (path within ``model``) -> (parameter name, tensor in
    torch's layout)."""
    from wmar_tpu_torch.audio.mimi import CausalConvTranspose1d

    mod, name = path.rsplit(".", 1) if "." in path else ("", path)
    if name == "kernel":
        sub = model.get_submodule(mod)
        if isinstance(sub, CausalConvTranspose1d):
            t = t.flip(0).permute(1, 2, 0) if sub.groups == 1 else t.flip(0).permute(2, 1, 0)
        elif isinstance(sub, torch.nn.Linear):
            t = t.T
        else:
            t = t.permute(2, 1, 0)
        return f"{mod}.weight", t
    if name == "scale":
        return f"{mod}.weight", t
    return path, t


def mimi_state_dict(model, tree: Dict) -> Dict[str, torch.Tensor]:
    """A Flax Mimi tree (of ``model``, a :class:`wmar_tpu_torch.audio.mimi.
    Mimi` or one of its parts; numpy or tensor leaves, ``{"params": ...}``
    or the inner dict) as ``model``'s parameter names and torch layouts."""
    params = tree.get("params", tree)
    return dict(_mimi_to_torch(model, path, to_tensor(leaf)) for path, leaf in flatten(params))


@torch.no_grad()
def load_mimi(model, variables: Dict):
    """Copy Flax Mimi variables (``{"params": ...}`` or the inner dict; the
    JAX package's, a msgpack file's or :func:`wmar_tpu_torch.audio.mimi.
    convert_mimi`'s) into a :class:`wmar_tpu_torch.audio.mimi.Mimi` (or one
    of its parts), casting to its dtype: a conv ``kernel [K, I, O]`` becomes
    ``weight [O, I, K]``, a transposed conv's flipped ``kernel [K, I/g, O]``
    torch's ``[I, O/g, K]``, a dense ``kernel`` a Linear's ``weight.T``, a
    LayerNorm ``scale`` its ``weight``. Every tensor of the model needs a
    leaf."""
    own = dict(model.named_parameters())
    sd = mimi_state_dict(model, variables)
    for key, t in sd.items():
        if key not in own:
            raise KeyError(f"Flax leaf for {key} has no counterpart")
        if own[key].shape != t.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(own[key].shape)}")
        own[key].copy_(t)
    if set(sd) != set(own):
        raise KeyError(f"parameters without a Flax leaf: {sorted(set(own) - set(sd))[:5]}")
    return model


def mimi_tree(model) -> Dict:
    """The inverse of :func:`load_mimi`: ``model``'s parameters as the Flax
    tree (kernels ``[K, I, O]``, transposed ones flipped, dense ``[in,
    out]``, LayerNorm ``scale``), detached contiguous copies on their
    device. The finetune's delta files take this layout."""
    from wmar_tpu_torch.audio.mimi import CausalConvTranspose1d

    tree: Dict = {}
    for key, t in model.named_parameters():
        mod, name = key.rsplit(".", 1) if "." in key else ("", key)
        t = t.detach()
        if name == "weight":
            sub = model.get_submodule(mod)
            if isinstance(sub, CausalConvTranspose1d):
                name, t = "kernel", (t.permute(2, 0, 1) if sub.groups == 1 else t.permute(2, 1, 0)).flip(0)
            elif isinstance(sub, torch.nn.Linear):
                name, t = "kernel", t.T
            elif isinstance(sub, torch.nn.LayerNorm):
                name = "scale"
            else:
                name, t = "kernel", t.permute(2, 1, 0)
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        node[name] = t.clone(memory_format=torch.contiguous_format)
    return tree


def load_mimi_ft(wrapper, variables: Dict, trainable: Optional[Dict] = None):
    """A JAX ``MimiFTWrapper``'s state into the port's
    (:class:`wmar_tpu_torch.audio.finetune.MimiFTWrapper`): the frozen Mimi
    from its variables, each trainable part from ``trainable[part]`` (JAX's
    ``state.trainable``; a copy of the frozen part when omitted)."""
    load_mimi(wrapper.model, variables)
    params = variables.get("params", variables)
    for part, module in wrapper.trainable.items():
        load_mimi(module, (trainable or params)[part])
    return wrapper


def mimi_ft_tree(wrapper) -> Dict:
    """The trainable parts of the port's ``MimiFTWrapper`` as JAX's
    ``trainable`` tree ``{part: Flax tree}``."""
    return {part: mimi_tree(module) for part, module in wrapper.trainable.items()}


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
    casting to their dtype: a conv ``kernel`` (HWIO) becomes an OIHW
    ``weight``, a Dense ``kernel`` ``[in, out]`` a Linear's ``weight``.
    Every tensor of the model needs a leaf."""
    params = variables.get("params", variables)
    own = _flax_state(model)
    seen = set()
    for path, leaf in flatten(params):
        mod, name = path.rsplit(".", 1) if "." in path else ("", path)
        # read only, so a writable numpy leaf is taken without a copy (552.8M parameters for DiffPure's UNet)
        writable = isinstance(leaf, np.ndarray) and leaf.flags.writeable and leaf.flags.c_contiguous \
            and leaf.dtype.name != "bfloat16"
        t = torch.from_numpy(leaf) if writable else to_tensor(leaf)
        if name == "kernel":
            key, t = f"{mod}.weight", t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T  # HWIO -> OIHW, [in, out]
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


def packed_cache(kv, scale, head_dim: int, device=None, tp_groups: int = 1) -> PackedQuantKVCache:
    """A JAX ``PackedQuantKVCache``'s ``kv`` and ``scale`` as the port's cache."""
    return PackedQuantKVCache(to_tensor(kv, device=device), to_tensor(scale, device=device), head_dim, tp_groups)


def packed4_cache(kv, scale, head_dim: int, device=None, tp_groups: int = 1) -> Packed4QuantKVCache:
    """A JAX ``Packed4QuantKVCache``'s ``kv`` and ``scale`` as the port's cache."""
    return Packed4QuantKVCache(to_tensor(kv, device=device), to_tensor(scale, device=device), head_dim, tp_groups)


# ---------------------------------------------------------------------------
# Sync models: the JAX package's parameter trees <-> the port's state dicts
# ---------------------------------------------------------------------------
#
# A pair is (path in the JAX tree, state-dict key, kind): "conv" is an HWIO
# kernel against an OIHW weight, "lin" a [in, out] matrix against a Linear's
# [out, in] weight, "id" the same array. Integer path parts index lists
# (which a msgpack file holds as maps {"0": ...}).

_TO_TORCH = {"conv": lambda t: t.permute(3, 2, 0, 1), "lin": lambda t: t.T, "id": lambda t: t}
_TO_JAX = {"conv": lambda t: t.permute(2, 3, 1, 0), "lin": lambda t: t.T, "id": lambda t: t}


def _get(tree, path):
    for part in path:
        tree = tree[part] if isinstance(tree, (list, tuple)) else tree[str(part) if str(part) in tree else part]
    return tree


def _set(tree: dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _lists(tree):
    """Maps whose keys are 0..n-1 (ints) as lists, recursively."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return [_lists(tree[i]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def pairs_to_state_dict(tree, pairs) -> Dict[str, torch.Tensor]:
    return {key: _TO_TORCH[kind](to_tensor(_get(tree, path))).contiguous() for path, key, kind in pairs}


def state_dict_to_tree(sd: Dict[str, torch.Tensor], pairs) -> Dict:
    tree: Dict = {}
    for path, key, kind in pairs:
        _set(tree, path, _TO_JAX[kind](sd[key].detach()).contiguous())
    return _lists(tree)


def _nb(path, key):
    """A norm's scale and bias."""
    return [((*path, "scale"), f"{key}.weight", "id"), ((*path, "bias"), f"{key}.bias", "id")]


def _cv(path, key, bias=True, kind="conv", w="kernel", b="bias"):
    return [((*path, w), f"{key}.weight", kind)] + ([((*path, b), f"{key}.bias", "id")] if bias else [])


def syncseal_ref_pairs(unet_cfg, convnext_cfg, unet_prefix="embedder.unet.", cn_prefix="extractor."):
    """Pairs of ``wmar_tpu.sync.syncseal_models``'s ``unet`` / ``convnext``
    trees (under the roots "unet" and "convnext") and ``SyncSealRef``'s
    state dict (the released checkpoint's names)."""

    def res(path, key):
        key = unet_prefix + key
        return (_cv((*path, "conv1"), f"{key}.double_conv.0", bias=False) + _nb((*path, "norm1"), f"{key}.double_conv.1")
                + _cv((*path, "conv2"), f"{key}.double_conv.3", bias=False)
                + _nb((*path, "norm2"), f"{key}.double_conv.4") + _cv((*path, "res"), f"{key}.res_conv"))

    u = ("unet",)
    nlev = len(unet_cfg.z_channels_mults)
    pairs = res((*u, "inc"), "inc")
    for i in range(nlev - 1):
        pairs += _cv((*u, "downs", i, "down"), f"{unet_prefix}downs.{i}.down") + res((*u, "downs", i, "conv"),
                                                                                     f"downs.{i}.conv")
    for j in range(unet_cfg.num_blocks):
        pairs += res((*u, "bottleneck", j), f"bottleneck.model.{j}")
    for i in range(nlev - 1):
        blk = f"{unet_prefix}ups.{i}.up.upsample_block"
        pairs += (_cv((*u, "ups", i, "up", "conv"), f"{blk}.2", bias=False) + _nb((*u, "ups", i, "up", "ln"), f"{blk}.3")
                  + res((*u, "ups", i, "conv"), f"ups.{i}.conv"))
    pairs += _cv((*u, "outc"), f"{unet_prefix}outc")
    c, cn = ("convnext",), f"{cn_prefix}convnext."
    for i in range(len(convnext_cfg.depths)):
        conv, norm = (0, 1) if i == 0 else (1, 0)
        pairs += (_cv((*c, "downsample", i, "conv"), f"{cn}downsample_layers.{i}.{conv}")
                  + _nb((*c, "downsample", i, "norm"), f"{cn}downsample_layers.{i}.{norm}"))
    for i, depth in enumerate(convnext_cfg.depths):
        for j in range(depth):
            p, k = (*c, "stages", i, j), f"{cn}stages.{i}.{j}"
            pairs += (_cv((*p, "dwconv"), f"{k}.dwconv") + _nb((*p, "norm"), f"{k}.norm")
                      + _cv((*p, "pwconv1"), f"{k}.pwconv1", kind="lin", w="w", b="b")
                      + [((*p, "grn", "gamma"), f"{k}.grn.gamma", "id"), ((*p, "grn", "beta"), f"{k}.grn.beta", "id")]
                      + _cv((*p, "pwconv2"), f"{k}.pwconv2", kind="lin", w="w", b="b"))
    return pairs + _cv((*c, "head"), f"{cn_prefix}head.linear", kind="lin", w="w", b="b")


def syncseal_ref_state_dict(unet_params, convnext_params, unet_cfg=None, convnext_cfg=None):
    """JAX's ``init_unet_params`` / ``init_convnext_params`` trees (or
    ``SyncSealRef``'s msgpack file's "unet" and "convnext") as the state
    dict of the port's ``SyncSealRef``."""
    from wmar_tpu_torch.sync import syncseal_models as sm

    pairs = syncseal_ref_pairs(unet_cfg or sm.UNET_SMALL2_YUV, convnext_cfg or sm.CONVNEXT_TINY)
    return pairs_to_state_dict({"unet": unet_params, "convnext": convnext_params}, pairs)


def wam_pairs(vit_cfg, upscale_stages, prefix: str = "detector."):
    """Pairs of the detector half of JAX's ``convert_wam`` tree ("vit",
    "pixel_decoder") and ``WamExact``'s state dict (``wam_mit.pth``'s names;
    ``prefix=""`` gives the zoo's ``SegExtractor``)."""
    v, k = ("vit",), f"{prefix}image_encoder."
    pairs = _cv((*v, "patch_embed"), f"{k}patch_embed.proj") + [((*v, "pos_embed"), f"{k}pos_embed", "id")]
    for i in range(vit_cfg.depth):
        p, b = (*v, "blocks", i), f"{k}blocks.{i}."
        pairs += (_nb((*p, "norm1"), b + "norm1") + _nb((*p, "norm2"), b + "norm2")
                  + _cv((*p, "attn", "qkv"), b + "attn.qkv", kind="lin", w="w", b="b")
                  + _cv((*p, "attn", "proj"), b + "attn.proj", kind="lin", w="w", b="b")
                  + [((*p, "attn", "rel_pos_h"), b + "attn.rel_pos_h", "id"),
                     ((*p, "attn", "rel_pos_w"), b + "attn.rel_pos_w", "id")]
                  + _cv((*p, "mlp_lin1"), b + "mlp.lin1", kind="lin", w="w", b="b")
                  + _cv((*p, "mlp_lin2"), b + "mlp.lin2", kind="lin", w="w", b="b"))
    pairs += (_cv((*v, "neck0"), f"{k}neck.0", bias=False) + _nb((*v, "neck1"), f"{k}neck.1")
              + _cv((*v, "neck2"), f"{k}neck.2", bias=False) + _nb((*v, "neck3"), f"{k}neck.3"))
    d = f"{prefix}pixel_decoder."
    for si in range(len(upscale_stages)):
        pairs += (_cv(("pixel_decoder", si, "conv"), f"{d}output_upscaling.{si}.upsample_block.2", bias=False)
                  + _nb(("pixel_decoder", si, "ln"), f"{d}output_upscaling.{si}.upsample_block.3"))
    return pairs + _cv(("pixel_decoder", len(upscale_stages)), f"{d}last_layer")


def wam_state_dict(params, vit_cfg=None, upscale_stages=(4, 2, 2)) -> Dict[str, torch.Tensor]:
    """JAX's ``convert_wam`` / ``init_wam_params`` tree as the state dict of
    the port's ``WamExact``: the VAE through the Flax rules of
    :func:`load_flax` (``models/vqgan.py``'s names), the detector through
    :func:`wam_pairs`."""
    from wmar_tpu_torch.sync.wam_exact import SAM_BASE

    sd = pairs_to_state_dict(params, wam_pairs(vit_cfg or SAM_BASE, upscale_stages))
    sd["embedder.msg_processor.msg_embeddings.weight"] = to_tensor(params["msg_embeddings"])
    for part, tree in (("encoder", params["vae_encoder"]), ("decoder", params["vae_decoder"])):
        for key, t in flax_state_dict(tree).items():
            sd[f"embedder.{part}.{key}"] = t
    return sd


def seg_extractor_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """JAX's ``syncseal_zoo`` seg-extractor tree ("vit", "pixel_decoder") as
    the state dict of the port's ``SegExtractor``."""
    return pairs_to_state_dict(params, wam_pairs(cfg.vit, cfg.upscale_stages, prefix=""))


def vae_embedder_state_dict(params) -> Dict[str, torch.Tensor]:
    """JAX's ``syncseal_zoo`` VAE-embedder tree (Flax "encoder" and
    "decoder" params) as the state dict of the port's ``VAEEmbedder``."""
    sd = {}
    for part in ("encoder", "decoder"):
        for key, t in flax_state_dict(params[part]).items():
            sd[f"{part}.{key}"] = t
    return sd


def flax_state_dict(variables) -> Dict[str, torch.Tensor]:
    """A Flax conv/norm tree by the torch names :func:`load_flax` reads
    (conv ``kernel`` HWIO -> ``weight`` OIHW, ``scale`` -> ``weight``,
    BatchNorm ``mean``/``var`` -> ``running_*``)."""
    sd = {}
    for path, leaf in flatten(variables.get("params", variables)):
        mod, name = path.rsplit(".", 1) if "." in path else ("", path)
        t = to_tensor(leaf)
        if name == "kernel":
            name, t = "weight", t.permute(3, 2, 0, 1)
        sd[f"{mod + '.' if mod else ''}{_FLAX_TO_TORCH.get(name, name)}"] = t.contiguous()
    return sd


def syncseal_model_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """JAX ``SyncSealModel``'s tree (``{"embedder": {"params": ...},
    "extractor": {"params": ...}}``, as its ``save`` writes it) as the state
    dict of the port's ``SyncSealModel``: conv kernels HWIO -> OIHW, Dense
    kernels transposed, the attention's ``[dim, heads, head_dim]`` query /
    key / value and ``[heads, head_dim, dim]`` out kernels as Linear
    weights, LayerNorm ``scale`` -> ``weight``."""
    sd = {}
    for part in ("embedder", "extractor"):
        tree = flax_params[part]
        for path, leaf in flatten(tree.get("params", tree)):
            mod, name = path.rsplit(".", 1) if "." in path else ("", path)
            t = to_tensor(leaf)
            if name == "kernel":
                name = "weight"
                if t.dim() == 4:
                    t = t.permute(3, 2, 0, 1)
                elif t.dim() == 2:
                    t = t.T
                elif mod.endswith(".out"):
                    t = t.reshape(-1, t.shape[-1]).T
                else:
                    t = t.reshape(t.shape[0], -1).T
            elif name == "bias" and t.dim() == 2:  # query / key / value [heads, head_dim]
                t = t.reshape(-1)
            elif name == "scale":
                name = "weight"
            sd[f"{part}.{mod + '.' if mod else ''}{name}"] = t.contiguous()
    return sd


def discriminator_state_dict(params, n_layers: int = 3) -> Dict[str, torch.Tensor]:
    """JAX's SyncSeal discriminator list (``init_discriminator_params`` or
    ``convert_discriminator``: ``[{"conv"}, {"conv", "norm"} x n_layers,
    {"conv"}]``) as the state dict of the port's ``SyncSealDiscriminator``."""
    from wmar_tpu_torch.sync.syncseal_models import discriminator_conv_indices

    pairs = []
    for i, idx in enumerate(discriminator_conv_indices(n_layers)):
        pairs += _cv((i, "conv"), f"main.{idx}")
        if 0 < i <= n_layers:
            pairs += _nb((i, "norm"), f"main.{idx + 1}")
    return pairs_to_state_dict(params, pairs)


def hidden_state_dicts(enc_params, dec_params):
    """JAX's HiDDeN trees (``init_hidden_params`` / ``convert_hidden_*``) as
    the state dicts of the port's ``HiddenEncoder`` and ``HiddenDecoder``
    (the TorchScript blobs' names)."""

    def conv_bn(path, key):
        return (_cv((*path, "conv"), f"{key}.layers.0")
                + [((*path, "bn", "gamma"), f"{key}.layers.1.weight", "id"),
                   ((*path, "bn", "beta"), f"{key}.layers.1.bias", "id"),
                   ((*path, "bn", "mean"), f"{key}.layers.1.running_mean", "id"),
                   ((*path, "bn", "var"), f"{key}.layers.1.running_var", "id")])

    enc = [p for i in range(len(enc_params["conv_bns"])) for p in conv_bn(("conv_bns", i), f"conv_bns.{i}")]
    enc += conv_bn(("after_concat",), "after_concat_layer") + _cv(("final",), "final_layer")
    dec = [p for i in range(len(dec_params["layers"])) for p in conv_bn(("layers", i), f"layers.{i}")]
    dec += _cv(("linear",), "linear", kind="lin", w="w", b="b")
    return pairs_to_state_dict(enc_params, enc), pairs_to_state_dict(dec_params, dec)


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax chain's
    state, as a NamedTuple or as the dict a msgpack file holds."""
    if hasattr(opt_state, "mu") or (isinstance(opt_state, dict) and "mu" in opt_state):
        return opt_state
    parts = opt_state.values() if isinstance(opt_state, dict) else opt_state if isinstance(opt_state, tuple) else ()
    for part in parts:
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


@torch.no_grad()
def load_adam_state(opt: torch.optim.Optimizer, sched, named_params, opt_state, to_state_dict) -> int:
    """Carry an optax ``adam``/``adamw`` state into a torch Adam/AdamW:
    ``mu``/``nu`` become each parameter's ``exp_avg``/``exp_avg_sq`` (through
    ``to_state_dict``, the tree's map to the port's names), ``count`` its
    ``step`` and the ``LambdaLR``'s position. Returns the count."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    count = int(np.asarray(_field(adam, "count")))
    mu, nu = to_state_dict(_field(adam, "mu")), to_state_dict(_field(adam, "nu"))
    for name, p in named_params:
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name].to(p.device, p.dtype).clone(),
                        "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
    if sched is not None:
        sched.last_epoch = count
        for group, base, fn in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(count)
    return count


@torch.no_grad()
def load_ref_train_state(state, jax_state) -> None:
    """JAX's SyncSeal train state ``(params, opt_state, disc_params,
    disc_opt_state)`` (numpy leaves, or the dicts of its msgpack checkpoint)
    into the port's ``RefTrainState``: the UNet, the ConvNeXt and the
    discriminator, and both optimizers' Adam moments and counts."""
    params, opt_state, disc_params, disc_opt_state = (
        [jax_state[str(i)] for i in range(4)] if isinstance(jax_state, dict) else jax_state)
    m = state.model

    def model_sd(tree):
        return syncseal_ref_state_dict(tree["unet"], tree["convnext"], m.unet_cfg, m.convnext_cfg)

    def disc_sd(tree):
        return discriminator_state_dict(tree)

    m.load_state_dict(model_sd(params))
    state.disc.load_state_dict(disc_sd(disc_params))
    load_adam_state(state.opt, state.sched, m.named_parameters(), opt_state, model_sd)
    load_adam_state(state.opt_d, state.sched_d, state.disc.named_parameters(), disc_opt_state, disc_sd)


# ---------------------------------------------------------------------------
# Neural codecs (the attack bank): the JAX package's parameter trees -> modules
# ---------------------------------------------------------------------------


def _codec_set(module, name: str, value: torch.Tensor, path: str, device) -> None:
    cur = getattr(module, name)
    if cur is None:  # an optional leaf (a DC-AE norm's bias or BatchNorm statistics)
        value = value.to(device=device, dtype=torch.float32)
        if name in module._parameters:
            module._parameters[name] = torch.nn.Parameter(value, requires_grad=False)
        else:
            module._buffers[name] = value
        return
    if tuple(cur.shape) != tuple(value.shape):
        raise ValueError(f"{path}.{name}: shape {tuple(value.shape)} != {tuple(cur.shape)}")
    cur.copy_(value)


def _codec_leaves(module, tree: dict, want: Dict[str, Any], path: str, device) -> None:
    """Set ``module``'s tensors from ``want`` (name -> tensor) after checking
    that ``tree``'s keys are exactly those the module holds."""
    have = {k for k in ("weight", "bias") if getattr(module, k, None) is not None}
    if set(want) != have:
        raise KeyError(f"{path}: the tree gives {sorted(tree)}, the module holds {sorted(have)}")
    for name, value in want.items():
        _codec_set(module, name, value, path, device)


@torch.no_grad()
def load_codec_tree(module: torch.nn.Module, tree: Any, device=None, path: str = "codec") -> torch.nn.Module:
    """Copy a codec parameter tree of the JAX package (numpy or tensor
    leaves) into ``module``, whose child names follow the tree's keys and
    whose lists follow its lists: an HWIO ``kernel`` becomes a Conv2d's OIHW
    ``weight`` (a ConvTranspose2d's ``[I, O, kh, kw]``, unflipped: the tree
    holds it flipped for a dilated conv), a ``[K, I, O]`` one a Conv1d's or
    ConvTranspose1d's alike; an LSTM's list of ``{"w_ih", "w_hh", "b"}``
    its ``weight_*_l{k}`` and ``bias_ih_l{k}`` (``bias_hh`` zero: ``b`` is
    the sum of both); a ``[in, out]`` matrix (bare, or
    ``{"w", "b"}``) a Linear's weight; GroupNorm's ``scale`` its weight;
    other leaves keep their name and layout. Every tensor of the module
    needs a leaf (a module's ``OPTIONAL`` ones may be absent and become
    None) and every leaf a tensor: a mismatch raises ``KeyError``, a wrong
    shape ``ValueError``."""
    device = device or next(iter(module.parameters())).device
    nn = torch.nn
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)):
        k = to_tensor(tree["kernel"], torch.float32)
        sp = tuple(range(k.dim() - 2))  # the spatial dims lead: [*K, I, O]
        if isinstance(module, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            weight = k.flip(sp).permute(len(sp), len(sp) + 1, *sp)
        else:
            weight = k.permute(len(sp) + 1, len(sp), *sp)
        want = {"weight": weight, **({"bias": to_tensor(tree["bias"], torch.float32)} if "bias" in tree else {})}
        if set(tree) - {"kernel", "bias"}:
            raise KeyError(f"{path}: unexpected leaves {sorted(set(tree) - {'kernel', 'bias'})}")
        _codec_leaves(module, tree, want, path, device)
    elif isinstance(module, nn.LSTM):
        if len(tree) != module.num_layers:
            raise KeyError(f"{path}: {len(tree)} LSTM layers against {module.num_layers} in the module")
        for k, layer in enumerate(tree):  # {"w_ih" [in, 4H], "w_hh" [H, 4H], "b": b_ih + b_hh}
            b = to_tensor(layer["b"], torch.float32)
            for name, value in ((f"weight_ih_l{k}", to_tensor(layer["w_ih"], torch.float32).T),
                                (f"weight_hh_l{k}", to_tensor(layer["w_hh"], torch.float32).T),
                                (f"bias_ih_l{k}", b), (f"bias_hh_l{k}", torch.zeros_like(b))):
                _codec_set(module, name, value, f"{path}.{k}", device)
        module.flatten_parameters()
    elif isinstance(module, nn.Linear):
        w, b = (tree["w"], tree.get("b")) if isinstance(tree, dict) else (tree, None)
        want = {"weight": to_tensor(w, torch.float32).T, **({"bias": to_tensor(b, torch.float32)} if b is not None
                                                            else {})}
        _codec_leaves(module, tree if isinstance(tree, dict) else {"w": w}, want, path, device)
    elif isinstance(module, nn.GroupNorm):
        _codec_leaves(module, tree, {"weight": to_tensor(tree["scale"], torch.float32),
                                     "bias": to_tensor(tree["bias"], torch.float32)}, path, device)
    elif isinstance(tree, (list, tuple)):
        children = list(module) if not isinstance(module, nn.ParameterList) else None
        n = len(module)
        if len(tree) != n:
            raise KeyError(f"{path}: a list of {len(tree)} against {n} in the module")
        for i, sub in enumerate(tree):
            if children is None:
                _codec_set(module, str(i), to_tensor(sub, torch.float32), path, device)
            else:
                load_codec_tree(children[i], sub, device, f"{path}.{i}")
    else:
        children = dict(module.named_children())
        tensors = {**module._parameters, **module._buffers}
        unknown = sorted(set(tree) - set(children) - set(tensors))
        missing = sorted(set(children) - set(tree))
        missing += sorted(k for k, v in tensors.items() if v is not None and k not in tree
                          and k not in getattr(module, "OPTIONAL", ()))
        if unknown or missing:
            raise KeyError(f"{path}: tree leaves without a tensor {unknown[:5]}, tensors without a leaf {missing[:5]}")
        for key, sub in tree.items():
            if key in children:
                load_codec_tree(children[key], sub, device, f"{path}.{key}")
            else:
                _codec_set(module, key, to_tensor(sub, torch.float32), path, device)
        for key in getattr(module, "OPTIONAL", ()):
            if key not in tree:
                setattr(module, key, None)
    return module


def _codec_module(build, tree, device):
    """``build()`` on the meta device, then the tree's weights on ``device``
    (no random draw of torch's own first)."""
    with torch.device("meta"):
        model = build()
    return load_codec_tree(model.to_empty(device=device), tree, torch.device(device)).eval()


def load_compressai(arch: str, tree: Dict, device="cpu"):
    """The compressai module of ``arch`` at the tree's widths (N, M), from a
    tree of ``convert_compressai`` or ``init_compressai_params``."""
    from wmar_tpu_torch.augmentations import compressai_models as cm

    n, m = cm.tree_nm(arch, tree)
    return _codec_module(lambda: cm.FORWARDS[arch](n, m), tree, device)


def load_kl_vae(cfg, tree: Dict, device="cpu"):
    """An ``AutoencoderKL`` of ``cfg`` from a tree of ``convert_kl_vae`` or
    ``init_kl_vae_params``."""
    from wmar_tpu_torch.augmentations.diffusers_vae import AutoencoderKL

    return _codec_module(lambda: AutoencoderKL(cfg), tree, device)


def load_dcae(cfg, tree: Dict, device="cpu"):
    """A ``DCAE`` of ``cfg`` from a tree of ``convert_dcae`` or
    ``init_dcae_params``."""
    from wmar_tpu_torch.augmentations.dcae import DCAE

    return _codec_module(lambda: DCAE(cfg), tree, device)


def load_encodec(tree: Dict, cfg=None, device="cpu"):
    """An ``Encodec`` of ``cfg`` (default ``ENCODEC_24K``) from a tree of
    ``convert_encodec`` (the JAX package's or the port's)."""
    from wmar_tpu_torch.audio.codecs import ENCODEC_24K, Encodec

    return _codec_module(lambda: Encodec(cfg or ENCODEC_24K), tree, device)


def load_dac(tree: Dict, cfg=None, device="cpu"):
    """A ``DAC`` of ``cfg`` (default ``DAC_24K``) from a tree of ``convert_dac``."""
    from wmar_tpu_torch.audio.codecs import DAC, DAC_24K

    return _codec_module(lambda: DAC(cfg or DAC_24K), tree, device)


def load_audioseal(gen_tree: Dict, det_tree: Dict, cfg=None, device="cpu"):
    """An ``AudioSealModel`` of ``cfg`` (default ``AUDIOSEAL_16B``; a JAX
    ``AudioSealConfig`` is read by its fields) from the generator's and the
    detector's trees (``convert_audioseal_generator`` / ``_detector``)."""
    import dataclasses

    from wmar_tpu_torch.audio.audioseal import AUDIOSEAL_16B, AudioSealConfig, AudioSealModel

    cfg = AudioSealConfig(**dataclasses.asdict(cfg)) if cfg is not None else AUDIOSEAL_16B
    with torch.device("meta"):
        model = AudioSealModel(cfg)
    model = model.to_empty(device=device)
    load_codec_tree(model.generator, gen_tree, torch.device(device), "generator")
    load_codec_tree(model.detector, det_tree, torch.device(device), "detector")
    return model.eval()


def load_conditioners(conditioners: Dict, device="cpu") -> Dict:
    """``{name: (config, params)}`` of the JAX package's
    ``convert_conditioners`` / ``init_lut_params`` (numpy or JAX leaves, its
    ``LUTConditionerConfig``) as the port's: the config rebuilt from its
    fields, each leaf a float32 tensor on ``device``. Pass the result to
    ``ConditionProvider``."""
    import dataclasses

    from wmar_tpu_torch.audio.conditioners import LUTConditionerConfig

    return {name: (LUTConditionerConfig(**dataclasses.asdict(cfg)),
                   {k: to_tensor(v, torch.float32, device) for k, v in params.items()})
            for name, (cfg, params) in conditioners.items()}


# ---------------------------------------------------------------------------
# DiffPure's ADM UNet and the FID InceptionV3
# ---------------------------------------------------------------------------


def adm_unet_tree(model) -> Dict:
    """An ``ADMUNet``'s Flax tree (the inverse of :func:`load_adm_unet`):
    conv weights as HWIO ``kernel``, Linear weights as ``[in, out]``
    ``kernel``, GroupNorm weights as ``scale``. Leaves are tensors on the
    model's device (meta tensors for a model built on the meta device)."""
    tree: Dict = {}
    for key, t in model.state_dict(keep_vars=True).items():
        mod, name = key.rsplit(".", 1)
        t = t.detach()
        if name == "weight":
            name, t = ("kernel", t.permute(2, 3, 1, 0)) if t.dim() == 4 else ("kernel", t.T) if t.dim() == 2 \
                else ("scale", t)
        node = tree
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[name] = t.contiguous()
    return tree


@torch.no_grad()
def load_adm_unet(variables: Dict, cfg=None, device="cpu"):
    """An ``ADMUNet`` of ``cfg`` (default ``GUIDED_DIFFUSION_256_UNCOND``)
    on ``device`` from its Flax tree (``convert_adm_unet``'s output or a
    ``.msgpack``'s; numpy or tensor leaves), built on the meta device first
    so no weight is drawn. The attention's ``qkv`` keeps the tree's
    ``[q, k, v][head][head_dim]`` rows, the module's own layout."""
    from wmar_tpu_torch.augmentations.diffpure import GUIDED_DIFFUSION_256_UNCOND, ADMUNet

    with torch.device("meta"):
        model = ADMUNet(cfg or GUIDED_DIFFUSION_256_UNCOND)
    return load_flax(model.to_empty(device=device), variables).eval()


def load_inception(params: Dict, device="cpu"):
    """The FID InceptionV3 on ``device`` from the JAX package's converted
    tree (``convert_inception``: per BasicConv2d ``kernel`` HWIO, ``scale``,
    ``bias``, ``mean``, ``var``), at the tree's widths."""
    from wmar_tpu_torch.eval.fid import FIDInceptionV3

    names = {"kernel": "conv.weight", "scale": "bn.weight", "bias": "bn.bias", "mean": "bn.running_mean",
             "var": "bn.running_var"}
    sd = {}
    for path, leaf in flatten(params):
        prefix, name = path.rsplit(".", 1)
        t = to_tensor(leaf, torch.float32)
        sd[f"{prefix}.{names[name]}"] = t.permute(3, 2, 0, 1) if name == "kernel" else t
    return FIDInceptionV3.from_state_dict(sd, device)
