"""Reference PyTorch checkpoints -> the JAX package's parameter trees
(PyTorch port of ``wmar_tpu.utils.convert``).

Host-side, tensors in and tensors out. Each converter returns the tree its
JAX counterpart returns (same keys, shapes and dtypes), with tensors for
leaves, so :func:`wmar_tpu_torch.utils.checkpoint.save_pytree` writes the
bytes the JAX tool writes. Conventions:

* torch ``nn.Linear.weight [out, in]`` -> ``w [in, out]`` (transposed);
* torch ``nn.Conv2d.weight [O, I, kh, kw]`` -> flax ``kernel [kh, kw, I, O]``;
* torch norm ``weight/bias`` -> ``scale/bias``.

Leaves keep the source's dtype: a bfloat16 checkpoint converts to a
bfloat16 tree (the JAX loader turns every tensor into numpy, which has no
bfloat16, and raises on such a file).

Checkpoint layouts:

* Taming ``net2net.ckpt``: ``transformer.*`` (minGPT) and
  ``first_stage_model.*`` (VQGAN) in one state dict;
* standalone Taming / Chameleon VQGAN state dicts (``vqgan.ckpt``);
* MaskGit-VQGAN ``maskgit-vqgan-imagenet-f16-256.bin``;
* RAR generator ``rar_{b,l,xl,xxl}.bin``;
* Chameleon's tensor-parallel ``consolidated.{rank:02}.pth`` shards;
* the published RCC deltas (encoder / decoder-relative state dicts).

The Moshi converters live in :mod:`wmar_tpu_torch.audio.lm` and are
re-exported here under the JAX names.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from wmar_tpu_torch.audio.lm import (  # noqa: F401  (the JAX module's names)
    convert_moshi_depformer,
    convert_moshi_lm,
    convert_moshi_transformer,
)

StateDict = Mapping[str, torch.Tensor]

# safetensors dtype names -> numpy (BF16 goes through int16 -> torch.bfloat16)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.int16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as tensors: an 8-byte little-endian header
    length, a JSON header (name -> dtype, shape, byte offsets into the
    data that follows), then the raw little-endian buffers."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dt = info["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {dt}, which the reader does not know")
        dtype = np.dtype(_ST_DTYPES[dt]).newbyteorder("<")
        arr = np.frombuffer(data, dtype, count=(end - begin) // dtype.itemsize, offset=base + begin)
        t = torch.from_numpy(arr.astype(dtype.newbyteorder("="))).reshape(info["shape"])
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


def load_torch_state_dict(path: str, weights_only: bool = False) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict as CPU tensors in their own dtype (bfloat16
    included): ``.safetensors`` through :func:`read_safetensors`, else
    ``torch.load`` of a pickle, else a TorchScript archive's state dict (the
    released ``syncmodel.jit.pt``); a ``state_dict`` / ``model`` entry is
    unwrapped (Lightning checkpoints, Mimi's ``.pth``).

    A pickle is read with ``torch.load(weights_only=True)`` (tensors and
    plain containers, no code run) and only a file that holds more, such as
    a Lightning checkpoint's hyper-parameters, is unpickled in full, as the
    JAX reader does; ``weights_only=True`` refuses such a file instead
    (third-party files whose formats are plain state dicts)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if weights_only:
            raise
        sd = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:  # a TorchScript archive, which weights_only cannot read
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    if not isinstance(sd, dict):  # an eager module pickled whole
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _mat(x) -> torch.Tensor:
    """A torch ``[out, in]`` matrix as ``[in, out]``."""
    return _t(x).T.contiguous()


def _hwio(x) -> torch.Tensor:
    """A torch conv weight ``[O, I, kh, kw]`` as a flax kernel ``[kh, kw, I, O]``."""
    return _t(x).permute(2, 3, 1, 0).contiguous()


def _lin(sd: StateDict, prefix: str) -> dict:
    out = {"w": _mat(sd[prefix + ".weight"])}
    out["b"] = _t(sd[prefix + ".bias"]) if prefix + ".bias" in sd else torch.zeros(out["w"].shape[1],
                                                                                   dtype=out["w"].dtype)
    return out


def _ln(sd: StateDict, prefix: str) -> dict:
    return {"scale": _t(sd[prefix + ".weight"]), "bias": _t(sd[prefix + ".bias"])}


def _conv(sd: StateDict, prefix: str) -> dict:
    out = {"kernel": _hwio(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


_gn = _ln


# ---------------------------------------------------------------------------
# Taming minGPT
# ---------------------------------------------------------------------------


def convert_taming_gpt(sd: StateDict, cfg, prefix: str = "transformer.") -> dict:
    """``transformer.*`` of net2net.ckpt -> the ``taming_gpt`` tree."""
    p = prefix
    blocks = []
    for i in range(cfg.n_layer):
        bp = f"{p}blocks.{i}."
        blocks.append({
            "ln1": _ln(sd, bp + "ln1"),
            "ln2": _ln(sd, bp + "ln2"),
            "attn": {"q": _lin(sd, bp + "attn.query"), "k": _lin(sd, bp + "attn.key"),
                     "v": _lin(sd, bp + "attn.value"), "proj": _lin(sd, bp + "attn.proj")},
            "mlp": {"fc": _lin(sd, bp + "mlp.0"), "proj": _lin(sd, bp + "mlp.2")},
        })
    return {
        "tok_emb": _t(sd[p + "tok_emb.weight"]),
        "pos_emb": _t(sd[p + "pos_emb"])[0],
        "blocks": blocks,
        "ln_f": _ln(sd, p + "ln_f"),
        "head": _mat(sd[p + "head.weight"]),
    }


# ---------------------------------------------------------------------------
# Taming VQGAN
# ---------------------------------------------------------------------------


def _taming_resblock(sd: StateDict, tp: str, has_shortcut: bool) -> dict:
    out = {"GroupNorm_0": _gn(sd, tp + ".norm1"), "conv1": _conv(sd, tp + ".conv1"),
           "GroupNorm_1": _gn(sd, tp + ".norm2"), "conv2": _conv(sd, tp + ".conv2")}
    if has_shortcut:
        out["nin_shortcut"] = _conv(sd, tp + ".nin_shortcut")
    return out


def _taming_attn(sd: StateDict, tp: str) -> dict:
    return {"GroupNorm_0": _gn(sd, tp + ".norm"), "q": _conv(sd, tp + ".q"), "k": _conv(sd, tp + ".k"),
            "v": _conv(sd, tp + ".v"), "proj_out": _conv(sd, tp + ".proj_out")}


def _convert_taming_encoder(sd: StateDict, cfg, p: str) -> dict:
    out = {"conv_in": _conv(sd, p + "conv_in")}
    curr_res = cfg.resolution
    in_mult = (1,) + tuple(cfg.ch_mult)
    for i, mult in enumerate(cfg.ch_mult):
        block_in = cfg.ch * in_mult[i]
        block_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            out[f"down_{i}_block_{j}"] = _taming_resblock(sd, f"{p}down.{i}.block.{j}", block_in != block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                out[f"down_{i}_attn_{j}"] = _taming_attn(sd, f"{p}down.{i}.attn.{j}")
        if i != cfg.num_resolutions - 1:
            out[f"down_{i}_downsample"] = {"conv": _conv(sd, f"{p}down.{i}.downsample.conv")}
            curr_res //= 2
    out["mid_block_1"] = _taming_resblock(sd, p + "mid.block_1", False)
    out["mid_attn_1"] = _taming_attn(sd, p + "mid.attn_1")
    out["mid_block_2"] = _taming_resblock(sd, p + "mid.block_2", False)
    out["GroupNorm_0"] = _gn(sd, p + "norm_out")
    out["conv_out"] = _conv(sd, p + "conv_out")
    return out


def _convert_taming_decoder(sd: StateDict, cfg, p: str) -> dict:
    out = {"conv_in": _conv(sd, p + "conv_in")}
    block_in = cfg.ch * cfg.ch_mult[-1]
    out["mid_block_1"] = _taming_resblock(sd, p + "mid.block_1", False)
    out["mid_attn_1"] = _taming_attn(sd, p + "mid.attn_1")
    out["mid_block_2"] = _taming_resblock(sd, p + "mid.block_2", False)
    curr_res = cfg.codes_per_side
    for i in reversed(range(cfg.num_resolutions)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            out[f"up_{i}_block_{j}"] = _taming_resblock(sd, f"{p}up.{i}.block.{j}", block_in != block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                out[f"up_{i}_attn_{j}"] = _taming_attn(sd, f"{p}up.{i}.attn.{j}")
        if i != 0:
            out[f"up_{i}_upsample"] = {"conv": _conv(sd, f"{p}up.{i}.upsample.conv")}
            curr_res *= 2
    out["GroupNorm_0"] = _gn(sd, p + "norm_out")
    out["conv_out"] = _conv(sd, p + "conv_out")
    return out


def convert_taming_vqgan(sd: StateDict, cfg, prefix: str = "") -> dict:
    """A state dict (``first_stage_model.``-prefixed or not) -> the
    TamingVQGAN flax variables ``{"params": ...}``."""
    p = prefix
    return {"params": {
        "encoder": _convert_taming_encoder(sd, cfg, p + "encoder."),
        "decoder": _convert_taming_decoder(sd, cfg, p + "decoder."),
        "quantize": {"embedding": _t(sd[p + "quantize.embedding.weight"])},
        "quant_conv": _conv(sd, p + "quant_conv"),
        "post_quant_conv": _conv(sd, p + "post_quant_conv"),
    }}


# ---------------------------------------------------------------------------
# MaskGit VQGAN
# ---------------------------------------------------------------------------


def convert_maskgit_vqgan(sd: StateDict, cfg, prefix: str = "") -> dict:
    p = prefix
    enc = {"conv_in": _conv(sd, p + "encoder.conv_in")}
    in_mult = (1,) + tuple(cfg.channel_mult)
    for i, mult in enumerate(cfg.channel_mult):
        block_in = cfg.hidden_channels * in_mult[i]
        block_out = cfg.hidden_channels * mult
        for j in range(cfg.num_res_blocks):
            enc[f"down_{i}_block_{j}"] = _taming_resblock(sd, f"{p}encoder.down.{i}.block.{j}", block_in != block_out)
            block_in = block_out
    for j in range(cfg.num_res_blocks):
        enc[f"mid_block_{j}"] = _taming_resblock(sd, f"{p}encoder.mid.{j}", False)
    enc["GroupNorm_0"] = _gn(sd, p + "encoder.norm_out")
    enc["conv_out"] = _conv(sd, p + "encoder.conv_out")

    dec = {"conv_in": _conv(sd, p + "decoder.conv_in")}
    for j in range(cfg.num_res_blocks):
        dec[f"mid_block_{j}"] = _taming_resblock(sd, f"{p}decoder.mid.{j}", False)
    block_in = cfg.hidden_channels * cfg.channel_mult[-1]
    for i in reversed(range(cfg.num_resolutions)):
        block_out = cfg.hidden_channels * cfg.channel_mult[i]
        for j in range(cfg.num_res_blocks):
            dec[f"up_{i}_block_{j}"] = _taming_resblock(sd, f"{p}decoder.up.{i}.block.{j}", block_in != block_out)
            block_in = block_out
        if i != 0:
            dec[f"up_{i}_upsample_conv"] = _conv(sd, f"{p}decoder.up.{i}.upsample_conv")
    dec["GroupNorm_0"] = _gn(sd, p + "decoder.norm_out")
    dec["conv_out"] = _conv(sd, p + "decoder.conv_out")
    return {"params": {"encoder": enc, "decoder": dec, "embedding": _t(sd[p + "quantize.embedding.weight"])}}


# ---------------------------------------------------------------------------
# RAR
# ---------------------------------------------------------------------------


def convert_rar(sd: StateDict, cfg, prefix: str = "") -> dict:
    p = prefix
    blocks = []
    for i in range(cfg.depth):
        bp = f"{p}blocks.{i}."
        blocks.append({
            "norm1": _ln(sd, bp + "norm1"),
            "norm2": _ln(sd, bp + "norm2"),
            "attn": {"qkv": _lin(sd, bp + "attn.qkv"), "q_norm": _ln(sd, bp + "attn.q_norm"),
                     "k_norm": _ln(sd, bp + "attn.k_norm"), "proj": _lin(sd, bp + "attn.proj")},
            "mlp": {"fc1": _lin(sd, bp + "mlp.fc1"), "fc2": _lin(sd, bp + "mlp.fc2")},
            "adaln": _lin(sd, bp + "adaLN_modulation.1"),
        })
    return {
        "cls_token": _t(sd[p + "cls_token"]),
        "embeddings": _t(sd[p + "embeddings.weight"]),
        "pos_embed": _t(sd[p + "pos_embed"])[0],
        "target_aware_pos_embed": _t(sd[p + "target_aware_pos_embed"])[0],
        "timesteps_embeddings": _t(sd[p + "timesteps_embeddings"])[0],
        "blocks": blocks,
        "final_adaln": _lin(sd, p + "adaln_before_head.adaLN_modulation.1"),
        "lm_head": _lin(sd, p + "lm_head"),
    }


# ---------------------------------------------------------------------------
# Chameleon / Llama
# ---------------------------------------------------------------------------

_COLUMN_PARALLEL = (".wq.", ".wk.", ".wv.", ".w1.", ".w3.", "output.weight", "tok_embeddings")
_ROW_PARALLEL = (".wo.", ".w2.")


def merge_chameleon_shards(shards) -> Dict[str, torch.Tensor]:
    """One state dict from the tensor-parallel ``consolidated.{rank:02}.pth``
    shards (``deps/chameleon/inference/loader.py:37-71``).

    The published shards hold unfused attention and FFN weights (the
    reference fuses wq/wk/wv -> wqkv and w1/w3 -> w13 after loading).
    Column-parallel weights (wq, wk, wv, w1, w3, output, tok_embeddings)
    join on dim 0, row-parallel ones (wo, w2) on dim 1; norms are
    replicated and taken from the first shard. A pre-fused sharded
    ``wqkv`` / ``w13`` is regrouped per component before joining (equal
    thirds for ``wqkv``: 32 query and 32 key-value heads in the 7B).

    Each tensor is popped from the shards as it is joined, so the shards
    come back empty and the merge holds one copy of the weights, not two."""
    out = {}
    for key in list(shards[0]):
        parts = [_t(s.pop(key)) for s in shards]
        if len(parts) == 1:
            out[key] = parts[0]
        elif "wqkv" in key or "w13" in key:
            n = 3 if "wqkv" in key else 2
            groups = [torch.chunk(p, n, dim=0) for p in parts]
            out[key] = torch.cat([torch.cat([g[i] for g in groups], dim=0) for i in range(n)], dim=0)
        elif any(t in key for t in _COLUMN_PARALLEL):
            out[key] = torch.cat(parts, dim=0)
        elif any(t in key for t in _ROW_PARALLEL):
            out[key] = torch.cat(parts, dim=1)
        else:
            out[key] = parts[0]
    return out


def convert_chameleon_llama(sd: Dict[str, torch.Tensor], cfg) -> dict:
    """A Chameleon transformer state dict -> the ``models.llama`` tree, from
    the fused (wqkv / w13) or the unfused (wq/wk/wv, w1/w3) layout. Each
    tensor it uses is popped from ``sd`` as it is converted, so the source
    and the tree are not held whole at once (the 7B is ~13 GiB in bf16)."""
    d = cfg.dim
    kvd = cfg.kv_heads * cfg.head_dim
    take = sd.pop
    blocks = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        if p + "attention.wqkv.weight" in sd:
            wqkv = _t(take(p + "attention.wqkv.weight"))  # [d + 2 kvd, d]
            wq, wk, wv = wqkv[:d], wqkv[d:d + kvd], wqkv[d + kvd:]
            del wqkv
        else:
            wq, wk, wv = (_t(take(p + f"attention.w{x}.weight")) for x in "qkv")
        if p + "feed_forward.w13.weight" in sd:
            w1, w3 = torch.chunk(_t(take(p + "feed_forward.w13.weight")), 2, dim=0)
        else:
            w1, w3 = _t(take(p + "feed_forward.w1.weight")), _t(take(p + "feed_forward.w3.weight"))
        blk = {
            "attention_norm": _t(take(p + "attention_norm.weight")),
            "ffn_norm": _t(take(p + "ffn_norm.weight")),
            "wq": _mat(wq), "wk": _mat(wk), "wv": _mat(wv),
            "wo": _mat(take(p + "attention.wo.weight")),
            "w1": _mat(w1), "w3": _mat(w3),
            "w2": _mat(take(p + "feed_forward.w2.weight")),
        }
        del wq, wk, wv, w1, w3
        if cfg.qk_normalization:
            for name in ("q", "k"):
                blk[f"{name}_norm"] = {"scale": _t(take(p + f"attention.{name}_normalization.weight")),
                                       "bias": _t(take(p + f"attention.{name}_normalization.bias"))}
        blocks.append(blk)
    return {
        "tok_embeddings": _t(take("tok_embeddings.weight")),
        "blocks": blocks,
        "norm": _t(take("norm.weight")),
        "output": _mat(take("output.weight")),
    }


# ---------------------------------------------------------------------------
# RCC deltas (the reference's published finetune artifacts)
# ---------------------------------------------------------------------------


def _tree_sub(new, base):
    """``new - base`` leaf by leaf over a tree of dicts and lists."""
    if isinstance(new, dict):
        if set(new) != set(base):
            raise ValueError(f"trees differ: {sorted(new)} against {sorted(base)}")
        return {k: _tree_sub(new[k], base[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_tree_sub(a, b) for a, b in zip(new, base, strict=True))
    return new - base


def convert_vqgan_delta(base_sd: StateDict, delta_sd: StateDict, part: str, convert_fn,
                        stage_prefix: str = "") -> dict:
    """A reference RCC delta -> the delta tree of the converted ``part``
    subtree (``encoder`` or ``decoder``).

    The reference publishes finetunes as additive state-dict deltas with
    keys relative to the encoder / decoder (``wmar/utils/utils.py:215-227``).
    The result is ``convert(base + delta) - convert(base)``, exact for any
    converter, which ``checkpoint.load_and_apply_delta`` and ``generate
    --{encoder,decoder}_ft_ckpt`` take."""
    module_prefix = f"{stage_prefix}{part}."
    new_sd = dict(base_sd)
    for k, v in delta_sd.items():
        key = module_prefix + k
        if key not in base_sd:
            raise KeyError(f"delta key {k!r} has no base weight {key!r}")
        new_sd[key] = _t(base_sd[key]) + _t(v)
    return _tree_sub(convert_fn(new_sd)["params"][part], convert_fn(base_sd)["params"][part])
