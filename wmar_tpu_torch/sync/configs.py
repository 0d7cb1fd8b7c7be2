"""Loaders for the reference's SyncSeal YAML configs (PyTorch port of
``wmar_tpu.sync.configs``).

The reference's ``train_sync.py`` reads four YAML files
(``syncseal/configs/{embedder,extractor,attenuation,all_augs}.yaml``); each
maps onto the port's own:

* embedder.yaml -> ``syncseal_models.UNetConfig`` or ``syncseal_zoo.
  VAEEmbedderConfig`` (train_sync.py:69);
* extractor.yaml -> ``syncseal_models.ConvNeXtConfig`` or ``syncseal_zoo.
  SegExtractorConfig`` (train_sync.py:71);
* attenuation.yaml -> a check of the JND variant (train_sync.py:73; the
  shipped model's ``jnd_1_1`` is the one ``SyncSealRef.embed01`` applies);
* all_augs.yaml -> per-family sampling weights of the in-training
  valuemetric bank and the geometric corner sampler (train_sync.py:81).

The machines the port runs on may have no PyYAML, so :func:`parse_yaml`
reads the subset these files use: block maps by indentation, plain and
quoted scalars resolved as ``yaml.safe_load`` resolves them (``null``,
YAML 1.1 booleans, integers, floats with a dot), flow lists and comments.
Anything else (block lists, flow maps, anchors, tags, block scalars,
several documents) raises rather than being guessed at.

As in JAX, the trainer draws exactly one valuemetric and one geometric
attack per image (the reference composes several); the weights steer both.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Tuple

import numpy as np

# yaml.SafeLoader's implicit resolvers (YAML 1.1)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_OTHER_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_OTHER_FLOAT = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_UNSUPPORTED_START = ("&", "*", "!", "|", ">", "{", "%", "@", "`", "- ", "? ")


class YAMLSubsetError(ValueError):
    """A construct outside the subset :func:`parse_yaml` reads."""


def _scalar(text: str, where: str) -> Any:
    t = text.strip()
    if t.startswith(_UNSUPPORTED_START) or t == "-":
        raise YAMLSubsetError(f"{where}: unsupported YAML construct {t!r}")
    if t[:1] in ("'", '"'):
        q = t[0]
        if len(t) < 2 or t[-1] != q or (q == '"' and "\\" in t) or (q == "'" and "''" in t[1:-1]) \
                or q in t[1:-1]:
            raise YAMLSubsetError(f"{where}: unsupported quoted scalar {t!r}")
        return t[1:-1]
    if _NULL.match(t):
        return None
    if _BOOL.match(t):
        return t.lower() in ("yes", "true", "on")
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        low = t.lower().replace("_", "")
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float("nan") if low.endswith("nan") else float(low)
    if _OTHER_INT.match(t) or _OTHER_FLOAT.match(t):
        raise YAMLSubsetError(f"{where}: unsupported number form {t!r}")
    if ": " in t or t.endswith(":") or " #" in t:
        raise YAMLSubsetError(f"{where}: unsupported plain scalar {t!r}")
    return t


def _flow_list(text: str, where: str) -> List[Any]:
    """``[a, b, [c, d]]`` of scalars and nested flow lists."""
    pos = 0

    def parse_list():
        nonlocal pos
        assert text[pos] == "["
        pos += 1
        items, item = [], ""
        while pos < len(text):
            ch = text[pos]
            if ch == "[":
                if item.strip():
                    raise YAMLSubsetError(f"{where}: malformed flow list {text!r}")
                items.append(parse_list())
                item = None
                continue
            if ch in ",]":
                if item is not None and item.strip():
                    items.append(_scalar(item, where))
                elif item is not None and ch == "," :
                    raise YAMLSubsetError(f"{where}: empty flow-list entry in {text!r}")
                pos += 1
                if ch == "]":
                    return items
                item = ""
                continue
            if ch in "{'\"":
                raise YAMLSubsetError(f"{where}: unsupported flow-list content {text!r}")
            if item is None:
                if not ch.isspace():
                    raise YAMLSubsetError(f"{where}: malformed flow list {text!r}")
            else:
                item += ch
            pos += 1
        raise YAMLSubsetError(f"{where}: unterminated flow list {text!r}")

    out = parse_list()
    if text[pos:].strip():
        raise YAMLSubsetError(f"{where}: text after a flow list {text!r}")
    return out


def _value(text: str, where: str) -> Any:
    t = text.strip()
    return _flow_list(t, where) if t.startswith("[") else _scalar(t, where)


def _strip_comment(line: str) -> str:
    """The line without its comment: ``#`` at the start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, where: str = "<yaml>") -> Any:
    """The subset of YAML described in the module docstring, as
    ``yaml.safe_load`` gives it; an empty document is None."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YAMLSubsetError(f"{where}:{n}: tab indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            raise YAMLSubsetError(f"{where}:{n}: document markers and directives are unsupported")
        lines.append((n, len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    pos = 0

    def parse_map(indent: int) -> dict:
        nonlocal pos
        out = {}
        while pos < len(lines):
            n, ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(f"{where}:{n}: unexpected indentation")
            m = re.match(r"^([^\s\[\]{},#'\"&*!|>%@`-][^:#]*?|-[^\s:#][^:#]*?)\s*:(?:\s+(.*))?$", body)
            if not m:
                raise YAMLSubsetError(f"{where}:{n}: not a 'key: value' line: {body!r}")
            key = _scalar(m.group(1), f"{where}:{n}")
            rest = m.group(2)
            pos += 1
            if rest is None or not rest.strip():
                if pos < len(lines) and lines[pos][1] > ind:
                    out[key] = parse_map(lines[pos][1])
                else:
                    out[key] = None
            else:
                out[key] = _value(rest, f"{where}:{n}")
        return out

    if not re.match(r"^[^:]*:(\s|$)", lines[0][2]) or lines[0][2].startswith("["):
        if len(lines) == 1:
            return _value(lines[0][2], where)
        raise YAMLSubsetError(f"{where}: the document is not a block map")
    result = parse_map(lines[0][1])
    if pos != len(lines):
        raise YAMLSubsetError(f"{where}:{lines[pos][0]}: unexpected indentation")
    return result


def _load_yaml(path: str) -> Any:
    with open(path) as f:
        return parse_yaml(f.read(), path)


def load_embedder_config(path: str):
    """embedder.yaml -> the registry config of the entry the top-level
    ``model:`` key names (matched by prefix as the reference's builder, so
    ``unet_small2_yuv_quant`` resolves ``unet_small2_yuv_quantizable``):
    ``vae*`` -> :class:`~wmar_tpu_torch.sync.syncseal_zoo.VAEEmbedderConfig`,
    ``unet*`` -> :class:`~wmar_tpu_torch.sync.syncseal_models.UNetConfig`
    (``embedder.py:99-110``)."""
    from wmar_tpu_torch.sync.syncseal_models import UNetConfig

    d = _load_yaml(path)
    name = d.get("model", "unet_small2_yuv")
    entry = d.get(name)
    if entry is None:
        matches = [k for k in d if k != "model" and isinstance(d[k], dict)
                   and (k.startswith(name) or name.startswith(k))]
        if not matches:
            raise ValueError(f"{path}: no model entry matching {name!r}")
        name = matches[0]
        entry = d[name]
    if name.startswith("vae") or ("encoder" in entry and "decoder" in entry):
        from wmar_tpu_torch.sync.syncseal_zoo import vae_embedder_config

        return vae_embedder_config(entry, name)
    if not name.startswith("unet") and not ({"z_channels", "num_blocks", "z_channels_mults"} & set(entry)):
        raise NotImplementedError(f"{path}: embedder {name!r} not in the registry "
                                  "(embedder.py:99-110 knows vae* and unet*)")
    act = entry.get("activation", "gelu")
    norm = entry.get("normalization", "group")
    if act not in ("gelu", "relu") or norm not in ("group", "batch"):
        raise NotImplementedError(f"{path}: {name} uses activation={act}/normalization={norm}; implemented: "
                                  "gelu/relu x group/batch (unet_small2_yuv and its quantizable variant)")
    return UNetConfig(
        in_channels=int(entry.get("in_channels", 1)),
        out_channels=int(entry.get("out_channels", 1)),
        z_channels=int(entry.get("z_channels", 16)),
        num_blocks=int(entry.get("num_blocks", 8)),
        z_channels_mults=tuple(entry.get("z_channels_mults", (1, 2, 4, 8))),
        last_tanh=bool(entry.get("last_tanh", True)),
        activation=act,
        normalization=norm,
    )


def load_extractor_config(path: str, img_size: int = 256):
    """extractor.yaml -> ``convnext*`` -> :class:`~wmar_tpu_torch.sync.
    syncseal_models.ConvNeXtConfig`, ``sam*`` -> :class:`~wmar_tpu_torch.
    sync.syncseal_zoo.SegExtractorConfig` at ``img_size``, as the reference
    forces it (``extractor.py:99-110``)."""
    from wmar_tpu_torch.sync.syncseal_models import ConvNeXtConfig

    d = _load_yaml(path)
    name = d.get("model", "convnext_tiny")
    entry = d[name]
    if name.startswith("sam") or "pixel_decoder" in entry:
        from wmar_tpu_torch.sync.syncseal_zoo import seg_extractor_config

        return seg_extractor_config(entry, img_size=img_size)
    if not name.startswith("convnext") and not ({"encoder", "head"} & set(entry)):
        raise NotImplementedError(f"{path}: extractor {name!r} not in the registry "
                                  "(extractor.py:99-110 knows convnext* and sam*)")
    enc = entry.get("encoder", {})
    head = entry.get("head", {})
    return ConvNeXtConfig(depths=tuple(enc.get("depths", (3, 3, 9, 3))),
                          dims=tuple(enc.get("dims", (96, 192, 384, 768))),
                          out_dim=int(head.get("out_dim", 8)))


def load_attenuation_config(path: str, name: str = "jnd_1_1") -> Tuple[int, int]:
    """attenuation.yaml -> (in_channels, out_channels) of the JND variant
    ``name``. Only ``jnd_1_1`` (the luminance heatmap on the Y delta, the
    shipped model's) is what ``SyncSealRef.embed01`` applies: others raise."""
    d = _load_yaml(path)
    if name not in d:
        raise ValueError(f"{path}: no attenuation entry {name!r}")
    io = (int(d[name].get("in_channels", 1)), int(d[name].get("out_channels", 1)))
    if io != (1, 1):
        raise NotImplementedError(f"attenuation {name} = jnd_{io[0]}_{io[1]}: embed01 implements jnd_1_1 "
                                  "(the shipped model's variant)")
    return io


# the families of syncseal.valuemetric_branches(), in its order (the two
# jpeg strengths share the yaml's 'jpeg' weight)
_VALUEMETRIC_NAMES = ("identity", "jpeg", "jpeg", "gaussian_blur", "median_filter", "brightness", "contrast",
                      "saturation", "hue", "gaussian_noise", "grayscale")
# syncseal.GEOMETRIC_FAMILIES, in the yaml's names
_GEOMETRIC_NAMES = ("identity", "rotate", "crop", "perspective", "hflip")


@dataclasses.dataclass(frozen=True)
class AugWeights:
    valuemetric: Tuple[float, ...]  # probabilities over valuemetric_branches()
    geometric: Tuple[float, ...]  # probabilities over sample_geometric_corners' families


def load_augs_config(path: Optional[str]) -> Optional[AugWeights]:
    """all_augs.yaml's ``augs:`` weights -> normalized sampling
    probabilities of the two samplers. Families the yaml does not name get
    weight 0; names the banks do not hold are ignored (the reference's
    getattr builder); identity weighs on both samplers."""
    if path is None:
        return None
    augs = (_load_yaml(path) or {}).get("augs") or {}

    def probs(names):
        w = np.asarray([float(augs.get(n, 0.0)) for n in names], np.float64)
        for n in set(names):
            idx = [i for i, m in enumerate(names) if m == n]
            if len(idx) > 1:
                w[idx] /= len(idx)
        if w.sum() <= 0:
            raise ValueError(f"{path}: all aug weights for {names} are zero")
        return tuple(w / w.sum())

    return AugWeights(valuemetric=probs(_VALUEMETRIC_NAMES), geometric=probs(_GEOMETRIC_NAMES))


def load_dataset_config(path: str) -> dict:
    """configs/datasets/*.yaml -> ``{train_dir, val_dir, ...}``
    (train_sync.py:59; the annotation files pass through)."""
    d = _load_yaml(path)
    if not isinstance(d, dict) or "train_dir" not in d:
        raise ValueError(f"{path}: dataset yaml needs a train_dir key")
    return d
