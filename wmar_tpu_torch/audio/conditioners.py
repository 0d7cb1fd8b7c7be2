"""Moshi's conditioners: LUT conditioners and the sum fuser (PyTorch).

Port of ``wmar_tpu.audio.conditioners``, the counterpart of the
reference's ``wmar_audio/moshi/conditioners/{base,text}.py``. Moshi v0.1
ships without conditioners, but its LM adds ``fuser.get_sum(conditions)``
to the temporal input every frame: :meth:`ConditionFuser.get_sum` gives
the ``condition_sum`` that :meth:`wmar_tpu_torch.audio.lm.MoshiGen.
generate_with_inputs` takes.

* :func:`hash_trick` and :func:`tokenize_lut`: one token per attribute
  value (sha256 of the word, or its index in ``possible_values``); ``None``
  is the pad index with an empty mask.
* :func:`lut_condition`: the lookup, a bias-free projection, then a masked
  blend with ``learnt_padding``.
* :class:`ConditionProvider` evaluates named conditioners together;
  :class:`ConditionFuser` sums them (``prepend`` and ``cross`` raise, as
  in the reference); :func:`cfg_pair` stacks the conditioned batch and its
  null condition for classifier-free guidance.

:func:`convert_conditioners` reads the released layout
``condition_provider.conditioners.{name}.{embed.weight, output_proj.weight,
learnt_padding}``; :func:`wmar_tpu_torch.bridge.load_conditioners` takes
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def hash_trick(word: str, vocab_size: int) -> int:
    """sha256-based word hashing (``conditioners/text.py:34-45``)."""
    return int(hashlib.sha256(word.encode("utf-8")).hexdigest(), 16) % vocab_size


@dataclasses.dataclass(frozen=True)
class LUTConditionerConfig:
    n_bins: int
    dim: int
    output_dim: int
    possible_values: Optional[Tuple[str, ...]] = None  # None: hash_trick
    learn_padding: bool = True

    @property
    def pad_idx(self) -> int:
        return self.n_bins


def init_lut_params(generator: torch.Generator, cfg: LUTConditionerConfig) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device: the embedding N(0, 1),
    the projection N(0, 1 / dim) as ``[dim, output_dim]``, the padding 0.2
    N(0, 1)."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    p = {"embed": randn(cfg.n_bins + 1, cfg.dim), "output_proj": randn(cfg.dim, cfg.output_dim) / cfg.dim ** 0.5}
    if cfg.learn_padding:
        p["learnt_padding"] = 0.2 * randn(1, 1, cfg.output_dim)
    return p


def tokenize_lut(cfg: LUTConditionerConfig, texts: Sequence[Optional[str]], device=None):
    """NoopTokenizer semantics: (tokens ``[B, 1]`` int64, mask ``[B, 1]`` bool)."""
    tokens, lengths = [], []
    for text in texts:
        if text is None:
            tokens.append(cfg.pad_idx)
            lengths.append(0)
        elif cfg.possible_values is None:
            tokens.append(hash_trick(text, cfg.n_bins))
            lengths.append(1)
        else:
            if text not in cfg.possible_values:
                raise ValueError(f"{text!r} is not in possible_values {cfg.possible_values}")
            tokens.append(cfg.possible_values.index(text))
            lengths.append(1)
    return (torch.tensor(tokens, dtype=torch.int64, device=device)[:, None],
            torch.tensor(lengths, dtype=torch.int64, device=device)[:, None] > 0)


def lut_condition(params: Dict[str, torch.Tensor], tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tokens ``[B, 1]`` -> the condition ``[B, 1, output_dim]``: embed,
    project, blend with the learnt padding where the mask is off."""
    cond = params["embed"][tokens] @ params["output_proj"]
    maskf = mask.to(cond.dtype)[..., None]
    if "learnt_padding" in params:
        return cond * maskf + params["learnt_padding"] * (1 - maskf)
    return cond * maskf


class ConditionProvider:
    """Named conditioners ``{name: (config, params)}`` evaluated together."""

    def __init__(self, conditioners: Dict[str, Tuple[LUTConditionerConfig, dict]]):
        self.conditioners = conditioners

    def condition_tensors(self, attributes: Sequence[Dict[str, Optional[str]]]
                          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Per-sample ``{attribute: value}`` dicts -> ``{name: (condition,
        mask)}``; every conditioner must receive its attribute."""
        out = {}
        for name, (cfg, params) in self.conditioners.items():
            texts = []
            for sample in attributes:
                if name not in sample:
                    raise RuntimeError(f"conditioner {name!r} did not receive an input")
                texts.append(sample[name])
            tokens, mask = tokenize_lut(cfg, texts, params["embed"].device)
            out[name] = (lut_condition(params, tokens, mask), mask)
        return out


class ConditionFuser:
    """The sum fuser; ``prepend`` and ``cross`` raise as in the reference."""

    def __init__(self, fuse2cond: Dict[str, List[str]]):
        for method, conds in fuse2cond.items():
            if method not in ("sum", "prepend", "cross"):
                raise ValueError(f"invalid fuse method {method}")
            if method in ("prepend", "cross") and conds:
                raise RuntimeError("only `sum` conditionings are supported for now.")
        self.fuse2cond = {"sum": [], "prepend": [], "cross": [], **fuse2cond}

    @property
    def has_conditions(self) -> bool:
        return any(self.fuse2cond.values())

    def get_sum(self, conditions) -> Optional[torch.Tensor]:
        """The sum ``[B, 1, D]`` of the ``sum`` conditions (None without any)."""
        total = None
        for name in self.fuse2cond["sum"]:
            cond, _ = conditions[name]
            if cond.shape[1] != 1:
                raise ValueError(f"condition {name!r}: shape {tuple(cond.shape)}, one step expected")
            total = cond if total is None else total + cond
        return total


def cfg_pair(attributes: Sequence[Dict[str, Optional[str]]]):
    """The batch and its null condition (every attribute ``None``) stacked,
    for classifier-free guidance (``ClassifierFreeGuidanceDropout`` at p=1)."""
    return list(attributes) + [{k: None for k in sample} for sample in attributes]


def convert_conditioners(sd, dims: Dict[str, LUTConditionerConfig], prefix: str = "condition_provider.conditioners."
                         ) -> Dict[str, Tuple[LUTConditionerConfig, dict]]:
    """The released layout -> ``{name: (config, float32 CPU params)}`` for
    :class:`ConditionProvider`; ``dims`` gives each conditioner's tokenizer
    config (the weights do not hold it)."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32)

    out = {}
    for name, cfg in dims.items():
        p = {"embed": t(sd[f"{prefix}{name}.embed.weight"]),
             "output_proj": t(sd[f"{prefix}{name}.output_proj.weight"]).T.contiguous()}
        if f"{prefix}{name}.learnt_padding" in sd:
            p["learnt_padding"] = t(sd[f"{prefix}{name}.learnt_padding"])
        out[name] = (cfg, p)
    return out
