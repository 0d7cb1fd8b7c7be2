"""Greenlist sources: who is green for a given context? (PyTorch)

Port of ``wmar_tpu.core.greenlist``'s hash source. :class:`HashGreenlist`
computes membership as a stateless integer hash thresholded per token, for
the whole vocab in one ``[B, V]`` pass, with the same bits as the JAX
package. ``keys`` is always the context *sum*; strategy FIXED uses key 0.

Not ported yet (ROADMAP queue 1, item 1): the torch-compat tables
(``TableGreenlist``, ``build_table_torch_compat``) and the clustering split.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from wmar_tpu_torch.core.hashing import hash_key_token
from wmar_tpu_torch.core.spec import SeedStrategy, SplitStrategy, WatermarkSpec

_NOT_PORTED = (
    "not ported to wmar_tpu_torch yet: torch-compat tables and the clustering "
    "split are ROADMAP queue 1, item 1 (core/)"
)


def _thresholds_u32(spec: WatermarkSpec, alive_mask: Optional[np.ndarray]) -> np.ndarray:
    """Per-token uint32 green thresholds implementing the split strategy."""
    v = spec.vocab_size
    if spec.split_strategy == SplitStrategy.RANDOM or alive_mask is None:
        p = np.full((v,), spec.gamma, dtype=np.float64)
    elif spec.split_strategy == SplitStrategy.RANDOM_STRATIFIED:
        n_alive = int(alive_mask.sum())
        n_dead = v - n_alive
        n_green_alive = int(n_alive * spec.gamma)
        n_green_dead = spec.greenlist_size - n_green_alive
        p_alive = n_green_alive / max(n_alive, 1)
        p_dead = n_green_dead / max(n_dead, 1)
        p = np.where(alive_mask, p_alive, p_dead)
    else:
        raise ValueError(
            f"{spec.split_strategy} has no hash-threshold form; use a fixed mask"
        )
    return np.minimum(p * 2.0**32, 2.0**32 - 1).astype(np.uint32)


class HashGreenlist:
    """Stateless hash-based greenlist, held on ``device``."""

    def __init__(
        self,
        spec: WatermarkSpec,
        alive_mask: Optional[np.ndarray] = None,
        fixed_mask: Optional[np.ndarray] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        self.spec = spec
        self.device = torch.device(device)
        v = spec.vocab_size
        if spec.seed_strategy == SeedStrategy.FIXED:
            # one split for the whole stream: an exact-size greenlist ranked
            # by hash score scaled inversely to each token's rate
            if fixed_mask is None:
                thresholds = _thresholds_u32(spec, alive_mask)
                scores = hash_key_token(
                    torch.zeros((1, 1), dtype=torch.int64), torch.arange(v), spec.salt_key
                )[0].numpy().astype(np.float64)
                rel = scores / np.maximum(thresholds.astype(np.float64), 1.0)
                order = np.argsort(rel)
                fixed_mask = np.zeros((v,), dtype=bool)
                fixed_mask[order[: spec.greenlist_size]] = True
            self._fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=self.device)
            self._thresholds = None
        else:
            if fixed_mask is not None:
                raise ValueError("fixed_mask only valid with FIXED seed strategy")
            self._fixed_mask = None
            self._thresholds = torch.as_tensor(
                _thresholds_u32(spec, alive_mask).astype(np.int64), device=self.device
            )
        self._tokens = torch.arange(v, dtype=torch.int64, device=self.device)

    def green_mask(self, keys: torch.Tensor) -> torch.Tensor:
        """``[...]`` int context sums -> ``[..., V]`` bool green masks."""
        v = self.spec.vocab_size
        if self._fixed_mask is not None:
            return self._fixed_mask.expand(*keys.shape, v)
        bits = hash_key_token(keys[..., None], self._tokens, self.spec.salt_key)
        return bits < self._thresholds

    def green_lookup(self, keys: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Membership of individual (context-sum, target) pairs."""
        targets = targets.to(torch.int64)
        if self._fixed_mask is not None:
            return self._fixed_mask[targets]
        bits = hash_key_token(keys, targets, self.spec.salt_key)
        return bits < self._thresholds[targets]


class TableGreenlist:
    """Torch-compat packed-bit tables: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


def build_table_torch_compat(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED)


def clustering_greenlist(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED)


@dataclasses.dataclass
class VQInfo:
    """Codebook metadata the watermark needs. ``alive_ids`` are the codebook
    entries the generator actually uses."""

    vocab_size: int
    alive_ids: Optional[np.ndarray] = None
    embedding: Optional[np.ndarray] = None

    @property
    def alive_mask(self) -> Optional[np.ndarray]:
        if self.alive_ids is None:
            return None
        m = np.zeros((self.vocab_size,), dtype=bool)
        m[np.asarray(self.alive_ids, dtype=np.int64)] = True
        return m


def make_greenlist(
    spec: WatermarkSpec,
    vq: Optional[VQInfo] = None,
    torch_compat: bool = False,
    device: Union[str, torch.device] = "cpu",
) -> HashGreenlist:
    """The right greenlist source for ``spec``, on ``device``: the hash
    source, unless the spec or ``torch_compat`` asks for one that is not
    ported yet (called as the JAX package calls them)."""
    if spec.split_strategy == SplitStrategy.CLUSTERING:
        if vq is None or vq.embedding is None or vq.alive_ids is None:
            raise ValueError("clustering split needs VQInfo with embedding + alive_ids")
        return clustering_greenlist(spec, vq.embedding, vq.alive_ids)
    if torch_compat:
        return build_table_torch_compat(spec, vq.alive_ids if vq is not None else None)
    alive_mask = vq.alive_mask if vq is not None else None
    return HashGreenlist(spec, alive_mask=alive_mask, device=device)
