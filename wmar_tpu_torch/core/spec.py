"""Watermark configuration.

Mirrors the reference's watermark parameterization and its string encoding
(``wmar/watermarking/gentime_watermark.py:156-159,348-366`` in
facebookresearch/wmar): ``"{seed}-{split}-h={ctx}-d={delta}-g={gamma}"``,
e.g. ``"linear-stratifiedrand-h=1-d=2.0-g=0.25"``. The string form is the
cross-process / on-disk config format, so we keep it byte-compatible.
"""

from __future__ import annotations

import dataclasses
import enum


class SeedStrategy(str, enum.Enum):
    FIXED = "fixed"
    LINEAR = "linear"
    SPATIAL = "spatial"


class SplitStrategy(str, enum.Enum):
    RANDOM = "rand"
    RANDOM_STRATIFIED = "stratifiedrand"
    CLUSTERING = "clustering"


@dataclasses.dataclass(frozen=True)
class WatermarkSpec:
    """Static watermark hyperparameters.

    Attributes:
      vocab_size: size of the token space the logits cover (VQ codebook for
        Taming/RAR, full BPE vocab for Chameleon).
      seed_strategy: how the greenlist seed is derived from past tokens.
      split_strategy: how the vocab is split into green/red.
      context_size: ``h`` — number of context tokens hashed into the seed.
      delta: logit bias added to green tokens.
      gamma: green fraction of the vocab.
      spatial_dim: side of the token grid (16 for Taming/RAR, 32 Chameleon).
      salt_key: hash salt (reference default 15485863).
    """

    vocab_size: int
    seed_strategy: SeedStrategy
    split_strategy: SplitStrategy
    context_size: int
    delta: float
    gamma: float
    spatial_dim: int = 16
    salt_key: int = 15485863

    @property
    def greenlist_size(self) -> int:
        return int(self.vocab_size * self.gamma)

    def method_string(self) -> str:
        """Reference-compatible method string."""
        return (
            f"{self.seed_strategy.value}-{self.split_strategy.value}-"
            f"h={self.context_size}-d={self.delta:.1f}-g={self.gamma:.2f}"
        )

    def __str__(self) -> str:  # noqa: D105
        return self.method_string()

    @staticmethod
    def from_string(
        method: str,
        vocab_size: int,
        spatial_dim: int = 16,
        salt_key: int = 15485863,
    ) -> "WatermarkSpec":
        """Parse ``"linear-stratifiedrand-h=1-d=2.0-g=0.25"`` style strings."""
        parts = method.split("-")
        if len(parts) != 5:
            raise ValueError(f"Bad watermark method string: {method!r}")
        seed_strategy = SeedStrategy(parts[0])
        split_strategy = SplitStrategy(parts[1])
        context_size = int(parts[2].split("=")[1])
        delta = float(parts[3].split("=")[1])
        gamma = float(parts[4].split("=")[1])
        return WatermarkSpec(
            vocab_size=vocab_size,
            seed_strategy=seed_strategy,
            split_strategy=split_strategy,
            context_size=context_size,
            delta=delta,
            gamma=gamma,
            spatial_dim=spatial_dim,
            salt_key=salt_key,
        )

    def seed_for_context_sum(self, context_sum: int) -> int:
        """The reference's seed derivation: ``(salt * sum(ctx)) % (2^64-1)``.

        For all realistic vocab sizes and context lengths the product is far
        below ``2^64-1``, so the modulo never wraps and distinct context sums
        give distinct seeds. On device we therefore key greenlists by the
        context *sum* directly (an int32), and only expand to the full seed
        on the host (e.g. when building torch-parity tables).
        """
        return (self.salt_key * int(context_sum)) % (2**64 - 1)
