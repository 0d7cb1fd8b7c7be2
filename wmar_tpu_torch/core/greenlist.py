"""Greenlist sources: who is green for a given context? (PyTorch)

Port of ``wmar_tpu.core.greenlist``. Two sources run on the device inside
the sampler (``green_mask``) and detection (``green_lookup``), with the
same bits as the JAX package:

* :class:`HashGreenlist`: membership is a stateless integer hash
  thresholded per token, for the whole vocab in one ``[B, V]`` pass; a
  FIXED strategy holds one exact-size mask (the clustering split too).
* :class:`TableGreenlist`: the reference's own greenlists, bit for bit, in
  a packed-bit table ``[n_keys, ceil(V / 32)]`` built on the host with
  torch's CPU ``randperm`` (``build_table_torch_compat``). The reference
  seeds with ``salt * sum(ctx)``, so the context sum indexes the table.

:class:`LazyTorchCompatGreenlist` builds the same rows on demand for
host-side detection where a table would be too large (Chameleon's 65,536
codes). ``keys`` is always the context *sum*; strategy FIXED uses key 0.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np
import torch

from wmar_tpu_torch.core.hashing import hash_key_token
from wmar_tpu_torch.core.ngrams import extract_ngrams
from wmar_tpu_torch.core.spec import SeedStrategy, SplitStrategy, WatermarkSpec


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
    """Packed-bit greenlist table keyed by context sum (torch-compat mode),
    held on ``device``."""

    def __init__(self, spec: WatermarkSpec, packed_table: np.ndarray, device: Union[str, torch.device] = "cpu"):
        """``packed_table``: uint32 ``[n_keys, ceil(V/32)]``; bit ``t % 32`` of
        word ``t // 32`` of row ``k`` says whether token ``t`` is green for
        context sum ``k``. FIXED strategies use a 1-row table. The words are
        held as int32 (torch's ``uint32`` has no ``>>`` on the CPU and few
        ops on CUDA) and unpacked with ``(w >> s) & 1``."""
        self.spec = spec
        self.device = torch.device(device)
        words = np.ascontiguousarray(packed_table, dtype=np.uint32).view(np.int32)
        self._table = torch.from_numpy(words).to(self.device)
        self.n_keys = packed_table.shape[0]
        self._shifts = torch.arange(32, dtype=torch.int32, device=self.device)

    def _keys(self, keys: torch.Tensor) -> torch.Tensor:
        if self.spec.seed_strategy == SeedStrategy.FIXED:
            keys = torch.zeros_like(keys)
        return keys.to(torch.int64).clamp(0, self.n_keys - 1)

    def green_mask(self, keys: torch.Tensor) -> torch.Tensor:
        """``[...]`` int context sums -> ``[..., V]`` bool green masks."""
        rows = self._table[self._keys(keys)]  # [..., W]
        bits = (rows[..., :, None] >> self._shifts) & 1  # [..., W, 32]
        return bits.reshape(*rows.shape[:-1], -1)[..., : self.spec.vocab_size].to(torch.bool)

    def green_lookup(self, keys: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Membership of individual (context-sum, target) pairs."""
        targets = targets.to(torch.int64)
        word = self._table[self._keys(keys), targets // 32]
        return ((word >> (targets % 32).to(torch.int32)) & 1).to(torch.bool)


# ---------------------------------------------------------------------------
# Tables built on the host
# ---------------------------------------------------------------------------


def pack_bool_rows(mask: np.ndarray) -> np.ndarray:
    """``[N, V]`` bool -> ``[N, ceil(V/32)]`` uint32, little-endian bits."""
    n, v = mask.shape
    pad = (-v) % 32
    if pad:
        mask = np.concatenate([mask, np.zeros((n, pad), dtype=bool)], axis=1)
    return np.packbits(mask, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def _split_ids(spec: WatermarkSpec, rng: torch.Generator, alive: Optional[np.ndarray],
               dead: Optional[np.ndarray]) -> np.ndarray:
    """The reference's split for one seeded generator (``alive``/``dead``
    given for the stratified split)."""
    if spec.split_strategy == SplitStrategy.RANDOM:
        return torch.randperm(spec.vocab_size, generator=rng).numpy()[: spec.greenlist_size].copy()
    if spec.split_strategy == SplitStrategy.RANDOM_STRATIFIED:
        alive_shuf = alive[torch.randperm(len(alive), generator=rng).numpy()]
        dead_shuf = dead[torch.randperm(len(dead), generator=rng).numpy()]
        n_green_alive = int(len(alive) * spec.gamma)
        n_green_dead = spec.greenlist_size - n_green_alive
        return np.concatenate([alive_shuf[:n_green_alive], dead_shuf[:n_green_dead]])
    raise ValueError(f"No torch-compat builder for {spec.split_strategy}")


def _alive_dead(spec: WatermarkSpec, alive_ids) -> tuple:
    if spec.split_strategy != SplitStrategy.RANDOM_STRATIFIED:
        return None, None
    if alive_ids is None:
        raise ValueError("stratifiedrand needs alive_ids")
    alive = np.asarray(alive_ids, dtype=np.int64)
    return alive, np.setdiff1d(np.arange(spec.vocab_size, dtype=np.int64), alive)


def greenlist_ids_torch_compat(spec: WatermarkSpec, seed: int, alive_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Greenlist ids for one seed, bit-identical to the reference's
    ``GentimeWatermark._split_with_seed``: torch's CPU Mersenne Twister,
    seeded as the reference seeds it. Always a CPU generator and a CPU
    ``randperm``: a CUDA ``randperm`` gives other permutations."""
    if spec.split_strategy not in (SplitStrategy.RANDOM, SplitStrategy.RANDOM_STRATIFIED):
        raise ValueError(f"No torch-compat builder for {spec.split_strategy}")
    rng = torch.Generator(device="cpu")
    rng.manual_seed(int(seed))
    return _split_ids(spec, rng, *_alive_dead(spec, alive_ids))


#: a dense torch-compat table above this many bits would hang or run out of
#: memory (65k keys x 65k vocab = ~512 MB of packed bits + 65k host
#: randperms); the lazy source takes over there
_TABLE_BITS_LIMIT = 2**31


def build_table_torch_compat(
    spec: WatermarkSpec,
    alive_ids: Optional[np.ndarray] = None,
    max_context_sum: Optional[int] = None,
    device: Union[str, torch.device] = "cpu",
) -> TableGreenlist:
    """A :class:`TableGreenlist` equal to the reference's greenlists bit for
    bit, built on the host and moved to ``device`` once.

    ``max_context_sum`` defaults to ``context_size * (vocab_size - 1)``, the
    largest sum of a context window. Refuses tables beyond
    ``_TABLE_BITS_LIMIT``: use :class:`LazyTorchCompatGreenlist` there.
    """
    v = spec.vocab_size
    if spec.seed_strategy == SeedStrategy.FIXED:
        n_keys = 1
    else:
        if max_context_sum is None:
            max_context_sum = spec.context_size * (v - 1)
        n_keys = max_context_sum + 1
    if n_keys * v > _TABLE_BITS_LIMIT:
        raise ValueError(
            f"torch-compat table would need {n_keys} x {v} bits "
            f"({n_keys * v / 8e9:.1f} GB + {n_keys} host randperms); at this "
            "vocab use LazyTorchCompatGreenlist (host-side detection parity) "
            "or the default hash greenlist for generation."
        )
    alive, dead = _alive_dead(spec, alive_ids)
    table = np.zeros((n_keys, -(-v // 32)), dtype=np.uint32)
    rng = torch.Generator(device="cpu")
    row = np.zeros((1, v), dtype=bool)
    for key in range(n_keys):
        rng.manual_seed(0 if spec.seed_strategy == SeedStrategy.FIXED else spec.seed_for_context_sum(key))
        row[:] = False
        row[0, _split_ids(spec, rng, alive, dead)] = True
        table[key] = pack_bool_rows(row)[0]
    return TableGreenlist(spec, table, device=device)


class LazyTorchCompatGreenlist:
    """Torch-compat greenlists built per context sum, on demand, with a
    host-side LRU: ``--wm_torch_compat`` detection at Chameleon's 65,536
    codes (the reference's own ``lru_cache`` pattern). Host only: for
    detection and parity checks, not inside the sampler.
    """

    def __init__(self, spec: WatermarkSpec, alive_ids=None, maxsize: int = 4096):
        self.spec = spec
        self.alive_ids = alive_ids
        self.maxsize = maxsize
        self._rows: "OrderedDict[int, np.ndarray]" = OrderedDict()

    def _row(self, key: int) -> np.ndarray:
        row = self._rows.get(key)
        if row is None:
            seed = 0 if self.spec.seed_strategy == SeedStrategy.FIXED else self.spec.seed_for_context_sum(key)
            row = np.zeros((self.spec.vocab_size,), dtype=bool)
            row[greenlist_ids_torch_compat(self.spec, seed, self.alive_ids)] = True
            self._rows[key] = row
            if len(self._rows) > self.maxsize:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(key)
        return row

    def green_lookup_host(self, keys: np.ndarray, targets: np.ndarray) -> np.ndarray:
        shape = np.asarray(keys).shape
        keys = np.asarray(keys).reshape(-1)
        targets = np.asarray(targets).reshape(-1)
        return np.asarray([self._row(int(k))[int(t)] for k, t in zip(keys, targets)], dtype=bool).reshape(shape)

    def detect_host(self, codes: np.ndarray) -> np.ndarray:
        """Host-side detection (ngram dedup and betainc) with the device
        path's scoring rules: ``codes [B, T] -> p-values [B]``. Through the
        C++ scorer (``wmar_tpu_torch.native``, over rows built for exactly
        the keys of the batch) where a compiler is found, else numpy; both
        give the same bits."""
        from scipy.special import betainc

        from wmar_tpu_torch import native

        codes = np.asarray(codes)
        if codes.ndim == 1:
            codes = codes[None]
        if native.available():
            return native.detect_native(self.spec, self, codes)
        out = np.zeros((codes.shape[0],), np.float64)
        for b in range(codes.shape[0]):
            rows_a, keys_a, tgts_a = (x.numpy() for x in extract_ngrams(self.spec, torch.as_tensor(codes[b])))
            rows_a = rows_a.reshape(-1, rows_a.shape[-1])
            keys_a, tgts_a = keys_a.reshape(-1), tgts_a.reshape(-1)
            # dedup on the whole ngram window (the reference's Counter); the
            # order of the unique rows does not change the counts
            _, uniq = np.unique(rows_a, axis=0, return_index=True)
            keys, tgts = keys_a[uniq], tgts_a[uniq]
            green = np.zeros(len(uniq), dtype=bool)
            for k in np.unique(keys):
                sel = keys == k
                green[sel] = self._row(int(k))[tgts[sel]]
            n_green, n_scored = int(green.sum()), len(uniq)
            out[b] = float(betainc(n_green, 1 + n_scored - n_green, self.spec.gamma)) if n_green > 0 else 1.0
        return out


def fixed_greenlist_from_ids(spec: WatermarkSpec, ids: Sequence[int],
                             device: Union[str, torch.device] = "cpu") -> HashGreenlist:
    """FIXED-strategy greenlist from an explicit id list (the clustering
    split, or ``assets/clustering_greenlist_ids.txt``)."""
    mask = np.zeros((spec.vocab_size,), dtype=bool)
    mask[np.asarray(list(ids), dtype=np.int64)] = True
    return HashGreenlist(spec, fixed_mask=mask, device=device)


def clustering_greenlist(spec: WatermarkSpec, embedding: np.ndarray, alive_ids: np.ndarray,
                         device: Union[str, torch.device] = "cpu") -> HashGreenlist:
    """Clustering split: green = alternating clusters of the alive codebook
    embeddings (t-SNE to 2D, 100 KMeans clusters, snake order), plus the
    even dead ids: the reference's semantic split. FIXED seeding only.
    Without sklearn the clusters are a numpy PCA to 2D and a 10 x 10
    quantile grid.
    """
    if spec.seed_strategy != SeedStrategy.FIXED:
        raise ValueError("clustering split requires fixed seeding")
    alive_ids = np.asarray(alive_ids, dtype=np.int64)
    alive_emb = np.asarray(embedding)[alive_ids].reshape(len(alive_ids), -1)
    try:
        from sklearn.cluster import KMeans
        from sklearn.manifold import TSNE

        pts = TSNE(n_components=2, random_state=42).fit_transform(alive_emb)
        km = KMeans(n_clusters=100, random_state=42).fit(pts)
        centers, labels_of = km.cluster_centers_, km.labels_
    except ImportError:
        x = alive_emb - alive_emb.mean(0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        pts = x @ vt[:2].T
        qy = np.searchsorted(np.quantile(pts[:, 1], np.linspace(0, 1, 11)[1:-1]), pts[:, 1])
        qx = np.searchsorted(np.quantile(pts[:, 0], np.linspace(0, 1, 11)[1:-1]), pts[:, 0])
        labels_of = (qy * 10 + qx).astype(np.int64)
        centers = np.stack([pts[labels_of == c].mean(0) if (labels_of == c).any() else np.zeros(2)
                            for c in range(100)])

    labels = np.arange(len(centers))
    ysort = np.argsort(centers[:, 1])
    centers, labels = centers[ysort].reshape(-1, 10, 2), labels[ysort].reshape(-1, 10)
    curr = 0
    label_to_color = {}
    for i in range(centers.shape[0]):
        curr = 1 - curr
        labels[i] = labels[i][np.argsort(centers[i, :, 0])]
        for lab in labels[i]:
            label_to_color[int(lab)] = curr
            curr = 1 - curr

    green = [int(t) for i, t in enumerate(alive_ids) if label_to_color[int(labels_of[i])] == 1]
    dead = np.setdiff1d(np.arange(spec.vocab_size, dtype=np.int64), alive_ids)
    green += [int(t) for t in dead if t % 2 == 0]
    return fixed_greenlist_from_ids(spec, green, device=device)


@dataclasses.dataclass
class VQInfo:
    """Codebook metadata the watermark needs. ``alive_ids`` are the codebook
    entries the generator actually uses (the reference ships them as
    ``assets/*_ids.txt``)."""

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

    @staticmethod
    def from_alive_ids_file(path: str, vocab_size: int, embedding=None) -> "VQInfo":
        ids: list = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    ids.extend(int(x) for x in line.split(","))
        return VQInfo(vocab_size=vocab_size, alive_ids=np.asarray(ids), embedding=embedding)


def make_greenlist(
    spec: WatermarkSpec,
    vq: Optional[VQInfo] = None,
    torch_compat: bool = False,
    device: Union[str, torch.device] = "cpu",
):
    """The right greenlist source for ``spec``, on ``device``: the
    clustering split, the torch-compat table (bit-exact with the reference)
    or the hash source."""
    if spec.split_strategy == SplitStrategy.CLUSTERING:
        if vq is None or vq.embedding is None or vq.alive_ids is None:
            raise ValueError("clustering split needs VQInfo with embedding + alive_ids")
        return clustering_greenlist(spec, vq.embedding, vq.alive_ids, device=device)
    if torch_compat:
        return build_table_torch_compat(spec, vq.alive_ids if vq is not None else None, device=device)
    alive_mask = vq.alive_mask if vq is not None else None
    return HashGreenlist(spec, alive_mask=alive_mask, device=device)
