"""The rank grid and sharding helpers of multi-GPU runs (PyTorch).

Port of ``wmar_tpu.parallel.mesh``. The reference reaches NCCL three ways
(SURVEY §2.10): DDP gradient all-reduce (``finetune.py:313-318``),
Chameleon's tensor-parallel collectives
(``deps/chameleon/inference/transformer.py:159,220``) and the SLURM /
torchrun rendezvous (``wmar/utils/distributed.py:88-228``). JAX collapses
them into one SPMD program over a device mesh; here each rank is a process
of its own, launched by ``torchrun`` or SLURM, that holds only its shard as
plain tensors on its own ``cuda:LOCAL_RANK``, and the collectives are
explicit (:func:`all_reduce`, :func:`all_gather`) over the process
group's backend: NCCL, one card a rank, or gloo where the caller names it.

Conventions, as in JAX: axis ``dp`` shards the batch, axis ``tp`` shards
attention heads, the MLP hidden dim and the vocabulary (Megatron), axis
``sp`` the prompt's sequence (ring-attention prefill,
:mod:`wmar_tpu_torch.parallel.ring`) and axis ``pp`` the layers (GPipe
prefill, :mod:`wmar_tpu_torch.parallel.pipeline`). The rank grid is
``np.arange(n).reshape(dp, tp[, sp][, pp])``, JAX's device order, with
``sp`` and ``pp`` present only when larger than 1: rank ``r`` sits where
JAX puts device ``r``, and a ``(dp, tp)`` grid is the same as before.

A :class:`Mesh` made with ``rank=`` and no process group is a view of one
rank of a grid, for code that slices shards in one process (the tests);
its collectives over more than one rank raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

class P(tuple):
    """A partition spec: one entry a dim, an axis name or None (not
    sharded); missing trailing entries are not sharded. Where a layout is
    no block of a grid (grouped int4's strided hidden units), a spec leaf
    may instead be a function ``(mesh, tensor) -> shard``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the ``(dp, tp[, sp][, pp])`` grid and its
    process groups.

    ``devices``: the rank grid; ``rank``: this process's rank in it;
    ``groups``: per axis the group of the ranks that share this rank's other
    coordinates (None in one process); ``names``: the grid's axes, in order.
    An axis that is not in ``names`` has size 1."""

    devices: np.ndarray
    rank: int
    groups: dict = dataclasses.field(default_factory=dict)
    names: tuple = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.devices.shape))

    def size_of(self, axis: str) -> int:
        """The size of ``axis``, 1 where the grid lacks it."""
        return self.shape.get(axis, 1)

    @property
    def dp(self) -> int:
        return self.size_of("dp")

    @property
    def tp(self) -> int:
        return self.size_of("tp")

    @property
    def sp(self) -> int:
        return self.size_of("sp")

    @property
    def pp(self) -> int:
        return self.size_of("pp")

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 where the grid lacks it)."""
        if axis not in self.names:
            return 0
        return int(np.argwhere(self.devices == self.rank)[0][self.names.index(axis)])

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``, in grid order."""
        if axis not in self.names:
            return [self.rank]
        where = tuple(np.argwhere(self.devices == self.rank)[0])
        i = self.names.index(axis)
        return [int(r) for r in self.devices[where[:i] + (slice(None),) + where[i + 1:]]]

    def group(self, axis: str):
        """The process group of ``axis`` (None: one rank, or one process)."""
        if self.size_of(axis) == 1:
            return None
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(f"mesh axis {axis!r} spans {self.size_of(axis)} ranks but this process has no group: "
                               "call init_distributed() before make_mesh()")
        return group


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, pp: int = 1, rank: Optional[int] = None) -> Mesh:
    """The ``(dp, tp[, sp][, pp])`` grid over the ranks of the process
    group, ``sp`` and ``pp`` only where larger than 1, as JAX's
    ``make_mesh`` builds it.

    With ``torch.distributed`` initialised, ``dp * tp * sp * pp`` must be
    its world size (``dp`` None: world size over the others), and every
    rank must call this in the same order: it makes one group per line of
    the grid along each axis. Without a process group, the grid has one
    rank, unless ``rank`` names a rank of the grid to view (no
    collectives)."""
    rest = tp * sp * pp
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        me = dist.get_rank() if rank is None else rank
    else:
        n = (dp or 1) * rest if rank is not None else 1
        me = 0 if rank is None else rank
    if dp is None:
        dp = n // rest
    if dp * rest != n:
        raise ValueError(f"dp({dp}) * tp({tp}) * sp({sp}) * pp({pp}) != ranks({n})")
    shape, names = [dp, tp], ["dp", "tp"]
    for axis, size in (("sp", sp), ("pp", pp)):
        if size > 1:
            shape.append(size)
            names.append(axis)
    grid = np.arange(n).reshape(shape)
    groups = {}
    if dist.is_available() and dist.is_initialized():
        for axis in ("tp", "dp", "sp", "pp"):  # the (dp, tp) grid's order first, as before sp and pp
            if axis not in names:
                continue
            i = names.index(axis)
            for ranks in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                group = dist.new_group([int(r) for r in ranks])
                if me in ranks:
                    groups[axis] = group
    return Mesh(grid, me, groups, tuple(names))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a pytree of ``[B, ...]`` tensors (``B`` a
    multiple of the dp size)."""
    dp, d = mesh.dp, mesh.axis_index("dp")

    def rows(x):
        if x.shape[0] % dp:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over dp={dp}")
        n = x.shape[0] // dp
        return x[d * n:(d + 1) * n]

    return _map(rows, batch)


def replicate(mesh: Mesh, tree):
    """The tree with every tensor broadcast from rank 0 of the grid, in
    place; in one process, the tree itself."""
    if mesh.size == 1:
        return tree
    if not dist.is_initialized():
        raise RuntimeError("replicate over more than one rank needs a process group")

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=int(mesh.devices.flat[0]))
        return x

    return _map(bcast, tree)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "tp") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``x`` itself on one)."""
    if mesh is None or mesh.size_of(axis) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=mesh.group(axis))
    return x


def all_gather(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "tp", dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` joined along ``dim``, in grid order."""
    if mesh is None or mesh.size_of(axis) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size_of(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh: Optional[Mesh], axis: str, index: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``index`` of ``axis`` on every rank
    of this rank's line (in place where ``x`` is contiguous)."""
    if mesh is None or mesh.size_of(axis) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=mesh.axis_ranks(axis)[index], group=mesh.group(axis))
    return x


def ring_exchange(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """One hop of a ring along ``axis``: sends ``x`` to the next rank of
    the line (the last to the first) and returns what the previous rank
    sent (``x`` itself on a line of one).

    On NCCL the tensors go rank to rank (``dist.batch_isend_irecv``). On
    gloo they go through the host: gloo's point-to-point calls read and
    write the buffer's memory from the CPU, so a CUDA tensor is copied to
    the host, sent, received into a host buffer and copied back. That is
    the backend's branch (the collectives of gloo stage through the host
    too), not a fallback: nothing is tried first."""
    n = mesh.size_of(axis) if mesh is not None else 1
    if n == 1:
        return x
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    group = mesh.group(axis)
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + 1) % n], group), dist.P2POp(dist.irecv, recv, ranks[i - 1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if host else recv


def parse_distributed_env(env=None) -> dict:
    """The SLURM or torchrun rendezvous in ``env`` (``os.environ`` by
    default), as JAX's function returns it: ``process_id``,
    ``num_processes`` and, where the launcher names one,
    ``coordinator_address``; empty when no launcher's variables are set."""
    env = os.environ if env is None else env
    out: dict = {}
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        out["process_id"] = int(env["SLURM_PROCID"])
        out["num_processes"] = int(env["SLURM_NTASKS"])
        addr = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        if addr:
            out["coordinator_address"] = f"{addr}:{env.get('MASTER_PORT', '12355')}"
    elif "RANK" in env and "WORLD_SIZE" in env:  # torchrun
        out["process_id"] = int(env["RANK"])
        out["num_processes"] = int(env["WORLD_SIZE"])
        if env.get("MASTER_ADDR"):
            out["coordinator_address"] = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12355')}"
    return out


def _local_rank(env=None) -> int:
    """This process's index on its host: ``LOCAL_RANK`` (torchrun) or
    ``SLURM_LOCALID``, else 0."""
    env = os.environ if env is None else env
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))


def init_distributed(backend: Optional[str] = None, env=None) -> bool:
    """Join the launcher's process group; the counterpart of JAX's
    ``init_multihost``. Returns whether a group of more than one rank is up.

    With a launcher's variables naming more than one process, it calls
    ``torch.distributed.init_process_group`` and lets any failure raise;
    without them it stays one process. The default backend is NCCL, one
    card a rank: it selects ``cuda:LOCAL_RANK`` and raises where that card
    does not exist. gloo runs only where the caller names it (the CPU tests,
    two ranks that share one card); nothing moves to the CPU unasked."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ if env is None else env
    kw = parse_distributed_env(env)
    if kw.get("num_processes", 1) <= 1:
        return False
    rank, world = kw["process_id"], kw["num_processes"]
    backend = backend or "nccl"
    if backend == "nccl":
        lr, n = _local_rank(env), torch.cuda.device_count()
        if lr >= n:
            raise RuntimeError(f"rank {rank}: LOCAL_RANK {lr} has no card (torch.cuda.device_count() = {n}); "
                               "NCCL needs one card a rank")
        torch.cuda.set_device(lr)
    if "coordinator_address" not in kw:
        raise RuntimeError(f"rank {rank} of {world}: no MASTER_ADDR (or SLURM_LAUNCH_NODE_IPADDR) to meet at")
    dist.init_process_group(backend, init_method=f"tcp://{kw['coordinator_address']}", world_size=world, rank=rank)
    return True


# ---------------------------------------------------------------------------
# Megatron-style specs, and the slicer that applies them
# ---------------------------------------------------------------------------


def gpt_tp_specs(params: dict) -> dict:
    """Specs of a ``taming_gpt`` tree: QKV and fc column-sharded over ``tp``,
    both projections row-sharded, the vocab head column-sharded."""

    def block_spec(_):
        return {
            "ln1": {"scale": P(), "bias": P()},
            "ln2": {"scale": P(), "bias": P()},
            "attn": {
                "q": {"w": P(None, "tp"), "b": P("tp")},
                "k": {"w": P(None, "tp"), "b": P("tp")},
                "v": {"w": P(None, "tp"), "b": P("tp")},
                "proj": {"w": P("tp", None), "b": P()},
            },
            "mlp": {
                "fc": {"w": P(None, "tp"), "b": P("tp")},
                "proj": {"w": P("tp", None), "b": P()},
            },
        }

    return {
        "tok_emb": P(),
        "pos_emb": P(),
        "blocks": [block_spec(b) for b in params["blocks"]],
        "ln_f": {"scale": P(), "bias": P()},
        "head": P(None, "tp"),
    }


def kvcache_tp_spec() -> P:
    """A ``[L, B, H, T, D]`` cache shards over heads (dim 2)."""
    return P(None, None, "tp", None, None)


def kvcache_tp_specs(cache):
    """The head-sharded spec of ``cache``, a cache of the same class whose
    fields are specs: the float and int8 caches over their head axis, the
    packed caches over their lane axis and scale rows (valid shards only
    where the cache was built with ``tp_groups`` equal to the tp size)."""
    from wmar_tpu_torch.engine.kvcache import KVCache, Packed4QuantKVCache, PackedQuantKVCache, QuantKVCache

    p5 = P(None, None, "tp", None, None)
    if isinstance(cache, (PackedQuantKVCache, Packed4QuantKVCache)):
        return cache.replace(kv=P(None, None, None, "tp"), scale=P(None, None, "tp", None))
    if isinstance(cache, QuantKVCache):
        p4 = P(None, None, "tp", None)
        return QuantKVCache(p5, p5, p4, p4)
    return KVCache(p5, p5)


def _slice(mesh: Mesh, x: torch.Tensor, spec: P) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.size_of(axis), mesh.axis_index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x.contiguous()


def apply_specs(mesh: Mesh, tree, specs):
    """This rank's shard of ``tree`` under ``specs`` (a tree of :class:`P`
    of the same structure): each tensor sliced along its sharded dims, in
    grid order, as a contiguous copy (a function in place of a :class:`P`
    is called as ``spec(mesh, tensor)``); a cache becomes this rank's local
    cache, carrying ``mesh``."""
    if isinstance(specs, P):
        return _slice(mesh, tree, specs)
    if callable(specs):
        return specs(mesh, tree).contiguous()
    if isinstance(specs, dict):
        return {k: apply_specs(mesh, tree[k], s) for k, s in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(tree)(apply_specs(mesh, x, s) for x, s in zip(tree, specs))
    fields = getattr(specs, "FIELDS", None)
    if fields is None:
        raise TypeError(f"no spec for {type(tree).__name__}")
    sharded = {f: apply_specs(mesh, getattr(tree, f), getattr(specs, f)) for f in fields}
    if hasattr(tree, "mesh"):
        sharded.update(mesh=mesh, dp_axis="dp" if mesh.dp > 1 else None, tp_axis="tp" if mesh.tp > 1 else None)
    return tree.replace(**sharded)
