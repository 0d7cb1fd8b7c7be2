"""Data parallelism of the trainers: the pieces that make a dp rank's step
the global batch's step.

JAX trains the global batch as one SPMD program and XLA inserts the
gradient all-reduce; here each rank holds its rows of the batch and the
trainers call these explicitly:

- :func:`mean_grads` averages the trainable gradients over the ``dp`` axis
  (flattened into buckets, summed, divided by dp) before the gradient norm
  and the optimizer step. For a loss that is a mean over the batch's rows,
  the mean of the ranks' gradients is the global batch's gradient.
- :func:`gather_rows` joins the ranks' rows of a tensor along dim 0,
  differentiably. A loss that is not a mean over rows (a spectral
  convergence ratio, a softmax over the batch) is computed whole on every
  rank from gathered tensors, so every rank holds the same gradient of it
  with respect to the gathered tensor; the gather's backward keeps this
  rank's rows times dp (dp x dL/dx_r) with no collective, and
  :func:`mean_grads` divides by dp.
- :func:`rows_of` and :func:`global_randn`: a random draw whose amount
  follows the batch's shape is made at the global batch's shape on every
  rank (the same generator, the same seed), and each rank keeps its rows,
  so the values and every later draw on that generator are the one
  process's.
- :func:`mean_over` and :func:`mean_metrics` average metrics (each a mean
  over a rank's rows).

Every function takes ``mesh`` None (one process) or a :class:`Mesh` with
dp 1 and then does nothing. :func:`traffic` counts the bytes these
collectives moved.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from wmar_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, shard_batch

BUCKET_BYTES = 128 << 20

_TRAFFIC = {"all_reduce_bytes": 0, "all_gather_bytes": 0, "collectives": 0}


def reset_traffic() -> None:
    for k in _TRAFFIC:
        _TRAFFIC[k] = 0


def traffic() -> dict:
    """Bytes this process sent into dp all-reduces and all-gathers, and the
    number of those collectives, since :func:`reset_traffic`."""
    return dict(_TRAFFIC)


def dp_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.dp


def is_lead(mesh: Optional[Mesh]) -> bool:
    """Whether this process is the run's first rank (the one that writes)."""
    return mesh is None or mesh.rank == int(mesh.devices.flat[0])


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    _TRAFFIC["all_reduce_bytes"] += x.numel() * x.element_size()
    _TRAFFIC["collectives"] += 1
    return all_reduce(x, mesh, "dp")


def mean_over(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of ``x`` over the dp ranks (a new tensor; ``x`` itself on one)."""
    if dp_size(mesh) == 1:
        return x
    return _sum(x.detach().clone(), mesh) / mesh.dp


def mean_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """A step's metrics (scalar tensors, each a mean over a rank's rows),
    detached and averaged over the dp ranks: the global batch's."""
    if dp_size(mesh) == 1:
        return {k: v.detach() for k, v in metrics.items()}
    device = next(iter(metrics.values())).device
    means = mean_over(torch.stack([v.detach().to(device, torch.float32) for v in metrics.values()]), mesh)
    return dict(zip(metrics, means.unbind()))


def mean_grads(params: Iterable[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Replace each gradient of ``params`` with its mean over the dp ranks,
    in place. Parameters without a gradient are left out; every rank must
    hold gradients for the same parameters (the same graph). The
    gradients go in buckets of ``BUCKET_BYTES``."""
    if dp_size(mesh) == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        if size >= BUCKET_BYTES or i == len(grads) - 1:
            flat = _sum(torch.cat([b.reshape(-1) for b in bucket]), mesh).div_(mesh.dp)
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view_as(b))
                offset += b.numel()
            bucket, size = [], 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        _TRAFFIC["all_gather_bytes"] += x.numel() * x.element_size()
        _TRAFFIC["collectives"] += 1
        return all_gather(x, mesh, "dp", dim=0)

    @staticmethod
    def backward(ctx, grad):
        # every rank computed the same loss from the same gathered rows, so ``grad`` is alike on all of them
        d, n = ctx.mesh.axis_index("dp"), ctx.rows
        return grad[d * n:(d + 1) * n] * ctx.mesh.dp, None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The dp ranks' ``x`` joined along dim 0 in grid order (the global
    batch), differentiable with respect to this rank's rows. Only for a
    loss that every rank computes whole from gathered tensors: the
    backward takes the gathered gradient to be the same on every rank."""
    if dp_size(mesh) == 1:
        return x
    if not x.requires_grad:
        _TRAFFIC["all_gather_bytes"] += x.numel() * x.element_size()
        _TRAFFIC["collectives"] += 1
        return all_gather(x, mesh, "dp", dim=0)
    return _GatherRows.apply(x, mesh)


def rows_of(mesh: Optional[Mesh], x):
    """This rank's rows of ``x``, a tensor or array of the global batch."""
    return x if dp_size(mesh) == 1 else shard_batch(mesh, x)


def global_randn(mesh: Optional[Mesh], local_shape, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard normal noise at the global batch's shape (``local_shape``
    with dp times its rows), the one process's draw on ``generator``."""
    shape = (dp_size(mesh) * local_shape[0], *local_shape[1:])
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def same_on_all(mesh: Optional[Mesh], value: int, what: str) -> int:
    """``value``, which must be equal on every dp rank (raises naming
    ``what`` otherwise)."""
    if dp_size(mesh) == 1:
        return value
    import torch.distributed as dist

    group = mesh.group("dp")
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else "cpu"
    x = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    hi, lo = int(x[0]), -int(x[1])
    if hi != lo:
        raise RuntimeError(f"the dp ranks disagree on {what}: from {lo} to {hi}")
    return value
