"""Training monitors (PyTorch port of ``wmar_tpu.utils.logging``'s
``encoder_drift`` and ``average_metrics``)."""

from __future__ import annotations

from typing import Iterable

import torch


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield torch.as_tensor(tree)


def encoder_drift(trainable, orig) -> float:
    """L2 distance of finetuned weights from the originals, over every leaf
    in order (the reference's ENC/DEC drift monitors, ``utils.py:170-186``).
    Takes modules or trees of tensors; one host sync."""
    sums = [((a.detach().float() - b.to(a.device).float()) ** 2).sum()
            for a, b in zip(_leaves(trainable), _leaves(orig), strict=True)]
    return float(torch.stack(sums).sum().sqrt()) if sums else 0.0


def average_metrics(metrics: dict, weight: float = 1.0) -> dict:
    """Weighted mean of scalar metrics over the processes of the default
    ``torch.distributed`` group (the reference's ``average_metrics``,
    ``distributed.py:231-243``); the metrics as floats in one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    vec = torch.tensor([float(metrics[k]) * weight for k in keys] + [weight], dtype=torch.float64, device=dev)
    dist.all_reduce(vec)
    return {k: float(vec[i] / vec[-1]) for i, k in enumerate(keys)}
