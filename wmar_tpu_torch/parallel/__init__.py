"""Multi-GPU runs: the rank grid (dp x tp), the launcher's rendezvous, the
sharding specs and their slicer, and the collectives of tensor parallelism."""

from wmar_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    all_gather,
    all_reduce,
    apply_specs,
    gpt_tp_specs,
    init_distributed,
    kvcache_tp_spec,
    kvcache_tp_specs,
    make_mesh,
    parse_distributed_env,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "P",
    "all_gather",
    "all_reduce",
    "apply_specs",
    "gpt_tp_specs",
    "init_distributed",
    "kvcache_tp_spec",
    "kvcache_tp_specs",
    "make_mesh",
    "parse_distributed_env",
    "replicate",
    "shard_batch",
]
