"""Multi-GPU runs: the rank grid (dp x tp x sp x pp), the launcher's
rendezvous, the sharding specs and their slicer, the collectives of tensor
parallelism, the ring-attention (sp) and GPipe (pp) prefills and the
data-parallel pieces of the trainers."""

from wmar_tpu_torch.parallel.data import (
    dp_size,
    gather_rows,
    global_randn,
    is_lead,
    mean_grads,
    mean_metrics,
    mean_over,
    reset_traffic,
    rows_of,
    same_on_all,
    traffic,
)
from wmar_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    all_gather,
    all_reduce,
    apply_specs,
    broadcast,
    gpt_tp_specs,
    init_distributed,
    kvcache_tp_spec,
    kvcache_tp_specs,
    make_mesh,
    parse_distributed_env,
    replicate,
    ring_exchange,
    shard_batch,
)
from wmar_tpu_torch.parallel.pipeline import llama_prefill_pp, stack_blocks
from wmar_tpu_torch.parallel.ring import ring_prefill_attention, sequence_block

__all__ = [
    "Mesh",
    "P",
    "all_gather",
    "all_reduce",
    "apply_specs",
    "broadcast",
    "dp_size",
    "gather_rows",
    "global_randn",
    "is_lead",
    "mean_grads",
    "mean_metrics",
    "mean_over",
    "reset_traffic",
    "rows_of",
    "same_on_all",
    "traffic",
    "gpt_tp_specs",
    "init_distributed",
    "kvcache_tp_spec",
    "kvcache_tp_specs",
    "llama_prefill_pp",
    "make_mesh",
    "parse_distributed_env",
    "replicate",
    "ring_exchange",
    "ring_prefill_attention",
    "sequence_block",
    "shard_batch",
    "stack_blocks",
]
