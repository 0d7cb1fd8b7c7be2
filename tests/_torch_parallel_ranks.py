"""What the ranks of the port's multi-process tests run.

``parallel.launch.spawn_ranks`` starts each rank in a new process, which
imports this module by name; it imports torch and the port only, so a rank
starts without JAX. Each function takes its rank, then a work directory
where the test left its inputs and where the rank writes what it computed.
"""

import os

import torch


def megatron_rank(rank: int, workdir: str) -> None:
    """A tiny llama's prefill and one decode step on this rank's Megatron
    shard, over a cache of its heads, for each cache of ``inputs.pt``;
    writes the logits (all-gathered, the whole vocabulary) to
    ``rank<r>.pt``."""
    from wmar_tpu_torch.engine.kvcache import CacheSpec, KVCache
    from wmar_tpu_torch.models import llama
    from wmar_tpu_torch.parallel import apply_specs, make_mesh

    torch.set_num_threads(1)
    params, cfg, inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(dp=1, tp=2)
    local = apply_specs(mesh, params, llama.llama_tp_specs(params))
    out = {}
    for name, dtype, slots in inputs["caches"]:
        out[name] = run_llama_steps(local, cfg, inputs, KVCache.zeros(
            cfg.n_layers, inputs["tokens"].shape[0], cfg.n_heads, slots, cfg.head_dim, CacheSpec(dtype, mesh, None, "tp")),
            mesh)
    out["transport"] = transport_check(rank, mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def transport_check(rank: int, mesh) -> dict:
    """The port's collectives over the tp axis on tensors drawn from
    ``100 + rank``: ``{dtype: (input, all_reduce, all_gather along dim 1)}``
    and rank 0's tensor as ``replicate`` hands it on."""
    from wmar_tpu_torch.parallel import all_gather, all_reduce, replicate

    g = torch.Generator().manual_seed(100 + rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((3, 5, 7), generator=g) * 100).to(dtype)
        out[str(dtype)] = (x, all_reduce(x.clone(), mesh), all_gather(x, mesh, dim=1))
    out["replicated"] = replicate(mesh, {"x": torch.full((4,), float(rank + 7))})["x"]
    return out


def run_llama_steps(params, cfg, inputs, cache, mesh=None):
    """Prefill ``inputs["tokens"]`` with its ragged ``start``, then one
    decode step; returns the two forwards' logits."""
    from wmar_tpu_torch.models import llama

    tokens, start, positions, nxt = (inputs[k] for k in ("tokens", "start", "positions", "next"))
    t = tokens.shape[1]
    first, cache = llama.llama_forward(params, cfg, tokens, cache, 0, positions, start=start, mesh=mesh)
    second, _ = llama.llama_forward(params, cfg, nxt, cache, torch.tensor(t), (t - start)[:, None].to(torch.int64),
                                    start=start, mesh=mesh)
    return first, second


def generate_rank(rank: int, workdir: str, cases: dict) -> None:
    """``generate.main`` for each ``{name: argv}`` case, into
    ``<workdir>/<name>``, in the process group the launcher made."""
    from wmar_tpu_torch import generate

    torch.set_num_threads(1)
    for name, argv in cases.items():
        generate.main(list(argv) + ["--outdir", os.path.join(workdir, name)])
