"""Port parity, the multi-GPU helpers (``wmar_tpu_torch.parallel``) and the
Megatron decode step.

The rendezvous parsing, the rank grid, the batch shards and every llama
leaf's tensor-parallel shard are held against ``wmar_tpu.parallel`` on the
conftest's 8 host devices (JAX's ``addressable_shards``). The Megatron
forward runs in two gloo ranks (``parallel.launch.spawn_ranks`` with a
``file://`` rendezvous under the test's own directory, so parallel test
workers never share a port) and is held against the one-rank forward and
JAX's ``--tp 2`` sharded forward.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine import kvcache as jkv
from wmar_tpu.models import llama as jl
from wmar_tpu.parallel import apply_specs as jax_apply_specs
from wmar_tpu.parallel import make_mesh as jax_mesh
from wmar_tpu.parallel import mesh as jmesh
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine import kvcache as tkv
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.parallel import (
    all_gather,
    all_reduce,
    apply_specs,
    gpt_tp_specs,
    init_distributed,
    kvcache_tp_spec,
    make_mesh,
    parse_distributed_env,
    replicate,
    shard_batch,
)
from wmar_tpu_torch.parallel.launch import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402

ENVS = {
    "empty": {},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "16", "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"},
    "slurm_launch_node": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.9"},
    "slurm_no_address": {"SLURM_PROCID": "1", "SLURM_NTASKS": "2"},
    "torchrun": {"RANK": "1", "WORLD_SIZE": "8", "MASTER_ADDR": "h0", "LOCAL_RANK": "1"},
    "torchrun_port": {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h1", "MASTER_PORT": "29400"},
    "both": {"RANK": "5", "WORLD_SIZE": "6", "SLURM_PROCID": "2", "SLURM_NTASKS": "4"},
}
GRIDS = [(2, 1), (1, 2), (2, 2), (4, 2)]
CFG = dict(dim=32, n_layers=2, n_heads=4, vocab_size=64, multiple_of=16, qk_normalization=True)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_parse_distributed_env_matches_jax(name):
    assert parse_distributed_env(ENVS[name]) == jmesh.parse_distributed_env(ENVS[name])


@pytest.mark.parametrize("dp,tp", GRIDS)
def test_rank_grid_matches_jax_mesh(dp, tp):
    """Rank r of the port's grid sits where JAX's ``make_mesh`` puts device
    r (``reshape([dp, tp])``: r = d * tp + t), for every rank's view."""
    jm = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r in range(dp * tp):
        view = make_mesh(dp=dp, tp=tp, rank=r)
        np.testing.assert_array_equal(view.devices, ids)
        d, t = np.argwhere(ids == r)[0]
        assert (view.axis_index("dp"), view.axis_index("tp")) == (d, t)
        assert view.shape == dict(jm.shape)


def _jax_llama(kind: str):
    params = jl.init_llama_params(jax.random.PRNGKey(0), jl.LlamaConfig(**CFG))
    if kind == "int8":
        return jl.quantize_llama_params_int8(params, compute_dtype=jnp.bfloat16)
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2), (1, 4)])
def test_apply_specs_matches_jax_shards(kind, dp, tp):
    """Every leaf of a llama tree (bf16, or int8 ``{q, s}`` with bf16
    scales) under ``llama_tp_specs``: the port's shard for rank r equals, bit
    for bit, the data JAX's ``apply_specs`` puts on device r."""
    params = _jax_llama(kind)
    jm = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    sharded = dict(_leaves(jax_apply_specs(jm, params, jl.llama_tp_specs(params))))
    tparams = bridge.load_llama(jax.tree.map(np.asarray, params))
    assert tl.llama_tp_specs(tparams) == jax.tree.map(tuple, jl.llama_tp_specs(params),
                                                      is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for r in range(dp * tp):
        mine = dict(_leaves(apply_specs(make_mesh(dp=dp, tp=tp, rank=r), tparams, tl.llama_tp_specs(tparams))))
        assert mine.keys() == sharded.keys()
        for path, leaf in mine.items():
            shard = next(s for s in sharded[path].addressable_shards if s.device.id == r)
            assert leaf.is_contiguous()
            np.testing.assert_array_equal(_bits(leaf), _bits(shard.data), err_msg=f"{path} rank {r}")


def test_gpt_and_cache_specs_match_jax():
    blocks = {"blocks": [None, None, None]}
    as_tuples = lambda tree: jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert gpt_tp_specs(blocks) == as_tuples(jmesh.gpt_tp_specs(blocks))
    assert tuple(kvcache_tp_spec()) == tuple(jmesh.kvcache_tp_spec())


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 1)])
def test_shard_batch_matches_jax(dp, tp):
    """A rank's rows of a batch are the rows JAX's ``shard_batch`` puts on
    that device; padding is the caller's (a batch must split evenly)."""
    batch = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    jm = jax_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    placed = jmesh.shard_batch(jm, jnp.asarray(batch))
    for r in range(dp * tp):
        shard = next(s for s in placed.addressable_shards if s.device.id == r)
        mine = shard_batch(make_mesh(dp=dp, tp=tp, rank=r), {"x": torch.as_tensor(batch)})["x"]
        np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(make_mesh(dp=dp, tp=tp, rank=0), torch.zeros((dp + 1, 2)))


def test_one_process_stays_one_rank():
    """Without a launcher's variables nothing is initialised and the grid
    is one rank; a bigger grid is refused, and a viewed rank of one has no
    collectives over more than itself."""
    assert init_distributed(env={}) is False
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
    x = torch.ones(3)
    assert all_reduce(x, mesh) is x and all_gather(x, mesh) is x and replicate(mesh, {"x": x})["x"] is x
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(dp=2)
    view = make_mesh(dp=1, tp=2, rank=1)
    with pytest.raises(RuntimeError, match="no group"):
        all_reduce(x, view)


@pytest.mark.parametrize("launcher", ["torchrun", "slurm"])
def test_nccl_rank_without_its_card_raises(launcher):
    """Under NCCL a rank whose ``LOCAL_RANK`` names no card (one past the
    host's count) raises, naming the rank and the card count, before any
    rendezvous; it never moves to the CPU on its own."""
    n = torch.cuda.device_count()
    env = ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": str(n), "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
           if launcher == "torchrun" else
           {"SLURM_PROCID": "0", "SLURM_NTASKS": "2", "SLURM_LOCALID": str(n), "MASTER_ADDR": "localhost"})
    rank = env.get("RANK", env.get("SLURM_PROCID"))
    with pytest.raises(RuntimeError, match=rf"rank {rank}: LOCAL_RANK {n} has no card "
                                           rf"\(torch.cuda.device_count\(\) = {n}\)"):
        init_distributed(env=env)
    assert not torch.distributed.is_initialized()


def test_launcher_without_an_address_raises():
    with pytest.raises(RuntimeError, match="no MASTER_ADDR"):
        init_distributed("gloo", env={"SLURM_PROCID": "1", "SLURM_NTASKS": "2"})


@pytest.fixture(scope="module")
def megatron(tmp_path_factory):
    """The tiny llama in both packages, the inputs, the ranks' logits (two
    gloo ranks, spawned once for the file) and JAX's tp=2 logits."""
    workdir = str(tmp_path_factory.mktemp("megatron"))
    jcfg = jl.LlamaConfig(**CFG)
    params = jl.init_llama_params(jax.random.PRNGKey(5), jcfg)
    tparams = bridge.load_llama(jax.tree.map(np.asarray, params))
    tcfg = tl.LlamaConfig(**CFG)
    rng = np.random.default_rng(6)
    b, t = 4, 6
    tokens = rng.integers(0, CFG["vocab_size"], (b, t)).astype(np.int64)
    start = np.asarray([0, 2, 1, 3], np.int32)
    positions = np.maximum(np.arange(t)[None] - start[:, None], 0)
    nxt = rng.integers(0, CFG["vocab_size"], (b, 1)).astype(np.int64)
    inputs = {"tokens": torch.as_tensor(tokens), "start": torch.as_tensor(start),
              "positions": torch.as_tensor(positions), "next": torch.as_tensor(nxt),
              "caches": [("f32", torch.float32, 16), ("packed", "packed", 1024), ("packed4", "packed4", 1024)]}
    torch.save((tparams, tcfg, inputs), os.path.join(workdir, "inputs.pt"))
    spawn_ranks(ranks.megatron_rank, 2, "gloo", f"file://{workdir}/rendezvous", args=(workdir,))
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(2)]
    one = {name: ranks.run_llama_steps(tparams, tcfg, inputs, tkv.KVCache.zeros(
        CFG["n_layers"], b, CFG["n_heads"], slots, tcfg.head_dim, dtype)) for name, dtype, slots in inputs["caches"]}

    jm = jax_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    jparams = jax_apply_specs(jm, params, jl.llama_tp_specs(params))
    want = {}
    for name, dtype, slots in inputs["caches"]:
        kw = {} if name == "f32" else dict(mesh=jm, tp_axis="tp")
        cache = jkv.KVCache.zeros(jcfg.n_layers, b, jcfg.n_heads, slots, jcfg.head_dim,
                                  jnp.float32 if name == "f32" else name, **kw)
        jstart = jnp.asarray(start)
        first, cache = jax.jit(lambda c: jl.llama_forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32), c, 0,
                                                          jnp.asarray(positions, jnp.int32), start=jstart))(cache)
        second, _ = jax.jit(lambda c: jl.llama_forward(jparams, jcfg, jnp.asarray(nxt, jnp.int32), c, t,
                                                       jnp.asarray((t - start)[:, None], jnp.int32),
                                                       start=jstart))(cache)
        want[name] = (np.asarray(first), np.asarray(second))
    return got, one, want


@pytest.mark.parametrize("cache", ["f32", "packed", "packed4"])
def test_megatron_decode_two_ranks(megatron, cache):
    """Prefill with a ragged ``start`` and one decode step of a tiny llama
    on two gloo ranks, each with its Megatron shard and a cache of its
    heads (the packed ones at 1024 slots: the chunked kernels' route,
    through the sharded dispatch): both ranks hold the same full-vocabulary
    logits, equal to the one-rank forward within 1e-5 (f32: only the
    row-parallel sums' order differs) and to JAX's ``--tp 2`` sharded
    forward within 1e-4 on the f32 cache (the bound of the one-rank llama
    parity) and 5e-2 on the int8 packed one (JAX's interpret-mode kernels
    round to bf16, as in the one-rank packed parity). On the int4 cache a
    K or V that the two packages round across a level boundary moves by a
    seventh of its head's absmax, past any logit bound, so that cache is
    held to the one-rank forward only."""
    got, one, want = megatron
    for i in range(2):
        assert torch.equal(got[0][cache][i], got[1][cache][i])
        assert got[0][cache][i].shape == one[cache][i].shape == want[cache][i].shape
        torch.testing.assert_close(got[0][cache][i], one[cache][i], rtol=0, atol=1e-5)
        if cache != "packed4":
            np.testing.assert_allclose(got[0][cache][i].numpy(), want[cache][i], rtol=0,
                                       atol=1e-4 if cache == "f32" else 5e-2)


def test_collectives_sum_and_gather_in_rank_order(megatron):
    """``all_reduce`` over the tp axis gives every rank the sum of both
    ranks' float32 and bf16 tensors, rounded once to their dtype;
    ``all_gather`` joins them in grid order; ``replicate`` hands every rank
    rank 0's tensor."""
    got, _, _ = megatron
    for r in range(2):
        checks = got[r]["transport"]
        for dtype in ("torch.float32", "torch.bfloat16"):
            x0, x1 = (got[q]["transport"][dtype][0] for q in range(2))
            _, total, joined = checks[dtype]
            assert total.dtype == x0.dtype
            assert torch.equal(total, (x0.float() + x1.float()).to(x0.dtype))
            assert torch.equal(joined, torch.cat([x0, x1], dim=1)) and joined.shape == (3, 10, 7)
        assert torch.equal(checks["replicated"], torch.full((4,), 7.0))  # rank 0's, broadcast
