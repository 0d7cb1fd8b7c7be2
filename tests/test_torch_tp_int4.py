"""Port parity, ``--tp`` with grouped-int4 weights: the rank's slices that
``llama_tp_specs`` cuts (``w2``'s within-group byte axis as JAX splits it,
``w1``/``w3`` on the strided hidden units those bytes hold, ``wo`` by
groups, the rest by columns) and kernel #8's plain version on them.

Two gloo ranks (``_torch_parallel_ranks.megatron_rank``, spawned once for
the file) run the prefill with a ragged ``start`` and one decode step of a
tiny llama whose widths line up with the int4 groups (dim 256, 2 heads of
64 a rank, ``wo`` 2 groups of 128, ``w2`` 6 groups of 128: 64-row groups a
rank); JAX runs its ``--tp 2`` sharded forward on the same ``q4``/``s4``
bytes. Bound, float32: 1e-5 of the largest |logit| (only the order of the
row-parallel sums differs).
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
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.models import llama as tl
from wmar_tpu_torch.ops import w4_matmul as tw4
from wmar_tpu_torch.ops.wquant import quantize_matrix_int4
from wmar_tpu_torch.parallel import apply_specs, make_mesh
from wmar_tpu_torch.parallel.launch import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402

CFG = dict(dim=256, n_layers=2, n_heads=4, vocab_size=64, multiple_of=128, qk_normalization=True)
TP_INT4_REL = 1e-5


@pytest.fixture(scope="module")
def int4(tmp_path_factory):
    """The int4 llama in both packages, the two ranks' logits, one rank's
    and JAX's tp=2 logits."""
    workdir = str(tmp_path_factory.mktemp("tp_int4"))
    jcfg = jl.LlamaConfig(**CFG)
    params = jl.quantize_llama_params_int8(jl.init_llama_params(jax.random.PRNGKey(7), jcfg), bits=4)
    tparams = bridge.load_llama(jax.tree.map(np.asarray, params))
    tcfg = tl.LlamaConfig(**CFG)
    rng = np.random.default_rng(8)
    b, t = 3, 5
    tokens = rng.integers(0, CFG["vocab_size"], (b, t))
    start = np.asarray([0, 2, 1], np.int32)
    positions = np.maximum(np.arange(t)[None] - start[:, None], 0)
    nxt = rng.integers(0, CFG["vocab_size"], (b, 1))
    inputs = {"tokens": torch.as_tensor(tokens), "start": torch.as_tensor(start),
              "positions": torch.as_tensor(positions), "next": torch.as_tensor(nxt),
              "caches": [("f32", torch.float32, 8)]}
    torch.save((tparams, tcfg, inputs), os.path.join(workdir, "inputs.pt"))
    spawn_ranks(ranks.megatron_rank, 2, "gloo", f"file://{workdir}/rendezvous", args=(workdir,))
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(2)]
    one = ranks.run_llama_steps(tparams, tcfg, inputs, KVCache.zeros(2, b, 4, 8, tcfg.head_dim))

    jm = jax_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    jparams = jax_apply_specs(jm, params, jl.llama_tp_specs(params))
    jstart = jnp.asarray(start)

    @jax.jit
    def forward(p, cache):
        first, cache = jl.llama_forward(p, jcfg, jnp.asarray(tokens, jnp.int32), cache, 0,
                                        jnp.asarray(positions, jnp.int32), start=jstart)
        second, _ = jl.llama_forward(p, jcfg, jnp.asarray(nxt, jnp.int32), cache, t,
                                     jnp.asarray((t - start)[:, None], jnp.int32), start=jstart)
        return first, second

    want = forward(jparams, jkv.KVCache.zeros(2, b, 4, 8, jcfg.head_dim))
    return {"got": got, "one": one, "want": [np.asarray(w) for w in want], "tparams": tparams}


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_tp2_int4_forward_matches_jax(int4, which):
    """Both ranks hold the same whole-vocabulary logits, within 1e-5 of the
    largest |logit| of JAX's ``--tp 2`` int4 forward on the same bytes and
    of the one-rank int4 forward."""
    i = ["prefill", "decode"].index(which)
    got = [g["f32"][i].numpy() for g in int4["got"]]
    want, one = int4["want"][i], int4["one"][i].numpy()
    assert np.array_equal(got[0], got[1])
    scale = np.abs(want).max()
    assert np.abs(got[0] - want).max() <= TP_INT4_REL * scale
    assert np.abs(got[0] - one).max() <= TP_INT4_REL * scale


def test_ring_exchange_and_broadcast_on_two_ranks(int4):
    """One ``ring_exchange`` hop over the tp axis hands each rank the other's
    tensor; ``broadcast`` from coordinate 1 gives every rank rank 1's."""
    for r, out in enumerate(int4["got"]):
        assert torch.equal(out["transport"]["ring"], torch.full((2, 3), float(1 - r)))
        assert torch.equal(out["transport"]["broadcast"], torch.full((4,), 8.0))


def test_rank_shapes_follow_the_splits(int4):
    """The int4 leaves of a tp 2 rank: wq/wk/wv/w1/w3 and the head by
    columns, wo by groups (its heads), w2 by bytes (groups of 64 rows)."""
    local = apply_specs(make_mesh(dp=1, tp=2, rank=1), int4["tparams"], tl.llama_tp_specs(int4["tparams"]))
    blk = local["blocks"][0]
    shapes = {k: tuple(blk[k]["q4"].shape) for k in tl.WEIGHT_KEYS}
    assert shapes == {"wq": (2, 64, 128), "wk": (2, 64, 128), "wv": (2, 64, 128), "wo": (1, 64, 256),
                      "w1": (2, 64, 384), "w3": (2, 64, 384), "w2": (6, 32, 256)}
    assert tuple(local["output"]["q4"].shape) == (2, 64, 32)


@pytest.mark.parametrize("tp,split", [(2, (1, 2)), (4, (1, 4)), (8, (2, 4))])
def test_matmul_w4_plain_on_a_ranks_strided_slice(tp, split):
    """Chameleon-7B's ``w2`` proportions at a small width (6 groups of 128
    rows; 86 there): a rank's slice holds the hidden units
    ``int4_hidden_units`` names, ``matmul_w4_plain`` on it equals the rows
    of the whole matrix it stands for, the tp ranks' partials sum to the
    whole product, and the tensor-core kernel's order of sums
    (``matmul_w4_split_plain``, every split count) agrees at the slice's
    group (64, 32) and K (384, 192: not multiples of 128 at tp 4 and 8)."""
    gen = torch.Generator().manual_seed(tp)
    k, n, group = 768, 64, 128
    w = quantize_matrix_int4(torch.randn((k, n), generator=gen) * 0.02, group=group)
    deq = (tw4.unpack_int4(w["q4"]).float() * w["s4"].float()[:, None, :]).reshape(k, n)
    x = torch.randn((5, k), generator=gen)
    assert tl.int4_row_split(6, group, tp) == split
    specs = tl.int4_row_specs(6, group)
    total = 0
    for r in range(tp):
        view = make_mesh(dp=1, tp=tp, rank=r)
        q4, s4 = (apply_specs(view, w[f], specs[f]) for f in ("q4", "s4"))
        units = tl.int4_hidden_units(6, group, tp, r)
        assert 2 * q4.shape[1] == group // split[1] and q4.shape[0] == 6 // split[0]
        part = tw4.matmul_w4_plain(x[:, units], q4, s4)
        torch.testing.assert_close(part, x[:, units] @ deq[units], rtol=0, atol=1e-5)
        chunks = -(-units.numel() // 128)
        for s in range(1, min(chunks, 8) + 1):
            torch.testing.assert_close(tw4.matmul_w4_split_plain(x[:, units], q4, s4, s), part, rtol=0, atol=1e-5)
        total = total + part
    assert torch.unique(torch.cat([tl.int4_hidden_units(6, group, tp, r) for r in range(tp)])).numel() == k
    torch.testing.assert_close(total, tw4.matmul_w4_plain(x, w["q4"], w["s4"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["wo_groups", "no_split"])
def test_shapes_that_do_not_line_up_raise(case):
    """``wo`` of 2 groups over tp 4 (a byte split would cut heads), and a
    ``w2`` of 86 groups of 128 over tp 16 (no factor leaves a group of 32
    or more), raise ``ValueError`` naming the shape."""
    if case == "no_split":
        with pytest.raises(ValueError, match="86 groups of 128 rows has no split over tp=16"):
            tl.int4_row_split(86, 128, 16)
        return
    params = tl.quantize_llama_params_int8(tl.init_llama_params(tl.LlamaConfig(**CFG), torch.Generator()), bits=4)
    with pytest.raises(ValueError, match=r"\(2, 64, 256\) does not split over tp=4"):
        apply_specs(make_mesh(dp=1, tp=4, rank=0), params, tl.llama_tp_specs(params))
