"""Port parity, the sequence- and pipeline-parallel prefills
(``wmar_tpu_torch.parallel.ring``, ``.pipeline``, ``models.llama.
llama_prefill_sp``) against JAX's on the conftest's 8 host devices.

Four gloo ranks (``parallel.launch.spawn_ranks``, a ``file://`` rendezvous
under the test's directory, spawned once for the file) run every case of
``_torch_parallel_ranks.sp_pp_rank``; each case makes its own grid over the
four. The inputs are drawn with numpy from a seed; JAX's functions run on
the same inputs at the same grids (8 devices where the port's four cannot
say ``dp x tp x sp``, the function being the same per row and head).

Bounds, all float32: the ring attention within 1e-5 of the largest |value|;
the prefills' logits, cache and the decode step after them within 1e-4 of
the largest |value| (summation order only: two float32 programs).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.engine.kvcache import KVCache as JKVCache
from wmar_tpu.models import llama as jl
from wmar_tpu.parallel import llama_prefill_pp as jax_prefill_pp
from wmar_tpu.parallel import make_mesh as jax_mesh
from wmar_tpu.parallel import ring_prefill_attention as jax_ring
from wmar_tpu.parallel import stack_blocks as jax_stack_blocks
from wmar_tpu_torch import bridge
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.parallel import llama_prefill_pp, make_mesh, sequence_block, stack_blocks
from wmar_tpu_torch.parallel.launch import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_ranks as ranks  # noqa: E402

RING_GRIDS = {"ring_tp_sp": dict(dp=1, tp=2, sp=2), "ring_sp4": dict(sp=4), "ring_dp_sp": dict(dp=2, sp=2)}
RING_REL = 1e-5
PREFILL_REL = 1e-4
SP_CFG = dict(dim=32, n_layers=2, n_heads=4, vocab_size=64, multiple_of=32, qk_normalization=True)
PP_CFG = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, multiple_of=32, qk_normalization=True)
# (name, port grid, JAX grid, weights, ragged start, microbatches)
PREFILLS = [
    ("sp4", dict(sp=4), dict(dp=2, tp=1, sp=4), "f32", [0, 4], None),
    ("sp2_tp2", dict(tp=2, sp=2), dict(dp=2, tp=2, sp=2), "f32", [0, 4], None),
    ("sp4_int8", dict(sp=4), dict(dp=2, tp=1, sp=4), "int8", [3, 0], None),
    ("pp4", dict(pp=4), dict(dp=2, tp=1, pp=4), "f32", None, 2),
    ("tp2_pp2", dict(tp=2, pp=2), dict(dp=2, tp=2, pp=2), "f32", [0, 2, 1, 0], 4),
    ("pp4_int8", dict(pp=4), dict(dp=2, tp=1, pp=4), "int8", [1, 0, 0, 2], 2),
]
TINY_CHAMELEON = ["--tiny", "--model", "chameleon7b", "--batch_size", "2", "--wm_delta", "4.0", "--seed", "7",
                  "--no_augs", "--device", "cpu"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_params(cfg: jl.LlamaConfig, kind: str):
    params = jl.init_llama_params(jax.random.PRNGKey(0), cfg)
    return jl.quantize_llama_params_int8(params) if kind == "int8" else params


def _ring_case(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((4, 4, 16, 8)).astype(np.float32) for _ in range(3))
    key_mask = rng.random((4, 16)) > 0.25
    key_mask[:, 0] = True
    return {"q": q, "k": k, "v": v, "start": np.asarray([0, 5, 2, 9], np.int32), "key_mask": key_mask}


def _prefill_case(name, weights, start, microbatches) -> dict:
    cfg = jl.LlamaConfig(**(PP_CFG if "pp" in name else SP_CFG))
    rng = np.random.default_rng(len(name))
    b, t, t_max = (4, 6, 10) if "pp" in name else (2, 16, 24)
    st = np.asarray(start if start is not None else [0] * b, np.int32)
    return {"cfg": cfg, "jparams": _jax_params(cfg, weights), "tokens": rng.integers(0, 64, (b, t)).astype(np.int32),
            "start": st, "positions": np.maximum(np.arange(t)[None] - st[:, None], 0).astype(np.int32),
            "next": rng.integers(0, 64, (b, 1)).astype(np.int32), "t_max": t_max, "microbatches": microbatches}


def _to_torch(case: dict) -> dict:
    from wmar_tpu_torch.models.llama import LlamaConfig

    out = {k: torch.as_tensor(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    out["tokens"], out["next"], out["positions"] = (out[k].to(torch.int64) for k in ("tokens", "next", "positions"))
    out["cfg"] = LlamaConfig(**{f: getattr(case["cfg"], f) for f in ("dim", "n_layers", "n_heads", "vocab_size",
                                                                       "multiple_of", "qk_normalization")})
    out["params"] = bridge.load_llama(jax.tree.map(np.asarray, case["jparams"]))
    out.update(t_max=case["t_max"], microbatches=case["microbatches"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("sp_pp"))
    prompts = os.path.join(workdir, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("a red car\nthe sea\n")
    rings = {name: _ring_case(i) for i, name in enumerate(RING_GRIDS)}
    prefills = {name: _prefill_case(name, w, st, m) for name, _, _, w, st, m in PREFILLS}
    generate_argv = TINY_CHAMELEON + ["--conditioning", prompts]
    interleaved_argv = TINY_CHAMELEON + ["--conditioning", "x", "--outdir", "unused"]
    inputs = {
        "ring": [(name, RING_GRIDS[name], {k: torch.as_tensor(v) for k, v in rings[name].items()})
                 for name in RING_GRIDS],
        "prefill": [(name, grid, _to_torch(prefills[name])) for name, grid, *_ in PREFILLS],
        "interleaved": [("interleaved_sp4", dict(sp=4), {"argv": interleaved_argv, "prompt": "a cat"})],
        "generate": {"sp2_tp2": generate_argv + ["--sp", "2", "--tp", "2"]},
    }
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    spawn_ranks(ranks.sp_pp_rank, 4, "gloo", f"file://{workdir}/rendezvous", args=(workdir,))
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    torch.set_num_threads(1)
    ranks.run_generate(generate_argv + ["--outdir", os.path.join(workdir, "one", "sp2_tp2")])
    return {"workdir": workdir, "rings": rings, "prefills": prefills, "ranks": got,
            "interleaved_argv": interleaved_argv}


def _jax_ring(case: dict, mesh):
    """JAX's ring on ``case`` over ``mesh``, heads on tp and rows on dp, jitted (eager, every op of the
    unrolled ring compiles on its own)."""
    ring = jax.jit(lambda q, k, v, start, km: jax_ring(q, k, v, mesh, tp_axis="tp", dp_axis="dp", start=start,
                                                       key_mask=km))
    return ring(*(jnp.asarray(case[x]) for x in ("q", "k", "v", "start", "key_mask")))


@pytest.mark.parametrize("name", sorted(RING_GRIDS))
def test_ring_attention_matches_jax(runs, name):
    """The ranks' blocks put together equal JAX's ``ring_prefill_attention``
    on the same grid (heads over tp, rows over dp, sequence over sp), with a
    ragged ``start`` and a ``key_mask``, within 1e-5 of the largest |value|."""
    case, grid = runs["rings"][name], RING_GRIDS[name]
    dp, tp, sp = grid.get("dp", 1), grid.get("tp", 1), grid.get("sp", 1)
    mesh = jax_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:dp * tp * sp])
    want = np.asarray(_jax_ring(case, mesh))
    got = np.zeros_like(want)
    b, h, t = (want.shape[i] // n for i, n in enumerate((dp, tp, sp)))
    for out in runs["ranks"]:
        at, block = out[name]
        got[at["dp"] * b:(at["dp"] + 1) * b, at["tp"] * h:(at["tp"] + 1) * h,
            at["sp"] * t:(at["sp"] + 1) * t] = block.numpy()
    assert _rel(got, want) <= RING_REL


def test_ring_attention_on_eight_devices_is_the_four_ranks_function(runs):
    """JAX's ring on its ``dp x tp x sp = 2 x 2 x 2`` grid gives what the
    port's ``ring_tp_sp`` grid (``tp 2 x sp 2`` on four ranks) gave: the
    attention is the same per row and per head, so the dp axis moves
    nothing."""
    case = runs["rings"]["ring_tp_sp"]
    want = _jax_ring(case, jax_mesh(dp=2, tp=2, sp=2))
    got = np.zeros(np.shape(want), np.float32)
    for out in runs["ranks"]:
        at, block = out["ring_tp_sp"]
        got[:, at["tp"] * 2:(at["tp"] + 1) * 2, at["sp"] * 8:(at["sp"] + 1) * 8] = block.numpy()
    assert _rel(got, want) <= RING_REL


@pytest.mark.parametrize("name", [p[0] for p in PREFILLS])
def test_prefill_and_decode_handoff_match_jax(runs, name):
    """``llama_prefill_sp`` / ``llama_prefill_pp`` (ragged ``start``, int8
    weights, under ``tp``) against JAX's on its grid: the logits of the
    valid positions, the cache's valid slots (every layer; the tp ranks'
    heads put together) and one decode step from that cache, within 1e-4
    of the largest |value|."""
    _, _, jgrid, _, _, m = PREFILLS[[p[0] for p in PREFILLS].index(name)]
    case = runs["prefills"][name]
    cfg, params = case["cfg"], case["jparams"]
    b, t = case["tokens"].shape
    n = int(np.prod(list(jgrid.values())))
    mesh = jax_mesh(**jgrid, devices=jax.devices()[:n])
    cache0 = JKVCache.zeros(cfg.n_layers, b, cfg.n_heads, case["t_max"], cfg.head_dim)

    @jax.jit  # one program: JAX's eager shard_map compiles every op on its own
    def run(params, tokens, positions, start, nxt, cache):
        if "pp" in jgrid:
            logits, cache = jax_prefill_pp(params, cfg, tokens, cache, positions, mesh, microbatches=m, start=start)
        else:
            logits, cache = jl.llama_prefill_sp(params, cfg, tokens, cache, positions, mesh, tp_axis="tp",
                                                dp_axis="dp", start=start)
        step, _ = jl.llama_forward(params, cfg, nxt, cache, t, (t - start)[:, None], start=start)
        return logits, cache, step

    logits, cache, step = run(params, *(jnp.asarray(case[x]) for x in ("tokens", "positions", "start", "next")),
                              cache0)
    valid = np.arange(t)[None] >= case["start"][:, None]
    slots = (np.arange(case["t_max"])[None] >= case["start"][:, None]) & (np.arange(case["t_max"])[None] < t)
    tp = {o[name][0]["tp"]: o[name] for o in runs["ranks"]}
    for r, out in enumerate(runs["ranks"]):
        got_logits, got_step = out[name][1].numpy(), out[name][4].numpy()
        assert _rel(got_logits[valid], np.asarray(logits)[valid]) <= PREFILL_REL, f"rank {r} logits"
        assert _rel(got_step, step) <= PREFILL_REL, f"rank {r} decode step"
    for i, field in ((2, "k"), (3, "v")):
        got = np.concatenate([tp[j][i].numpy() for j in sorted(tp)], axis=2)  # [L, B, H, T, D]
        want = np.asarray(getattr(cache, field))
        sel = slots[None, :, None, :, None] & np.ones(want.shape, bool)
        assert _rel(got[sel], want[sel]) <= PREFILL_REL, f"cache {field}"


def test_stack_blocks_matches_jax():
    """``stack_blocks`` of an int8 tree: JAX's ``[L, ...]`` leaves, bit for bit."""
    cfg = jl.LlamaConfig(**PP_CFG)
    params = _jax_params(cfg, "int8")
    want = jax_stack_blocks(params["blocks"])
    got = stack_blocks(bridge.load_llama(jax.tree.map(np.asarray, params))["blocks"])
    flat = dict(_leaves(got))
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert flat.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(flat[path].float().numpy() if flat[path].is_floating_point()
                                      else flat[path].numpy(), leaf.astype(np.float32) if leaf.dtype.kind == "f"
                                      else leaf, err_msg=path)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("what", ["layers", "microbatches", "ring"])
def test_bad_geometry_raises_as_in_jax(what):
    """4 layers over 8 stages, a batch of 4 in 3 microbatches and a
    sequence of 15 over a ring of 2 raise ``ValueError`` in both packages
    with JAX's words, before any collective."""
    cfg = jl.LlamaConfig(**PP_CFG)
    case = _to_torch(_prefill_case("pp4", "f32", None, 2))
    tcfg, params, tokens, positions = case["cfg"], case["params"], case["tokens"], case["positions"]
    cache = KVCache.zeros(4, 4, 4, 10, 8)
    jcase = _prefill_case("pp4", "f32", None, 2)
    jcache = JKVCache.zeros(4, 4, 4, 10, 8)
    if what == "layers":
        match = "not divisible by pp"
        with pytest.raises(ValueError, match=match):
            llama_prefill_pp(params, tcfg, tokens, cache, positions, make_mesh(pp=8, rank=0))
        with pytest.raises(ValueError, match=match):
            jax_prefill_pp(jcase["jparams"], cfg, jnp.asarray(jcase["tokens"]), jcache,
                           jnp.asarray(jcase["positions"]), jax_mesh(dp=1, tp=1, pp=8))
    elif what == "microbatches":
        match = "batch 4 not divisible by microbatches=3"
        with pytest.raises(ValueError, match=match):
            llama_prefill_pp(params, tcfg, tokens, cache, positions, make_mesh(pp=2, rank=0), microbatches=3)
        with pytest.raises(ValueError, match=match):
            jax_prefill_pp(jcase["jparams"], cfg, jnp.asarray(jcase["tokens"]), jcache,
                           jnp.asarray(jcase["positions"]), jax_mesh(dp=4, tp=1, pp=2), microbatches=3)
    else:
        match = "seq len 15 not divisible by sp=2"
        with pytest.raises(ValueError, match=match):
            sequence_block(torch.zeros((1, 15)), make_mesh(sp=2, rank=1))
        x = jnp.zeros((1, 1, 15, 8))
        with pytest.raises(ValueError, match=match):
            jax_ring(x, x, x, jax_mesh(dp=4, tp=1, sp=2))


def test_interleaved_sp_prefill_is_token_identical(runs):
    """``sample_interleaved_fused(sp_mesh=)`` over a ring of 4 (the prompt
    right-padded to it, the pad slots key-masked) gives, on every rank, the
    tokens of the replicated prefill under greedy decoding, as JAX's test
    asks of JAX."""
    from wmar_tpu_torch import generate
    from wmar_tpu_torch.models import GenParams
    from wmar_tpu_torch.models.chameleon_interleaved import TextGenOptions, sample_interleaved_fused

    wrapper = generate.load_chameleon(generate.get_parser().parse_args(runs["interleaved_argv"]), torch.device("cpu"))
    want = sample_interleaved_fused(wrapper, "a cat", GenParams(greedy=True),
                                    text_opts=TextGenOptions(max_gen_len=8, greedy=True), max_images=1)
    flat = [(k, np.asarray(t).tolist()) for k, t in want]
    assert any(k == "text_seg" for k, _ in flat)
    for out in runs["ranks"]:
        assert [(k, np.asarray(t).tolist()) for k, t in out["interleaved_sp4"]] == flat


def test_generate_sp2_tp2_matches_one_rank(runs):
    """``generate --sp 2 --tp 2`` over four gloo ranks (the tiny Chameleon's
    t2i: the ring prefill of left-padded prompts on each tp shard) writes
    the codes, ``l0`` and p-values (rtol 1e-6) of the one-rank run, as
    ``tests/test_generate_dp.py`` asks of JAX's ``--sp 2 --tp 2``."""
    from test_torch_generate_dp_tp import _collect

    recs1, codes1 = _collect(os.path.join(runs["workdir"], "one", "sp2_tp2"))
    recs2, codes2 = _collect(os.path.join(runs["workdir"], "sp2_tp2"))
    assert codes1 and recs1.keys() == recs2.keys() and codes1 == codes2
    for rel, rec in recs1.items():
        assert rec["l0"] == recs2[rel]["l0"]
        assert np.isclose(rec["pvalue"], recs2[rel]["pvalue"], rtol=1e-6)


def test_fault_q_jax_interleaved_ignores_the_parallel_flags(tmp_path, monkeypatch):
    """Fault (q): JAX's ``generate.py`` returns into ``run_interleaved``
    (``:397-398``) before its mesh block (``:483``), so ``--interleaved
    --sp 2 --tp 2`` builds no grid and runs the whole model on one device;
    the port's entry point exits naming the fault instead."""
    import generate as jax_generate  # the JAX entry point, at the repository's root
    import wmar_tpu.parallel as jax_parallel
    from wmar_tpu_torch import generate

    prompts = tmp_path / "p.txt"
    prompts.write_text("a cat\n")
    ran = []
    monkeypatch.setattr(jax_generate, "run_interleaved", lambda args, wrapper, wm: ran.append((args.sp, args.tp)))
    monkeypatch.setattr(jax_parallel, "make_mesh", lambda *a, **k: pytest.fail("JAX built a grid"))
    argv = ["--tiny", "--model", "chameleon7b", "--interleaved", str(prompts), "--sp", "2", "--tp", "2",
            "--outdir", str(tmp_path / "out")]
    jax_generate.main(argv)
    assert ran == [(2, 2)]
    with pytest.raises(SystemExit, match=r"fault \(q\)"):
        generate.main(argv + ["--device", "cpu"])


def test_fault_r_jax_sp_with_pp_runs_only_the_pipeline(monkeypatch):
    """Fault (r): JAX's Chameleon prefill with both an ``sp_mesh`` and a
    ``pp_mesh`` (``generate --sp 2 --pp 2``) takes the pipeline and never
    the ring (``wmar_tpu/models/chameleon.py:191-199``); the port's wrapper
    and sampler refuse the pair."""
    import wmar_tpu.parallel.pipeline as jax_pipeline
    from wmar_tpu.models import chameleon as jcham
    from wmar_tpu_torch import generate
    from wmar_tpu_torch.models import GenParams

    vocab = jcham.ChameleonVocab.synthetic(n_codes=4, n_text=2)
    cfg = jl.LlamaConfig(dim=8, n_layers=1, n_heads=1, vocab_size=vocab.vocab_size, multiple_of=8)
    taken = []

    def record(name):
        return lambda params, cfg, tokens, cache, *a, **k: taken.append(name) or (
            jnp.zeros((tokens.shape[0], tokens.shape[1], vocab.vocab_size)), cache)

    monkeypatch.setattr(jax_pipeline, "llama_prefill_pp", record("pp"))
    monkeypatch.setattr(jl, "llama_prefill_sp", record("sp"))
    mesh = jax_mesh(dp=2, tp=1, sp=2, pp=2)
    sampler = jcham.ChameleonT2ISampler({}, cfg, vocab, jnp.zeros((3, 4), jnp.int32), jnp.zeros((3,), jnp.int32),
                                        jcham.ImageCFGOptions(), image_seq_len=4, sp_mesh=mesh, pp_mesh=mesh)
    sampler.prefill()
    assert taken == ["pp"]
    args = generate.get_parser().parse_args(TINY_CHAMELEON + ["--outdir", "unused"])
    wrapper = generate.load_chameleon(args, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"fault \(r\)"):
        wrapper.shard(make_mesh(sp=2, pp=2, rank=0))
    wrapper.mesh = make_mesh(sp=2, pp=2, rank=0)
    with pytest.raises(ValueError, match=r"fault \(r\)"):
        wrapper.sample(["a cat"], GenParams(greedy=True))


@pytest.mark.parametrize("dp,tp,sp,pp", [(1, 2, 2, 1), (2, 1, 1, 4), (1, 1, 2, 2), (2, 2, 2, 1), (1, 2, 1, 4)])
def test_rank_grid_matches_jax_mesh(dp, tp, sp, pp):
    """Rank r of the port's ``(dp, tp[, sp][, pp])`` grid sits where JAX's
    ``make_mesh`` puts device r, with the same axes, for every rank's view;
    its line along each axis is JAX's."""
    jm = jax_mesh(dp=dp, tp=tp, sp=sp, pp=pp, devices=jax.devices()[:dp * tp * sp * pp])
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r in range(ids.size):
        view = make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, rank=r)
        np.testing.assert_array_equal(view.devices, ids)
        assert view.shape == dict(jm.shape) and view.names == tuple(jm.axis_names)
        where = np.argwhere(ids == r)[0]
        for i, axis in enumerate(jm.axis_names):
            assert view.axis_index(axis) == where[i]
            line = list(where)
            line[i] = slice(None)
            assert view.axis_ranks(axis) == ids[tuple(line)].tolist()
        assert (view.sp, view.pp) == (sp, pp)

