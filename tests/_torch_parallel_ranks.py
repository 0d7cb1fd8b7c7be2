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
    ``100 + rank``: ``{dtype: (input, all_reduce, all_gather along dim 1)}``,
    rank 0's tensor as ``replicate`` hands it on, rank 1's as ``broadcast``
    does, and what one ``ring_exchange`` hop brings."""
    from wmar_tpu_torch.parallel import all_gather, all_reduce, broadcast, replicate, ring_exchange

    g = torch.Generator().manual_seed(100 + rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((3, 5, 7), generator=g) * 100).to(dtype)
        out[str(dtype)] = (x, all_reduce(x.clone(), mesh), all_gather(x, mesh, dim=1))
    out["replicated"] = replicate(mesh, {"x": torch.full((4,), float(rank + 7))})["x"]
    out["broadcast"] = broadcast(torch.full((4,), float(rank + 7)), mesh, "tp", 1)
    out["ring"] = ring_exchange(torch.full((2, 3), float(rank)), mesh, "tp")
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
    ``<workdir>/<name>``, in the process group the launcher made; a case
    given as ``(argv, tiny)`` runs with ``generate.TINY_CHAMELEON`` set to
    ``tiny``."""
    torch.set_num_threads(1)
    for name, argv in cases.items():
        argv, tiny = argv if isinstance(argv, tuple) else (argv, None)
        run_generate(list(argv) + ["--outdir", os.path.join(workdir, name)], tiny)


def run_generate(argv, tiny=None):
    """``generate.main(argv)``, with the ``--tiny`` Chameleon's Llama at
    ``tiny`` (a ``TINY_CHAMELEON`` dict) where given."""
    from wmar_tpu_torch import generate

    saved = generate.TINY_CHAMELEON
    generate.TINY_CHAMELEON = tiny or saved
    try:
        return generate.main(argv)
    finally:
        generate.TINY_CHAMELEON = saved


def grid_block(mesh, x, row_dim=0, head_dim=None, seq_dim=None):
    """This rank's block of a global tensor: its rows over ``dp``, its
    heads over ``tp``, its positions over ``sp`` (each where a dim is given)."""
    from wmar_tpu_torch.parallel import sequence_block

    for dim, axis in ((row_dim, "dp"), (head_dim, "tp")):
        if dim is not None:
            n, i = mesh.size_of(axis), mesh.axis_index(axis)
            x = x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)
    return sequence_block(x, mesh, seq_dim) if seq_dim is not None else x


def sp_pp_rank(rank: int, workdir: str) -> None:
    """The sequence- and pipeline-parallel pieces on this rank, for each
    case of ``inputs.pt`` (every rank makes each case's grid, in the same
    order): the ring attention on the rank's block of rows, heads and
    positions; ``llama_prefill_sp`` / ``llama_prefill_pp`` on the rank's
    tp shard (ragged ``start``), then one decode step from the cache they
    built; ``sample_interleaved_fused`` with an ``sp_mesh`` (greedy); then
    ``generate.main`` for each ``generate`` case. Writes ``rank<r>.pt``:
    per case the rank's coordinates and what it computed."""
    from wmar_tpu_torch.engine.kvcache import CacheSpec, KVCache
    from wmar_tpu_torch.models import GenParams, llama
    from wmar_tpu_torch.models.chameleon_interleaved import TextGenOptions, sample_interleaved_fused
    from wmar_tpu_torch.parallel import apply_specs, llama_prefill_pp, make_mesh, ring_prefill_attention

    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for name, grid, case in inputs["ring"]:
        mesh = make_mesh(**grid)
        q, k, v = (grid_block(mesh, case[x], 0, 1, 2) for x in "qkv")
        got = ring_prefill_attention(q, k, v, mesh, start=grid_block(mesh, case["start"]),
                                     key_mask=grid_block(mesh, case["key_mask"]))
        out[name] = ({a: mesh.axis_index(a) for a in ("dp", "tp", "sp")}, got)
    for name, grid, case in inputs["prefill"]:
        mesh = make_mesh(**grid)
        cfg, params, tokens, start, positions = (case[x] for x in ("cfg", "params", "tokens", "start", "positions"))
        if mesh.tp > 1:
            params = apply_specs(mesh, params, llama.llama_tp_specs(params))
        b, t = tokens.shape
        cache = KVCache.zeros(cfg.n_layers, b, cfg.n_heads, case["t_max"], cfg.head_dim,
                              CacheSpec(torch.float32, mesh, None, "tp") if mesh.tp > 1 else torch.float32)
        if mesh.pp > 1:
            logits, cache = llama_prefill_pp(params, cfg, tokens, cache, positions, mesh,
                                             microbatches=case["microbatches"], start=start)
        else:
            logits, cache = llama.llama_prefill_sp(params, cfg, tokens, cache, positions, mesh, start=start)
        step, _ = llama.llama_forward(params, cfg, case["next"], cache, t, (t - start)[:, None].to(torch.int64),
                                      start=start, mesh=mesh)
        out[name] = ({"tp": mesh.axis_index("tp")}, logits, cache.k, cache.v, step)
    for name, grid, case in inputs["interleaved"]:
        from wmar_tpu_torch import generate

        mesh = make_mesh(**grid)
        wrapper = generate.load_chameleon(generate.get_parser().parse_args(case["argv"]), torch.device("cpu"))
        out[name] = sample_interleaved_fused(wrapper, case["prompt"], GenParams(greedy=True),
                                             text_opts=TextGenOptions(max_gen_len=8, greedy=True), max_images=1,
                                             sp_mesh=mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    for name, argv in inputs["generate"].items():
        run_generate(list(argv) + ["--outdir", os.path.join(workdir, name)])


def finetune_rank(rank: int, workdir: str, cases: list) -> None:
    """The trainers under a launcher, in the process group it made: for
    each ``(name, entry, argv)`` of ``cases`` in order, ``finetune.cli.main``
    (``entry`` ``"rcc"``; handed the adapter ``adapters.pt`` holds under
    ``name``, where it holds one) or ``finetune_mimi.main`` (``"mimi"``),
    with ``{rank}`` in ``argv`` replaced by the rank, each case after the
    last one's files are written. Then, where the test
    left ``units.pt``, :func:`dp_units`."""
    import torch.distributed as dist

    from wmar_tpu_torch import finetune_mimi
    from wmar_tpu_torch.finetune import cli

    torch.set_num_threads(1)
    path = os.path.join(workdir, "adapters.pt")
    adapters = torch.load(path, weights_only=False) if os.path.exists(path) else {}
    for name, entry, argv in cases:
        argv = [a.replace("{rank}", str(rank)) for a in argv]
        if entry == "rcc":
            cli.main(argv, adapter=adapters.get(name))
        else:
            finetune_mimi.main(argv)
        dist.barrier()  # the next case starts after the first rank's files, as a new launch would
    if os.path.exists(os.path.join(workdir, "units.pt")):
        torch.save(dp_units(torch.load(os.path.join(workdir, "units.pt"), weights_only=False)),
                   os.path.join(workdir, f"rank{rank}_units.pt"))


def dp_units(inputs: dict, mesh=None) -> dict:
    """Each data-parallel piece on this rank's rows of ``inputs``' global
    batch, computed two ways: ``"dp"`` as the trainers run it on a dp rank
    of ``mesh`` (the run's grid when None) and ``"local"`` from this rank's
    rows alone. Each entry is a value (the rank's) and, for a loss, its
    gradient with respect to the rank's rows over dp (the rank's share of
    the mean of the ranks' gradients). With ``mesh`` a one-rank grid, the
    one process's numbers on the whole batch."""
    import argparse

    from wmar_tpu_torch.audio import augmentations as A
    from wmar_tpu_torch.audio.losses import get_audio_loss
    from wmar_tpu_torch.finetune import cli, gan, rcc
    from wmar_tpu_torch.finetune.perceptual import PerceptualLoss
    from wmar_tpu_torch.parallel import dp_size, make_mesh, rows_of

    mesh = make_mesh(tp=1) if mesh is None else mesh
    dp = dp_size(mesh)
    out = {}

    adapter = cli.build_adapter(argparse.Namespace(model="taming", tiny=True), torch.device("cpu"))
    trainable = adapter.init_trainable()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():  # a decoder past the first step, so that the drift has a gradient
        for p in trainable["decoder"].parameters():
            p.add_(1e-2 * torch.randn(p.shape, generator=g))
    cfg = gan.GanConfig(gan.init_taming_discriminator(torch.Generator().manual_seed(1), ndf=16))
    decoder, perceptual = trainable["decoder"], PerceptualLoss()
    z_q = adapter.lookup(rows_of(mesh, inputs["codes"]))
    xrec = adapter.decode(decoder, z_q)
    with torch.no_grad():
        xrec_orig = adapter.decode_orig(z_q)
    out["gan_weight"] = {how: (gan.gan_generator_terms(
        cfg, decoder, lambda params: adapter.decode_with(decoder, params, z_q), xrec,
        lambda xr: (xrec_orig - xr).abs().mean() + perceptual(xrec_orig, xr).mean(), 0, m)["d_weight"], None)
        for how, m in (("dp", mesh), ("local", None))}

    for name in ("mrstft", "tf_loudness"):
        out[name] = {}
        for how, m in (("dp", mesh), ("local", None)):
            x = rows_of(mesh, inputs["pred"]).clone().requires_grad_(True)
            loss = get_audio_loss(name, 24000, m)(x, rows_of(mesh, inputs["target"]))
            loss.backward()
            out[name][how] = (loss.detach(), x.grad / dp)

    out["noise"] = {}
    for how, m in (("dp", mesh), ("local", None)):
        image = rcc.AugBranch("noise", 0.1)(rows_of(mesh, inputs["images"]), torch.Generator().manual_seed(5), mesh=m)
        pink = A.pink_noise(rows_of(mesh, inputs["audio"]), 0.02, torch.Generator().manual_seed(6), mesh=m)
        out["noise"][how] = (image, pink)
    return out
