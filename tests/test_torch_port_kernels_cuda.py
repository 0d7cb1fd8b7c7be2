"""The port's hand-written CUDA kernels on the card, against their plain
versions. Marked ``cuda``: without a CUDA card every test skips. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels_cuda.py
"""

import copy
import os

import pytest
import torch

from wmar_tpu_torch.engine.kvcache import KVCache, Packed4QuantKVCache, PackedQuantKVCache
from wmar_tpu_torch.ops import flash_decode as fd
from wmar_tpu_torch.ops import w4_matmul as tw4
from wmar_tpu_torch.ops import wquant
from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention, packed4_decode_attention_plain
from wmar_tpu_torch.ops.w4_matmul import matmul_w4, matmul_w4_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cache(n_layers, b, h, t, d, device, seed=0, cls=Packed4QuantKVCache):
    g = torch.Generator(device=device).manual_seed(seed)
    cache = cls.zeros(n_layers, b, h, t, d, device=device)
    for li in range(n_layers):
        k, v = (torch.randn((b, h, t, d), generator=g, device=device) for _ in range(2))
        cache.write(li, 0, k, v)
    return cache, g


@pytest.mark.parametrize("d", [6, 16, 20, 30, 48, 80, 88, 104, 128, 132, 256])
@pytest.mark.parametrize("t", [1, 33, 257, 258, 1023])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(device, d, t, q_dtype):
    """Kernel #1 (the tiled kernel of kernels #3/#4 without masks; at D = 132
    the slot-by-slot kernel, at D = 6 and 30 the same byte by byte) against
    its plain version: max abs error, relative to the largest output, 2^-8 +
    1e-5 for bf16 q (bf16's rounding of the output plus float32 summation
    order) and 1e-5 for f32 q. One launch counted per call, on kernel #1's
    count only. T = 1023 at D = 256 was past the first design's 48 KB of
    scores."""
    b, h = 5, 3
    cache, g = _cache(2, b, h, t, d, device, seed=d + t)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    for layer in (0, 1):
        for n in sorted({1, 2, t // 2 + 1, max(t - 1, 1), t}):
            before = (packed4_decode_attention.launches, fd.packed4_decode_attention_chunked.launches)
            got = packed4_decode_attention(q, cache.kv, cache.scale, layer,
                                           torch.full((1,), n, dtype=torch.int32, device=device))
            torch.cuda.synchronize()
            assert (packed4_decode_attention.launches, fd.packed4_decode_attention_chunked.launches) == (
                before[0] + 1, before[1])
            want = packed4_decode_attention_plain(q.float(), cache.kv, cache.scale, layer, n)
            assert got.dtype == q_dtype and got.shape == (b, h, 1, d)
            err = (got.float() - want).abs().max().item()
            assert err <= rel * want.abs().max().item() + 1e-6, (layer, n, err)
            for wh in (True, False) if fd.packed_decode_tile(d) and d % 4 == 0 else ():  # both layouts of the tiled kernel
                lens = torch.full((1,), n, dtype=torch.int32, device=device)
                one = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, None, None, True, splits=1, warp_head=wh)
                two = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, None, None, True, splits=1, warp_head=wh)
                torch.cuda.synchronize()
                assert (one.float() - want).abs().max().item() <= rel * want.abs().max().item() + 1e-6, (n, wh)
                assert torch.equal(one, two), (n, wh)


def test_packed4_launches_per_route(device):
    """``packed4_decode_attention`` counts kernel #1 below 1024 slots (the
    tiled kernel, the slot-by-slot one at D = 132 and 6, and a payload view
    off its 16-byte alignment) and kernel #4's count from 1024 on; the
    private launcher counts nothing."""
    k1, k4 = packed4_decode_attention, fd.packed4_decode_attention_chunked
    for t, d, want in ((1023, 128, (1, 0)), (1024, 128, (0, 1)), (40, 132, (1, 0)), (40, 6, (1, 0))):
        cache, g = _cache(1, 2, 2, t, d, device, seed=t)
        q = torch.randn((2, 2, 1, d), generator=g, device=device)
        before = (k1.launches, k4.launches)
        k1(q, cache.kv, cache.scale, 0, t)
        assert (k1.launches - before[0], k4.launches - before[1]) == want, (t, d)
    cache, g = _cache(1, 2, 2, 40, 16, device)
    flat = torch.zeros(cache.kv.numel() + 16, dtype=torch.uint8, device=device)
    shifted = flat[4:4 + cache.kv.numel()].view(cache.kv.shape)
    shifted.copy_(cache.kv)
    q = torch.randn((2, 2, 1, 16), generator=g, device=device)
    before = k1.launches
    got = k1(q, shifted, cache.scale, 0, 40)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    torch.testing.assert_close(got, packed4_decode_attention_plain(q, cache.kv, cache.scale, 0, 40), rtol=1e-5,
                               atol=1e-5)
    before = (k1.launches, k4.launches)
    fd._launch_packed(q, cache.kv, cache.scale, 0, 40, None, None, True, splits=2)
    assert (k1.launches, k4.launches) == before


# (wrapper that launches the kernel, its plain version, cache class, T)
PACKED_KERNELS = {
    "q8": (fd.packed_decode_attention_q8, fd.packed_decode_attention_q8_plain, PackedQuantKVCache, 40),
    "q8_chunked": (fd.packed_decode_attention_q8_chunked, fd.packed_decode_attention_q8_plain,
                   PackedQuantKVCache, 1100),
    "packed4_chunked": (fd.packed4_decode_attention_chunked, fd.packed4_decode_attention_plain,
                        Packed4QuantKVCache, 1100),
}


PACKED_SPLITS = (1, 2, 3, 8, 16)  # forced through the private launcher; the wrappers take the planner's choice


@pytest.mark.parametrize("kernel", list(PACKED_KERNELS))
@pytest.mark.parametrize("d", [16, 20, 80, 88, 104, 128, 132, 256])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_packed_kernels_match_plain(device, kernel, d, q_dtype):
    """Kernels #2-#4 against their plain float32 versions, with and without
    a ragged ``start`` and a random ``key_mask`` on the chunked ones, at the
    tolerances of kernel #1. Every row keeps at least one valid slot (the
    kernels' precondition). Each goes through the wrapper (the planner's
    layout) and through the private launcher with 1, 2, 3, 8 and 16 blocks
    per (row, head) forced (``valid_len`` 1, 128 and 129 leave shares empty)
    and with a warp per (row, head), twice with equal bits: kernel #2 is the
    tiled kernel of #3 below 1024 slots, so it takes both layouts too. The
    head dims cover the 16-byte loads (16, 80, 128, 256), the 8-byte (88,
    104) and the 4-byte (20); 132 fits no warp and takes the slot-by-slot
    kernel."""
    launch, plain, cls, t = PACKED_KERNELS[kernel]
    b, h = 5, 3
    cache, g = _cache(2, b, h, t, d, device, seed=d, cls=cls)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    masks = [(None, None)]
    if kernel != "q8":
        start = torch.randint(0, 300, (b,), generator=g, device=device, dtype=torch.int32)
        key_mask = torch.rand((b, t), generator=g, device=device) < 0.7
        masks += [(start, None), (None, key_mask), (start, key_mask)]
    for layer in (0, 1):
        for n in ((1, 17, 39, 40) if t < 1024 else (1, 128, 129, 600, t)):
            for start, key_mask in masks:
                if start is not None:
                    start = torch.clamp(start, max=n - 1)
                if key_mask is not None:
                    key_mask = key_mask.clone()
                    key_mask[torch.arange(b, device=device), start if start is not None else 0] = True
                before = launch.launches
                got = launch(q, cache.kv, cache.scale, layer, torch.full((1,), n, dtype=torch.int32, device=device),
                             start=start, key_mask=key_mask)
                torch.cuda.synchronize()
                assert launch.launches == before + 1
                want = plain(q.float(), cache.kv, cache.scale, layer, n, start, key_mask)
                assert got.dtype == q_dtype and got.shape == (b, h, 1, d)
                err = (got.float() - want).abs().max().item()
                assert err <= rel * want.abs().max().item() + 1e-6, (layer, n, start is None, key_mask is None, err)
                for splits, wh in ([(s_, False) for s_ in PACKED_SPLITS] + [(1, True)] if layer == 1 else ()):
                    args = (q, cache.kv, cache.scale, layer, torch.full((1,), n, dtype=torch.int32, device=device),
                            start, key_mask, kernel == "packed4_chunked")
                    forced = fd._launch_packed(*args, splits=splits, warp_head=wh)
                    again = fd._launch_packed(*args, splits=splits, warp_head=wh)
                    torch.cuda.synchronize()
                    err = (forced.float() - want).abs().max().item()
                    assert err <= rel * want.abs().max().item() + 1e-6, (n, start is None, key_mask is None, splits, err)
                    assert torch.equal(forced, again), (n, splits)
                assert launch.launches == before + 1  # the private launcher counts nothing


@pytest.mark.parametrize("d", [6, 16, 20, 48, 80, 88, 104, 128, 132, 256])
@pytest.mark.parametrize("t", [1, 33, 257, 258, 1023])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_q8_kernel_matches_plain(device, d, t, q_dtype):
    """Kernel #2 (the tiled kernel over the int8 cache without masks; at D =
    132 the slot-by-slot kernel; D = 6 raises: int8 slots are read in 32-bit
    words) against its plain version at kernel #1's tolerances: at D = 80
    over 128 rows x 16 heads, where the planner gives a warp per (row, head)
    on the H100's 132 SMs, else over 12 x 16 (blocks of four warps); both
    layouts also forced at S = 1, twice with equal bits. One launch per
    call, counted on kernel #2 only."""
    k2, k3 = fd.packed_decode_attention_q8, fd.packed_decode_attention_q8_chunked
    b, h = (128, 16) if d == 80 else (12, 16)
    cache, g = _cache(2, b, h, t, d, device, seed=d + t, cls=PackedQuantKVCache)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    if d % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            k2(q, cache.kv, cache.scale, 0, t)
        return
    for layer in (0, 1):
        for n in sorted({1, 2, t // 2 + 1, max(t - 1, 1), t}):
            lens = torch.full((1,), n, dtype=torch.int32, device=device)
            before = (k2.launches, k3.launches)
            got = k2(q, cache.kv, cache.scale, layer, lens)
            torch.cuda.synchronize()
            assert (k2.launches, k3.launches) == (before[0] + 1, before[1])
            want = fd.packed_decode_attention_q8_plain(q.float(), cache.kv, cache.scale, layer, n)
            assert got.dtype == q_dtype and got.shape == (b, h, 1, d)
            err = (got.float() - want).abs().max().item()
            assert err <= rel * want.abs().max().item() + 1e-6, (layer, n, err)
            for wh in (True, False) if fd.packed_decode_tile(d) else ():
                one = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, None, None, False, splits=1, warp_head=wh)
                two = fd._launch_packed(q, cache.kv, cache.scale, layer, lens, None, None, False, splits=1, warp_head=wh)
                torch.cuda.synchronize()
                assert (one.float() - want).abs().max().item() <= rel * want.abs().max().item() + 1e-6, (n, wh)
                assert torch.equal(one, two), (n, wh)


def test_packed_blocks_per_sm(device):
    """The tiled kernel's instantiations share an SM as their rings and
    launch bounds ask: the int8 kernel at RAR-XL's D = 80 (three-stage ring
    of 36 KB) and at Taming's D = 104 (the window) four blocks, so that
    either main path's 512 blocks run in one wave on 132 SMs; int4 six (the
    768 blocks of a Chameleon call); int8 at D = 128 three (64 KB). Where
    the int8 loads go through L1 (a warp per (row, head), the window) the
    DMA probe's blocks share an SM as the attention's they time."""
    assert fd.packed_blocks_per_sm(80, False, True) == 4
    assert fd.packed_blocks_per_sm(104, False, False) == 4
    assert fd.packed_blocks_per_sm(128, True, False) == 6
    assert fd.packed_blocks_per_sm(128, False, False) == 3
    for d, warp_head in ((80, True), (104, False), (104, True), (128, True)):
        assert fd.packed_blocks_per_sm(d, False, warp_head, probe=True) == fd.packed_blocks_per_sm(d, False, warp_head)


@pytest.mark.parametrize("b,t,h,d", [(128, 258, 16, 80), (32, 257, 16, 104)], ids=["rar_xl", "taming"])
def test_packed_q8_replays_from_a_cuda_graph(device, b, t, h, d):
    """One launch of kernel #2 captured in a CUDA graph at the RAR-XL shape
    (a warp per (row, head)) and at Taming-1.4B's (blocks of four warps),
    replayed after ``valid_len`` was changed in place, gives the bits of a
    fresh call."""
    launch = fd.packed_decode_attention_q8
    cache, g = _cache(2, b, h, t, d, device, seed=b, cls=PackedQuantKVCache)
    q = torch.randn((b, h, 1, d), generator=g, device=device, dtype=torch.bfloat16)
    if fd._sm_count(0) == 132:
        assert fd.packed_decode_plan(b, h, t, d, False, 132).warp_head == (b == 128)
    lens = torch.full((1,), 2, dtype=torch.int32, device=device)
    launch(q, cache.kv, cache.scale, 1, lens)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, cache.kv, cache.scale, 1, lens)
    for n in (2, 1, 129, t):
        lens.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, launch(q, cache.kv, cache.scale, 1, lens)), n
        want = fd.packed_decode_attention_q8_plain(q.float(), cache.kv, cache.scale, 1, n)
        assert (out.float() - want).abs().max().item() <= (2.0**-8 + 1e-5) * want.abs().max().item() + 1e-6, n


@pytest.mark.parametrize("kernel", ["q8_chunked", "packed4_chunked"])
def test_packed_chunked_kernels_replay_from_a_cuda_graph(device, kernel):
    """One launch of kernel #3 or #4 captured in a CUDA graph (the split
    count comes from the shapes alone) and replayed after ``valid_len``,
    ``start`` and ``key_mask`` were changed in place gives the bits of a
    fresh call."""
    launch, _, cls, _ = PACKED_KERNELS[kernel]
    b, h, t, d = 3, 8, 4096, 128
    cache, g = _cache(2, b, h, t, d, device, seed=5, cls=cls)
    q = torch.randn((b, h, 1, d), generator=g, device=device, dtype=torch.bfloat16)
    lens = torch.full((1,), 700, dtype=torch.int32, device=device)
    start = torch.zeros(b, dtype=torch.int32, device=device)
    key_mask = torch.rand((b, t), generator=g, device=device) < 0.5
    later_mask = torch.rand((b, t), generator=g, device=device) < 0.8
    key_mask[:, :40] = later_mask[:, :40] = True  # every start below keeps a slot
    launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)  # the scratch, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)
    for n, first, mask in ((700, 0, key_mask.clone()), (1, 0, key_mask.clone()), (3000, 33, later_mask),
                           (4096, 7, later_mask)):
        lens.fill_(n)
        start.copy_(torch.tensor([0, first, first // 2], dtype=torch.int32))
        key_mask.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        fresh = launch(q, cache.kv, cache.scale, 1, lens, start=start, key_mask=key_mask)
        assert torch.equal(out, fresh), n


@pytest.mark.parametrize("kernel", ["q8_chunked", "packed4_chunked"])
def test_packed_chunked_kernels_skip_masked_slots(device, kernel):
    """A masked slot costs its mask byte only: NaN scales planted at the
    masked slots of the kernel's input do not reach the output, which equals
    the plain version's on a clean copy; a Python-int ``valid_len`` works; a
    row with no slot that takes part gets zeros."""
    launch, plain, cls, _ = PACKED_KERNELS[kernel]
    b, h, t, d = 3, 2, 1100, 16
    cache, g = _cache(1, b, h, t, d, device, seed=1, cls=cls)
    q = torch.randn((b, h, 1, d), generator=g, device=device)
    km = torch.rand((b, t), generator=g, device=device) < 0.5
    km[:, 3] = True
    want = plain(q, cache.kv, cache.scale, 0, 900, None, km)
    poisoned = cache.scale.clone()
    poisoned[0][~km[:, None, :].expand(b, 2 * h, t)] = float("nan")
    for splits in (None, 1, 5):
        got = fd._launch_packed(q, cache.kv, poisoned, 0, 900, None, km, kernel == "packed4_chunked", splits=splits)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    km[1] = False
    got = launch(q, cache.kv, poisoned, 0, 900, key_mask=km)
    assert bool((got[1] == 0).all()) and torch.isfinite(got).all()


def test_packed_chunked_kernels_reject_bad_inputs(device):
    """Wrong dtypes, shapes, devices, a head dim that is no multiple of 4, a
    payload that is not aligned to its 16-byte loads, a bad split count and
    mis-shaped masks raise, and nothing is counted."""
    b, h, t, d = 2, 2, 1024, 16
    c4, _ = _cache(1, b, h, t, d, device)
    c8, _ = _cache(1, b, h, t, d, device, cls=PackedQuantKVCache)
    q = torch.zeros((b, h, 1, d), device=device)
    k4, k8 = fd.packed4_decode_attention_chunked, fd.packed_decode_attention_q8_chunked
    before = (k4.launches, k8.launches)
    with pytest.raises(TypeError):
        k4(q.half(), c4.kv, c4.scale, 0, 4)
    with pytest.raises(TypeError):
        k4(q, c8.kv, c8.scale, 0, 4)
    with pytest.raises(TypeError):
        k8(q, c4.kv, c4.scale, 0, 4)
    with pytest.raises(ValueError):
        k8(q, c8.kv.cpu(), c8.scale, 0, 4)
    with pytest.raises(ValueError):
        k4(torch.zeros((b, h, 2, d), device=device), c4.kv, c4.scale, 0, 4)
    with pytest.raises(IndexError):
        k4(q, c4.kv, c4.scale, 1, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        k4(torch.zeros((b, h, 1, 6), device=device), torch.zeros((1, b, t, h * 6), dtype=torch.uint8, device=device),
           torch.ones((1, b, 2 * h, t), dtype=torch.bfloat16, device=device), 0, 4)
    with pytest.raises(ValueError, match="key_mask"):
        k4(q, c4.kv, c4.scale, 0, 4, key_mask=torch.ones((b, t + 1), dtype=torch.bool, device=device))
    with pytest.raises(ValueError, match="start"):
        k8(q, c8.kv, c8.scale, 0, 4, start=torch.zeros(b + 1, dtype=torch.int32, device=device))
    with pytest.raises(ValueError, match="splits"):
        fd._launch_packed(q, c4.kv, c4.scale, 0, 4, None, None, True, splits=17)
    flat = torch.zeros(c4.kv.numel() + 16, dtype=torch.uint8, device=device)
    shifted = flat[4:4 + c4.kv.numel()].view(c4.kv.shape)  # contiguous, 4 bytes past an aligned address
    with pytest.raises(ValueError, match="aligned"):
        k4(q, shifted, c4.scale, 0, 4)
    assert before == (k4.launches, k8.launches)


def test_packed_wrappers_route_by_length(device):
    """The public wrappers take the chunked kernels from 1024 slots on and
    refuse start/key_mask below that, as the JAX wrappers do."""
    for public, chunked, cls in ((fd.packed4_decode_attention, fd.packed4_decode_attention_chunked,
                                  Packed4QuantKVCache),
                                 (fd.packed_decode_attention_q8, fd.packed_decode_attention_q8_chunked,
                                  PackedQuantKVCache)):
        long, _ = _cache(1, 2, 2, 1024, 16, device, cls=cls)
        q = torch.randn((2, 2, 1, 16), device=device)
        before = (public.launches, chunked.launches)
        public(q, long.kv, long.scale, 0, 5, start=torch.zeros(2, dtype=torch.int32, device=device))
        assert (public.launches, chunked.launches) == (before[0], before[1] + 1)
        short, _ = _cache(1, 2, 2, 16, 16, device, cls=cls)
        with pytest.raises(ValueError, match="chunked"):
            public(q, short.kv, short.scale, 0, 5, key_mask=torch.ones((2, 16), dtype=torch.bool, device=device))


def test_kernel_rejects_bad_inputs(device):
    cache, _ = _cache(1, 2, 2, 8, 16, device)
    q = torch.zeros((2, 2, 1, 16), device=device)
    with pytest.raises(TypeError):
        packed4_decode_attention(q.half(), cache.kv, cache.scale, 0, 4)
    with pytest.raises(ValueError):
        packed4_decode_attention(q, cache.kv.cpu(), cache.scale, 0, 4)
    with pytest.raises(ValueError):
        packed4_decode_attention(torch.zeros((2, 2, 2, 16), device=device), cache.kv, cache.scale, 0, 4)
    with pytest.raises(ValueError):
        packed4_decode_attention(torch.zeros((2, 2, 1, 32), device=device)[..., ::2], cache.kv, cache.scale, 0, 4)
    with pytest.raises(IndexError):
        packed4_decode_attention(q, cache.kv, cache.scale, 1, 4)


def test_tiny_main_path_runs_through_the_kernel(device):
    """A tiny RarARMM with a packed4 cache on the card: every decode step's
    attention launches the kernel, and greedy tokens agree with the CPU run
    of the plain version on >= 95% of the positions."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.models import GenParams, MaskGitVQConfig, RARConfig, RarARMM, init_maskgit, init_rar

    cfg = RARConfig(embed_dim=80, depth=2, num_heads=2, intermediate_size=128, image_seq_len=16,
                    codebook_size=64, num_classes=10)
    vq_cfg = MaskGitVQConfig(resolution=8, hidden_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                             z_channels=16, n_embed=64, embed_dim=16)
    out = {}
    for dev in (device, torch.device("cpu")):
        g = torch.Generator().manual_seed(0)
        rar = init_rar(cfg, g)
        with torch.no_grad():
            for blk in rar.blocks:
                blk.adaln.w = torch.randn(blk.adaln.w.shape, generator=g) * 0.05
        wrapper = RarARMM(rar, init_maskgit(vq_cfg, g), cache_dtype="packed4", device=dev)
        wrapper.set_watermarker(WatermarkSpec.from_string("linear-rand-h=1-d=2.0-g=0.25", vocab_size=64,
                                                          spatial_dim=4))
        packed4_decode_attention.launches = 0
        codes = wrapper.sample(list(range(6)), GenParams(greedy=True), apply_watermark=True)
        out[dev.type] = (codes.cpu(), packed4_decode_attention.launches)
    assert out["cuda"][1] == (cfg.image_seq_len - 1) * cfg.depth and out["cpu"][1] == 0
    assert (out["cuda"][0] == out["cpu"][0]).float().mean() >= 0.95


def test_decode_loop_never_syncs(device):
    """The 15 decode steps after prefill (model step, watermark bias, draw,
    kernel) run with CUDA's sync debug mode set to raise on any host sync."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.core.greenlist import HashGreenlist
    from wmar_tpu_torch.engine.decode import SamplerConfig, WatermarkRuntime, decode_tokens
    from wmar_tpu_torch.models import RARConfig, RARSampler, init_rar

    cfg = RARConfig(embed_dim=64, depth=2, num_heads=4, intermediate_size=128, image_seq_len=16,
                    codebook_size=64, num_classes=10)
    rar = init_rar(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    spec = WatermarkSpec.from_string("linear-rand-h=1-d=2.0-g=0.25", vocab_size=64, spatial_dim=4)
    wm = WatermarkRuntime(spec, HashGreenlist(spec, device=device))
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.inference_mode():
        sampler = RARSampler(rar, torch.arange(4, device=device), cache_dtype="packed4")
        logits, cache = sampler.prefill()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tokens, _ = decode_tokens(sampler.step_fn, cache, logits, cfg.image_seq_len,
                                      SamplerConfig(top_k=20, top_p=0.9), watermark=wm, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert tokens.shape == (4, 16) and int(tokens.max()) < 64


# (M, K, N) of kernel #8 on the main paths: Taming-1.4B (32 rows), Chameleon-7B
# (24 rows, the vocab head cut to 4160 columns), RAR-XL (128 rows) and ragged
# row counts (Chameleon's prefill of 24 rows x 19 tokens is 456)
W4_SHAPES = [(32, 1664, 1664), (32, 1664, 6656), (32, 6656, 1664), (32, 1664, 16384),
             (24, 4096, 4096), (24, 4096, 11008), (24, 11008, 4096), (24, 4096, 4160),
             (128, 1280, 3840), (128, 5120, 1280), (128, 1280, 1024),
             (1, 4096, 4096), (7, 4096, 4096), (456, 4096, 4096)]


@pytest.mark.parametrize("m,k,n", W4_SHAPES)
@pytest.mark.parametrize("group", [128, 64, 32])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_matches_plain(device, m, k, n, group, x_dtype):
    """Kernel #8 against its plain float32 version: max abs error within
    2^-8 + 1e-5 of max|y| for bf16 x (bf16's rounding of the output plus
    float32 summation order), 1e-5 for f32 x. Leading dimensions are
    flattened and restored; one launch per call."""
    g = torch.Generator(device=device).manual_seed(m * 7 + k + n + group)
    w = wquant.quantize_matrix_int4(torch.randn((k, n), generator=g, device=device) * 0.02, group=group)
    x = torch.randn((1, m, k), generator=g, device=device).to(x_dtype)
    before = matmul_w4.launches
    got = matmul_w4(x, w["q4"], w["s4"])
    torch.cuda.synchronize()
    assert matmul_w4.launches == before + 1
    want = matmul_w4_plain(x.float(), w["q4"], w["s4"])
    assert got.dtype == x_dtype and got.shape == (1, m, n)
    rel = 2.0**-8 + 1e-5 if x_dtype == torch.bfloat16 else 1e-5
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err


W4_SPLIT_M = [1, 7, 17, 32, 33, 128, 456]


@pytest.mark.parametrize("m", W4_SPLIT_M)
@pytest.mark.parametrize("n", [1664, 1000, 16384])
@pytest.mark.parametrize("group", [128, 64, 32])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_forced_splits(device, m, n, group, x_dtype):
    """Kernel #8 at K = 1664 (13 chunks of 128) against its plain version,
    at the tolerances above: through the wrapper (the planner's split count
    on the tensor cores for bf16 x; the CUDA-core kernel for f32 x), and for
    bf16 x with every split count from 1 to 8 (a cluster's most) forced
    through the private launcher, twice with equal bits. N = 1000 leaves the last 128-column tile
    ragged and takes 8-byte copies of q."""
    k = 1664
    g = torch.Generator(device=device).manual_seed(m + n + group)
    w = wquant.quantize_matrix_int4(torch.randn((k, n), generator=g, device=device) * 0.02, group=group)
    x = torch.randn((m, k), generator=g, device=device).to(x_dtype)
    want = matmul_w4_plain(x.float(), w["q4"], w["s4"])
    tol = (2.0**-8 + 1e-5 if x_dtype == torch.bfloat16 else 1e-5) * want.abs().max().item() + 1e-6
    before = matmul_w4.launches
    got = matmul_w4(x, w["q4"], w["s4"])
    torch.cuda.synchronize()
    assert matmul_w4.launches == before + 1 and got.dtype == x_dtype and got.shape == (m, n)
    assert (got.float() - want).abs().max().item() <= tol
    for splits in range(1, 9) if x_dtype == torch.bfloat16 else ():
        one, two = tw4._launch(x, w["q4"], w["s4"], splits=splits), tw4._launch(x, w["q4"], w["s4"], splits=splits)
        torch.cuda.synchronize()
        assert (one.float() - want).abs().max().item() <= tol, splits
        assert torch.equal(one, two), splits
    assert matmul_w4.launches == before + 1  # the private launcher counts nothing


@pytest.mark.parametrize("m,k,group", [(5, 352, 32), (20, 320, 64), (3, 96, 32)])
def test_w4_matmul_ragged_chunks(device, m, k, group):
    """A K that is no multiple of 128 leaves the last chunk part empty; every
    split count up to the chunks, against the plain version."""
    g = torch.Generator(device=device).manual_seed(k)
    w = wquant.quantize_matrix_int4(torch.randn((k, 264), generator=g, device=device) * 0.02, group=group)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
    want = matmul_w4_plain(x.float(), w["q4"], w["s4"])
    tol = (2.0**-8 + 1e-5) * want.abs().max().item() + 1e-6
    for splits in range(1, min(-(-k // 128), 8) + 1):
        got = tw4._launch(x, w["q4"], w["s4"], splits=splits)
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() <= tol, splits


@pytest.mark.parametrize("m,k,n", [(32, 1664, 1664), (24, 4096, 11008)])
def test_w4_matmul_replays_from_a_cuda_graph(device, m, k, n):
    """One launch of kernel #8 (with the planner's split count, above 1 at
    these shapes) captured in a CUDA graph and replayed after x changed in
    place gives the bits of a fresh call."""
    g = torch.Generator(device=device).manual_seed(n)
    w = wquant.quantize_matrix_int4(torch.randn((k, n), generator=g, device=device) * 0.02, group=128)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
    assert tw4.w4_splits(m, n, k, 128, fd._sm_count(device.index)) > 1
    matmul_w4(x, w["q4"], w["s4"])  # the kernel library is loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul_w4(x, w["q4"], w["s4"])
    for _ in range(2):
        x.copy_(torch.randn((m, k), generator=g, device=device))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, matmul_w4(x, w["q4"], w["s4"]))


def test_w4_matmul_rejects_bad_inputs(device):
    """A wrong dtype, a mismatched K, a non-contiguous x, an unsupported group
    or operands on two devices raise, and nothing is launched."""
    w = wquant.quantize_matrix_int4(torch.randn((256, 64), device=device), group=128)
    q4, s4 = w["q4"], w["s4"]
    x = torch.randn((4, 256), device=device, dtype=torch.bfloat16)
    before = matmul_w4.launches
    with pytest.raises(TypeError):
        matmul_w4(x.half(), q4, s4)
    with pytest.raises(TypeError):
        matmul_w4(x, q4.to(torch.int8), s4)
    with pytest.raises(TypeError):
        matmul_w4(x, q4, s4.float())
    with pytest.raises(ValueError, match="K"):
        matmul_w4(x[:, :128].contiguous(), q4, s4)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_w4(torch.randn((256, 4), device=device, dtype=torch.bfloat16).t(), q4, s4)
    with pytest.raises(ValueError, match="group"):  # groups of 16
        matmul_w4(x, q4.reshape(16, 8, 64), torch.ones((16, 64), dtype=torch.bfloat16, device=device))
    with pytest.raises(ValueError, match="device"):
        matmul_w4(x, q4.cpu(), s4)
    flat = torch.zeros(x.numel() + 8, dtype=x.dtype, device=device)
    with pytest.raises(ValueError, match="aligned"):  # 2 bytes past an aligned address
        matmul_w4(flat[1:1 + x.numel()].view(x.shape), q4, s4)
    with pytest.raises(ValueError, match="splits"):
        tw4._launch(x, q4, s4, splits=3)  # K = 256 is two chunks of 128
    with pytest.raises(ValueError, match="splits"):
        tw4._launch(torch.randn((4, 2048), device=device, dtype=torch.bfloat16),
                    *wquant.quantize_matrix_int4(torch.randn((2048, 64), device=device), group=128).values(),
                    splits=9)  # a cluster holds 8
    with pytest.raises(ValueError, match="splits"):
        tw4._launch(x.float(), q4, s4, splits=2)  # the CUDA-core kernel does not split
    assert matmul_w4.launches == before


def test_tiny_taming_int4_runs_through_the_kernels(device):
    """A tiny TamingARMM with int4 weights and a packed4 cache on the card:
    every product of every forward launches kernel #8 and every attention
    call kernel #1; greedy tokens agree with the CPU run of the plain
    versions on >= 95% of the positions."""
    from wmar_tpu_torch.models import GenParams, GPTConfig, TamingARMM, VQGANConfig, init_gpt, init_taming_vqgan
    from wmar_tpu_torch.models.taming_gpt import quantize_gpt_params_int8

    cfg = GPTConfig(vocab_size=64, block_size=300, n_layer=2, n_head=2, n_embd=64)
    vq_cfg = VQGANConfig(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32,
                         n_embed=64, embed_dim=16)
    out = {}
    for dev in (device, torch.device("cpu")):
        g = torch.Generator().manual_seed(0)
        gpt = init_gpt(cfg, g)
        with torch.no_grad():
            gpt.pos_emb.normal_(0.0, 0.02, generator=g)
        quantize_gpt_params_int8(gpt, bits=4)
        wrapper = TamingARMM(gpt, init_taming_vqgan(vq_cfg, g), cache_dtype="packed4", device=dev)
        packed4_decode_attention.launches = matmul_w4.launches = 0
        codes = wrapper.sample([0, 5, 9], GenParams(greedy=True))
        out[dev.type] = (codes.cpu(), packed4_decode_attention.launches, matmul_w4.launches)
    steps = vq_cfg.codes_per_side**2
    assert out["cuda"][1:] == (steps * cfg.n_layer, steps * (6 * cfg.n_layer + 1)) and out["cpu"][1:] == (0, 0)
    assert (out["cuda"][0] == out["cpu"][0]).float().mean() >= 0.95


def _flash_layer(cache_dtype, b, h, t, d, device, seed):
    """One filled layer of a bf16, f32 or int8 cache, as (wrapper, plain
    version, the layer's tensors)."""
    g = torch.Generator(device=device).manual_seed(seed)
    k, v = (torch.randn((b, h, t, d), generator=g, device=device) for _ in range(2))
    cache = KVCache.zeros(2, b, h, t, d, cache_dtype, device=device).write(1, 0, k, v)
    if cache_dtype == torch.int8:
        return (fd.flash_decode_attention_q8, fd.flash_decode_attention_q8_plain,
                (cache.k[1], cache.v[1], cache.k_scale[1], cache.v_scale[1]), g)
    return fd.flash_decode_attention, fd.flash_decode_attention_plain, (cache.k[1], cache.v[1]), g


FLASH_SPLITS = (1, 2, 3, 8)  # forced through the private launcher; the wrappers take the planner's choice


def _forced(layer, q, lens, start, key_mask, splits):
    """Kernel #5 or #6 through the private launcher with ``splits`` blocks
    per (row, head); ``layer`` is ``(k, v)`` or ``(k, v, k_scale, v_scale)``."""
    k, v, *scales = layer
    return fd._launch_flash(q, k, v, *(scales or (None, None)), lens, start, key_mask, splits=splits)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32, torch.int8], ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("d", [8, 16, 20, 80, 104, 128])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_match_plain(device, cache_dtype, d, q_dtype):
    """Kernels #5 and #6 against their plain float32 versions at short and
    long caches, with and without a ragged ``start`` and a random
    ``key_mask`` (bool and uint8), at the tolerances of kernel #1: through
    the wrapper (the planner's split count, one launch counted per call) and
    with 1, 2, 3 and 8 blocks per (row, head) forced, ``valid_len`` 1
    included (fewer slots than splits). Every row keeps at least one slot
    that takes part. A repeat call gives the same bits."""
    b, h = 5, 3
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    for t, lens in ((40, (1, 17, 39, 40)), (2100, (1, 33, 600, 2049, 2100))):
        launch, plain, layer, g = _flash_layer(cache_dtype, b, h, t, d, device, seed=d + t)
        q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
        start0 = torch.randint(0, 30, (b,), generator=g, device=device, dtype=torch.int32)
        key_mask0 = torch.rand((b, t), generator=g, device=device) < 0.6
        for n in lens:
            n_lens = torch.full((1,), n, dtype=torch.int32, device=device)
            start = torch.clamp(start0, max=n - 1)
            km = key_mask0.clone()
            km[torch.arange(b, device=device), start.long()] = True
            km0 = key_mask0.clone()
            km0[:, 0] = True
            for st, mask in ((None, None), (start, None), (None, km0), (start, km), (start, km.to(torch.uint8))):
                before = launch.launches
                got = launch(q, *layer, n_lens, start=st, key_mask=mask)
                torch.cuda.synchronize()
                assert launch.launches == before + 1
                want = plain(q.float(), *layer, n, st, mask)
                tol = rel * want.abs().max().item() + 1e-6
                assert got.dtype == q_dtype and got.shape == (b, h, 1, d)
                err = (got.float() - want).abs().max().item()
                assert err <= tol, (t, n, st is None, mask is None, err)
                for splits in FLASH_SPLITS:
                    forced = _forced(layer, q, n_lens, st, mask, splits)
                    again = _forced(layer, q, n_lens, st, mask, splits)
                    torch.cuda.synchronize()
                    err = (forced.float() - want).abs().max().item()
                    assert err <= tol, (t, n, st is None, mask is None, splits, err)
                    assert torch.equal(forced, again), (t, n, splits)
                assert launch.launches == before + 1  # the private launcher counts nothing


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32, torch.int8], ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("d", [80, 104, 128])
def test_flash_kernels_16_byte_loads(device, cache_dtype, d):
    """The models' head dims on the 16-byte path (every one but int8 at D =
    104, whose 104-byte slots take 8-byte loads), at a 3-row 4096-slot cache
    with the three interleaved key masks, every forced split count and the
    planner's: against the plain version, and a repeat call bit for bit. A
    payload that is not aligned to its load raises."""
    from wmar_tpu_torch.tools.bench_attention import interleaved_masks

    b, h, t = 3, 8, 4096
    load = fd._flash_load_bytes(d, cache_dtype)
    assert load == (8 if (cache_dtype == torch.int8 and d == 104) else 16)
    launch, plain, layer, g = _flash_layer(cache_dtype, b, h, t, d, device, seed=d)
    q = torch.randn((b, h, 1, d), generator=g, device=device, dtype=torch.bfloat16)
    for n in (2, 1160, 4096):
        n_lens = torch.full((1,), n, dtype=torch.int32, device=device)
        for mask in (None, interleaved_masks(t, n, 7, 64, 1024, device)):
            want = plain(q.float(), *layer, n, None, mask)
            tol = (2.0**-8 + 1e-5) * want.abs().max().item() + 1e-6
            for splits in FLASH_SPLITS + (None,):
                got = _forced(layer, q, n_lens, None, mask, splits)
                again = _forced(layer, q, n_lens, None, mask, splits)
                torch.cuda.synchronize()
                assert (got.float() - want).abs().max().item() <= tol, (n, mask is None, splits)
                assert torch.equal(got, again), (n, mask is None, splits)
    k = layer[0]
    flat = torch.zeros(k.numel() + 16, dtype=k.dtype, device=device)
    shifted = flat[4:4 + k.numel()].view(k.shape)  # contiguous, 4 values past an aligned address
    if shifted.data_ptr() % load:
        with pytest.raises(ValueError, match="aligned"):
            launch(q, shifted, *layer[1:], 4)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_flash_kernels_replay_from_a_cuda_graph(device, cache_dtype):
    """One launch captured in a CUDA graph (the split count comes from the
    shapes alone) and replayed after ``valid_len`` and ``key_mask`` were
    changed in place gives the bits of a fresh call."""
    b, h, t, d = 3, 8, 4096, 128
    launch, _, layer, g = _flash_layer(cache_dtype, b, h, t, d, device, seed=5)
    q = torch.randn((b, h, 1, d), generator=g, device=device, dtype=torch.bfloat16)
    lens = torch.full((1,), 700, dtype=torch.int32, device=device)
    key_mask = torch.rand((b, t), generator=g, device=device) < 0.5
    key_mask[:, 0] = True
    later_mask = torch.rand((b, t), generator=g, device=device) < 0.8
    later_mask[:, 0] = True
    launch(q, *layer, lens, key_mask=key_mask)  # the scratch is allocated outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, *layer, lens, key_mask=key_mask)
    for n, mask in ((700, key_mask.clone()), (1, key_mask.clone()), (3000, later_mask), (4096, later_mask)):
        lens.fill_(n)
        key_mask.copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        fresh = launch(q, *layer, lens, key_mask=key_mask)
        assert torch.equal(out, fresh), n


def test_flash_kernels_skip_masked_slots_and_take_int_valid_len(device):
    """A masked slot's payload is never used (NaNs planted there do not reach
    the output), a Python-int ``valid_len`` works, and a row with no slot
    that takes part gets zeros."""
    b, h, t, d = 3, 2, 64, 16
    launch, plain, (k, v), g = _flash_layer(torch.float32, b, h, t, d, device, seed=1)
    q = torch.randn((b, h, 1, d), generator=g, device=device)
    km = torch.rand((b, t), generator=g, device=device) < 0.5
    km[:, 3] = True
    k, v = k.clone(), v.clone()
    want = plain(q, k, v, 50, None, km)
    k[~km[:, None, :].expand(b, h, t)] = float("nan")
    v[~km[:, None, :].expand(b, h, t)] = float("nan")
    got = launch(q, k, v, 50, key_mask=km)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    km[1] = False
    got = launch(q, k, v, 50, key_mask=km)
    assert bool((got[1] == 0).all()) and torch.isfinite(got).all()


def test_flash_kernels_reject_bad_inputs(device):
    """Wrong dtypes, shapes, devices, a head dim that is no multiple of 4 and
    non-contiguous views raise, and nothing is launched."""
    b, h, t, d = 2, 2, 8, 16
    _, _, (k, v), _ = _flash_layer(torch.float32, b, h, t, d, device, seed=2)
    _, _, (k8, v8, ks, vs), _ = _flash_layer(torch.int8, b, h, t, d, device, seed=2)
    q = torch.zeros((b, h, 1, d), device=device)
    before = (fd.flash_decode_attention.launches, fd.flash_decode_attention_q8.launches)
    with pytest.raises(TypeError):
        fd.flash_decode_attention(q.half(), k, v, 4)
    with pytest.raises(TypeError):
        fd.flash_decode_attention(q, k8, v8, 4)
    with pytest.raises(TypeError):
        fd.flash_decode_attention_q8(q, k, v, ks, vs, 4)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(q, k.cpu(), v, 4)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(torch.zeros((b, h, 2, d), device=device), k, v, 4)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(q, k, v[:, :, :4], 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        fd.flash_decode_attention(q[..., :6].contiguous(), k[..., :6].contiguous(), v[..., :6].contiguous(), 4)
    with pytest.raises(ValueError, match="multiple of 4"):  # head dims above 128 are not taken
        fd.flash_decode_attention(*(torch.zeros((b, h, n, 132), device=device) for n in (1, t, t)), 4)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 4)
    with pytest.raises(ValueError, match="k_scale"):
        fd.flash_decode_attention_q8(q, k8, v8, ks.float(), vs, 4)
    with pytest.raises(ValueError, match="key_mask"):
        fd.flash_decode_attention(q, k, v, 4, key_mask=torch.ones((b, t + 1), dtype=torch.bool, device=device))
    with pytest.raises(ValueError, match="start"):
        fd.flash_decode_attention(q, k, v, 4, start=torch.zeros(b + 1, dtype=torch.int32, device=device))
    assert before == (fd.flash_decode_attention.launches, fd.flash_decode_attention_q8.launches)


@pytest.mark.parametrize("b,t,h,d", [(5, 40, 3, 20), (128, 258, 16, 80), (32, 257, 16, 104), (3, 1100, 4, 128),
                                     (2, 33, 2, 256), (128, 40, 16, 48)])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_dma_probe_matches_plain(device, b, t, h, d, q_dtype):
    """Kernel #7 (kernel #2's instantiation at these shapes with its math
    compiled out: a warp per (row, head) at 128 x 16, blocks of four warps
    and S = 2 or more at the small shapes) gives its plain version's output
    bit for bit (one float32 add, one rounding), for both layers of a
    stacked cache; one launch per call. A head dim that fits no warp of the
    tiled kernel, or a uint8 payload, raises."""
    cache, _ = _cache(2, b, h, t, d, device, seed=t, cls=PackedQuantKVCache)
    q = torch.zeros((b, h, 1, d), dtype=q_dtype, device=device)
    for layer in (0, 1):
        before = fd._packed_dma_probe.launches
        got = fd._packed_dma_probe(q, cache.kv, cache.scale, layer)
        torch.cuda.synchronize()
        assert fd._packed_dma_probe.launches == before + 1
        want = fd._packed_dma_probe_plain(q, cache.kv, cache.scale, layer)
        assert got.dtype == q_dtype and torch.equal(got, want) and got.abs().max() > 1
    with pytest.raises(TypeError):
        fd._packed_dma_probe(q, cache.kv.view(torch.uint8), cache.scale, 0)
    wide, _ = _cache(1, 2, 2, 8, 132, device, cls=PackedQuantKVCache)
    with pytest.raises(ValueError, match="fits no warp"):
        fd._packed_dma_probe(torch.zeros((2, 2, 1, 132), device=device), wide.kv, wide.scale, 0)
    assert fd._packed_dma_probe.launches == before + 1


@pytest.mark.parametrize("rows,cols", [(1, 1024), (3, 8), (64, 1024), (1000, 136), (16384, 1024)])
def test_row_mean_probe_matches_plain(device, rows, cols):
    """Kernel #9 against its plain version within bf16's rounding of the mean
    (2^-8 + 1e-5 of the largest mean: the sums run in different orders);
    one launch per call; bad inputs raise."""
    g = torch.Generator(device=device).manual_seed(rows)
    x = (torch.randn((rows, cols), generator=g, device=device) + 0.5).to(torch.bfloat16)
    before = fd.row_mean_probe.launches
    got = fd.row_mean_probe(x)
    torch.cuda.synchronize()
    assert fd.row_mean_probe.launches == before + 1
    want = fd.row_mean_probe_plain(x)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 128)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2.0**-8 + 1e-5) * want.float().abs().max().item() + 1e-6
    with pytest.raises(ValueError):
        fd.row_mean_probe(x.float())
    with pytest.raises(ValueError):
        fd.row_mean_probe(torch.zeros((2, 12), dtype=torch.bfloat16, device=device))
    assert fd.row_mean_probe.launches == before + 1


def test_tiny_interleaved_runs_through_the_flash_kernels(device):
    """A tiny Chameleon through ``sample_interleaved_fused`` with a 2048-slot
    cache on the card: every forward after the prefill launches kernel #5
    (f32 cache) or #6 (int8 cache) once per layer and no other attention
    kernel, with no host sync inside the loop's steps; greedy tokens on the
    f32 cache equal the CPU run of the plain version on >= 90% of the
    positions."""
    from wmar_tpu_torch.models import ChameleonARMM, ChameleonVocab, GenParams, LlamaConfig, VQGANConfig, \
        init_llama_params, init_taming_vqgan
    from wmar_tpu_torch.models import chameleon_interleaved as il
    from wmar_tpu_torch.models.chameleon_interleaved import TextGenOptions, sample_interleaved_fused

    vocab = ChameleonVocab.synthetic(n_codes=16, n_text=20)
    cfg = LlamaConfig(dim=64, n_layers=2, n_heads=4, vocab_size=vocab.vocab_size, multiple_of=16)
    vq_cfg = VQGANConfig(resolution=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), z_channels=32,
                         n_embed=16, embed_dim=8)
    opts = TextGenOptions(max_gen_len=3, greedy=True)
    budget = 18 + 2 * 3
    out = {}
    for dev in (device, torch.device("cpu")):
        g = torch.Generator().manual_seed(1)  # a seed whose greedy run opens an image
        params = init_llama_params(cfg, g)
        vq = init_taming_vqgan(vq_cfg, g)
        params = {k: ([{n: (w.to(dev) if torch.is_tensor(w) else {m: x.to(dev) for m, x in w.items()})
                        for n, w in blk.items()} for blk in v] if k == "blocks" else v.to(dev))
                  for k, v in params.items()}
        wrapper = ChameleonARMM(params, cfg, vocab, vq, tokenizer=lambda s: [6 + (ord(c) % 20) for c in s[:4]],
                                image_seq_len=16, cache_dtype=torch.float32, device=dev)
        for cache_dtype in (torch.float32, torch.int8):
            wrapper.cache_dtype = cache_dtype
            for fn in (fd.flash_decode_attention, fd.flash_decode_attention_q8, fd.packed4_decode_attention_chunked,
                       fd.packed_decode_attention_q8_chunked):
                fn.launches = 0
            calls, real = [0], il.llama_forward

            def forward(*args, **kwargs):
                # from the first decode step to the last forward, any host sync raises
                calls[0] += 1
                if dev.type == "cuda" and calls[0] in (2, budget):
                    torch.cuda.set_sync_debug_mode("error" if calls[0] == 2 else "default")
                return real(*args, **kwargs)

            il.llama_forward = forward
            try:
                segs = sample_interleaved_fused(wrapper, "ab", GenParams(greedy=True), text_opts=opts, max_images=1,
                                                cache_budget=2048)
            finally:
                il.llama_forward = real
                torch.cuda.set_sync_debug_mode("default")
            assert calls[0] == budget
            out[(dev.type, cache_dtype)] = ([int(t) for _, toks in segs for t in toks[0]],
                                            fd.flash_decode_attention.launches, fd.flash_decode_attention_q8.launches,
                                            fd.packed4_decode_attention_chunked.launches
                                            + fd.packed_decode_attention_q8_chunked.launches)
    per_run = (budget - 1) * cfg.n_layers
    assert out[("cuda", torch.float32)][1:] == (per_run, 0, 0) and out[("cuda", torch.int8)][1:] == (0, per_run, 0)
    assert out[("cpu", torch.float32)][1:] == (0, 0, 0)
    a, b_ = out[("cuda", torch.float32)][0], out[("cpu", torch.float32)][0]
    n = min(len(a), len(b_))
    assert n >= 20 and sum(x == y for x, y in zip(a[:n], b_[:n])) >= 0.9 * n


def test_attack_grid_on_the_card_matches_the_cpu(device, monkeypatch):
    """Every cell of the attack grid runs on the card (its output stays
    there) and agrees with the same cell on the CPU: within 1e-5 (float32
    summation order), noise fed the same draws; PIL's JPEG exactly. The
    device JPEG: on >= 99.9% of the pixels within 1e-5; its quantized DCT
    coefficients within 1e-3 of the CPU's, so one rounds the other way only
    near a rounding boundary, and each such flip moves a pixel by at most
    one quantization step (``0.25 * table / 255`` a channel, times 1.772
    through YCbCr -> RGB): the largest error is held to 1e-5 plus that many
    steps."""
    from wmar_tpu_torch.augmentations import AugmentationManager
    from wmar_tpu_torch.augmentations import valuemetric

    seen = []
    st_round = valuemetric._st_round

    def recording(c):
        seen.append(c.detach().double().cpu().ravel())
        return st_round(c)

    monkeypatch.setattr(valuemetric, "_st_round", recording)
    x = torch.rand((4, 40, 40, 3), generator=torch.Generator().manual_seed(0))
    for exact in (False, True):
        for name, fn, params in AugmentationManager(exact_jpeg=exact).augs:
            if exact and name != "jpeg":
                continue
            for p in params:
                if name == "gaussian-noise":
                    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
                    want = valuemetric.gaussian_noise(x, float(p), noise=noise)
                    got = valuemetric.gaussian_noise(x.to(device), float(p), noise=noise.to(device))
                else:
                    seen.clear()
                    want, got = fn(x, p, None), fn(x.to(device), p, None)
                assert got.device.type == "cuda" and got.shape == x.shape, (name, p)
                err = (got.cpu() - want).abs()
                if name == "jpeg" and not exact:
                    assert len(seen) == 6, (name, p)
                    flips = 0
                    for cpu_c, card_c in zip(seen[:3], seen[3:]):
                        torch.testing.assert_close(card_c, cpu_c, atol=1e-3, rtol=1e-5)
                        flips += int((torch.round(cpu_c) != torch.round(card_c)).sum())
                    table = max(float(t.max()) for t in valuemetric._quality_tables(p))
                    bound = 1e-5 + flips * 0.25 * 1.772 * table / 255.0
                    assert float(err.max()) <= bound, (name, p, float(err.max()), flips)
                    assert float((err > 1e-5).float().mean()) <= 1e-3, (name, p)
                else:
                    assert float(err.max()) <= (0 if exact else 1e-5), (name, p, float(err.max()))


# ---------------------------------------------------------------------------
# RCC finetuning and the checkpoint format on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["taming", "maskgit"])
@pytest.mark.parametrize("level,index", [("warmup", None), ("strong", 18)], ids=["warmup", "croppad_0.5"])
def test_rcc_train_step_on_the_card_matches_the_cpu(device, kind, level, index):
    """One RCC loss and backward at the JAX tests' tiny sizes on the card
    against the same on the CPU, TF32 off: losses within 1e-5 relative,
    every gradient within 1e-3 of its leaf's largest magnitude (or of 1e-3
    of the step's largest gradient, for leaves that are zero in exact
    arithmetic); then one Adam step moves both alike."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.finetune import cli, rcc
    from wmar_tpu_torch.models import MaskGitVQConfig, VQGANConfig, init_maskgit, init_taming_vqgan

    gen = torch.Generator().manual_seed(0)
    if kind == "taming":
        model, adapter_cls = init_taming_vqgan(VQGANConfig(**cli.TINY_TAMING), gen), rcc.TamingRCCAdapter
    else:
        model, adapter_cls = init_maskgit(MaskGitVQConfig(**cli.TINY_MASKGIT), gen), rcc.MaskGitRCCAdapter
    with torch.no_grad():  # a codebook spread to N(0, 1)
        for name, p in model.named_parameters():
            if name.endswith("embedding"):
                p.copy_(torch.randn(p.shape, generator=gen))
    codes = torch.randint(0, 64, (4, model.cfg.codes_per_side**2), generator=gen)
    draws = {} if index is None else dict(gate=0.0, index=index)
    out = []
    for dev in (torch.device("cpu"), device):
        adapter = adapter_cls(copy.deepcopy(model).to(dev))
        state = rcc.init_state(adapter, rcc.RCCConfig(lr=1e-4))
        loss, metrics = rcc.make_loss_fn(adapter, rcc.RCCConfig(), level)(state.trainable, codes.to(dev), **draws)
        loss.backward()
        grads = {n: bridge.flax_tree([(k, p.grad) for k, p in state.trainable[n].named_parameters()])
                 for n in ("decoder", "watermark_encoder")}
        state.optimizer.step()
        out.append(({k: float(v) for k, v in metrics.items()}, grads,
                    {k: v.detach().cpu() for k, v in state.trainable.state_dict().items()}))
    (cm, cg, cw), (gm, gg, gw) = out
    for k in cm:
        assert gm[k] == pytest.approx(cm[k], rel=1e-5, abs=1e-7), k
    flat_c = dict(bridge.flatten(cg))
    flat_g = dict(bridge.flatten(gg))
    floor = 1e-3 * max(float(v.abs().max()) for v in flat_c.values())
    for k, want in flat_c.items():
        scale = max(float(want.abs().max()), floor)
        torch.testing.assert_close(flat_g[k].cpu(), want, rtol=0, atol=1e-3 * scale, msg=k)
    for k, want in cw.items():  # Adam's first step: +-lr where the gradients agree in sign
        assert float((gw[k] - want).abs().max()) <= 2 * 1e-4 + 1e-6, k


def test_codec_chunked_leaf_round_trip(device):
    """A float32 leaf of 2**28 + 1024 elements (just over 1 GiB) goes as
    flax's chunked map of two flat chunks and reads back equal."""
    from wmar_tpu_torch.utils import msgpack_codec as codec

    x = torch.randn((2**28 + 1024,), device=device)
    data = codec.serialize({"big": x, "small": torch.arange(3, device=device)})
    back = codec.restore(data)
    assert torch.equal(back["big"], x.cpu()) and torch.equal(back["small"], torch.arange(3))
    head = codec.restore(codec.serialize({"big": x[:1]}))  # unchunked form of one element
    assert head["big"].shape == (1,)
    del data, back


def test_full_size_tokenizer_msgpack_round_trip(device, tmp_path):
    """The f16 Taming VQGAN at full size (random weights on the card) saved
    in the Flax layout and loaded into a fresh module on the card: every
    tensor equal; the deltas of a perturbed copy re-applied equal it within
    4 float32 ulps of the largest weight."""
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.models import TAMING_IMAGENET_F16, TamingVQGAN, init_taming_vqgan
    from wmar_tpu_torch.utils import checkpoint as ckpt

    model = init_taming_vqgan(TAMING_IMAGENET_F16, torch.Generator(device=device).manual_seed(0), device=device)
    ckpt.save_pytree(str(tmp_path / "vqgan.msgpack"), bridge.flax_tree(model))
    assert os.path.getsize(tmp_path / "vqgan.msgpack") > 250e6
    fresh = bridge.load_flax_file(TamingVQGAN, TAMING_IMAGENET_F16, str(tmp_path / "vqgan.msgpack"), device)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    base = bridge.flax_tree(model.decoder)

    def plus(tree):
        return {k: plus(v) if isinstance(v, dict) else v + 1e-3 for k, v in tree.items()}

    new = plus(base)
    ckpt.save_delta(str(tmp_path / "d.msgpack"), new, base)
    got = ckpt.load_and_apply_delta(str(tmp_path / "d.msgpack"), base)
    for (k, g), (_, w) in zip(bridge.flatten(got), bridge.flatten(new)):
        assert float((g - w).abs().max()) <= 4 * torch.finfo(torch.float32).eps * max(float(w.abs().max()), 1.0), k


# Moshi-7B's temporal decode (MOSHI_V01, batch 8, 64 frames): 32 heads of 128
# over a cache of n_frames + max_delay + 1 = 66 slots
MOSHI_SHAPE = dict(b=8, h=32, t=66, d=128)


@pytest.mark.parametrize("kernel", ["packed4", "q8"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_moshi_shape_packed_kernels_match_plain(device, kernel, q_dtype):
    """Kernels #1 (int4) and #2 (int8) at Moshi's shape against their plain
    versions, every fill of the 66 slots' interesting ones: 2^-8 + 1e-5 of
    the largest output for bf16 q, 1e-5 for f32; one launch counted per
    call, on the kernel's own count. On 132 SMs the planner gives each of
    the 256 (row, head) pairs one block of four warps (S = 1)."""
    b, h, t, d = (MOSHI_SHAPE[k] for k in "bhtd")
    int4 = kernel == "packed4"
    launch = packed4_decode_attention if int4 else fd.packed_decode_attention_q8
    plain = packed4_decode_attention_plain if int4 else fd.packed_decode_attention_q8_plain
    cache, g = _cache(2, b, h, t, d, device, seed=66, cls=Packed4QuantKVCache if int4 else PackedQuantKVCache)
    if fd._sm_count(0) == 132:
        plan = fd.packed_decode_plan(b, h, t, d, int4, 132)
        assert (plan.kernel, plan.splits, plan.warp_head, plan.tile) == ("tiled", 1, False, 32)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    for layer in (0, 1):
        for n in (1, 2, 31, 32, 33, 64, 65, 66):
            before = launch.launches
            got = launch(q, cache.kv, cache.scale, layer, torch.full((1,), n, dtype=torch.int32, device=device))
            torch.cuda.synchronize()
            assert launch.launches == before + 1
            want = plain(q.float(), cache.kv, cache.scale, layer, n)
            assert got.dtype == q_dtype and torch.isfinite(got).all()
            assert (got.float() - want).abs().max().item() <= rel * want.abs().max().item() + 1e-6, (layer, n)


@pytest.mark.parametrize("kernel", ["packed4", "q8"])
def test_moshi_shape_replays_from_a_cuda_graph(device, kernel):
    """One launch at Moshi's shape captured in a CUDA graph, replayed after
    ``valid_len`` changed in place, gives the bits of a fresh call."""
    b, h, t, d = (MOSHI_SHAPE[k] for k in "bhtd")
    int4 = kernel == "packed4"
    launch = packed4_decode_attention if int4 else fd.packed_decode_attention_q8
    cache, g = _cache(2, b, h, t, d, device, seed=67, cls=Packed4QuantKVCache if int4 else PackedQuantKVCache)
    q = torch.randn((b, h, 1, d), generator=g, device=device, dtype=torch.bfloat16)
    lens = torch.full((1,), 2, dtype=torch.int32, device=device)
    launch(q, cache.kv, cache.scale, 1, lens)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch(q, cache.kv, cache.scale, 1, lens)
    for n in (2, 1, 33, t):
        lens.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, launch(q, cache.kv, cache.scale, 1, lens)), n


@pytest.mark.parametrize("cache_dtype", ["packed", "packed4"])
def test_tiny_moshi_runs_through_the_kernels(device, cache_dtype):
    """A tiny Moshi (MOSHI_V01's flags: 6 input streams for 4 generated,
    per-codebook depformer weights) on a packed cache: every temporal layer
    of every loop frame launches the cache's kernel (layers x (frames +
    max_delay)), and greedy tokens agree with the CPU run of the plain
    version on >= 95% of the positions."""
    from wmar_tpu_torch.audio import lm

    cfg = lm.MoshiConfig(n_audio_streams=4, audio_vocab=64, text_vocab=64, dim=128, n_layers=2, n_heads=2,
                         dep_dim=32, dep_layers=1, dep_heads=2, delays=(0, 1, 1, 1, 0, 1), n_q=6,
                         depformer_multi_linear=True, depformer_weights_per_step=True, depformer_pos_emb="none")
    launch = packed4_decode_attention if cache_dtype == "packed4" else fd.packed_decode_attention_q8
    wm = lm.WMConfig(method="none", greedy=True)
    from wmar_tpu_torch.bridge import load_moshi

    cpu_params = lm.init_moshi_params(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dev in (device, torch.device("cpu")):
        params = load_moshi(cpu_params, device=dev)
        before = launch.launches
        text, audio = lm.MoshiGen(params, cfg, wm, cache_dtype=cache_dtype).generate(12, batch=3)
        out[dev.type] = (text.cpu(), audio.cpu(), launch.launches - before)
    assert out["cuda"][2] == cfg.n_layers * cfg.total_steps(12) and out["cpu"][2] == 0
    assert (out["cuda"][1] == out["cpu"][1]).float().mean() >= 0.95
    assert (out["cuda"][0] == out["cpu"][0]).float().mean() >= 0.95


def _random_adm(device):
    """``GUIDED_DIFFUSION_256_UNCOND``'s UNet with every weight drawn (none
    left at zero): weights N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1),
    biases N(0, 0.1)."""
    from wmar_tpu_torch.augmentations.diffpure import GUIDED_DIFFUSION_256_UNCOND, ADMUNet

    with torch.device("meta"):
        model = ADMUNet(GUIDED_DIFFUSION_256_UNCOND)
    model = model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(15)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            else:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1, generator=g)
    return model.eval()


def test_diffpure_on_the_card_matches_the_cpu(device):
    """The full-width ADM UNet (552.8M parameters) on a 64 px image, and a
    10-step DiffPure chain (steps 0.01; on the card its UNet forwards replay
    a CUDA graph) fed the same noise, on the card against a CPU copy,
    float32 (TF32 off): within 1e-3 of the output's scale, the codecs'
    bound (~100 convolutions and GroupNorms, 16 attentions, summed in
    another order)."""
    from wmar_tpu_torch.augmentations.diffpure import DiffPure

    unet = _random_adm(device)
    cpu = copy.deepcopy(unet).cpu()
    g = torch.Generator().manual_seed(16)
    x = torch.rand((1, 64, 64, 3), generator=g)
    t = torch.full((1,), 500, dtype=torch.int32)
    with torch.inference_mode():
        want = cpu(x.permute(0, 3, 1, 2) * 2 - 1, t)
        got = unet(x.permute(0, 3, 1, 2).to(device) * 2 - 1, t.to(device)).cpu()
    scale = float(want.abs().max())
    assert scale > 0.1 and float((got - want).abs().max()) <= 1e-3 * max(1.0, scale)
    noise = torch.randn((10, *x.shape), generator=g)
    dp_card, dp_cpu = DiffPure(unet), DiffPure(cpu)
    got = dp_card(x.to(device), 0.01, noise=noise).cpu()
    want = dp_cpu(x, 0.01, noise=noise)
    assert dp_card.unet_calls == dp_cpu.unet_calls == 10 and float((got - x).abs().max()) > 1e-3
    assert float((got - want).abs().max()) <= 1e-3


def test_fid_features_on_the_card_match_the_cpu(device):
    """The FID InceptionV3 at full width (random, BatchNorm variances
    positive) on 512 px and 256 px images, the card's pool3 features
    against the CPU's, float32: within 1e-3 of the largest feature."""
    from wmar_tpu_torch.eval import fid

    g = torch.Generator().manual_seed(19)
    sd = {}
    for k, s in fid.inception_state_dict_shapes().items():
        if k.endswith("conv.weight"):
            sd[k] = torch.randn(s, generator=g) * (2.0 / float(torch.tensor(s[1:]).prod())) ** 0.5
        elif k.endswith(("running_var", "bn.weight")):
            sd[k] = torch.rand(s, generator=g) * 0.4 + 0.8
        else:
            sd[k] = torch.rand(s, generator=g) * 0.2 - 0.1
    card, cpu = fid.FIDInceptionV3.from_state_dict(sd, device), fid.FIDInceptionV3.from_state_dict(sd, "cpu")
    for size in (512, 256):
        x = torch.rand((3, size, size, 3), generator=g).numpy()
        want = fid.compute_activations(cpu, x)
        got = fid.compute_activations(card, x)
        assert got.shape == (3, 2048) and abs(got - want).max() <= 1e-3 * abs(want).max()


def _audio_models(kind):
    """A random full-width AudioSeal (``AUDIOSEAL_16B``), EnCodec
    (``ENCODEC_24K``) or DAC (``DAC_24K``) on the CPU, from a seed."""
    from wmar_tpu_torch.audio import audioseal, codecs

    build = {"audioseal": lambda: audioseal.AudioSealModel(audioseal.AUDIOSEAL_16B),
             "encodec": lambda: codecs.Encodec(codecs.ENCODEC_24K), "dac": lambda: codecs.DAC(codecs.DAC_24K)}[kind]
    return codecs.random_codec(build, torch.Generator().manual_seed(20))


def _within_scale(got, want, tol=1e-3):
    scale = float(want.abs().max())
    assert scale > 0 and float((got.cpu() - want).abs().max()) <= tol * max(1.0, scale), (
        float((got.cpu() - want).abs().max()), scale)


@pytest.mark.parametrize("kind", ["audioseal", "encodec", "dac"])
def test_audio_models_on_the_card_match_the_cpu(device, kind):
    """AudioSeal's watermark and presence, and EnCodec's and DAC's codes,
    decodes and round trips, at full width on a 1 s clip (24,000 samples),
    float32 (TF32 off): the card against a CPU copy within 1e-3 of the
    output's scale; codes may differ at a near tie of the argmin (at most
    1e-3 of them), and each decoder is fed the CPU's codes."""
    cpu = _audio_models(kind)
    card = copy.deepcopy(cpu).to(device)
    x = torch.rand((2, 24000, 1), generator=torch.Generator().manual_seed(21)) * 1.6 - 0.8
    with torch.no_grad():
        if kind == "audioseal":
            _within_scale(card.get_watermark(x.to(device)), cpu.get_watermark(x))
            _within_scale(card.detect(x.to(device)), cpu.detect(x))
            return
        codes = cpu.encode(x)
        got = card.encode(x.to(device)).cpu()
        assert got.shape == codes.shape and float((got != codes).float().mean()) <= 1e-3
        _within_scale(card.decode(codes.to(device)), cpu.decode(codes))
        if torch.equal(got, codes):
            _within_scale(card(x.to(device)), cpu(x))
