"""The port's hand-written CUDA kernels on the card, against their plain
versions. Marked ``cuda``: without a CUDA card every test skips. This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_kernels_cuda.py
"""

import pytest
import torch

from wmar_tpu_torch.engine.kvcache import Packed4QuantKVCache
from wmar_tpu_torch.ops.flash_decode import packed4_decode_attention, packed4_decode_attention_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cache(n_layers, b, h, t, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    cache = Packed4QuantKVCache.zeros(n_layers, b, h, t, d, device=device)
    for li in range(n_layers):
        k, v = (torch.randn((b, h, t, d), generator=g, device=device) for _ in range(2))
        cache.write(li, 0, k, v)
    return cache, g


@pytest.mark.parametrize("d", [16, 20, 48, 80, 88, 256])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(device, d, q_dtype):
    """Max abs error, relative to the largest output: 2^-8 + 1e-5 for bf16 q
    (bf16's rounding of the output plus float32 summation order) and 1e-5
    for f32 q."""
    b, h, t = 5, 3, 40
    cache, g = _cache(2, b, h, t, d, device, seed=d)
    q = torch.randn((b, h, 1, d), generator=g, device=device).to(q_dtype)
    rel = 2.0**-8 + 1e-5 if q_dtype == torch.bfloat16 else 1e-5
    for layer in (0, 1):
        for n in (1, 2, 17, 39, 40):
            before = packed4_decode_attention.launches
            got = packed4_decode_attention(q, cache.kv, cache.scale, layer,
                                           torch.full((1,), n, dtype=torch.int32, device=device))
            torch.cuda.synchronize()
            assert packed4_decode_attention.launches == before + 1
            want = packed4_decode_attention_plain(q.float(), cache.kv, cache.scale, layer, n)
            assert got.dtype == q_dtype and got.shape == (b, h, 1, d)
            err = (got.float() - want).abs().max().item()
            assert err <= rel * want.abs().max().item() + 1e-6, (layer, n, err)


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
