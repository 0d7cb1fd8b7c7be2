"""Port parity, the Taming VQGAN (Chameleon's image tokenizer).

Flax variables are made from a PRNG key, turned into numpy trees and
bridged into the port (:func:`wmar_tpu_torch.bridge.load_taming_vqgan`).
Decode within 1e-4 and encode to identical codes, at f32, once with
attention at the 16-pixel resolution and once without (Chameleon's
setting).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wmar_tpu.models import vqgan as jvq
from wmar_tpu_torch import bridge
from wmar_tpu_torch.models import vqgan as tvq

CONFIGS = {
    "attn16": dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), z_channels=32,
                   n_embed=64, embed_dim=16),
    "no_attn": dict(resolution=16, ch=32, ch_mult=(1, 2, 2), num_res_blocks=2, attn_resolutions=(), z_channels=32,
                    n_embed=64, embed_dim=16),
}


def _pair(name):
    kw = CONFIGS[name]
    jm = jvq.TamingVQGAN(jvq.VQGANConfig(**kw))
    res = kw["resolution"]
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, res, res, 3)))
    # a codebook with the spread of encoder outputs, so nearest() is no near tie
    params["params"]["quantize"]["embedding"] = jnp.asarray(
        np.random.default_rng(6).standard_normal((kw["n_embed"], kw["embed_dim"])), jnp.float32)
    tm = tvq.TamingVQGAN(tvq.VQGANConfig(**kw))
    bridge.load_taming_vqgan(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_encode_f32(name):
    """Decode at atol 1e-4; the codes of encode, and of the decode -> encode
    round trip the pipeline makes, exactly equal."""
    jm, params, tm = _pair(name)
    cfg = tm.cfg
    if name == "attn16":
        assert hasattr(tm.encoder, "down_1_attn_0") and hasattr(tm.decoder, "up_1_attn_1")
    else:
        assert not any("attn_" in n and "mid" not in n for n, _ in tm.named_modules())
    jdecode = jax.jit(lambda c: jm.apply(params, c, method=jvq.TamingVQGAN.decode_codes))
    jencode = jax.jit(lambda x: jm.apply(params, x, method=jvq.TamingVQGAN.encode_codes))
    rng = np.random.default_rng(7)
    codes = rng.integers(0, cfg.n_embed, size=(2, cfg.codes_per_side**2))
    want = jdecode(jnp.asarray(codes))
    with torch.inference_mode():
        got = tm.decode_codes(torch.as_tensor(codes))
        assert got.shape == (2, cfg.resolution, cfg.resolution, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        imgs = rng.uniform(-1, 1, (2, cfg.resolution, cfg.resolution, 3)).astype(np.float32)
        np.testing.assert_array_equal(tm.encode_codes(torch.as_tensor(imgs)).numpy(),
                                      np.asarray(jencode(jnp.asarray(imgs))))
        clipped = torch.clamp(got, -1, 1)
        np.testing.assert_array_equal(tm.encode_codes(clipped).numpy(),
                                      np.asarray(jencode(jnp.clip(want, -1, 1))))


def test_init_and_configs():
    tm = tvq.init_taming_vqgan(tvq.VQGANConfig(**CONFIGS["attn16"]), torch.Generator().manual_seed(0))
    assert tm.quantize.embedding.abs().max() <= 1 / 64
    assert tm.encoder.down_0_downsample.conv.weight.shape == (32, 32, 3, 3)
    assert tm.decoder.up_1_block_0.nin_shortcut is None and tm.decoder.up_0_block_0.nin_shortcut is not None
    assert tvq.CHAMELEON_F16.codes_per_side == 32 and tvq.CHAMELEON_F16.n_embed == 8192
    assert tvq.TAMING_IMAGENET_F16.codes_per_side == 16 and tvq.TAMING_IMAGENET_F16.attn_resolutions == (16,)
    # every Flax leaf of a real init has a counterpart in the port, and back
    jm = jvq.TamingVQGAN(jvq.VQGANConfig(**CONFIGS["no_attn"]))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    bridge.load_taming_vqgan(tvq.TamingVQGAN(tvq.VQGANConfig(**CONFIGS["no_attn"])), jax.tree.map(np.asarray, params))
