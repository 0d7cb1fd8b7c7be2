"""ARMM wrappers: one API over the autoregressive image models (PyTorch).

Port of ``wmar_tpu.models.armm``:

  sample(conditioning, gen_params, apply_watermark) -> codes [B, S]
  codes_to_images(codes) -> images (NHWC, [-1, 1])
  images_to_codes(images) -> codes
  get_vq() / get_total_vocab_size() / set_watermarker()

The watermark is fused into the sampler. Randomness comes from an explicit
``torch.Generator`` (or, in tests, from fed Gumbel noise); every method
runs under ``torch.inference_mode`` on the wrapper's device.
``ChameleonARMM`` lives in :mod:`wmar_tpu_torch.models.chameleon`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wmar_tpu_torch.core.greenlist import VQInfo, make_greenlist
from wmar_tpu_torch.core.spec import WatermarkSpec
from wmar_tpu_torch.engine.decode import SamplerConfig, WatermarkRuntime, decode_tokens
from wmar_tpu_torch.models import taming_gpt
from wmar_tpu_torch.models.maskgit_vqgan import MaskGitVQGAN
from wmar_tpu_torch.models.rar import RAR, RARSampler
from wmar_tpu_torch.models.vqgan import TamingVQGAN


@dataclasses.dataclass(frozen=True)
class GenParams:
    """Generation hyperparameters (reference ``gen_params`` dict)."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False
    guidance_scale: float = 4.0
    guidance_scale_pow: float = 0.0

    def sampler(self) -> SamplerConfig:
        return SamplerConfig(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p, greedy=self.greedy
        )


class ARMMWrapper:
    """Base: device and watermark plumbing."""

    codes_size: int
    image_size: int

    def __init__(self, device):
        self.device = torch.device(device)
        self.watermark_spec: Optional[WatermarkSpec] = None
        self.greenlist = None

    def set_watermarker(self, spec: Optional[WatermarkSpec], torch_compat: bool = False):
        self.watermark_spec = spec
        if spec is not None:  # None keeps the last greenlist, as in the JAX package
            self.greenlist = make_greenlist(spec, self.get_vq(), torch_compat=torch_compat, device=self.device)

    def watermark_runtime(self) -> Optional[WatermarkRuntime]:
        if self.watermark_spec is None:
            return None
        return WatermarkRuntime(self.watermark_spec, self.greenlist)

    def get_vq(self) -> VQInfo:
        raise NotImplementedError

    def get_total_vocab_size(self) -> int:
        raise NotImplementedError

    def is_codes_shaped(self, codes) -> bool:
        return codes.ndim == 2 and codes.shape[1] == self.codes_size**2

    def is_images_shaped(self, images) -> bool:
        return images.ndim == 4 and tuple(images.shape[1:]) == (self.image_size, self.image_size, 3)


class TamingARMM(ARMMWrapper):
    """Taming cin_transformer + f=16 VQGAN.

    Conditioning is the raw ImageNet class index used directly as the first
    token (``cond_offset`` 0): class ids alias the first 1000 code ids, a
    quirk of the published checkpoint. The watermark context buffer also
    starts with the raw index, as the reference's logit processor sees it.
    """

    def __init__(
        self,
        gpt: taming_gpt.GPT,
        vq: TamingVQGAN,
        alive_ids: Optional[np.ndarray] = None,
        cond_offset: int = 0,
        cache_dtype=torch.float32,
        device="cuda",
    ):
        super().__init__(device)
        self.gpt = gpt.to(self.device)
        self.gpt_cfg = gpt.cfg
        self.vq = vq.to(self.device)
        self.vq_cfg = vq.cfg
        self.alive_ids = alive_ids
        self.codes_size = self.vq_cfg.codes_per_side
        self.image_size = self.vq_cfg.resolution
        self.cond_offset = cond_offset
        self.cache_dtype = cache_dtype

    def get_vq(self) -> VQInfo:
        emb = self.vq.quantize.embedding.detach().float().cpu().numpy()
        return VQInfo(vocab_size=self.vq_cfg.n_embed, alive_ids=self.alive_ids, embedding=emb)

    def get_total_vocab_size(self) -> int:
        return self.vq_cfg.n_embed

    @torch.inference_mode()
    def sample(self, conditioning, gen_params: GenParams, apply_watermark: bool = False,
               generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """Codes ``[B, codes_size**2]`` for the class ids in ``conditioning``.

        ``noise [codes_size**2, B, k]`` feeds the draws' Gumbel noise;
        otherwise it comes from ``generator`` (on this wrapper's device)."""
        class_ids = torch.as_tensor(np.asarray(conditioning, np.int64).reshape(-1), device=self.device)
        steps = self.codes_size**2
        v = self.vq_cfg.n_embed
        cond = (class_ids + self.cond_offset)[:, None]
        init_logits, cache = taming_gpt.prefill(self.gpt, cond, max_len=steps + cond.shape[1],
                                                dtype=self.cache_dtype)
        raw_step = taming_gpt.make_step_fn(self.gpt, cond_len=1)

        def step_fn(cache, prev, step):
            logits, cache = raw_step(cache, prev, step)
            return logits[:, :v], cache

        tokens, _ = decode_tokens(
            step_fn, cache, init_logits[:, :v], steps, gen_params.sampler(),
            watermark=self.watermark_runtime() if apply_watermark else None,
            cond_tokens=class_ids[:, None],
            generator=generator, noise=noise,
        )
        return tokens

    @torch.inference_mode()
    def codes_to_images(self, codes: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.vq.decode_codes(codes.to(self.device)), -1.0, 1.0)

    @torch.inference_mode()
    def images_to_codes(self, images: torch.Tensor) -> torch.Tensor:
        return self.vq.encode_codes(images.to(self.device))


class RarARMM(ARMMWrapper):
    """RAR generator + MaskGit-VQGAN tokenizer."""

    def __init__(
        self,
        rar: RAR,
        vq: MaskGitVQGAN,
        alive_ids: Optional[np.ndarray] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        super().__init__(device)
        self.rar = rar.to(self.device)
        self.rar_cfg = rar.cfg
        self.vq = vq.to(self.device)
        self.vq_cfg = vq.cfg
        self.alive_ids = alive_ids
        self.codes_size = int(self.rar_cfg.image_seq_len**0.5)
        if self.codes_size != self.vq_cfg.codes_per_side:
            raise ValueError(
                f"RAR seq {self.rar_cfg.image_seq_len} vs tokenizer grid {self.vq_cfg.codes_per_side}^2")
        self.image_size = self.vq_cfg.resolution
        self.cache_dtype = cache_dtype

    def get_vq(self) -> VQInfo:
        emb = self.vq.embedding.detach().float().cpu().numpy()
        return VQInfo(vocab_size=self.vq_cfg.n_embed, alive_ids=self.alive_ids, embedding=emb)

    def get_total_vocab_size(self) -> int:
        return self.vq_cfg.n_embed

    @torch.inference_mode()
    def sample(self, conditioning, gen_params: GenParams, apply_watermark: bool = False,
               generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """Codes ``[B, image_seq_len]`` for the class ids in ``conditioning``.

        ``noise [image_seq_len, B, k]`` feeds the draws' Gumbel noise;
        otherwise it comes from ``generator`` (on this wrapper's device)."""
        class_ids = torch.as_tensor(np.asarray(conditioning, np.int64).reshape(-1), device=self.device)
        sampler = RARSampler(
            self.rar, class_ids,
            guidance_scale=gen_params.guidance_scale,
            guidance_scale_pow=gen_params.guidance_scale_pow,
            cache_dtype=self.cache_dtype,
        )
        init_logits, cache = sampler.prefill()
        tokens, _ = decode_tokens(
            sampler.step_fn, cache, init_logits, self.rar_cfg.image_seq_len, gen_params.sampler(),
            watermark=self.watermark_runtime() if apply_watermark else None,
            cond_tokens=None,  # RAR's processor sees generated ids only
            generator=generator, noise=noise,
        )
        return tokens

    @torch.inference_mode()
    def codes_to_images(self, codes: torch.Tensor) -> torch.Tensor:
        return self.vq.decode_codes(codes.to(self.device))

    @torch.inference_mode()
    def images_to_codes(self, images: torch.Tensor) -> torch.Tensor:
        return self.vq.encode_codes(images.to(self.device))
