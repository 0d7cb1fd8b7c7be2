"""Chameleon/Anole-7B text-to-image frontend (PyTorch).

Port of ``wmar_tpu.models.chameleon``. The Llama backbone runs the three
instruct-CFG branches as one 3B batch against a shared KV cache; every
decode step goes through the port's decode engine:

  CFG rows = [full prompt | image-conditioned filter | <bos><boi>]
  each step: logits -> instruct CFG combine -> allow-only image tokens
  -> (engine) watermark bias -> temperature -> top-p -> draw
  -> the drawn token replicated to the 3 rows; 1024 tokens.

The step output is masked before the engine adds the watermark bias;
adding delta to a -1e10 logit keeps it out of reach, so this equals the
reference's CFG -> watermark -> mask order.

Vocab translation: image BPE tokens are named ``IMGIMG<digits as A..J>Z``;
``img2bpe``/``bpe2img`` are device gathers. Codes are full-BPE-vocab ids,
as in the reference; translation to VQGAN codebook ids happens inside
``codes_to_images``/``images_to_codes``.

The interleaved text-and-image frontend is
:mod:`wmar_tpu_torch.models.chameleon_interleaved`.

Multi-GPU runs (``generate --tp/--sp/--pp``): :meth:`ChameleonARMM.shard`
hands the wrapper its rank's grid (``parallel.Mesh``) and, under ``tp``,
keeps this rank's Megatron shard of the Llama (:func:`llama_tp_specs`,
grouped-int4 weights included); the sampler then runs the rank's heads over
a cache of those heads and gets the whole vocabulary's logits from the
forward, so every tp rank draws the same tokens. With ``pp`` in the grid
the prompt's prefill is the GPipe pipeline
(:func:`wmar_tpu_torch.parallel.llama_prefill_pp`), with ``sp`` the ring
(:func:`wmar_tpu_torch.models.llama.llama_prefill_sp`; the prompts are
left-padded to a multiple of the ring's size, ``start`` absorbing the
pad), as in JAX; the decode after it runs on every rank. The interleaved
samplers run the whole model and refuse a tp shard (:data:`TP_INTERLEAVED`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from wmar_tpu_torch.core.greenlist import VQInfo
from wmar_tpu_torch.core.sampling import instruct_cfg_combine
from wmar_tpu_torch.engine.decode import SamplerConfig, decode_tokens
from wmar_tpu_torch.engine.kvcache import CacheSpec, KVCache
from wmar_tpu_torch.models.armm import ARMMWrapper, GenParams
from wmar_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_prefill_sp, llama_tp_specs

TP_INTERLEAVED = ("the interleaved samplers run the whole model: --dp, --tp, --sp and --pp are refused on the "
                  "interleaved path, which JAX's entry point runs before its mesh block, ignoring them (ROADMAP "
                  "section 3, fault (q))")
SP_WITH_PP = ("--sp and --pp together: JAX's prefill takes the pipeline and silently drops the ring (ROADMAP section "
              "3, fault (r)); give one of them")


def refuse_tp_interleaved(wrapper) -> None:
    """Raise where ``wrapper`` holds a tensor-parallel shard: the interleaved
    samplers run the whole model."""
    mesh = getattr(wrapper, "mesh", None)
    if mesh is not None and mesh.tp > 1:
        raise NotImplementedError(TP_INTERLEAVED)
from wmar_tpu_torch.models.vqgan import TamingVQGAN


class ChameleonVocab:
    """Vocabulary metadata and the bpe <-> image-code translation tables
    (CPU tensors under the JAX names)."""

    def __init__(self, name2val: dict):
        self.name2val = dict(name2val)
        self.vocab_size = max(self.name2val.values()) + 1
        self.bos_id = self.name2val.get("<s>")
        self.eos_id = self.name2val.get("</s>")
        self.boi_id = self.name2val.get("<racm3:break>")
        self.eoi_id = self.name2val.get("<eoss>")
        self.pad_id = self.name2val.get("<pad>")
        self.eot_id = self.name2val.get("<reserved08706>")

        chr_map = {chr(ord("A") + i): str(i) for i in range(10)}
        bpe2img = {}
        for name, val in self.name2val.items():
            if name.startswith("IMGIMG"):
                digits = "".join(chr_map.get(c, "") for c in name[len("IMGIMG"):-1])
                bpe2img[val] = int(digits)
        self.image_tokens = sorted(bpe2img)
        self.bpe2img_table = torch.full((self.vocab_size,), -1, dtype=torch.int64)
        self.img2bpe_table = torch.zeros((max(bpe2img.values(), default=0) + 1,), dtype=torch.int64)
        if bpe2img:
            bpe = torch.tensor(list(bpe2img.keys()))
            img = torch.tensor(list(bpe2img.values()))
            self.bpe2img_table[bpe] = img
            self.img2bpe_table[img] = bpe
        special = {v for n, v in self.name2val.items() if n.startswith("<") and n != "<"}
        self.special_tokens = sorted(special)
        self.text_tokens = sorted(set(self.name2val.values()) - set(self.image_tokens) - special)
        self.image_token_mask = torch.zeros((self.vocab_size,), dtype=torch.bool)
        self.image_token_mask[self.image_tokens] = True

    @staticmethod
    def from_tokenizer_json(path: str) -> "ChameleonVocab":
        import json

        with open(path) as f:
            tok = json.load(f)
        name2val = dict(tok["model"]["vocab"])
        for item in tok.get("added_tokens", []):
            name2val[item["content"]] = item["id"]
        return ChameleonVocab(name2val)

    @staticmethod
    def synthetic(n_codes: int = 32, n_text: int = 40) -> "ChameleonVocab":
        """Specials, ``n_text`` text tokens and ``n_codes`` IMGIMG code tokens."""
        name2val = {"<s>": 0, "</s>": 1, "<racm3:break>": 2, "<eoss>": 3, "<pad>": 4, "<reserved08706>": 5}
        nxt = 6
        for i in range(n_text):
            name2val[f"tok{i}"] = nxt
            nxt += 1
        for code in range(n_codes):
            name2val["IMGIMG" + "".join(chr(ord("A") + int(d)) for d in str(code)) + "Z"] = nxt
            nxt += 1
        return ChameleonVocab(name2val)

    def bpe_to_img(self, codes: torch.Tensor) -> torch.Tensor:
        return self.bpe2img_table.to(codes.device)[codes]

    def img_to_bpe(self, codes: torch.Tensor) -> torch.Tensor:
        return self.img2bpe_table.to(codes.device)[codes]


@dataclasses.dataclass
class ImageCFGOptions:
    """``Options.Image`` defaults of the reference."""

    guidance_scale_text: float = 3.0
    guidance_scale_image: float = 1.2
    temp: float = 0.7
    top_p: float = 0.9


def build_cfg_prompts(vocab: ChameleonVocab, prompt_ids: List[List[int]]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The right-aligned 3B prompt matrix of instruct CFG.

    Rows: full-conditioned | image-conditioned (image/bos/boi/eoi ids only)
    | unconditioned [bos, boi]; every row ends with <boi>. Returns (tokens
    [3B, L], start [3B], lengths [3B]) with left padding.
    """
    img_ok = set(vocab.image_tokens) | {vocab.bos_id, vocab.boi_id, vocab.eoi_id}
    full = [list(p) + ([] if p and p[-1] == vocab.boi_id else [vocab.boi_id]) for p in prompt_ids]
    image_cond = [[t for t in p if t in img_ok] for p in prompt_ids]
    image_cond = [p + ([] if p and p[-1] == vocab.boi_id else [vocab.boi_id]) for p in image_cond]
    uncond = [[vocab.bos_id, vocab.boi_id] for _ in prompt_ids]
    rows = full + image_cond + uncond
    max_len = max(len(r) for r in rows)
    out = np.full((len(rows), max_len), vocab.pad_id, dtype=np.int32)
    start = np.zeros((len(rows),), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, max_len - len(r):] = r
        start[i] = max_len - len(r)
    return out, start, np.asarray([len(r) for r in rows], dtype=np.int32)


class ChameleonT2ISampler:
    """Prefill and engine ``step_fn`` of 1024-token image generation.

    ``prompts [3B, L]`` (int64) and ``start [3B]`` (int32) lie on the
    parameters' device; ``image_token_mask [V]`` too."""

    def __init__(self, params, cfg: LlamaConfig, image_token_mask: torch.Tensor, prompts: torch.Tensor,
                 start: torch.Tensor, cfg_opts: ImageCFGOptions, image_seq_len: int = 1024,
                 cache_dtype=torch.bfloat16, mesh=None):
        self.params = params
        self.cfg = cfg
        self.image_token_mask = image_token_mask
        self.prompts = prompts
        self.start = start
        self.opts = cfg_opts
        self.image_seq_len = image_seq_len
        self.cache_dtype = cache_dtype
        self.mesh = mesh
        self.prompt_len = prompts.shape[1]

    def _combine(self, logits: torch.Tensor) -> torch.Tensor:
        full, img_cond, uncond = torch.chunk(logits, 3, dim=0)
        return instruct_cfg_combine(full, img_cond, uncond, self.opts.guidance_scale_text,
                                    self.opts.guidance_scale_image)

    def allow_only_mask(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.where(self.image_token_mask, logits, -1e10)

    def prefill(self):
        """The prompt's forward: the GPipe pipeline where the grid has a
        ``pp`` axis, the ring where it has an ``sp`` axis, else
        :func:`llama_forward`. Returns the combined last logits and the
        cache."""
        from wmar_tpu_torch.parallel import llama_prefill_pp

        dev = self.prompts.device
        max_len = self.prompt_len + self.image_seq_len
        cache = KVCache.zeros(self.cfg.n_layers, self.prompts.shape[0], self.cfg.n_heads, max_len,
                              self.cfg.head_dim, self.cache_dtype, device=dev)
        positions = torch.clamp_min(torch.arange(self.prompt_len, device=dev)[None, :] - self.start[:, None], 0)
        mesh = self.mesh
        if mesh is not None and mesh.sp > 1 and mesh.pp > 1:
            raise ValueError(SP_WITH_PP)
        if mesh is not None and mesh.pp > 1:
            logits, cache = llama_prefill_pp(self.params, self.cfg, self.prompts, cache, positions, mesh,
                                             start=self.start)
        elif mesh is not None and mesh.sp > 1:
            logits, cache = llama_prefill_sp(self.params, self.cfg, self.prompts, cache, positions, mesh,
                                             start=self.start)
        else:
            logits, cache = llama_forward(self.params, self.cfg, self.prompts, cache, 0, positions, start=self.start,
                                          mesh=mesh)
        return self._combine(logits[:, -1]), cache

    def step_fn(self, cache, prev: torch.Tensor, step: torch.Tensor):
        tokens = prev.repeat(3)[:, None]  # the drawn token to all three CFG rows
        write_pos = self.prompt_len + step - 1
        positions = (write_pos - self.start)[:, None]
        logits, cache = llama_forward(self.params, self.cfg, tokens, cache, write_pos, positions, start=self.start,
                                      mesh=self.mesh)
        return self._combine(logits[:, -1]), cache


class ChameleonARMM(ARMMWrapper):
    """Anole-7B wrapper: text prompts -> watermarked image codes (BPE space).

    ``llama_params`` is the JAX-layout tree on ``device``; ``tokenizer``
    maps a prompt string to text BPE ids.
    """

    def __init__(
        self,
        llama_params,
        llama_cfg: LlamaConfig,
        vocab: ChameleonVocab,
        vq: TamingVQGAN,
        tokenizer=None,
        alive_ids: Optional[np.ndarray] = None,
        image_seq_len: int = 1024,
        cfg_opts: Optional[ImageCFGOptions] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        super().__init__(device)
        self.llama_params = llama_params
        self.llama_cfg = llama_cfg
        self.vocab = vocab
        self.vq = vq.to(self.device)
        self.vq_cfg = vq.cfg
        self.tokenizer = tokenizer
        self.alive_ids = alive_ids
        self.image_seq_len = image_seq_len
        self.codes_size = int(image_seq_len**0.5)
        if self.codes_size != self.vq_cfg.codes_per_side:
            raise ValueError(f"image_seq_len {image_seq_len} vs tokenizer grid {self.vq_cfg.codes_per_side}^2")
        self.image_size = self.vq_cfg.resolution
        self.cfg_opts = cfg_opts or ImageCFGOptions()
        self.cache_dtype = cache_dtype
        self._bpe2img = vocab.bpe2img_table.to(self.device)
        self._img2bpe = vocab.img2bpe_table.to(self.device)
        self._image_mask = vocab.image_token_mask.to(self.device)
        self.mesh = None

    def shard(self, mesh) -> None:
        """Run on this rank's place of ``mesh`` (a ``parallel.Mesh``): under
        ``tp`` keep only the rank's Megatron shard of the Llama (any weight
        form: float, int8 or grouped int4); the tokenizer stays whole."""
        from wmar_tpu_torch.parallel import apply_specs

        if mesh.sp > 1 and mesh.pp > 1:
            raise ValueError(SP_WITH_PP)
        if mesh.tp > 1:
            self.llama_params = apply_specs(mesh, self.llama_params, llama_tp_specs(self.llama_params))
        self.mesh = mesh

    def _cache_dtype(self):
        """The cache dtype, as a :class:`CacheSpec` of this rank's heads under tensor parallelism."""
        if self.mesh is None or self.mesh.tp == 1 or isinstance(self.cache_dtype, CacheSpec):
            return self.cache_dtype
        return CacheSpec(self.cache_dtype, self.mesh, "dp" if self.mesh.dp > 1 else None, "tp")

    def get_vq(self) -> VQInfo:
        emb = self.vq.quantize.embedding.detach().float().cpu().numpy()
        return VQInfo(vocab_size=self.vocab.vocab_size, alive_ids=self.alive_ids, embedding=emb)

    def get_total_vocab_size(self) -> int:
        return self.vocab.vocab_size

    def tokenize_prompts(self, prompts: Sequence) -> List[List[int]]:
        """(idx, text) tuples or raw strings -> BPE id lists framed as [bos]
        ... [eot] (the reference's end-of-turn sentinel)."""
        if self.tokenizer is None:
            raise ValueError("No text tokenizer configured")
        out = []
        for p in prompts:
            text = p[1] if isinstance(p, (tuple, list)) else p
            out.append([self.vocab.bos_id] + list(self.tokenizer(text)) + [self.vocab.eot_id])
        return out

    @torch.inference_mode()
    def sample(self, conditioning, gen_params: GenParams, apply_watermark: bool = False,
               generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """Codes ``[B, image_seq_len]`` (BPE ids) for the prompts in
        ``conditioning``. ``noise [image_seq_len, B, k]`` feeds the draws'
        Gumbel noise; otherwise it comes from ``generator``."""
        return self.sample_from_ids(self.tokenize_prompts(conditioning), gen_params, apply_watermark, generator, noise)

    def cfg_prompts(self, prompt_ids: List[List[int]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The CFG rows of ``prompt_ids`` as the sampler takes them:
        ``prompts [3B, L]`` int64 and ``start [3B]`` int32 on the wrapper's
        device, left-padded to a multiple of the ring's size under ``sp``
        (``start`` moved by the pad), as JAX's ``sample`` does."""
        prompts, start, _ = build_cfg_prompts(self.vocab, prompt_ids)
        pad = -prompts.shape[1] % (self.mesh.sp if self.mesh is not None else 1)
        if pad:  # the ring's prefill cuts the sequence into sp blocks
            prompts = np.pad(prompts, ((0, 0), (pad, 0)), constant_values=self.vocab.pad_id)
            start = start + pad
        return (torch.as_tensor(prompts, dtype=torch.int64, device=self.device),
                torch.as_tensor(start, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def sample_from_ids(self, prompt_ids: List[List[int]], gen_params: GenParams, apply_watermark: bool = False,
                        generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """:meth:`sample` for prompts given as BPE id lists (for example an
        interleaved history that ends with <boi>)."""
        prompts, start = self.cfg_prompts(prompt_ids)
        sampler = ChameleonT2ISampler(self.llama_params, self.llama_cfg, self._image_mask, prompts, start,
                                      self.cfg_opts, self.image_seq_len, self._cache_dtype(), self.mesh)
        init_logits, cache = sampler.prefill()

        def masked_step(cache, prev, step):
            logits, cache = sampler.step_fn(cache, prev, step)
            return sampler.allow_only_mask(logits), cache

        sampler_cfg = SamplerConfig(
            temperature=gen_params.temperature if gen_params.temperature is not None else self.cfg_opts.temp,
            top_k=gen_params.top_k,
            top_p=gen_params.top_p if gen_params.top_p is not None else self.cfg_opts.top_p,
            greedy=gen_params.greedy,
        )
        tokens, _ = decode_tokens(
            masked_step, cache, sampler.allow_only_mask(init_logits), self.image_seq_len, sampler_cfg,
            watermark=self.watermark_runtime() if apply_watermark else None,
            cond_tokens=prompts[: prompts.shape[0] // 3],  # the full-cond rows
            generator=generator, noise=noise,
        )
        return tokens

    @torch.inference_mode()
    def codes_to_images(self, codes: torch.Tensor) -> torch.Tensor:
        img = torch.clamp_min(self._bpe2img[codes.to(self.device)], 0)
        return torch.clamp(self.vq.decode_codes(img), -1.0, 1.0)

    @torch.inference_mode()
    def images_to_codes(self, images: torch.Tensor) -> torch.Tensor:
        return self._img2bpe[self.vq.encode_codes(images.to(self.device))]
