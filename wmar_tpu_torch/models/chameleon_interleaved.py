"""Interleaved text and image generation for Chameleon (PyTorch).

Port of ``wmar_tpu.models.chameleon_interleaved``: decode text until <boi>
or EOS, then ``image_seq_len`` image tokens, then <eoi>, then text again.

Two entry points, as in the JAX package:

* :func:`sample_interleaved_fused`: one decode loop over one KV cache, with
  no re-prefill at a switch of modality. The three instruct-CFG rows share
  one token history and are told apart by a per-row ``key_mask [3, t_max]``
  that is updated on the device every step. With a cache of 2048 slots or
  more (``cache_budget``) every step's attention goes to the flash-decode
  kernels on a float or int8 cache, and to the chunked packed kernels on a
  packed one.
* :func:`sample_interleaved`: a host-driven loop of segments, each with a
  fresh prefill (:class:`ChameleonTextSampler` for text, the text-to-image
  sampler for an image).

Text-segment processors: allowed-tokens mask (text + eos + boi), repetition
penalty, temperature, top-p, an optional text watermark, and no <boi> once
a whole image no longer fits.

Randomness comes from an explicit ``torch.Generator`` or, in tests that hold
the port against JAX, from fed Gumbel noise. The JAX loop draws a step's
text token and its image token from one key; here both draws of a step take
the same noise tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from wmar_tpu_torch.core.sampling import (
    apply_watermark_bias,
    context_keys_at_step,
    gumbel_noise,
    instruct_cfg_combine,
    warp_and_sample,
)
from wmar_tpu_torch.engine.kvcache import KVCache
from wmar_tpu_torch.models.chameleon import TP_INTERLEAVED, ChameleonVocab, refuse_tp_interleaved
from wmar_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_prefill_sp

NEG = -1e10


@dataclasses.dataclass(frozen=True)
class TextGenOptions:
    """``Options.Text`` defaults of the reference."""

    max_gen_len: int = 64
    temp: float = 0.7
    top_p: float = 0.9
    repetition_penalty: float = 1.2
    greedy: bool = False


def make_text_watermark(spec, greenlist):
    """Text-stream watermark hook: biases green tokens using the last ``h``
    emitted tokens as context. ``hook(logits [B, V], buffer [B, L], length)``."""

    def hook(logits, buffer, length):
        keys, valid = context_keys_at_step(spec, buffer, length, length)
        return apply_watermark_bias(spec, greenlist, logits, keys, valid)

    return hook


def repetition_penalty_mask(logits: torch.Tensor, counts: torch.Tensor, penalty: float) -> torch.Tensor:
    """HF-style repetition penalty: divide positive logits of seen tokens by
    ``penalty``, multiply negative ones."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, pen, logits)


def _step_noise(noise, s: int, shape, generator, device, greedy: bool):
    """The Gumbel noise of draw ``s``: fed, drawn from ``generator``, or
    None where the draw is greedy."""
    if noise is not None:
        return noise[s]
    return None if greedy else gumbel_noise(shape, generator, device)


class ChameleonTextSampler:
    """One text segment: a decode loop with EOS freeze and allowed-token masking."""

    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        vocab: ChameleonVocab,
        opts: TextGenOptions,
        allow_image_start: bool = True,
        max_seq_len: int = 4096,
        cache_dtype=torch.float32,
        text_watermark=None,
        device="cpu",
    ):
        self.params = params
        self.cfg = cfg
        self.vocab = vocab
        self.opts = opts
        self.max_seq_len = max_seq_len
        self.cache_dtype = cache_dtype
        self.text_watermark = text_watermark
        self.device = torch.device(device)
        mask = torch.zeros((vocab.vocab_size,), dtype=torch.bool)
        mask[vocab.text_tokens] = True
        mask[vocab.eos_id] = True
        if allow_image_start:
            mask[vocab.boi_id] = True
        self.allowed = mask.to(self.device)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, start: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """``prompts [B, L]`` right-aligned -> ``(tokens [B, max_gen_len],
        n_valid [B])``; after EOS or <boi> a row emits pad. ``noise
        [max_gen_len, B, V]`` feeds the draws' Gumbel noise."""
        cfg, opts, vocab, dev = self.cfg, self.opts, self.vocab, self.device
        prompts = prompts.to(dev, torch.int64)
        start = start.to(dev)
        b, l = prompts.shape
        cache = KVCache.zeros(cfg.n_layers, b, cfg.n_heads, l + opts.max_gen_len, cfg.head_dim, self.cache_dtype,
                              device=dev)
        positions = torch.clamp_min(torch.arange(l, device=dev)[None, :] - start[:, None], 0)
        logits, cache = llama_forward(self.params, cfg, prompts, cache, 0, positions, start=start)

        counts = torch.zeros((b, vocab.vocab_size), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, prompts, torch.ones_like(prompts, dtype=torch.int32))
        # watermark context buffer: the prompt (pads included) followed by emitted tokens
        buffer = torch.cat([prompts, torch.zeros((b, opts.max_gen_len), dtype=torch.int64, device=dev)], dim=1)
        # <boi> forbidden once fewer than 1026 slots remain
        boi_budget_ok = l + opts.max_gen_len + 1026 <= self.max_seq_len

        def draw(logits, s: int):
            logits = logits.to(torch.float32)
            if self.text_watermark is not None:
                logits = self.text_watermark(logits, buffer, l + s)
            logits = torch.where(self.allowed, logits, NEG)
            if not boi_budget_ok:
                logits[:, vocab.boi_id] = NEG
            logits = repetition_penalty_mask(logits, counts, opts.repetition_penalty)
            return warp_and_sample(logits, temperature=opts.temp, top_p=opts.top_p, greedy=opts.greedy,
                                   noise=_step_noise(noise, s, logits.shape, generator, dev, opts.greedy))

        tok = draw(logits[:, -1], 0)
        done = (tok == vocab.eos_id) | (tok == vocab.boi_id)
        counts.scatter_add_(1, tok[:, None], torch.ones((b, 1), dtype=torch.int32, device=dev))
        buffer[:, l] = tok
        for s in range(1, opts.max_gen_len):
            pos = l + s - 1
            logits, cache = llama_forward(self.params, cfg, tok[:, None], cache, pos, (pos - start)[:, None],
                                          start=start)
            tok = torch.where(done, vocab.pad_id, draw(logits[:, -1], s))
            counts.scatter_add_(1, tok[:, None], (~done).to(torch.int32)[:, None])
            buffer[:, l + s] = tok
            done = done | (tok == vocab.eos_id) | (tok == vocab.boi_id)
        tokens = buffer[:, l:]
        return tokens, (tokens != vocab.pad_id).sum(dim=1)


def split_token_sequence(tokens: np.ndarray, boi: int, eoi: int) -> List[Tuple[str, np.ndarray]]:
    """Split a 1-row token stream into text and image segments."""
    assert tokens.shape[0] == 1
    segments: List[Tuple[str, np.ndarray]] = []
    current: List[int] = []
    in_image = False
    for token in tokens[0].tolist():
        if token == boi:
            if current:
                segments.append(("text_seg", np.asarray(current)[None]))
                current = []
            in_image = True
        elif token == eoi and in_image:
            segments.append(("image_seg", np.asarray(current)[None]))
            current = []
            in_image = False
        else:
            current.append(token)
    if current:
        segments.append(("image_seg" if in_image else "text_seg", np.asarray(current)[None]))
    return segments


def _emitted_segments(out: np.ndarray, vocab: ChameleonVocab):
    emitted = [int(t) for t in out if t != vocab.pad_id]
    if vocab.eos_id in emitted:
        emitted = emitted[: emitted.index(vocab.eos_id) + 1]
    return split_token_sequence(np.asarray(emitted)[None], vocab.boi_id, vocab.eoi_id)


@torch.inference_mode()
def sample_interleaved_fused(
    wrapper,
    prompt,
    gen_params,
    text_opts: Optional[TextGenOptions] = None,
    max_images: int = 1,
    apply_watermark: bool = False,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: Optional[int] = None,
    cache_budget: Optional[int] = None,
    sp_mesh=None,
    noise: Optional[torch.Tensor] = None,
):
    """Interleaved generation as one decode loop, with no re-prefill at a
    switch of modality. Returns the ``[(kind, tokens [1, n])]`` segment list.

    ``cache_budget`` sizes the KV cache beyond the generation budget (for
    example the reference's 4096-token context), so the attention runs at a
    real cache geometry. ``sp_mesh``: a grid with an ``sp`` axis (and no
    ``tp``), on whose ranks the prompt's prefill runs as the ring
    (:func:`~wmar_tpu_torch.models.llama.llama_prefill_sp`), as in JAX:
    the prompt is right-padded to a multiple of the ring's size and the
    pad slots stay key-masked; every rank then runs the same loop.
    ``noise [budget, 1, V]`` feeds the Gumbel noise: slice 0 draws the
    first token (from the prefill logits), slice ``s + 1`` the token of
    loop step ``s``; a step's text and image draws share it.

    All three instruct-CFG rows share one KV cache over one token history;
    per-row key masks give each row its context (everything | image tokens
    only | <s> and the current image). Each row carries its own compacted
    rope position counter (the rank of a token within that row's valid
    set), so queries and keys are rotated at the positions a re-prefill of
    the row's own sequence would assign, the uncond row's reset to ``[<s>,
    <boi>]`` at each new image included.

    The loop's state (mode, counters, key mask, token counts, image buffer)
    stays on the device and the loop makes exactly ``budget - 1`` forwards
    whatever is drawn: nothing is read back before the end, so the launch
    count is exact. Slot indices are Python ints of the loop counter.
    """
    refuse_tp_interleaved(wrapper)
    if sp_mesh is not None and sp_mesh.tp > 1:
        raise NotImplementedError(TP_INTERLEAVED)  # the wrapper's weights are whole: a tp grid would sum them twice
    text_opts = text_opts or TextGenOptions()
    vocab, cfg, opts = wrapper.vocab, wrapper.llama_cfg, wrapper.cfg_opts
    dev = wrapper.device
    image_seq_len = wrapper.image_seq_len
    params = wrapper.llama_params
    v = vocab.vocab_size
    prompt_ids = wrapper.tokenize_prompts([prompt])[0]
    lp = len(prompt_ids)
    budget = max_new_tokens or (max_images * (image_seq_len + 2) + (max_images + 1) * text_opts.max_gen_len)
    t_max = max(lp + budget + 1, cache_budget or 0)
    wm = wrapper.watermark_runtime() if apply_watermark else None

    img_ok = vocab.image_token_mask.clone()
    img_ok[[vocab.bos_id, vocab.boi_id, vocab.eoi_id]] = True
    text_ok = torch.zeros((v,), dtype=torch.bool)
    text_ok[vocab.text_tokens] = True
    text_ok[vocab.eos_id] = True
    text_ok = text_ok.to(dev)
    image_mask = vocab.image_token_mask.to(dev)
    temp_img = gen_params.temperature if gen_params.temperature is not None else opts.temp
    top_p_img = gen_params.top_p if gen_params.top_p is not None else opts.top_p
    all_greedy = text_opts.greedy and gen_params.greedy

    def scalar(x, dtype=torch.int64):
        return torch.tensor(x, dtype=dtype, device=dev)

    boi, eos, eoi, pad = (scalar(t) for t in (vocab.boi_id, vocab.eos_id, vocab.eoi_id, vocab.pad_id))

    # --- one prefill over the prompt, 3 rows, per-row key masks
    prompt_tokens = torch.tensor(prompt_ids, dtype=torch.int64)
    prow1 = img_ok[prompt_tokens]
    prow2 = prompt_tokens == vocab.bos_id
    key_mask = torch.zeros((3, t_max), dtype=torch.bool)
    key_mask[0, :lp] = True
    key_mask[1, :lp] = prow1
    key_mask[2, :lp] = prow2
    row2_reset = torch.zeros((t_max,), dtype=torch.bool)  # the uncond row after a <boi>: the prompt's <s> only
    row2_reset[:lp] = prow2
    # per-row compacted positions: the rank within the row's valid subset;
    # invalid slots are key-masked, so their rope angle is moot
    positions = torch.stack([torch.arange(lp), torch.cumsum(prow1.long(), 0) - 1,
                             torch.cumsum(prow2.long(), 0) - 1]).clamp_min(0)
    n1, n2 = int(prow1.sum()), int(prow2.sum())
    key_mask, row2_reset, positions, prompt_tokens = (x.to(dev) for x in (key_mask, row2_reset, positions,
                                                                           prompt_tokens))
    cache = KVCache.zeros(cfg.n_layers, 3, cfg.n_heads, t_max, cfg.head_dim, wrapper.cache_dtype, device=dev)
    toks3 = prompt_tokens[None].expand(3, lp)
    if sp_mesh is not None and sp_mesh.sp > 1:
        # the ring's prefill over the prompt right-padded to a multiple of the ring's size; the pad slots stay
        # key-masked and the decode overwrites them from slot lp on
        pad = -lp % sp_mesh.sp
        logits, cache = llama_prefill_sp(params, cfg, torch.nn.functional.pad(toks3, (0, pad)), cache,
                                         torch.nn.functional.pad(positions, (0, pad)), sp_mesh, key_mask=key_mask)
        logits = logits[:, :lp]
    else:
        logits, cache = llama_forward(params, cfg, toks3, cache, 0, positions, key_mask=key_mask)

    def process(last3, mode, counts, img_buf, img_count, images_done, step: int, text_count):
        last3 = last3.to(torch.float32)
        # text path (row 0 only)
        lt = repetition_penalty_mask(last3[0], counts, text_opts.repetition_penalty)
        # <boi> only while a whole image and its <eoi> still fit the budget
        allow_boi = (images_done < max_images) & (budget - (step + 2) >= image_seq_len + 1)
        boi_logit = lt[vocab.boi_id]
        lt = torch.where(text_ok, lt, NEG)
        lt[vocab.boi_id] = torch.where(allow_boi, boi_logit, NEG)
        # image path (CFG combine over the 3 rows)
        li = instruct_cfg_combine(last3[0:1], last3[1:2], last3[2:3], opts.guidance_scale_text,
                                  opts.guidance_scale_image)
        if wm is not None:
            li = wm.bias(li, img_buf[None], img_count, img_count)
        li = torch.where(image_mask, li, NEG)
        g = _step_noise(noise, step + 1, (1, v), generator, dev, all_greedy)
        tok_text = warp_and_sample(lt[None], temperature=text_opts.temp, top_p=text_opts.top_p,
                                   greedy=text_opts.greedy, noise=g)[0]
        tok_img = warp_and_sample(li, temperature=temp_img, top_p=top_p_img, greedy=gen_params.greedy, noise=g)[0]
        # per-segment max_gen_len: at the cap, open an image if one is still budgeted, else end the turn
        tok_text = torch.where(text_count >= text_opts.max_gen_len, torch.where(allow_boi, boi, eos), tok_text)
        return torch.where(mode == 0, tok_text, tok_img)

    img_buf = torch.zeros((image_seq_len,), dtype=torch.int64, device=dev)
    # the repetition penalty covers the whole past, the prompt included
    counts = torch.bincount(prompt_tokens, minlength=v).to(torch.int32)
    zero, one = scalar(0), scalar(1)
    # the first token comes from the prefill logits, by the loop's own transition logic
    tok = process(logits[:, -1], zero, counts, img_buf, zero, zero, -1, zero)
    is_boi = tok == boi
    key_mask[0, lp] = True
    key_mask[1, lp] = is_boi
    key_mask[2] = torch.where(is_boi, row2_reset, key_mask[2])
    key_mask[2, lp] = is_boi | key_mask[2, lp]
    pos_ctr = torch.stack([scalar(lp), scalar(n1), torch.where(is_boi, 1, n2)])
    mode = is_boi.to(torch.int64)
    img_count, images_done = zero.clone(), zero.clone()
    counts.index_add_(0, tok.reshape(1), torch.ones((1,), dtype=torch.int32, device=dev))
    done = tok == eos
    text_count = (~is_boi).to(torch.int64)

    toks = torch.empty((budget,), dtype=torch.int64, device=dev)
    toks[0] = tok
    write_pos = torch.arange(lp, lp + budget, device=dev)  # write_pos[s] is a 0-d device view
    for step in range(budget - 1):
        wp = lp + step
        # each row rotates this token at its own compacted position
        logits, cache = llama_forward(params, cfg, tok.expand(3, 1), cache, write_pos[step], pos_ctr[:, None],
                                      key_mask=key_mask)
        pos_ctr = pos_ctr + key_mask[:, wp].to(torch.int64)
        tok = process(logits[:, -1], mode, counts, img_buf, img_count, images_done, step, text_count)
        # forced <eoi> once the image segment is complete
        img_full = (mode == 1) & (img_count >= image_seq_len)
        tok = torch.where(img_full, eoi, tok)
        tok = torch.where(done, pad, tok)

        is_boi = (mode == 0) & (tok == boi)
        is_eos = (mode == 0) & (tok == eos)
        is_eoi = img_full & ~done
        is_img_tok = (mode == 1) & ~img_full & ~done

        # key-mask updates at the write position of tok (the next step's wp);
        # the uncond row resets to [<s>, <boi>] at each new image segment
        in_image_ctx = (is_img_tok | is_boi | is_eoi) & ~done
        key_mask[2] = torch.where(is_boi, row2_reset, key_mask[2])
        key_mask[:, wp + 1] = torch.stack([~done, in_image_ctx, in_image_ctx])

        slot = img_count.clamp(max=image_seq_len - 1).reshape(1)
        img_buf.index_copy_(0, slot, torch.where(is_img_tok, tok.reshape(1), img_buf.index_select(0, slot)))
        counts.index_add_(0, tok.reshape(1), (mode == 0).to(torch.int32).reshape(1))
        img_count = torch.where(is_boi, 0, torch.where(is_img_tok, img_count + 1, img_count))
        images_done = images_done + is_eoi.to(torch.int64)
        mode = torch.where(is_boi, 1, torch.where(is_eoi, 0, mode))
        # text-segment length: +1 per text token, reset at a segment boundary
        text_count = torch.where(is_boi | is_eoi, 0, text_count + ((mode == 0) & ~done).to(torch.int64))
        done = done | is_eos
        # the uncond row's valid set collapses to {<s>}: the <boi> just written sits at compacted position 1
        pos_ctr = torch.where(is_boi, torch.stack([pos_ctr[0], pos_ctr[1], one]), pos_ctr)
        toks[step + 1] = tok
    return _emitted_segments(toks.cpu().numpy(), vocab)


@torch.inference_mode()
def sample_interleaved(
    wrapper,
    prompt,
    gen_params,
    text_opts: Optional[TextGenOptions] = None,
    max_images: int = 1,
    apply_watermark: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Interleaved output for one prompt by a host-driven loop of segments,
    each with a fresh prefill over the whole history. Returns the
    ``[(kind, tokens)]`` segment list."""
    refuse_tp_interleaved(wrapper)
    text_opts = text_opts or TextGenOptions()
    vocab = wrapper.vocab
    history = list(wrapper.tokenize_prompts([prompt])[0])
    out_tokens: List[int] = []
    images_done = 0

    for _ in range(2 * max_images + 1):
        # --- text segment
        sampler = ChameleonTextSampler(wrapper.llama_params, wrapper.llama_cfg, vocab, text_opts,
                                       allow_image_start=images_done < max_images,
                                       cache_dtype=wrapper.cache_dtype, device=wrapper.device)
        toks, _ = sampler.generate(torch.tensor([history]), torch.zeros((1,), dtype=torch.int32), generator)
        emitted = [int(t) for t in toks[0].tolist() if t != vocab.pad_id]
        stop = next((i for i, t in enumerate(emitted) if t in (vocab.eos_id, vocab.boi_id)), None)
        text_part = emitted if stop is None else emitted[: stop + 1]
        history += text_part
        out_tokens += text_part
        if not text_part or text_part[-1] != vocab.boi_id or images_done >= max_images:
            break

        # --- image segment: re-prefill with the CFG rows over the whole history
        img_tokens = wrapper.sample_from_ids([history], gen_params, apply_watermark, generator=generator)[0].tolist()
        history += img_tokens + [vocab.eoi_id]
        out_tokens += img_tokens + [vocab.eoi_id]
        images_done += 1

    return split_token_sequence(np.asarray(out_tokens)[None], vocab.boi_id, vocab.eoi_id)
