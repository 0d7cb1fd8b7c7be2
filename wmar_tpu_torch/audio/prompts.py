"""Prompt sets of the audio case study (the port's own copy of
``wmar_tpu.audio.prompts``, numpy only).

* Text prompts: sample candidate monologue topics from an instruction LLM,
  drop malformed lines, and keep a prompt only while its ROUGE-L
  similarity to every accepted one stays below a threshold.
* Audio prompts: synthesize each text prompt to a 16 kHz wav with a TTS
  model, striped over job-array chunks.

The models are backends: any ``generate() -> str`` / ``tts(text) -> float32
samples`` callable. :func:`transformers_prompt_backend` loads a locally
cached Llama through ``transformers`` at call time and raises a clear
error where that checkpoint is missing.
"""

from __future__ import annotations

import os
import re
import wave
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

TOPIC_INSTRUCTION = """\
You are a creative assistant designing engaging monologue topics for an
audio AI. Generate {n} single-sentence prompts, one per line, each starting
with a verb (describe, explain, talk about, ...), each on a distinct topic,
with nothing else in the answer.
"""


# ---------------------------------------------------------------------------
# Candidate parsing
# ---------------------------------------------------------------------------


def parse_candidate_prompts(text: str) -> List[str]:
    """Extract plausible prompt lines from raw LLM output.

    Drops bullets/headers, meta lines mentioning generate/prompt/example,
    lines outside [10, 100] chars; strips leading ``12. `` numbering; drops
    the final line (possibly truncated mid-generation) when more than one
    candidate survives.
    """
    out = []
    for line in text.strip().split("\n"):
        s = line.strip()
        if not s or s.startswith(("-", "#", "•", "*")):
            continue
        low = s.lower()
        if any(w in low for w in ("generate", "prompt", "example")):
            continue
        if not (10 <= len(s) <= 100):
            continue
        out.append(re.sub(r"^\d+\.\s*", "", s))
    return out[:-1] if len(out) > 1 else out


# ---------------------------------------------------------------------------
# ROUGE-L (LCS f-measure) — the dedup metric
# ---------------------------------------------------------------------------


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    # O(len(a)*len(b)) DP with a rolling row; prompts are short sentences.
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    cur = np.zeros(len(b) + 1, dtype=np.int32)
    for x in a:
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev, cur = cur, prev
    return int(prev[-1])


def rouge_l_fmeasure(a_tokens: Sequence[str], b_tokens: Sequence[str]) -> float:
    """LCS-based F1 (``rouge_scorer._score_lcs``'s ROUGE-L)."""
    lcs = _lcs_len(a_tokens, b_tokens)
    if lcs == 0:
        return 0.0
    p = lcs / len(a_tokens)
    r = lcs / len(b_tokens)
    return 2 * p * r / (p + r)


def default_tokenize(text: str) -> List[str]:
    """Whitespace/alnum tokenizer (stands in for the HF tokenizer; dedup
    only needs a consistent tokenization)."""
    return re.findall(r"[a-z0-9]+", text.lower())


# ---------------------------------------------------------------------------
# Dedup accumulation loop
# ---------------------------------------------------------------------------


def dedup_prompts(
    candidates: Iterable[str],
    num_prompts: int,
    similarity_threshold: float = 0.7,
    tokenize: Callable[[str], List[str]] = default_tokenize,
    accepted: Optional[List[str]] = None,
) -> Tuple[List[str], int]:
    """Accept candidates until ``num_prompts`` unique, sufficiently-distinct
    prompts are collected. Returns ``(accepted, n_filtered)``."""
    acc = list(accepted or [])
    acc_tokens = [tokenize(p) for p in acc]
    seen = set(acc)
    filtered = 0
    for cand in candidates:
        if len(acc) >= num_prompts:
            break
        if cand in seen:
            continue
        toks = tokenize(cand)
        if acc_tokens and max(rouge_l_fmeasure(toks, t) for t in acc_tokens) > similarity_threshold:
            filtered += 1
            continue
        acc.append(cand)
        acc_tokens.append(toks)
        seen.add(cand)
    return acc, filtered


def generate_text_prompts(
    backend: Callable[[], str],
    num_prompts: int,
    similarity_threshold: float = 0.7,
    max_rounds: int = 1000,
    tokenize: Callable[[str], List[str]] = default_tokenize,
) -> List[str]:
    """Repeatedly sample ``backend()`` (one LLM generation per call), parse
    and dedup, until ``num_prompts`` prompts are collected."""
    acc: List[str] = []
    for _ in range(max_rounds):
        if len(acc) >= num_prompts:
            break
        cands = parse_candidate_prompts(backend())
        acc, _ = dedup_prompts(
            cands, num_prompts, similarity_threshold, tokenize, accepted=acc
        )
    return acc[:num_prompts]


def transformers_prompt_backend(model_id: str = "meta-llama/Llama-3.1-8B-Instruct",
                                max_gen_len: int = 1024, temperature: float = 1.0,
                                seed: int = 42):
    """LLM backend via a locally cached HF checkpoint, sampling with top-p
    0.9 after ``torch.manual_seed(seed)``. Raises with a clear message when
    the checkpoint or ``transformers`` is missing."""
    try:
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_id, local_files_only=True)
        model = AutoModelForCausalLM.from_pretrained(model_id, local_files_only=True)
    except Exception as e:  # pragma: no cover - host-dependent
        raise RuntimeError(
            f"text-prompt backend needs a locally cached copy of {model_id!r}; "
            "pass any generate()->str callable instead"
        ) from e
    torch.manual_seed(seed)

    def backend() -> str:  # pragma: no cover - host-dependent
        msgs = [{"role": "user", "content": TOPIC_INSTRUCTION.format(n=50)}]
        ids = tok.apply_chat_template(msgs, add_generation_prompt=True, return_tensors="pt")
        out = model.generate(ids, max_new_tokens=max_gen_len, do_sample=True,
                             top_p=0.9, temperature=temperature)
        return tok.decode(out[0, ids.shape[-1]:], skip_special_tokens=True)

    return backend


# ---------------------------------------------------------------------------
# Audio synthesis over chunks
# ---------------------------------------------------------------------------


def chunk_prompts(prompts: Sequence[str], chunk_idx: int, total_chunks: int
                  ) -> Tuple[List[str], int]:
    """Job-array striping: equal-size contiguous chunks, remainder to the
    last chunk. Returns ``(chunk, start_idx)``."""
    if not 0 <= chunk_idx < total_chunks:
        raise ValueError(f"chunk_idx {chunk_idx} out of range [0, {total_chunks})")
    size = len(prompts) // total_chunks
    start = chunk_idx * size
    end = start + size if chunk_idx < total_chunks - 1 else len(prompts)
    return list(prompts[start:end]), start


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """16-bit PCM mono wav through the stdlib."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), dtype="<i2")
    return pcm.astype(np.float32) / 32767.0, sr


def synthesize_audio_prompts(
    prompts: Sequence[str],
    tts: Callable[[str], np.ndarray],
    output_dir: str,
    chunk_idx: int = 0,
    total_chunks: int = 1,
    sample_rate: int = 16000,
) -> List[str]:
    """Write ``prompt_{global_idx:05d}.wav`` + ``.txt`` pairs for this
    chunk's slice; failures on individual prompts are logged and skipped.
    Returns the wav paths written."""
    os.makedirs(output_dir, exist_ok=True)
    chunk, start = chunk_prompts(prompts, chunk_idx, total_chunks)
    written = []
    for i, prompt in enumerate(chunk):
        gi = start + i
        try:
            audio = np.asarray(tts(prompt)).squeeze()
            wav_path = os.path.join(output_dir, f"prompt_{gi:05d}.wav")
            write_wav(wav_path, audio, sample_rate)
            with open(os.path.join(output_dir, f"prompt_{gi:05d}.txt"), "w") as f:
                f.write(prompt)
            written.append(wav_path)
        except Exception as e:  # keep the job array going
            print(f"prompt {gi}: {type(e).__name__}: {e}")
    return written
