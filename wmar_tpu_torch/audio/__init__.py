"""Audio watermarking case study (PyTorch): the Moshi LM with the fused
watermark, the Mimi codec, the samplers and the audio attack grid.

Port of ``wmar_tpu.audio``'s serving half; the conditioners, AudioSeal and
the sync pattern, the extra codecs and Mimi's finetuning are not ported yet
(ROADMAP queue 1, item 13).
"""

from wmar_tpu_torch.audio.lm import MOSHI_V01, MoshiConfig, MoshiGen, WMConfig, init_moshi_params
from wmar_tpu_torch.audio.mimi import MIMI_V0_1, Mimi, MimiConfig, init_mimi
from wmar_tpu_torch.audio.wm import (
    gumbel_sample,
    gumbel_score,
    maryland_green,
    maryland_sample,
    pvalue_gumbel,
    pvalue_maryland,
    score_stream_maryland,
    window_hash,
    wm_sample_token,
)

__all__ = [
    "MIMI_V0_1",
    "MOSHI_V01",
    "Mimi",
    "MimiConfig",
    "MoshiConfig",
    "MoshiGen",
    "WMConfig",
    "gumbel_sample",
    "gumbel_score",
    "init_mimi",
    "init_moshi_params",
    "maryland_green",
    "maryland_sample",
    "pvalue_gumbel",
    "pvalue_maryland",
    "score_stream_maryland",
    "window_hash",
    "wm_sample_token",
]
