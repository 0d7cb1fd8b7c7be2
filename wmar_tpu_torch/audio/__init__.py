"""Audio watermarking case study (PyTorch): the Moshi LM with the fused
watermark and its conditioners, the Mimi codec, the samplers, the audio
attack grid with the EnCodec and DAC codecs, and the AudioSeal sync
watermark.

Port of ``wmar_tpu.audio``'s serving half (``eval_audioseal`` included).
"""

from wmar_tpu_torch.audio.audioseal import AUDIOSEAL_16B, AudioSealConfig, AudioSealModel
from wmar_tpu_torch.audio.codecs import DAC, DAC_24K, ENCODEC_24K, CodecCompression, DACConfig, Encodec, EncodecConfig
from wmar_tpu_torch.audio.conditioners import ConditionFuser, ConditionProvider, LUTConditionerConfig
from wmar_tpu_torch.audio.lm import MOSHI_V01, MoshiConfig, MoshiGen, WMConfig, init_moshi_params
from wmar_tpu_torch.audio.mimi import MIMI_V0_1, Mimi, MimiConfig, init_mimi
from wmar_tpu_torch.audio.sync import SyncPattern
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
    "AUDIOSEAL_16B",
    "AudioSealConfig",
    "AudioSealModel",
    "CodecCompression",
    "ConditionFuser",
    "ConditionProvider",
    "DAC",
    "DACConfig",
    "DAC_24K",
    "ENCODEC_24K",
    "Encodec",
    "EncodecConfig",
    "LUTConditionerConfig",
    "MIMI_V0_1",
    "MOSHI_V01",
    "Mimi",
    "MimiConfig",
    "MoshiConfig",
    "MoshiGen",
    "SyncPattern",
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
