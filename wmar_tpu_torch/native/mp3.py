"""Host MP3 round trip over the system ``libmp3lame`` (the port's copy of
``wmar_tpu.native.mp3``).

The reference applies MP3 compression as an audio attack by passing the
waveform through ffmpeg's ``libmp3lame`` encoder and back. The LAME library
(``libmp3lame.so.0``) bundles both the encoder and the HIP decoder, so it is
bound directly with ctypes: encode CBR mono at the requested bitrate, decode
with HIP, and strip the codec latency (encoder delay + the 529-sample
decoder delay) so the output is time-aligned with the input, as ffmpeg's
gapless handling makes it. Where the library does not load,
:func:`available` is false and the audio grid leaves MP3 out.

Host-side numpy; the attack wrapper is
:class:`wmar_tpu_torch.audio.augmentations.MP3Compression`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_MONO = 3  # MPEG_mode MONO
_VBR_OFF = 0

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _Mp3Data(ctypes.Structure):
    # mp3data_struct from lame.h
    _fields_ = [
        ("header_parsed", ctypes.c_int),
        ("stereo", ctypes.c_int),
        ("samplerate", ctypes.c_int),
        ("bitrate", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("mode_ext", ctypes.c_int),
        ("framesize", ctypes.c_int),
        ("nsamp", ctypes.c_ulong),
        ("totalframes", ctypes.c_int),
        ("framenum", ctypes.c_int),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for name in ("libmp3lame.so.0", "libmp3lame.so", ctypes.util.find_library("mp3lame")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
        p_short = np.ctypeslib.ndpointer(np.int16, flags="C")
        p_uchar = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.lame_init.restype = c_void_p
        lib.lame_init.argtypes = []
        for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
                   "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
                   "lame_set_quality", "lame_set_VBR", "lame_set_bWriteVbrTag"):
            getattr(lib, fn).argtypes = [c_void_p, c_int]
            getattr(lib, fn).restype = c_int
        lib.lame_init_params.argtypes = [c_void_p]
        lib.lame_init_params.restype = c_int
        lib.lame_get_encoder_delay.argtypes = [c_void_p]
        lib.lame_get_encoder_delay.restype = c_int
        lib.lame_encode_buffer.argtypes = [c_void_p, p_short, ctypes.c_void_p, c_int, p_uchar, c_int]
        lib.lame_encode_buffer.restype = c_int
        lib.lame_encode_flush.argtypes = [c_void_p, p_uchar, c_int]
        lib.lame_encode_flush.restype = c_int
        lib.lame_close.argtypes = [c_void_p]
        lib.hip_decode_init.restype = c_void_p
        lib.hip_decode_init.argtypes = []
        lib.hip_decode1_headers.argtypes = [
            c_void_p, p_uchar, ctypes.c_size_t, p_short, p_short, ctypes.POINTER(_Mp3Data),
        ]
        lib.hip_decode1_headers.restype = c_int
        lib.hip_decode_exit.argtypes = [c_void_p]
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    """True iff the system libmp3lame could be loaded."""
    return _load() is not None


def encode_mp3(pcm: np.ndarray, sample_rate: int, bitrate_kbps: int) -> tuple[bytes, int]:
    """Encode mono int16 PCM to an MP3 byte stream (CBR).

    Returns ``(mp3_bytes, encoder_delay_samples)``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libmp3lame is not available on this host")
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    assert pcm.ndim == 1
    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_out_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_mode(gfp, _MONO)
        lib.lame_set_VBR(gfp, _VBR_OFF)
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, 2)
        # No Xing/LAME info tag: it decodes as a spurious 576-sample frame,
        # which would shift the whole stream off the enc_delay+529 latency.
        lib.lame_set_bWriteVbrTag(gfp, 0)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params failed (sr={sample_rate}, brate={bitrate_kbps})"
            )
        delay = int(lib.lame_get_encoder_delay(gfp))
        out = np.zeros(int(len(pcm) * 1.25) + 7200, dtype=np.uint8)
        n = lib.lame_encode_buffer(gfp, pcm, None, len(pcm), out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {n}")
        tail = np.zeros(7200, dtype=np.uint8)
        m = lib.lame_encode_flush(gfp, tail, len(tail))
        if m < 0:
            raise RuntimeError(f"lame_encode_flush failed: {m}")
        return out[:n].tobytes() + tail[:m].tobytes(), delay
    finally:
        lib.lame_close(gfp)


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an MP3 byte stream to mono int16 PCM.

    Returns ``(pcm, samplerate)``. Stereo streams are downmixed to mono.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libmp3lame is not available on this host")
    hip = lib.hip_decode_init()
    if not hip:
        raise RuntimeError("hip_decode_init failed")
    try:
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        pcm_l = np.zeros(65536, dtype=np.int16)
        pcm_r = np.zeros(65536, dtype=np.int16)
        info = _Mp3Data()
        chunks = []
        empty = np.zeros(0, dtype=np.uint8)
        # mpglib wants the stream in bounded chunks; after each feed, drain
        # every frame it has buffered (len=0 calls) before feeding more.
        step = 4096
        for pos in range(0, max(len(buf), 1), step):
            feed = np.ascontiguousarray(buf[pos : pos + step])
            feed_len = len(feed)
            while True:
                n = lib.hip_decode1_headers(hip, feed, feed_len, pcm_l, pcm_r, ctypes.byref(info))
                feed, feed_len = empty, 0
                if n < 0:
                    raise RuntimeError(f"hip_decode1_headers failed: {n}")
                if n == 0:
                    break
                if info.stereo == 2:
                    mono = ((pcm_l[:n].astype(np.int32) + pcm_r[:n].astype(np.int32)) // 2).astype(np.int16)
                else:
                    mono = pcm_l[:n].copy()
                chunks.append(mono)
        pcm = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int16)
        return pcm, int(info.samplerate)
    finally:
        lib.hip_decode_exit(hip)


# The HIP (mpglib) decoder outputs 528+1 samples of filterbank latency on top
# of the encoder's own delay — the constant ffmpeg/LAME gapless metadata uses.
_DECODER_DELAY = 529


def mp3_roundtrip(audio: np.ndarray, sample_rate: int, bitrate_kbps: int) -> np.ndarray:
    """float32 mono waveform(s) -> MP3 @ bitrate -> time-aligned float32.

    ``audio``: [T] or [B, T] in [-1, 1]. The output has identical shape;
    codec latency is stripped so sample k lines up with input sample k
    (what the reference gets back from ffmpeg).
    """
    audio = np.asarray(audio, dtype=np.float32)
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    out = np.zeros_like(audio)
    for b in range(audio.shape[0]):
        pcm = np.clip(audio[b] * 32767.0, -32768, 32767).astype(np.int16)
        data, enc_delay = encode_mp3(pcm, sample_rate, bitrate_kbps)
        dec, _sr = decode_mp3(data)
        start = enc_delay + _DECODER_DELAY
        dec = dec[start : start + audio.shape[1]]
        out[b, : len(dec)] = dec.astype(np.float32) / 32767.0
    return out[0] if squeeze else out
