"""Port parity, the Mimi finetune's data and the audio prompt sets: the
port's own copies ``wmar_tpu_torch.audio.dataloader`` and
``wmar_tpu_torch.audio.prompts`` (and the CLI's ``synthetic_clips``)
against ``wmar_tpu.audio`` and ``finetune_mimi``, bit for bit: discovery
and its JSON cache, the PCM16 / 24 / 32 and ``.npy`` readers with their
sidecar rates, the spectral resampler, ``AudioDataset``'s crops, pads and
stereo sums, the batches, the seeded split; prompt parsing, ROUGE-L, the
dedup loop, chunking, the wav writer's bytes and reader, the synthesis
loop, and the ``transformers`` backend's refusal without a cached model.
"""

import os
import wave

import numpy as np
import pytest

import finetune_mimi as jcli
from wmar_tpu.audio import dataloader as jdl
from wmar_tpu.audio import prompts as jpr
from wmar_tpu_torch import finetune_mimi as tcli
from wmar_tpu_torch.audio import dataloader as tdl
from wmar_tpu_torch.audio import prompts as tpr


def _write_pcm(path, x, sr, width, channels=1):
    scale = {2: 32767, 3: 8388607, 4: 2147483647}[width]
    ints = np.round(np.clip(x, -1, 1) * scale).astype(np.int64).reshape(-1)
    raw = b"".join(int(v).to_bytes(width, "little", signed=True) for v in ints)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    os.makedirs(d / "sub")
    _write_pcm(str(d / "a16.wav"), rng.standard_normal(3000) * 0.2, 24000, 2)
    _write_pcm(str(d / "sub" / "b24.wav"), rng.standard_normal(1000) * 0.2, 16000, 3)
    _write_pcm(str(d / "c32_stereo.wav"), rng.standard_normal((2000, 2)) * 0.2, 48000, 4, channels=2)
    np.save(d / "d.npy", (rng.standard_normal((2, 2500)) * 0.2).astype(np.float32))
    np.save(d / "e.npy", (rng.standard_normal(900) * 0.2).astype(np.float32))
    (d / "e.sr.txt").write_text("12000\n")
    return str(d)


def test_discovery_and_cache(audio_dir, tmp_path):
    want = jdl.get_cached_audio_files(audio_dir, cache_dir=str(tmp_path / "j"))
    got = tdl.get_cached_audio_files(audio_dir, cache_dir=str(tmp_path / "t"))
    assert got == want and len(got) == 5
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j")
    assert tdl.get_cached_audio_files(audio_dir, cache_dir=str(tmp_path / "j")) == want  # JAX's cache file reads
    assert tdl.get_cached_audio_files(audio_dir, cache_dir=None) == want


@pytest.mark.parametrize("duration", [0.05, 0.2])
def test_dataset_items_and_batches(audio_dir, duration):
    j = jdl.AudioDataset(audio_dir, 24000, duration, cache_dir=None)
    t = tdl.AudioDataset(audio_dir, 24000, duration, cache_dir=None)
    assert t.audio_files == j.audio_files and len(t) == len(j) == 5
    for i in range(len(j)):
        np.testing.assert_array_equal(t[i], j[i])
        assert t[i].dtype == np.float32 and t[i].shape == (int(24000 * duration), 1)
    for drop_last in (False, True):
        jb = list(j.batches([4, 0, 2, 1, 3], 2, drop_last))
        tb = list(t.batches([4, 0, 2, 1, 3], 2, drop_last))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)


def test_readers_and_resampler(audio_dir):
    for name in ("a16.wav", "sub/b24.wav", "c32_stereo.wav"):
        (x, sr), (y, sr2) = tdl._read_wav_any(os.path.join(audio_dir, name)), jdl._read_wav_any(
            os.path.join(audio_dir, name))
        np.testing.assert_array_equal(x, y)
        assert sr == sr2
    for name in ("d.npy", "e.npy"):
        (x, sr), (y, sr2) = tdl._read_npy(os.path.join(audio_dir, name), 24000), jdl._read_npy(
            os.path.join(audio_dir, name), 24000)
        np.testing.assert_array_equal(x, y)
        assert sr == sr2
    x = np.random.default_rng(1).standard_normal((2, 777)).astype(np.float32)
    for sr_in, sr_out in ((24000, 16000), (16000, 24000), (24000, 24000)):
        np.testing.assert_array_equal(tdl._fft_resample(x, sr_in, sr_out), jdl._fft_resample(x, sr_in, sr_out))


def test_empty_dir_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdl.AudioDataset(str(tmp_path), cache_dir=None)


@pytest.mark.parametrize("n,num_valid,seed", [(24, 8, 42424242), (5, 4, 0), (100, 1, 7)])
def test_train_valid_split(n, num_valid, seed):
    for a, b in zip(tdl.train_valid_split(n, num_valid, seed), jdl.train_valid_split(n, num_valid, seed)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdl.train_valid_split(n, n, seed)


def test_synthetic_clips():
    np.testing.assert_array_equal(tcli.synthetic_clips(6, 960, 3), jcli.synthetic_clips(6, 960, 3))


RAW = """Here are 5 prompts you asked for:
1. Describe the smell of rain on a hot summer street.
2. Explain how a bicycle stays upright while moving forward.
- a bullet line to drop
# header
short
3. Talk about the history of the printing press in Europe.
4. Describe a walk through an old forest in autumn light.
5. Explain why the sky looks blue on a clear day and red at"""


def test_prompt_parsing_and_rouge():
    assert tpr.parse_candidate_prompts(RAW) == jpr.parse_candidate_prompts(RAW)
    assert tpr.parse_candidate_prompts("one good prompt line here") == jpr.parse_candidate_prompts(
        "one good prompt line here")
    a, b = tpr.default_tokenize("The cat sat on the mat"), tpr.default_tokenize("a cat sat on a red mat!")
    assert a == jpr.default_tokenize("The cat sat on the mat")
    assert tpr.rouge_l_fmeasure(a, b) == jpr.rouge_l_fmeasure(a, b)
    assert tpr.rouge_l_fmeasure([], b) == 0.0


def test_dedup_and_generation_loop():
    cands = tpr.parse_candidate_prompts(RAW) + ["Describe the smell of rain on a hot summer road.",
                                                "Explain how a bicycle stays upright while moving forward."]
    for threshold in (0.3, 0.7):
        assert tpr.dedup_prompts(cands, 10, threshold) == jpr.dedup_prompts(cands, 10, threshold)
    outputs = [RAW, RAW.replace("rain", "snow"), "1. Talk about volcanoes and how they form under the sea.\nx"]

    def backend(state={"i": 0}):
        state["i"] += 1
        return outputs[(state["i"] - 1) % len(outputs)]

    def jax_backend(state={"i": 0}):
        state["i"] += 1
        return outputs[(state["i"] - 1) % len(outputs)]

    assert tpr.generate_text_prompts(backend, 6, max_rounds=5) == jpr.generate_text_prompts(jax_backend, 6,
                                                                                            max_rounds=5)


@pytest.mark.parametrize("n,chunks", [(10, 3), (3, 3), (7, 1)])
def test_chunking(n, chunks):
    prompts = [f"p{i}" for i in range(n)]
    for idx in range(chunks):
        assert tpr.chunk_prompts(prompts, idx, chunks) == jpr.chunk_prompts(prompts, idx, chunks)
    with pytest.raises(ValueError):
        tpr.chunk_prompts(prompts, chunks, chunks)


def test_wav_writer_bytes_and_reader(tmp_path):
    x = np.random.default_rng(2).standard_normal(1234) * 0.7
    tpr.write_wav(str(tmp_path / "t.wav"), x, 24000)
    jpr.write_wav(str(tmp_path / "j.wav"), x, 24000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    (a, sr), (b, sr2) = tpr.read_wav(str(tmp_path / "t.wav")), jpr.read_wav(str(tmp_path / "t.wav"))
    np.testing.assert_array_equal(a, b)
    assert sr == sr2 == 24000


def test_synthesize_audio_prompts(tmp_path):
    prompts = [f"say number {i}" for i in range(5)]

    def tts(text):
        if text.endswith("3"):
            raise RuntimeError("tts failed")
        return np.full(400 + int(text[-1]), 0.25, np.float32)

    got = tpr.synthesize_audio_prompts(prompts, tts, str(tmp_path / "t"), 1, 2)
    want = jpr.synthesize_audio_prompts(prompts, tts, str(tmp_path / "j"), 1, 2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == ["prompt_00002.wav",
                                                                                        "prompt_00004.wav"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_transformers_backend_refuses_without_a_cached_model():
    with pytest.raises(RuntimeError, match="locally cached"):
        tpr.transformers_prompt_backend("no-such-org/no-such-model-for-tests")
