"""The port's audio front end and VAD against the JAX package, on the CPU:
log-mel (batched and chunk-gathered), the energy VAD's host and device
probabilities, the segmenter, and the merged chunk lists."""

import numpy as np
import pytest
import torch

from conftest import synth_speech
from whisperx_tpu.audio import device_chunk as jdc
from whisperx_tpu.audio import mel as jmel
from whisperx_tpu.vad import energy as jenergy
from whisperx_tpu.vad.merge import merge_chunks as jax_merge
from whisperx_tpu.vad.silero import probs_to_speech_timestamps as jax_p2s
from whisperx_tpu_torch.audio import device_chunk as tdc
from whisperx_tpu_torch.audio import mel as tmel
from whisperx_tpu_torch.audio.io import pad_or_trim
from whisperx_tpu_torch.vad import energy as tenergy
from whisperx_tpu_torch.vad.merge import merge_chunks as torch_merge
from whisperx_tpu_torch.vad.silero import probs_to_speech_timestamps as torch_p2s
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# normalized log-mel, both in f32 (JAX with Precision.HIGHEST)
MEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def speech35():
    return synth_speech(35.0)


def test_filterbank_and_dft_tables_are_the_jax_tables():
    np.testing.assert_array_equal(tmel.mel_filters(128), jmel.mel_filters(128))
    np.testing.assert_array_equal(tmel._dft_matrices(), jmel._dft_matrices())


def test_log_mel_batch_matches_jax():
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((3, 16000 * 3))).astype(np.float32)
    want = np.asarray(jmel.log_mel_batch(audio, 80))
    got = tmel.log_mel_batch(audio, 80, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("padding", [0, 16000])
def test_log_mel_spectrogram_matches_jax(padding):
    audio = synth_speech(4.0, seed=3)
    want = np.asarray(jmel.log_mel_spectrogram(audio, 128, padding=padding))
    got = tmel.log_mel_spectrogram(audio, 128, padding=padding, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("max_batch", [64, 2])
def test_chunk_mels_match_jax(speech35, max_batch):
    """3 chunks: one power-of-two bucket of 4 rows, or (max_batch=2) two
    buckets of 2 with the second padded; padded rows are sliced off."""
    chunks = [
        {"start": 0.3, "end": 12.5},
        {"start": 14.0, "end": 35.0},  # longer than the audio's tail is fine
        {"start": 2.0, "end": 2.5},
    ]
    want = np.asarray(
        jdc.chunk_mels(jdc.upload_audio(speech35), chunks, 80, max_batch=max_batch)
    )
    dev = tdc.upload_audio(speech35, "cpu")
    got = tdc.chunk_mels(dev, chunks, 80, max_batch=max_batch)
    assert got.shape == want.shape == (3, 3000, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_ATOL, rtol=0)


def test_upload_is_int16_exact_like_jax():
    """PCM-exact audio takes the int16 upload; either way the resident
    waveform is bitwise the JAX package's."""
    rng = np.random.default_rng(1)
    pcm = (rng.integers(-32768, 32767, 20000) / 32768.0).astype(np.float32)
    for audio in (pcm, pcm + np.float32(1e-6)):
        want = jdc.upload_audio(audio)
        got = tdc.upload_audio(audio, "cpu")
        assert got.length == want.length == len(audio)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert tdc._pcm16_exact(pcm) is not None
    assert tdc._pcm16_exact(pcm + np.float32(1e-6)) is None


def test_energy_vad_host_probs_match_jax(speech35):
    want = jenergy.EnergyVAD().speech_probs(speech35)
    got = tenergy.EnergyVAD().speech_probs(speech35)
    np.testing.assert_array_equal(got, want)  # the same numpy code


def test_energy_vad_device_probs_match_jax(speech35):
    """The device path over the minute-padded resident waveform, masked to
    the real windows: f32 on both sides, tolerance 1e-5 on probs in [0, 1]."""
    jdev = jdc.upload_audio(speech35)
    tdev = tdc.upload_audio(speech35, "cpu")
    t = -(-len(speech35) // 512)
    want = np.asarray(jenergy._energy_probs_jit(jdev.data, t))[:t]
    got = tenergy.energy_probs(tdev.data, t)[:t].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and the device path agrees with the host path, as in the JAX package
    host = tenergy.EnergyVAD().speech_probs(speech35)
    np.testing.assert_allclose(got, host, atol=1e-4, rtol=0)


def test_segmenter_matches_jax():
    rng = np.random.default_rng(2)
    probs = np.clip(
        np.repeat(rng.random(120), 8) + 0.1 * rng.standard_normal(960), 0, 1
    ).astype(np.float32)
    for max_s in (float("inf"), 5.0):
        want = jax_p2s(probs, 960 * 512, max_speech_duration_s=max_s)
        got = torch_p2s(probs, 960 * 512, max_speech_duration_s=max_s)
        assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]


@pytest.mark.parametrize("chunk_size", [30.0, 8.0])
def test_vad_chunk_lists_identical(speech35, chunk_size):
    """Device VAD → segmenter → merge_chunks: identical chunk lists."""
    jvad, tvad = jenergy.EnergyVAD(), tenergy.EnergyVAD()
    jdev = jdc.upload_audio(speech35)
    tdev = tdc.upload_audio(speech35, "cpu")
    jsegs = jvad(
        {"waveform": jdev.data, "sample_rate": 16000, "length": jdev.length},
        max_speech_duration_s=chunk_size,
    )
    tsegs = tvad(
        {"waveform": tdev.data, "sample_rate": 16000, "length": tdev.length},
        max_speech_duration_s=chunk_size,
    )
    want = jax_merge(jsegs, chunk_size)
    got = torch_merge(tsegs, chunk_size)
    assert got == want
    assert len(got) >= 2


def test_pad_or_trim_tensor_and_array():
    x = torch.arange(10, dtype=torch.float32)
    assert pad_or_trim(x, 4).tolist() == [0, 1, 2, 3]
    assert pad_or_trim(x, 12).tolist() == list(range(10)) + [0, 0]
    assert pad_or_trim(np.ones(3, np.float32), 5).tolist() == [1, 1, 1, 0, 0]
