"""The port's audio front end against the JAX package's on the CPU: the
native C++ WAV decoder and resampler (built by the port into its own
``_build/``), ``load_audio`` without ffmpeg on WAVs at 8, 16, 44.1 and
48 kHz, mono and stereo, and the opt-in upload codecs of
``WHISPERX_TPU_UPLOAD_COMPAND``."""

import os
import shutil
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperx_tpu.audio import device_chunk as jdc
from whisperx_tpu_torch.audio import device_chunk as tdc
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def _write_wav(path, sr, channels, seconds=1.5, seed=0):
    """Seeded int16 noise with a tone, ``channels`` interleaved channels."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sig = 0.3 * np.sin(2 * np.pi * 440 * t)[:, None] + 0.1 * rng.standard_normal((n, channels))
    pcm = (np.clip(sig, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


def test_the_port_builds_its_own_library():
    """The shared object lands in the port's ``_build/`` under a name that
    hashes the source, never beside ``native/wav_decode.cpp``."""
    from whisperx_tpu_torch import native

    lib = native._get_lib()
    assert lib is native._get_lib()
    so = native.library_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(native.BUILD_DIR)) == "whisperx_tpu_torch"
    assert not os.path.exists(os.path.join(os.path.dirname(native.SRC), os.path.basename(so)))


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000])
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_load_audio_without_ffmpeg_is_bit_identical(tmp_path, monkeypatch, sr, channels):
    """ffmpeg hidden: both packages decode the WAV with the native library,
    bit for bit (this was scipy's ``resample_poly`` in the port, up to 0.043
    away at 8 kHz stereo)."""
    import whisperx_tpu.audio.io as jio
    import whisperx_tpu_torch.audio.io as tio

    monkeypatch.setattr(jio, "_FFMPEG", None)
    monkeypatch.setattr(tio, "_FFMPEG", None)
    path = _write_wav(tmp_path / f"a{sr}{channels}.wav", sr, channels, seed=sr + channels)
    want, got = jio.load_audio(path), tio.load_audio(path)
    assert got.dtype == want.dtype == np.float32
    assert abs(len(got) - 24000) <= 2
    np.testing.assert_array_equal(got, want)


def test_native_resample_and_errors(tmp_path):
    from whisperx_tpu import native as jnative
    from whisperx_tpu_torch import native

    x = np.random.default_rng(1).standard_normal(9000).astype(np.float32)
    for sr_in, sr_out in ((44100, 16000), (8000, 16000), (16000, 16000)):
        np.testing.assert_array_equal(native.resample(x, sr_in, sr_out), jnative.resample(x, sr_in, sr_out))
    assert native.resample(np.zeros(0, np.float32), 44100, 16000).shape == (0,)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(RuntimeError, match="native WAV decode"):
        native.decode_wav_file(str(bad), 16000)


def _codec_input(n=48000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(n) * 0.3, -1, 1).astype(np.float32)
    x[:6] = [-1.0, 1.0, 0.0, -1e-9, 1e-9, 0.5]
    return x


def test_codecs_match_jax():
    """The encoders (numpy in both packages) and the 12-bit unpacking are
    bit-identical to JAX's. μ-law expansion is a deliberate difference: the
    port looks each of the 256 codes up in a table of the formula in f64,
    rounded once (the same bits on every device); JAX evaluates it in f32
    with XLA's exp, which is off by up to ~1e-6 (the 16-bit PCM step is
    3.05e-5)."""
    x = _codec_input()
    u = jdc.mulaw_encode(x)
    np.testing.assert_array_equal(tdc.mulaw_encode(x), u)
    p = jdc.pack12_encode(x)
    np.testing.assert_array_equal(tdc.pack12_encode(x), p)
    np.testing.assert_array_equal(
        tdc.pack12_expand(torch.from_numpy(p)).numpy(),
        np.asarray(jdc.pack12_expand(jnp.asarray(p))),
    )
    codes = np.arange(256, dtype=np.uint8)
    got = tdc.mulaw_expand(torch.from_numpy(codes)).numpy()
    y = codes.astype(np.float64) * (2.0 / 255.0) - 1.0
    exact = (np.sign(y) * np.expm1(np.abs(y) * np.log1p(255.0)) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    want = np.asarray(jdc.mulaw_expand(jnp.asarray(codes)))
    assert 0 < np.abs(got - want).max() <= 1e-6
    assert got[0] == -1.0 and got[255] == 1.0 and got.dtype == np.float32


@pytest.mark.parametrize("mode", ["mulaw", "pack12", ""])
def test_upload_compand_switch_is_honoured(monkeypatch, mode):
    """``WHISPERX_TPU_UPLOAD_COMPAND`` picks the codec ``upload_audio``
    sends, as in JAX: the resident waveform is the codec's expansion (unset:
    the exact waveform). μ-law has no code for 0: its padded tail expands to
    code 128's 8.6e-5, in both packages."""
    monkeypatch.setenv("WHISPERX_TPU_UPLOAD_COMPAND", mode)
    x = _codec_input(30000, seed=2)
    dev = tdc.upload_audio(x, "cpu")
    jax_dev = jdc.upload_audio(x)
    assert dev.length == jax_dev.length == len(x)
    assert dev.data.shape[0] == jax_dev.data.shape[0] == tdc.AUDIO_BUCKET
    got = dev.data.numpy()
    if mode == "mulaw":
        expected = tdc.mulaw_expand(torch.from_numpy(tdc.mulaw_encode(np.pad(x, (0, tdc.AUDIO_BUCKET - len(x))))))
        np.testing.assert_array_equal(got, expected.numpy())
        assert 0 < np.abs(got[: len(x)] - x).max() < 0.05
        np.testing.assert_allclose(got, np.asarray(jax_dev.data), atol=1e-6, rtol=0)
    elif mode == "pack12":
        np.testing.assert_array_equal(got, np.asarray(jax_dev.data))
        assert 0 < np.abs(got[: len(x)] - x).max() <= 2.0**-11  # +1.0 clips to 2047/2048
    else:
        np.testing.assert_array_equal(got[: len(x)], x)
        np.testing.assert_array_equal(got, np.asarray(jax_dev.data))
    tail = got[len(x) :]
    assert (tail == (tail[0] if mode == "mulaw" else 0.0)).all()
