"""Host-side audio I/O.

Decodes arbitrary containers via the ffmpeg CLI when present (parity with
reference whisperx/audio.py:25-65); without ffmpeg, WAV files go through the
repo's native C++ decoder and resampler (``whisperx_tpu_torch.native``, as
in the JAX package), and through the stdlib ``wave`` reader + ``scipy``
resampler when that library cannot be built.

Output contract (all paths): mono float32 in [-1, 1] at the requested sample
rate, matching ``np.frombuffer(s16le) / 32768.0`` semantics.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave

import numpy as np

from whisperx_tpu_torch.audio.constants import N_SAMPLES, SAMPLE_RATE

_FFMPEG = shutil.which("ffmpeg")


def _resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    try:
        from scipy.signal import resample_poly

        return resample_poly(audio, up, down).astype(np.float32)
    except ImportError:
        # Linear interpolation fallback (adequate for speech VAD/ASR tests).
        n_out = int(round(len(audio) * target_sr / orig_sr))
        x_old = np.arange(len(audio), dtype=np.float64)
        x_new = np.linspace(0.0, len(audio) - 1, n_out)
        return np.interp(x_new, x_old, audio).astype(np.float32)


def _load_wav(file: str, sr: int) -> np.ndarray:
    """Decode a PCM WAV file with the stdlib, then resample/downmix."""
    with wave.open(file, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        raw = w.readframes(w.getnframes())

    if sampwidth == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise RuntimeError(f"Unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return _resample(data, framerate, sr)


def _load_ffmpeg(file: str, sr: int) -> np.ndarray:
    cmd = [
        "ffmpeg",
        "-nostdin",
        "-threads",
        "0",
        "-i",
        file,
        "-f",
        "s16le",
        "-ac",
        "1",
        "-acodec",
        "pcm_s16le",
        "-ar",
        str(sr),
        "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Read an audio file as a mono float32 waveform at ``sr`` Hz.

    Parity: reference whisperx/audio.py:25-65 (ffmpeg s16le pipe). ``.npy``
    files holding a float waveform are accepted directly for test fixtures.
    """
    if not os.path.exists(file):
        raise FileNotFoundError(f"Audio file not found: {file!r}")
    if file.endswith(".npy"):
        # fixture path: assumed already at ``sr``; downmix multi-channel
        arr = np.load(file).astype(np.float32)
        if arr.ndim == 2:  # [n, channels] or [channels, n]
            arr = arr.mean(axis=1 if arr.shape[1] < arr.shape[0] else 0)
        return arr.reshape(-1)
    if _FFMPEG is not None:
        return _load_ffmpeg(file, sr)
    if file.lower().endswith((".wav", ".wave")):
        try:
            from whisperx_tpu_torch.native import decode_wav_file

            return decode_wav_file(file, sr)
        except Exception:
            return _load_wav(file, sr)
    raise RuntimeError(
        f"Cannot decode {file!r}: ffmpeg is not installed and only WAV/NPY "
        "files are supported by the built-in decoders."
    )


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad with zeros or trim ``array`` to ``length`` along ``axis``.

    Parity: reference whisperx/audio.py:68-91. Works for numpy arrays and
    torch tensors.
    """
    if array.shape[axis] > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        array = array[tuple(sl)]
    elif array.shape[axis] < length:
        pad_widths = [(0, 0)] * array.ndim
        pad_widths[axis] = (0, length - array.shape[axis])
        if isinstance(array, np.ndarray):
            array = np.pad(array, pad_widths)
        else:
            import torch.nn.functional as F

            flat = [w for pair in reversed(pad_widths) for w in pair]
            array = F.pad(array, flat)
    return array


def save_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write a mono float32 waveform to a 16-bit PCM WAV file."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
