"""Device-side chunking: upload the raw audio ONCE, slice + mel on the device.

Counterpart of ``whisperx_tpu/audio/device_chunk.py``: the waveform is
uploaded once (as int16 when that is lossless), the VAD reads the resident
tensor (``vad/energy.py``), and each merged chunk's window is cut from it on
the device and fed to the shared log-mel body — the host never touches
chunk samples. The opt-in μ-law and 12-bit upload codecs come later.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE
from whisperx_tpu_torch.audio.mel import _log_mel_batch_body

# Uploads are padded to whole minutes: a few distinct lengths, and 960000
# samples divide into 512-sample VAD windows with no re-padding.
AUDIO_BUCKET = 60 * SAMPLE_RATE


class DeviceAudio(NamedTuple):
    """A device-resident waveform plus its un-padded sample count."""

    data: torch.Tensor  # [padded_len] float32, zero beyond `length`
    length: int


def _pcm16_exact(padded: np.ndarray) -> Optional[np.ndarray]:
    """The waveform as int16 when that is LOSSLESS, else None: values of the
    form k/32768 scale to exact integers in f32, so the check is bitwise,
    not a tolerance. -32768 is representable (clipped PCM)."""
    scaled = padded * 32768.0
    a16 = np.round(scaled)
    if (
        np.abs(scaled - a16).max() == 0.0
        and a16.min() >= -32768
        and a16.max() <= 32767
    ):
        return a16.astype(np.int16)
    return None


def to_device(padded: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """Upload f32 audio, as int16 (half the bytes) when it is PCM-exact."""
    a16 = _pcm16_exact(padded)
    if a16 is not None:
        return torch.from_numpy(a16).to(device).to(torch.float32) / 32768.0
    return torch.from_numpy(np.ascontiguousarray(padded)).to(device)


def upload_audio(
    audio: Union[np.ndarray, DeviceAudio], device: Union[str, torch.device] = "cuda"
) -> DeviceAudio:
    """Pad to a minute bucket and upload once. Idempotent on DeviceAudio."""
    if isinstance(audio, DeviceAudio):
        return audio
    audio = np.asarray(audio, np.float32).reshape(-1)
    n = len(audio)
    target = max(AUDIO_BUCKET, -(-n // AUDIO_BUCKET) * AUDIO_BUCKET)
    if target != n:
        padded = np.zeros(target, np.float32)
        padded[:n] = audio
    else:
        padded = audio
    return DeviceAudio(to_device(padded, device), n)


def chunk_mels(
    dev: DeviceAudio, chunks: List[dict], n_mels: int, max_batch: int = 64
) -> torch.Tensor:
    """Per-chunk log-mels [N, 3000, n_mels] cut from the resident waveform.

    Each row is ``audio[start : start + length]`` zero-padded to 30 s
    BEFORE the mel (whisper training-time semantics: silence has a non-zero
    mel floor). As in the JAX package, chunk counts are bucketed to powers
    of two (≤ ``max_batch``), so the mel sees a few fixed shapes whatever
    the audio's length; the silent padded rows are sliced off.
    """
    n = len(chunks)
    device = dev.data.device
    if n == 0:  # no chunks: empty [0, 3000, n_mels], not an error
        return torch.zeros((0, N_SAMPLES // HOP_LENGTH, n_mels), device=device)
    spans = []
    for ch in chunks:
        s = int(ch["start"] * SAMPLE_RATE)
        e = min(int(ch["end"] * SAMPLE_RATE), dev.length)
        spans.append((s, min(max(e - s, 0), N_SAMPLES)))
    bucket = 1
    while bucket < min(n, max_batch):
        bucket *= 2
    parts = []
    for i in range(0, n, bucket):
        rows = torch.zeros((bucket, N_SAMPLES), dtype=torch.float32, device=device)
        for r, (s, length) in enumerate(spans[i : i + bucket]):
            rows[r, :length] = dev.data[s : s + length]
        parts.append(_log_mel_batch_body(rows, n_mels))
    out = torch.cat(parts) if len(parts) > 1 else parts[0]
    return out[:n]
