"""Device-side chunking: upload the raw audio ONCE, slice + mel on the device.

Counterpart of ``whisperx_tpu/audio/device_chunk.py``: the waveform is
uploaded once (as int16 when that is lossless), the VAD reads the resident
tensor (``vad/energy.py``), and each merged chunk's window is cut from it on
the device and fed to the shared log-mel body — the host never touches
chunk samples. The opt-in upload codecs of ``WHISPERX_TPU_UPLOAD_COMPAND``
(``mulaw``: 8-bit μ-law, lossy; ``pack12``: 12-bit linear) encode on the
host and expand on the device, as in the JAX package.
"""

from __future__ import annotations

import os
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


_MU = 255.0


def mulaw_encode(padded: np.ndarray) -> np.ndarray:
    """8-bit μ-law companding (G.711-style): [L] f32 in [-1, 1] → [L] uint8.
    Lossy (~38 dB SNR on speech-level signals), hence opt-in."""
    x = np.clip(padded, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def _mulaw_table() -> np.ndarray:
    """The expansion of each of the 256 codes, in f64, rounded once to f32."""
    y = np.arange(256, dtype=np.float64) * (2.0 / 255.0) - 1.0
    return (np.sign(y) * np.expm1(np.abs(y) * np.log1p(_MU)) / _MU).astype(np.float32)


_MULAW_TABLE = _mulaw_table()


def mulaw_expand(u8: torch.Tensor) -> torch.Tensor:
    """Device-side inverse companding as a 256-entry table lookup: the
    upload moves one byte per sample. The table is the formula in f64,
    rounded once, so every device expands to the same bits; the JAX package
    evaluates it in f32 with XLA's ``exp`` (within one f32 ulp of this)."""
    table = torch.from_numpy(_MULAW_TABLE).to(u8.device)
    return table[u8.long()]


def pack12_encode(padded: np.ndarray) -> np.ndarray:
    """12-bit linear packing: [L] f32 (L even) → [L·3/2] uint8, at 2⁻¹¹
    amplitude steps (1.33× fewer bytes than int16)."""
    a = np.clip(np.round(padded * 2048.0), -2048, 2047).astype(np.int32)
    u = (a & 0xFFF).astype(np.uint16)  # two's complement, 12 bits
    lo, hi = u[0::2], u[1::2]
    b0 = lo & 0xFF
    b1 = (lo >> 8) | ((hi & 0xF) << 4)
    b2 = hi >> 4
    return np.stack([b0, b1, b2], axis=1).astype(np.uint8).reshape(-1)


def pack12_expand(u8: torch.Tensor) -> torch.Tensor:
    """Device-side unpack: integer shifts and a sign fold."""
    b = u8.to(torch.int32)
    b0, b1, b2 = b[0::3], b[1::3], b[2::3]
    lo = b0 | ((b1 & 0xF) << 8)
    hi = (b1 >> 4) | (b2 << 4)
    lo = torch.where(lo >= 2048, lo - 4096, lo)
    hi = torch.where(hi >= 2048, hi - 4096, hi)
    out = torch.empty(lo.shape[0] * 2, dtype=torch.float32, device=u8.device)
    out[0::2] = lo.to(torch.float32) / 2048.0
    out[1::2] = hi.to(torch.float32) / 2048.0
    return out


def _compand_mode() -> str:
    return os.environ.get("WHISPERX_TPU_UPLOAD_COMPAND", "").lower()


def to_device(padded: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """Upload f32 audio: μ-law or 12-bit packed when
    ``WHISPERX_TPU_UPLOAD_COMPAND`` asks (``mulaw`` / ``pack12``), else as
    int16 (half the bytes) when it is PCM-exact, else as f32."""
    mode = _compand_mode()
    if mode == "mulaw":
        return mulaw_expand(torch.from_numpy(mulaw_encode(padded)).to(device))
    if mode == "pack12":
        return pack12_expand(torch.from_numpy(pack12_encode(padded)).to(device))
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
