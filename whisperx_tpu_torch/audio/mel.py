"""Log-mel spectrogram front end.

Numerical contract (reference whisperx/audio.py:94-159, and
``whisperx_tpu/audio/mel.py``): hann(400, periodic) STFT with hop 160,
center=True reflect padding, drop the final frame, |.|^2, slaney mel
filterbank (librosa-compatible, computed from the closed form), log10
clamped at 1e-10, dynamic-range floor at (max - 8), then (x+4)/4.

The windowed DFT is two dense matrix products over reshape-framed audio
(no FFT op). Everything is f32; on CUDA the products run without TF32
(``utils/precision.py::reference_matmul`` around the body), which matches
JAX's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from whisperx_tpu_torch.audio.constants import HOP_LENGTH, N_FFT, SAMPLE_RATE
from whisperx_tpu_torch.utils.precision import reference_matmul


def _hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney-scale hz→mel (librosa default, htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2 + 1).

    Equivalent to ``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels)``
    — the matrix the reference ships as ``assets/mel_filters.npz``
    (whisperx/audio.py:96-113); here it is computed from the closed form.
    """
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each filter integrates to ~equal area.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int = N_FFT) -> np.ndarray:
    """Hann-windowed DFT as a [n_fft, 2*(n_fft//2+1)] matmul matrix: columns
    [0, F) are the cosine bank, [F, 2F) the sine bank."""
    n_freqs = 1 + n_fft // 2
    n = np.arange(n_fft)
    # periodic hann window (torch.hann_window default)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    k = np.arange(n_freqs)[:, None]
    angles = 2.0 * np.pi * k * n[None, :] / n_fft
    cos_bank = (np.cos(angles) * window[None, :]).astype(np.float32)
    sin_bank = (-np.sin(angles) * window[None, :]).astype(np.float32)
    return np.ascontiguousarray(np.concatenate([cos_bank, sin_bank], axis=0).T)


def _frame_signal(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[..., L] reflect-padded signal → [..., n_frames, N_FFT] frames at
    HOP_LENGTH stride — pure reshapes/slices: N_FFT = 2.5 hops, so frame k
    = rows k, k+1 and half of row k+2 of the hop-strided reshape."""
    lead = padded.shape[:-1]
    length = padded.shape[-1]
    rows_needed = n_frames + 2
    target = rows_needed * HOP_LENGTH
    if length < target:
        padded = F.pad(padded, (0, target - length))
    else:
        padded = padded[..., :target]
    x2 = padded.reshape(*lead, rows_needed, HOP_LENGTH)
    a = x2[..., 0:n_frames, :]
    b = x2[..., 1 : n_frames + 1, :]
    c = x2[..., 2 : n_frames + 2, : N_FFT - 2 * HOP_LENGTH]
    return torch.cat([a, b, c], dim=-1)  # [..., n_frames, N_FFT]


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``np.pad(x, pad, mode="reflect")`` along the last axis: PyTorch's
    reflect mode where the axis is longer than ``pad``; shorter, the
    reflection wraps again, with period 2·(n-1), as numpy's and JAX's do
    (``F.pad`` refuses such inputs)."""
    n = x.shape[-1]
    if n > pad:
        return F.pad(x, (pad, pad), mode="reflect")
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(i)]
    m = torch.remainder(i, 2 * (n - 1))
    return x[..., torch.where(m < n, m, 2 * (n - 1) - m)]


def _stft_power(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[..., L] → power spectrum [..., n_frames, n_freqs] via a framed matmul."""
    frames = _frame_signal(padded, n_frames)
    dft = torch.from_numpy(_dft_matrices()).to(padded.device)
    spec = torch.matmul(frames, dft)
    n_freqs = 1 + N_FFT // 2
    return spec[..., :n_freqs] ** 2 + spec[..., n_freqs:] ** 2


def _mel_filters_tensor(n_mels: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filters(n_mels)).to(device)


@reference_matmul()
def _log_mel_batch_body(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[N, L] f32 → [N, L // HOP_LENGTH, n_mels] log-mels, each row with its
    own dynamic-range floor. Shared by ``log_mel_batch`` and the chunk
    gather (``audio/device_chunk.py``)."""
    half = N_FFT // 2
    n_frames = audio.shape[-1] // HOP_LENGTH
    padded = reflect_pad(audio, half)
    magnitudes = _stft_power(padded, n_frames)  # [N, T, F]
    filters = _mel_filters_tensor(n_mels, audio.device)
    mel_spec = torch.matmul(magnitudes, filters.T)  # [N, T, n_mels]
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def _as_f32_tensor(audio, device) -> torch.Tensor:
    if isinstance(audio, torch.Tensor):
        return audio.to(torch.float32)
    return torch.as_tensor(np.asarray(audio, np.float32), device=device)


def log_mel_batch(
    audio: Union[np.ndarray, torch.Tensor],
    n_mels: int = 80,
    max_batch: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Log-mels of equal-length rows: [N, L] → [N, L // 160, n_mels], in
    slices of at most ``max_batch`` rows (bounds the framed intermediate).
    A tensor stays on its device; an array goes to ``device``."""
    x = _as_f32_tensor(audio, device)
    n = x.shape[0]
    if n == 0:  # empty batch: [0, T, n_mels], not an error
        return torch.zeros((0, x.shape[1] // HOP_LENGTH, n_mels), device=x.device)
    parts = [
        _log_mel_batch_body(x[i : i + max_batch], n_mels)
        for i in range(0, n, max_batch)
    ]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def log_mel_spectrogram(
    audio,
    n_mels: int = 80,
    padding: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Log-mel spectrogram of one waveform, shape (n_mels, n_frames).

    ``audio``: a file path, numpy array or tensor of 16 kHz mono samples. A
    tensor is computed on its own device; other input on ``device``
    (default ``"cuda"``).
    """
    if isinstance(audio, str):
        from whisperx_tpu_torch.audio.io import load_audio

        audio = load_audio(audio)
    x = _as_f32_tensor(audio, device or "cuda")
    if padding > 0:
        x = F.pad(x, (0, padding))
    return _log_mel_batch_body(x[None], n_mels)[0].T
