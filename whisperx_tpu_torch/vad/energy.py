"""Weightless spectral-energy VAD.

Counterpart of ``whisperx_tpu/vad/energy.py``. Scores are adaptive-threshold
normalized band-limited log energies per 32 ms window, squashed to [0, 1] so
the Silero hysteresis segmenter applies. The device path computes the
probabilities from the resident waveform, so only the per-window prob vector
comes back to the host.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from whisperx_tpu_torch.vad.silero import (
    WINDOW_SIZE_SAMPLES,
    probs_to_speech_timestamps,
)
from whisperx_tpu_torch.vad.types import SpeechSegment

# Absolute floor (log10 mean-square of the pre-emphasized window) below
# which a window is never speech: the percentile squash alone is RELATIVE,
# so noise-only recordings would otherwise have their louder half called
# speech. Speech at normal levels sits far above (amplitude 0.05 ≈ -2.6).
ENERGY_FLOOR = -7.0


def _masked_percentile(
    sorted_vals: torch.Tensor, q: float, n_valid: int
) -> torch.Tensor:
    """np.percentile('linear') over the first n_valid entries of a sorted
    tensor whose invalid tail is +inf."""
    pos = q / 100.0 * (n_valid - 1)
    i0 = min(max(int(np.floor(pos)), 0), sorted_vals.shape[0] - 1)
    i1 = min(i0 + 1, n_valid - 1)
    frac = pos - np.floor(pos)
    return sorted_vals[i0] * (1.0 - frac) + sorted_vals[i1] * frac


def energy_probs(audio: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Device-resident energy VAD pass: [L] f32 (L divisible by the 512-sample
    window; zeros beyond the real audio) → per-window speech prob
    [L // 512]. The percentile statistics mask the padded tail, so the first
    ``n_windows`` entries match the host path."""
    t_pad = audio.shape[0] // WINDOW_SIZE_SAMPLES
    frames = audio.reshape(t_pad, WINDOW_SIZE_SAMPLES)
    emphasized = torch.diff(frames, dim=1, prepend=frames[:, :1])
    energy = torch.log10(torch.mean(emphasized**2, dim=1) + 1e-10)
    valid = torch.arange(t_pad, device=audio.device) < n_windows
    es = torch.sort(torch.where(valid, energy, torch.inf)).values
    lo = _masked_percentile(es, 10.0, n_windows)
    hi = _masked_percentile(es, 95.0, n_windows)
    mid = 0.5 * (lo + hi)
    scale = 8.0 / torch.clamp(hi - lo, min=1e-3)
    # tanh form of the sigmoid: saturates cleanly far from mid
    probs = 0.5 * (1.0 + torch.tanh(0.5 * scale * (energy - mid)))
    probs = torch.where(energy < ENERGY_FLOOR, 0.0, probs)
    return torch.where(hi - lo < 1e-3, 0.0, probs)


class EnergyVAD:
    """Speech/silence detection from band-limited energy statistics."""

    supports_device_audio = True

    def __init__(self, vad_onset: float = 0.5, chunk_size: float = 30.0):
        self.vad_onset = vad_onset
        self.chunk_size = chunk_size

    def speech_probs(self, audio: np.ndarray) -> np.ndarray:
        """Host path, numpy end to end."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = len(audio)
        t = -(-n // WINDOW_SIZE_SAMPLES)
        padded = np.pad(audio, (0, t * WINDOW_SIZE_SAMPLES - n))
        frames = padded.reshape(t, WINDOW_SIZE_SAMPLES)
        # first-difference pre-emphasis (suppresses DC/rumble)
        emphasized = np.diff(frames, axis=1, prepend=frames[:, :1])
        energy = np.log10(np.mean(emphasized**2, axis=1) + 1e-10)
        lo = np.percentile(energy, 10)
        hi = np.percentile(energy, 95)
        if hi - lo < 1e-3:
            return np.zeros(t, np.float32)
        mid = 0.5 * (lo + hi)
        scale = 8.0 / max(hi - lo, 1e-3)
        probs = 0.5 * (1.0 + np.tanh(0.5 * scale * (energy - mid)))
        return np.where(energy < ENERGY_FLOOR, 0.0, probs).astype(np.float32)

    def __call__(self, audio_dict, **options) -> List[SpeechSegment]:
        wav: Union[np.ndarray, torch.Tensor] = audio_dict["waveform"]
        if isinstance(wav, torch.Tensor):
            n = int(audio_dict.get("length", wav.shape[0]))
            pad = (-wav.shape[0]) % WINDOW_SIZE_SAMPLES
            if pad:
                wav = torch.nn.functional.pad(wav, (0, pad))
            t = -(-n // WINDOW_SIZE_SAMPLES)
            probs = energy_probs(wav, t)[:t].cpu().numpy()
        else:
            audio = np.asarray(wav, np.float32).reshape(-1)
            n = len(audio)
            probs = self.speech_probs(audio)
        return probs_to_speech_timestamps(
            probs,
            n,
            threshold=options.get("threshold", self.vad_onset),
            max_speech_duration_s=options.get(
                "max_speech_duration_s", self.chunk_size
            ),
        )
