"""Silero VAD: the LSTM network (``models/silero_vad``) and the hysteresis
segmenter every VAD feeds.

Counterpart of ``whisperx_tpu/vad/silero.py``. The segmenter reproduces
``get_speech_timestamps`` semantics (threshold / neg_threshold hysteresis,
min/max speech duration with forced split at the last silence, speech
padding) so options map 1:1: vad_onset → threshold, chunk_size →
max_speech_duration_s.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE
from whisperx_tpu_torch.models.silero_vad.model import (
    WINDOW_SIZE_SAMPLES,
    SileroVADNet,
    frame_audio,
    init_params,
    speech_probs,
)
from whisperx_tpu_torch.vad.types import SpeechSegment


def probs_to_speech_timestamps(
    probs: np.ndarray,
    audio_length_samples: int,
    *,
    threshold: float = 0.5,
    neg_threshold: Optional[float] = None,
    sampling_rate: int = SAMPLE_RATE,
    min_speech_duration_ms: float = 250,
    max_speech_duration_s: float = float("inf"),
    min_silence_duration_ms: float = 100,
    speech_pad_ms: float = 30,
    window_size_samples: int = WINDOW_SIZE_SAMPLES,
) -> List[SpeechSegment]:
    """Convert per-window speech probabilities to speech segments (seconds)."""
    probs = np.asarray(probs).reshape(-1)
    sr = sampling_rate
    min_speech = sr * min_speech_duration_ms / 1000
    pad = int(sr * speech_pad_ms / 1000)
    if math.isinf(max_speech_duration_s):
        max_speech = float("inf")
    else:
        max_speech = sr * max_speech_duration_s - window_size_samples - 2 * pad
    min_silence = sr * min_silence_duration_ms / 1000
    min_silence_at_max = sr * 98 / 1000
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)

    triggered = False
    speeches: List[dict] = []
    current: dict = {}
    temp_end = 0
    prev_end = 0
    next_start = 0

    for i, p in enumerate(probs):
        pos = window_size_samples * i
        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos
        if p >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue
        if triggered and pos - current["start"] > max_speech:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:
                    triggered = False
                else:
                    current["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                current["end"] = pos
                speeches.append(current)
                current = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue
        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end > min_silence_at_max:
                prev_end = temp_end
            if pos - temp_end < min_silence:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False

    if current and audio_length_samples - current["start"] > min_speech:
        current["end"] = audio_length_samples
        speeches.append(current)

    for i, speech in enumerate(speeches):
        if i == 0:
            speech["start"] = int(max(0, speech["start"] - pad))
        if i != len(speeches) - 1:
            silence = speeches[i + 1]["start"] - speech["end"]
            if silence < 2 * pad:
                speech["end"] += silence // 2
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - silence // 2)
                )
            else:
                speech["end"] = int(min(audio_length_samples, speech["end"] + pad))
                speeches[i + 1]["start"] = int(
                    max(0, speeches[i + 1]["start"] - pad)
                )
        else:
            speech["end"] = int(min(audio_length_samples, speech["end"] + pad))

    return [SpeechSegment(s["start"] / sr, s["end"] / sr) for s in speeches]


class SileroVAD:
    """The Silero network with the reference's call contract:
    ``vad({"waveform": audio, "sample_rate": sr})`` → list of SpeechSegment.
    ``model``: a ``SileroVADNet`` (its device is the VAD's); without one,
    random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``."""

    supports_device_audio = True

    def __init__(
        self,
        model: Optional[SileroVADNet] = None,
        *,
        vad_onset: float = 0.5,
        chunk_size: float = 30.0,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        if model is None:
            from whisperx_tpu_torch.models.whisper import resolve_device

            model = init_params(torch.Generator(resolve_device(device)).manual_seed(seed))
        self.model = model
        self.vad_onset = vad_onset
        self.chunk_size = chunk_size

    @classmethod
    def from_checkpoint(
        cls, path: str, device: Union[str, torch.device] = "cuda", **kw
    ) -> "SileroVAD":
        """A converted Silero checkpoint (the JAX package's layout)."""
        from whisperx_tpu_torch.convert.checkpoint import read_checkpoint, silero_from_numpy
        from whisperx_tpu_torch.models.whisper import resolve_device

        flat, _ = read_checkpoint(path)
        return cls(silero_from_numpy(flat, device=resolve_device(device)), **kw)

    def speech_probs(self, audio: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        """Per-window speech probs of host audio or of a waveform already on
        the VAD's device (then only the prob vector comes back)."""
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.asarray(audio, np.float32).reshape(-1))
        windows = frame_audio(audio.to(self.model.device, torch.float32))
        return speech_probs(self.model, windows)[0].cpu().numpy()

    def __call__(self, audio_dict, **options) -> List[SpeechSegment]:
        wav = audio_dict["waveform"]
        if isinstance(wav, torch.Tensor):
            n = int(audio_dict.get("length", wav.shape[0]))
            t = -(-n // WINDOW_SIZE_SAMPLES)
            # zeros beyond `length` are the host path's zero-filled final
            # window, so probs[:t] is the host result
            probs = self.speech_probs(wav)[:t]
        else:
            audio = np.asarray(wav, np.float32).reshape(-1)
            n = len(audio)
            probs = self.speech_probs(audio)
        return probs_to_speech_timestamps(
            probs,
            n,
            threshold=options.get("threshold", self.vad_onset),
            max_speech_duration_s=options.get("max_speech_duration_s", self.chunk_size),
        )
