"""The Silero-style hysteresis segmenter: per-window speech probs → segments.

The Silero network itself comes with the other VADs; this slice keeps the
segmenter that every VAD feeds. It reproduces
``get_speech_timestamps`` semantics (threshold / neg_threshold hysteresis,
min/max speech duration with forced split at the last silence, speech
padding) so options map 1:1: vad_onset → threshold, chunk_size →
max_speech_duration_s.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE
from whisperx_tpu_torch.vad.types import SpeechSegment

WINDOW_SIZE_SAMPLES = 512  # 32 ms @ 16 kHz, Silero's window


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
