"""Hysteresis binarization with the WhisperX min-cut split.

Counterpart of ``whisperx_tpu/vad/binarize.py`` (numpy, a copy): pyannote's
Binarize plus Max Bain's max_duration min-cut at the lowest-score frame
(arXiv:2303.00747), over plain numpy frame scores without pyannote's
Annotation machinery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from whisperx_tpu_torch.vad.types import SpeechSegment


@dataclass
class Binarize:
    onset: float = 0.5
    offset: Optional[float] = None
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0
    pad_onset: float = 0.0
    pad_offset: float = 0.0
    max_duration: float = float("inf")

    def __post_init__(self):
        if self.offset is None:
            self.offset = self.onset

    def __call__(self, scores: np.ndarray, timestamps: np.ndarray) -> List[SpeechSegment]:
        """``scores``: [T] per-frame speech scores; ``timestamps``: [T] frame
        center times (seconds). Returns the active regions."""
        scores = np.asarray(scores, np.float32).reshape(-1)
        timestamps = np.asarray(timestamps, np.float64).reshape(-1)
        assert scores.shape == timestamps.shape

        regions: List[SpeechSegment] = []
        if len(scores) == 0:
            return regions

        start = timestamps[0]
        is_active = scores[0] > self.onset
        curr_scores = [scores[0]]
        curr_times = [start]
        t = start
        for t, y in zip(timestamps[1:], scores[1:]):
            if is_active:
                if t - start > self.max_duration:
                    # min-cut: split at the lowest-score frame in the second
                    # half of the running window
                    search_after = len(curr_scores) // 2
                    div = search_after + int(np.argmin(curr_scores[search_after:]))
                    cut_t = curr_times[div]
                    regions.append(SpeechSegment(start - self.pad_onset, cut_t + self.pad_offset))
                    start = cut_t
                    curr_scores = curr_scores[div + 1 :]
                    curr_times = curr_times[div + 1 :]
                elif y < self.offset:
                    regions.append(SpeechSegment(start - self.pad_onset, t + self.pad_offset))
                    start = t
                    is_active = False
                    curr_scores = []
                    curr_times = []
                curr_scores.append(y)
                curr_times.append(t)
            else:
                if y > self.onset:
                    start = t
                    is_active = True
        if is_active:
            regions.append(SpeechSegment(start - self.pad_onset, t + self.pad_offset))

        # merge overlaps created by padding; fill short gaps
        if self.pad_onset > 0 or self.pad_offset > 0 or self.min_duration_off > 0:
            if self.max_duration < float("inf"):
                raise NotImplementedError("padding/gap-filling would break max_duration min-cut")
            regions = _support(regions, collar=self.min_duration_off)

        if self.min_duration_on > 0:
            regions = [r for r in regions if r.duration >= self.min_duration_on]
        return regions


def _support(regions: List[SpeechSegment], collar: float) -> List[SpeechSegment]:
    """Merge regions whose gap is < collar (pyannote Annotation.support)."""
    if not regions:
        return regions
    regions = sorted(regions, key=lambda r: r.start)
    out = [SpeechSegment(regions[0].start, regions[0].end, regions[0].speaker)]
    for r in regions[1:]:
        if r.start - out[-1].end < collar:
            out[-1].end = max(out[-1].end, r.end)
        else:
            out.append(SpeechSegment(r.start, r.end, r.speaker))
    return out
