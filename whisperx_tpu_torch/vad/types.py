"""Lightweight segment types (replaces pyannote.core Segment/Annotation)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class SpeechSegment:
    start: float
    end: float
    speaker: Optional[str] = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self):
        return f"[{self.start:.3f} -> {self.end:.3f}]"
