"""Inter-layer data contracts (parity: reference whisperx/types.py)."""

from typing import List, TypedDict


class SingleSegment(TypedDict):
    start: float
    end: float
    text: str


class TranscriptionResult(TypedDict):
    segments: List[SingleSegment]
    language: str
