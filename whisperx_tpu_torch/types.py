"""Inter-layer data contracts (parity: reference whisperx/types.py:1-69)."""

from typing import List, Optional, Tuple, TypedDict


class SingleWordSegment(TypedDict):
    word: str
    start: float
    end: float
    score: float


class SingleCharSegment(TypedDict):
    char: str
    start: float
    end: float
    score: float


class SingleSegment(TypedDict):
    start: float
    end: float
    text: str


class SegmentData(TypedDict):
    """Per-segment preprocessed data used during forced alignment."""

    clean_char: List[str]
    clean_cdx: List[int]
    clean_wdx: List[int]
    sentence_spans: List[Tuple[int, int]]


class SingleAlignedSegment(TypedDict):
    start: float
    end: float
    text: str
    words: List[SingleWordSegment]
    chars: Optional[List[SingleCharSegment]]


class TranscriptionResult(TypedDict):
    segments: List[SingleSegment]
    language: str


class AlignedTranscriptionResult(TypedDict):
    segments: List[SingleAlignedSegment]
    word_segments: List[SingleWordSegment]
