"""The WhisperX merge operation: pack speech segments into ≤chunk_size windows.

Semantics parity: reference whisperx/vads/vad.py:20-53 (greedy packing; a
window closes when adding the next segment would exceed chunk_size).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from whisperx_tpu_torch.vad.types import SpeechSegment


def merge_chunks(
    segments: Sequence[SpeechSegment],
    chunk_size: float,
    onset: float = 0.5,
    offset: Optional[float] = None,
) -> List[dict]:
    """Greedily merge speech segments into windows of at most ``chunk_size``
    seconds. Returns ``[{"start", "end", "segments": [(s, e), ...]}, ...]``.
    """
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if not segments:
        return []

    merged: List[dict] = []
    curr_start = segments[0].start
    curr_end = 0.0
    seg_idxs: List[tuple] = []

    for seg in segments:
        if seg.end - curr_start > chunk_size and curr_end - curr_start > 0:
            merged.append(
                {"start": curr_start, "end": curr_end, "segments": seg_idxs}
            )
            curr_start = seg.start
            seg_idxs = []
        curr_end = seg.end
        seg_idxs.append((seg.start, seg.end))

    merged.append({"start": curr_start, "end": curr_end, "segments": seg_idxs})
    return merged
