"""Small text/number helpers (parity: reference whisperx/utils.py:129-190)."""

from __future__ import annotations

import zlib


def compression_ratio(text: str) -> float:
    """zlib compressibility of the text — Whisper's repetition-loop detector."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    if seconds < 0:
        raise ValueError(f"non-negative timestamp expected, got {seconds}")
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"
