"""Small text/number helpers (parity: reference whisperx/utils.py:129-190,438)."""

from __future__ import annotations

import sys
import zlib


def exact_div(x: int, y: int) -> int:
    if x % y != 0:
        raise ValueError(f"{x} is not a multiple of {y}")
    return x // y


def str2bool(string: str) -> bool:
    if string == "True":
        return True
    if string == "False":
        return False
    raise ValueError(f"Expected one of {{'True', 'False'}}, got {string}")


def optional_int(string):
    return None if string == "None" else int(string)


def optional_float(string):
    return None if string == "None" else float(string)


def compression_ratio(text: str) -> float:
    """zlib compressibility of the text — Whisper's repetition-loop detector."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def make_safe(string: str) -> str:
    enc = sys.getdefaultencoding()
    if enc == "utf-8":
        return string
    return string.encode(enc, errors="replace").decode(enc)


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


def interpolate_nans(x, method: str = "nearest"):
    """Fill NaNs in a pandas Series by interpolation (alignment helper)."""
    if x.notnull().sum() > 1:
        return x.interpolate(method=method).ffill().bfill()
    return x.ffill().bfill()
