"""Advanced subtitle generation: sentence/conjunction/comma-aware splitting.

Behavioral parity with reference whisperx/SubtitlesProcessor.py:33-225:
per-language line lengths (complex scripts → 30/20 chars), conjunction and
comma split points, midpoint splitting for overlong lines, and k=0.25 s/char
timestamp estimation for words without alignment.
"""

from __future__ import annotations

import math
from typing import List, Optional

from whisperx_tpu_torch.utils.conjunctions import get_comma, get_conjunctions

COMPLEX_SCRIPT_LANGUAGES = (
    "th", "lo", "my", "km", "am", "ko", "ja", "zh", "ti", "ta", "te",
    "kn", "ml", "hi", "ne", "mr", "ar", "fa", "ur", "ka",
)
SECONDS_PER_CHAR = 0.25  # k for unaligned-word timestamp estimation


def _half_up(n: float) -> int:
    return math.floor(n) if n - math.floor(n) < 0.5 else math.ceil(n)


def format_timestamp(seconds: float, is_vtt: bool = False) -> str:
    from whisperx_tpu_torch.utils.text import format_timestamp as _fmt

    return _fmt(
        seconds,
        always_include_hours=True,
        decimal_marker="." if is_vtt else ",",
    )


class SubtitlesProcessor:
    def __init__(
        self,
        segments: List[dict],
        lang: str,
        max_line_length: int = 45,
        min_char_length_splitter: int = 30,
        is_vtt: bool = False,
    ):
        self.segments = segments
        self.lang = lang
        self.comma = get_comma(lang)
        self.conjunctions = get_conjunctions(lang)
        self.is_vtt = is_vtt
        if lang in COMPLEX_SCRIPT_LANGUAGES:
            max_line_length, min_char_length_splitter = 30, 20
        self.max_line_length = max_line_length
        self.min_char_length_splitter = min_char_length_splitter

    # -- word-timestamp estimation (reference :47-72) ----------------------

    def estimate_timestamp_for_word(
        self, words: List[dict], i: int, next_segment_start_time: Optional[float] = None
    ) -> None:
        k = SECONDS_PER_CHAR
        word = words[i]
        prev_end = words[i - 1].get("end") if i > 0 else None
        next_start = words[i + 1].get("start") if i < len(words) - 1 else None

        if prev_end is not None:
            word["start"] = prev_end
            if next_start is not None:
                word["end"] = next_start
            elif next_segment_start_time is not None:
                gap_ok = next_segment_start_time - prev_end <= 1
                word["end"] = (
                    next_segment_start_time if gap_ok else next_segment_start_time - 0.5
                )
            else:
                word["end"] = word["start"] + len(word["word"]) * k
        elif next_start is not None:
            word["start"] = next_start - len(word["word"]) * k
            word["end"] = next_start
        elif next_segment_start_time is not None:
            word["start"] = next_segment_start_time - 1
            word["end"] = next_segment_start_time - 0.5
        else:
            word["start"] = word["end"] = 0

    # -- split-point logic (reference :100-137) ----------------------------

    def determine_advanced_split_points(
        self, segment: dict, next_segment_start_time: Optional[float] = None
    ) -> List[int]:
        words = segment.get("words", segment["text"].split())
        add_space = 0 if self.lang in ("zh", "ja") else 1

        def wlen(w) -> int:
            return (len(w["word"]) if isinstance(w, dict) else len(w)) + add_space

        split_points: List[int] = []
        last_split = 0
        char_count = 0
        char_count_after = sum(wlen(w) for w in words)

        for i, word in enumerate(words):
            text = word["word"] if isinstance(word, dict) else word
            length = wlen(word)
            char_count += length
            char_count_after -= length
            char_count_before = char_count - length

            if isinstance(word, dict) and ("start" not in word or "end" not in word):
                self.estimate_timestamp_for_word(words, i, next_segment_start_time)

            if char_count >= self.max_line_length:
                if char_count_before >= self.min_char_length_splitter:
                    midpoint = _half_up((last_split + i) / 2)
                    split_points.append(midpoint)
                    last_split = midpoint + 1
                    char_count = sum(wlen(words[j]) for j in range(last_split, i + 1))
            elif (
                text.endswith(self.comma)
                and char_count_before >= self.min_char_length_splitter
                and char_count_after >= self.min_char_length_splitter
            ):
                split_points.append(i)
                last_split = i + 1
                char_count = 0
            elif (
                text.lower() in self.conjunctions
                and char_count_before >= self.min_char_length_splitter
                and char_count_after >= self.min_char_length_splitter
            ):
                split_points.append(i - 1)
                last_split = i
                char_count = length

        return split_points

    # -- subtitle assembly (reference :140-200) ----------------------------

    def generate_subtitles_from_split_points(
        self,
        segment: dict,
        split_points: List[int],
        next_start_time: Optional[float] = None,
    ) -> List[dict]:
        words = segment.get("words", segment["text"].split())
        total_words = len(words)
        total_time = segment["end"] - segment["start"]
        elapsed = segment["start"]
        joiner = "" if self.lang in ("zh", "ja") else " "

        subtitles = []
        boundaries = list(split_points) + [len(words) - 1]
        start_idx = 0
        for b_idx, split_point in enumerate(boundaries):
            if start_idx > split_point:
                continue
            fragment = words[start_idx : split_point + 1]
            if not fragment:
                continue
            if isinstance(fragment[0], dict):
                start_time = fragment[0].get("start", elapsed)
                end_time = fragment[-1].get("end", start_time)
                nxt = (
                    words[split_point + 1].get("start")
                    if split_point + 1 < len(words)
                    and isinstance(words[split_point + 1], dict)
                    else next_start_time
                )
                if nxt is not None and 0 <= nxt - end_time <= 0.8:
                    end_time = nxt
                text = joiner.join(w["word"] for w in fragment)
            else:
                duration = (len(fragment) / total_words) * total_time
                start_time = elapsed
                end_time = elapsed + duration
                elapsed = end_time
                text = joiner.join(fragment).strip()
            subtitles.append(
                {"start": start_time, "end": end_time, "text": text}
            )
            start_idx = split_point + 1
        return subtitles

    def process_segments(self, advanced_splitting: bool = True) -> List[dict]:
        subtitles = []
        for i, segment in enumerate(self.segments):
            next_start = (
                self.segments[i + 1]["start"] if i + 1 < len(self.segments) else None
            )
            if advanced_splitting:
                points = self.determine_advanced_split_points(segment, next_start)
                subtitles.extend(
                    self.generate_subtitles_from_split_points(segment, points, next_start)
                )
            else:
                words = segment.get("words", [])
                for j, w in enumerate(words):
                    if "start" not in w or "end" not in w:
                        self.estimate_timestamp_for_word(words, j, next_start)
                subtitles.append(
                    {
                        "start": segment["start"],
                        "end": segment["end"],
                        "text": segment["text"],
                    }
                )
        return subtitles

    def save(self, filename: str = "subtitles.srt", advanced_splitting: bool = True) -> int:
        subtitles = self.process_segments(advanced_splitting)
        with open(filename, "w", encoding="utf-8") as f:
            if self.is_vtt:
                f.write("WEBVTT\n\n")
            for idx, sub in enumerate(subtitles, 1):
                start = format_timestamp(sub["start"], self.is_vtt)
                end = format_timestamp(sub["end"], self.is_vtt)
                f.write(f"{idx}\n{start} --> {end}\n{sub['text'].strip()}\n\n")
        return len(subtitles)
