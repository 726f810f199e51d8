"""Transcript output writers: txt / srt / vtt / tsv / json / aud.

Behavioral parity with reference whisperx/utils.py:192-436 (same formats,
same subtitle line-breaking rules, speaker prefixes, ``<u>`` word
highlighting), re-implemented around a standalone block-builder generator.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterator, Optional, TextIO, Tuple

from whisperx_tpu_torch.utils.languages import LANGUAGES_WITHOUT_SPACES
from whisperx_tpu_torch.utils.text import format_timestamp


def _subtitle_blocks(result: dict, options: dict) -> Iterator[tuple]:
    """Group word timings into subtitle blocks honoring max_line_width /
    max_line_count / segment boundaries / >3 s pauses.

    Yields ``(words, (seg_start, seg_end, speaker))`` tuples where ``words``
    is a list of word-timing dicts whose "word" text already contains any
    embedded line breaks.
    """
    max_line_width = options.get("max_line_width")
    max_line_count = options.get("max_line_count")
    width = 1000 if max_line_width is None else max_line_width
    # When either constraint is unset, blocks follow ASR segment boundaries.
    preserve_segments = max_line_count is None or max_line_width is None

    segments = result["segments"]
    if not segments:
        return

    block: list = []
    block_times: list = []
    line_len = 0
    line_count = 1
    last_start = segments[0]["start"]

    for segment in segments:
        for i, timing in enumerate(segment["words"]):
            word = dict(timing)
            timed = "start" in word
            long_pause = (
                not preserve_segments and timed and word["start"] - last_start > 3.0
            )
            fits = line_len + len(word["word"]) <= width
            seg_break = i == 0 and block and preserve_segments

            if line_len > 0 and fits and not long_pause and not seg_break:
                line_len += len(word["word"])
            else:
                word["word"] = word["word"].strip()
                must_flush = (
                    block
                    and max_line_count is not None
                    and (long_pause or line_count >= max_line_count)
                ) or seg_break
                if must_flush:
                    yield block, block_times[0]
                    block, block_times = [], []
                    line_count = 1
                elif line_len > 0:
                    line_count += 1
                    word["word"] = "\n" + word["word"]
                line_len = len(word["word"].strip())

            block.append(word)
            block_times.append(
                (segment["start"], segment["end"], segment.get("speaker"))
            )
            if timed:
                last_start = word["start"]

    if block:
        yield block, block_times[0]


def iterate_subtitles(
    result: dict, options: dict, fmt_ts
) -> Iterator[Tuple[str, str, str]]:
    """Yield (start, end, text) subtitle entries, word-aware when possible."""
    segments = result["segments"]
    if not segments:
        return

    if segments and "words" in segments[0]:
        joiner = "" if result.get("language") in LANGUAGES_WITHOUT_SPACES else " "
        highlight = options.get("highlight_words", False)
        for block, (seg_start, seg_end, speaker) in _subtitle_blocks(result, options):
            text = joiner.join(w["word"] for w in block)
            prefix = f"[{speaker}]: " if speaker is not None else ""
            timed_words = [w for w in block if "start" in w]
            if highlight and timed_words:
                last = fmt_ts(seg_start)
                words = [w["word"] for w in block]
                for i, w in enumerate(block):
                    if "start" not in w:
                        continue
                    start, end = fmt_ts(w["start"]), fmt_ts(w["end"])
                    if last != start:
                        yield last, start, prefix + text
                    underlined = joiner.join(
                        re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word)
                        if j == i
                        else word
                        for j, word in enumerate(words)
                    )
                    yield start, end, prefix + underlined
                    last = end
            else:
                yield fmt_ts(seg_start), fmt_ts(seg_end), prefix + text
    else:
        for segment in segments:
            text = segment["text"].strip().replace("-->", "->")
            if "speaker" in segment:
                text = f"[{segment['speaker']}]: {text}"
            yield fmt_ts(segment["start"]), fmt_ts(segment["end"]), text


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, options: dict):
        base = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir, f"{base}.{self.extension}")
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options)

    def write_result(self, result: dict, file: TextIO, options: dict):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result, file, options):
        for segment in result["segments"]:
            text = segment["text"].strip()
            speaker = segment.get("speaker")
            line = f"[{speaker}]: {text}" if speaker is not None else text
            print(line, file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def _fmt(self, seconds: float) -> str:
        return format_timestamp(
            seconds, self.always_include_hours, self.decimal_marker
        )

    def entries(self, result, options):
        return iterate_subtitles(result, options, self._fmt)


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result, file, options):
        print("WEBVTT\n", file=file)
        for start, end, text in self.entries(result, options):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result, file, options):
        for i, (start, end, text) in enumerate(self.entries(result, options), 1):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """start/end in integer milliseconds + tab-separated text (locale-proof)."""

    extension = "tsv"

    def write_result(self, result, file, options):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            text = segment["text"].strip().replace("\t", " ")
            print(
                round(1000 * segment["start"]),
                round(1000 * segment["end"]),
                text,
                sep="\t",
                file=file,
                flush=True,
            )


class WriteAudacity(ResultWriter):
    """Audacity label track: seconds, tab-separated, no header."""

    extension = "aud"

    def write_result(self, result, file, options):
        for segment in result["segments"]:
            text = segment["text"].strip().replace("\t", " ")
            if "speaker" in segment:
                text = f"[[{segment['speaker']}]]{text}"
            print(segment["start"], segment["end"], text, sep="\t", file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result, file, options):
        json.dump(result, file, ensure_ascii=False)


class WriteRTTM(ResultWriter):
    """NIST RTTM speaker turns — the standard diarization interchange
    format (consumable by dscore / pyannote.metrics / tools/der_eval.py).
    One SPEAKER line per speaker-labelled segment; abutting same-speaker
    segments merge into one turn. Speakerless segments are skipped (RTTM
    carries who-spoke-when, not transcripts). No reference counterpart:
    its diarization labels only live inside the JSON output."""

    extension = "rttm"

    def __call__(self, result, audio_path, options):
        self._uri = os.path.splitext(os.path.basename(audio_path))[0]
        super().__call__(result, audio_path, options)

    def write_result(self, result, file, options):
        uri = getattr(self, "_uri", None) or "audio"
        turns = []
        for seg in result["segments"]:
            spk = seg.get("speaker")
            if spk is None:
                continue
            s, e = float(seg["start"]), float(seg["end"])
            if turns and turns[-1][2] == spk and s - turns[-1][1] < 1e-3:
                turns[-1] = (turns[-1][0], max(turns[-1][1], e), spk)
            else:
                turns.append((s, e, spk))
        for s, e, spk in turns:
            print(
                f"SPEAKER {uri} 1 {s:.3f} {e - s:.3f} <NA> <NA> {spk} <NA> <NA>",
                file=file,
                flush=True,
            )


WRITERS = {
    "txt": WriteTXT,
    "vtt": WriteVTT,
    "srt": WriteSRT,
    "tsv": WriteTSV,
    "json": WriteJSON,
}
OPTIONAL_WRITERS = {"aud": WriteAudacity, "rttm": WriteRTTM}


def get_writer(output_format: str, output_dir: str):
    if output_format == "all":
        all_writers = [cls(output_dir) for cls in WRITERS.values()]

        def write_all(result, audio_path, options):
            for writer in all_writers:
                writer(result, audio_path, options)

        return write_all
    if output_format in OPTIONAL_WRITERS:
        return OPTIONAL_WRITERS[output_format](output_dir)
    return WRITERS[output_format](output_dir)
