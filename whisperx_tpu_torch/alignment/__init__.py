"""Forced alignment: wav2vec2 CTC emissions → trellis DP → word timestamps.

Counterpart of ``whisperx_tpu/alignment/__init__.py`` (reference
whisperx/alignment.py:113-380): character cleaning with wildcards, Punkt
sentence spans (a regex split without nltk), the beam backtrack, char →
word → sentence aggregation with NaN interpolation. The emissions of every
alignable segment run batched on the aligner's device, one forward pass per
length bucket; the trellis and the backtrack run on the host.

``WHISPERX_TPU_ALLOW_RANDOM_ALIGN`` unset: a random-weight aligner returns
the transcript unaligned (empty ``words``), as in the JAX package.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Iterable, List, Union

import numpy as np

from whisperx_tpu_torch.alignment.aligner import (
    DEFAULT_ALIGN_MODELS_HF,
    DEFAULT_ALIGN_MODELS_TORCH,
    DEFAULT_EN_VOCAB,
    Wav2Vec2Aligner,
    load_align_model,
)
from whisperx_tpu_torch.alignment.trellis import (
    backtrack,
    backtrack_beam,
    get_trellis,
    merge_repeats,
)
from whisperx_tpu_torch.audio import SAMPLE_RATE
from whisperx_tpu_torch.types import (
    AlignedTranscriptionResult,
    SingleAlignedSegment,
    SingleSegment,
    SingleWordSegment,
)

PUNKT_ABBREVIATIONS = ["dr", "vs", "mr", "mrs", "prof"]
LANGUAGES_WITHOUT_SPACES = ["ja", "zh"]


def _sentence_spans(text: str) -> List[tuple]:
    """Punkt sentence spans with the reference's abbreviation set
    (alignment.py:191-194); regex fallback if nltk is unavailable."""
    try:
        from nltk.tokenize.punkt import PunktParameters, PunktSentenceTokenizer

        punkt_param = PunktParameters()
        punkt_param.abbrev_types = set(PUNKT_ABBREVIATIONS)
        splitter = PunktSentenceTokenizer(punkt_param)
        return list(splitter.span_tokenize(text))
    except Exception:
        spans, start = [], None
        for m in re.finditer(r"[^\s]", text):
            if start is None:
                start = m.start()
            if text[m.start()] in ".!?":
                spans.append((start, m.end()))
                start = None
        if start is not None:
            spans.append((start, len(text)))
        return spans or [(0, len(text))]


def _interpolate_nans(values: List[float], method: str) -> List[float]:
    """Equivalent of pandas Series.interpolate(method).ffill().bfill() for
    method in {nearest, linear, ignore} (reference utils.interpolate_nans)."""
    arr = np.asarray(
        [np.nan if v is None else v for v in values], np.float64
    )
    valid = np.where(~np.isnan(arr))[0]
    if len(valid) == 0:
        return [np.nan] * len(arr)
    if len(valid) == 1 or method == "ignore":
        # ffill then bfill
        out = arr.copy()
        last = np.nan
        for i in range(len(out)):
            if np.isnan(out[i]):
                out[i] = last
            else:
                last = out[i]
        nxt = np.nan
        for i in range(len(out) - 1, -1, -1):
            if np.isnan(out[i]):
                out[i] = nxt
            else:
                nxt = out[i]
        return out.tolist()
    idx = np.arange(len(arr))
    if method == "linear":
        filled = np.interp(idx, valid, arr[valid])
    else:  # nearest
        pos = np.searchsorted(valid, idx)
        pos = np.clip(pos, 0, len(valid) - 1)
        left = valid[np.clip(pos - 1, 0, len(valid) - 1)]
        right = valid[pos]
        nearest = np.where(np.abs(idx - left) <= np.abs(right - idx), left, right)
        filled = arr[nearest]
    return filled.tolist()


def align(
    transcript: Iterable[SingleSegment],
    model: Wav2Vec2Aligner,
    align_model_metadata: dict,
    audio: Union[str, np.ndarray],
    device: str = "cuda",
    interpolate_method: str = "nearest",
    return_char_alignments: bool = False,
    print_progress: bool = False,
    combined_progress: bool = False,
) -> AlignedTranscriptionResult:
    """Align transcript segments to audio at word level.

    API and behavior parity: reference alignment.py:113-380. ``device`` is
    accepted for the reference's signature; the aligner's own device runs
    the emissions."""
    transcript = list(transcript)
    if align_model_metadata.get("random_weights") and not os.environ.get(
        "WHISPERX_TPU_ALLOW_RANDOM_ALIGN"
    ):
        # The guard lives HERE so every entry point (the CLI, library
        # callers, per-language reloads) refuses random-weight timings —
        # garbage word times are worse than none.
        warnings.warn(
            "Skipping alignment: the wav2vec2 model has RANDOM weights "
            f"(no converted checkpoint for {align_model_metadata.get('language')!r}). "
            "Convert one with python -m whisperx_tpu_torch.convert wav2vec2, or set "
            "WHISPERX_TPU_ALLOW_RANDOM_ALIGN=1 to force."
        )
        return {
            "segments": [dict(seg, words=[]) for seg in transcript],
            "word_segments": [],
        }
    if isinstance(audio, str):
        from whisperx_tpu_torch.audio import load_audio

        audio = load_audio(audio)
    audio = np.asarray(audio, np.float32).reshape(-1)
    max_duration = len(audio) / SAMPLE_RATE

    model_dictionary = align_model_metadata["dictionary"]
    model_lang = align_model_metadata["language"]
    total_segments = len(transcript)

    # 1. preprocess: keep only characters present in the model dictionary
    seg_meta = {}
    for seg_i, segment in enumerate(transcript):
        if print_progress:
            pct_raw = ((seg_i + 1) / total_segments) * 100
            pct = (50 + pct_raw / 2) if combined_progress else pct_raw
            print(f"Progress: {pct:.2f}%...")

        text = segment["text"]
        lead_ws = len(text) - len(text.lstrip())
        trail_ws = len(text) - len(text.rstrip())

        kept_chars, kept_idx = [], []
        for ch_i, char in enumerate(text):
            char_ = char.lower()
            if model_lang not in LANGUAGES_WITHOUT_SPACES:
                char_ = char_.replace(" ", "|")
            if ch_i < lead_ws or ch_i > len(text) - trail_ws - 1:
                continue
            if char_ in model_dictionary:
                kept_chars.append(char_)
                kept_idx.append(ch_i)
            else:
                kept_chars.append("*")  # wildcard placeholder
                kept_idx.append(ch_i)

        seg_meta[seg_i] = {
            "clean_char": kept_chars,
            "clean_cdx": kept_idx,
            "sentence_spans": _sentence_spans(text),
        }

    aligned_segments: List[SingleAlignedSegment] = []

    # 2a. batched CTC emissions: one device call per length bucket for all
    # alignable segments (the reference looped segments; alignment.py:237)
    wave_slices = {}
    for seg_i, segment in enumerate(transcript):
        if (
            len(seg_meta[seg_i]["clean_char"]) == 0
            or segment["start"] >= max_duration
        ):
            continue
        f1 = int(segment["start"] * SAMPLE_RATE)
        f2 = int(segment["end"] * SAMPLE_RATE)
        w = audio[f1:f2]
        if len(w) < 400:
            w = np.pad(w, (0, 400 - len(w)))
        wave_slices[seg_i] = w
    emission_cache = {}
    if wave_slices and hasattr(model, "emissions_batch"):
        keys = list(wave_slices)
        for k, em in zip(keys, model.emissions_batch([wave_slices[k] for k in keys])):
            emission_cache[k] = em

    # 2b. trellis + backtrack per segment
    for seg_i, segment in enumerate(transcript):
        t1, t2, text = segment["start"], segment["end"], segment["text"]
        aligned_seg: SingleAlignedSegment = {
            "start": t1,
            "end": t2,
            "text": text,
            "words": [],
            "chars": [] if return_char_alignments else None,
        }

        if len(seg_meta[seg_i]["clean_char"]) == 0:
            print(
                f'Cannot align "{text}" — none of its characters are in the '
                "aligner vocabulary; keeping the original timestamps."
            )
            aligned_segments.append(aligned_seg)
            continue
        if t1 >= max_duration:
            print(
                f'Cannot align "{text}" — it starts past the end of the '
                "audio; keeping the original timestamps."
            )
            aligned_segments.append(aligned_seg)
            continue

        matchable_text = "".join(seg_meta[seg_i]["clean_char"])
        tokens = [model_dictionary.get(c, -1) for c in matchable_text]

        if seg_i in emission_cache:
            emission = emission_cache[seg_i]
        else:
            emission = model.emissions(wave_slices[seg_i])[0]
        blank_id = model.blank_id if hasattr(model, "blank_id") else 0
        for char, code in model_dictionary.items():
            if char in ("[pad]", "<pad>"):
                blank_id = code

        trellis = get_trellis(emission, tokens, blank_id)
        path = backtrack_beam(trellis, emission, tokens, blank_id, beam_width=2)
        if path is None:
            print(
                f'Cannot align "{text}" — CTC backtracking found no path; '
                "keeping the original timestamps."
            )
            aligned_segments.append(aligned_seg)
            continue

        char_spans = merge_repeats(path, matchable_text)
        duration = t2 - t1
        # a sub-25 ms segment can yield a single-frame trellis; avoid /0
        ratio = duration / max(trellis.shape[0] - 1, 1)

        # 3. char-level timestamps, tracked per original character index
        kept_idx = seg_meta[seg_i]["clean_cdx"]
        span_by_char = dict(zip(kept_idx, char_spans))  # O(1) lookups
        char_rows = []
        word_i = 0
        for ch_i, char in enumerate(text):
            start = end = score = None
            if ch_i in span_by_char:
                cs = span_by_char[ch_i]
                start = round(cs.start * ratio + t1, 3)
                end = round(cs.end * ratio + t1, 3)
                score = round(cs.score, 3)
            char_rows.append(
                {
                    "char": char,
                    "start": start,
                    "end": end,
                    "score": score,
                    "word_i": word_i,
                }
            )
            if model_lang in LANGUAGES_WITHOUT_SPACES:
                word_i += 1
            elif ch_i == len(text) - 1 or text[ch_i + 1] == " ":
                word_i += 1

        # 4. per-sentence aggregation
        sub_rows = []
        for s_start, s_end in seg_meta[seg_i]["sentence_spans"]:
            curr = [
                (i, r) for i, r in enumerate(char_rows) if s_start <= i <= s_end
            ]
            if not curr:
                continue
            rows = [r for _, r in curr]
            starts = [r["start"] for r in rows if r["start"] is not None]
            ends = [
                r["end"]
                for r in rows
                if r["end"] is not None and r["char"] != " "
            ]
            sentence_start = min(starts) if starts else None
            sentence_end = max(ends) if ends else None
            sentence_text = text[s_start:s_end]

            sentence_words: List[SingleWordSegment] = []
            seen = []
            for r in rows:
                if r["word_i"] not in seen:
                    seen.append(r["word_i"])
            for widx in seen:
                wchars = [r for r in rows if r["word_i"] == widx]
                word_text = "".join(r["char"] for r in wchars).strip()
                if not word_text:
                    continue
                wchars = [r for r in wchars if r["char"] != " "]
                wstarts = [r["start"] for r in wchars if r["start"] is not None]
                wends = [r["end"] for r in wchars if r["end"] is not None]
                wscores = [r["score"] for r in wchars if r["score"] is not None]
                word_segment = {"word": word_text}
                if wstarts:
                    word_segment["start"] = min(wstarts)
                if wends:
                    word_segment["end"] = max(wends)
                if wscores:
                    word_segment["score"] = round(float(np.mean(wscores)), 3)
                sentence_words.append(word_segment)

            sub = {
                "text": sentence_text,
                "start": sentence_start,
                "end": sentence_end,
                "words": sentence_words,
            }
            if return_char_alignments:
                sub["chars"] = [
                    {
                        k: v
                        for k, v in r.items()
                        if k in ("char", "start", "end", "score") and v is not None
                    }
                    for r in rows
                ]
            sub_rows.append(sub)

        # 5. NaN interpolation + merge sentences sharing timestamps
        if sub_rows:
            starts = _interpolate_nans([r["start"] for r in sub_rows], interpolate_method)
            ends = _interpolate_nans([r["end"] for r in sub_rows], interpolate_method)
            for r, s, e in zip(sub_rows, starts, ends):
                r["start"], r["end"] = s, e

            merged: List[dict] = []
            joiner = "" if model_lang in LANGUAGES_WITHOUT_SPACES else " "
            by_key = {}
            def _bad(v):
                return v is None or (isinstance(v, float) and np.isnan(v))

            for r in sub_rows:
                if _bad(r["start"]) or _bad(r["end"]):
                    continue  # pandas groupby drops rows with ANY NaN key
                key = (r["start"], r["end"])
                if key in by_key:
                    g = by_key[key]
                    g["text"] = g["text"] + joiner + r["text"]
                    g["words"] = g["words"] + r["words"]
                    if return_char_alignments:
                        g["chars"] = g["chars"] + r["chars"]
                else:
                    by_key[key] = dict(r)
            merged = [by_key[k] for k in sorted(by_key)]
            aligned_segments.extend(merged)

    word_segments: List[SingleWordSegment] = []
    for segment in aligned_segments:
        word_segments += segment["words"]

    return {"segments": aligned_segments, "word_segments": word_segments}


__all__ = [
    "align",
    "load_align_model",
    "Wav2Vec2Aligner",
    "DEFAULT_ALIGN_MODELS_HF",
    "DEFAULT_ALIGN_MODELS_TORCH",
    "DEFAULT_EN_VOCAB",
    "backtrack",
    "backtrack_beam",
    "get_trellis",
    "merge_repeats",
]
