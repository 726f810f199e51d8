"""Whisper transcription: the 30 s seek loop with temperature fallback.

Counterpart of ``whisperx_tpu/decoding/transcribe.py``, with its semantics
(OpenAI Whisper's ``transcribe``):

  - one log-mel for the whole file, computed once on the model's device
    and sliced there per 30 s window; the window's tokens are read back once,
    by ``decode``;
  - the temperature-fallback ladder gated on compression ratio and average
    log-probability, where confident silence never climbs the ladder;
  - no-speech gating, ``condition_on_previous_text`` with the prompt reset
    at temperatures above 0.5;
  - timestamp-token parsing into sub-segments and seek advancement;
  - with ``word_timestamps``, DTW word timing of each window (``timing/``),
    the seek resumed at the last word's end, and with
    ``hallucination_silence_threshold`` the skip of anomalous segments
    conjured from silence (whisper's heuristics, through the anomaly helpers
    below).

Each window decodes at the options' ``kv_quant`` (off unless asked, as in
JAX): the seek loop's cross-KV stays in the model's dtype and never takes
the int8 cross-decode route (K3). Sampling at a temperature above 0 draws
from a ``torch.Generator`` seeded with ``seed`` at every decode, as JAX
starts every decode from ``PRNGKey(0)``; the two generators' numbers differ.

``hallucination_silence_threshold`` without word timestamps warns and is
ignored, as in JAX.

Returns ``{"text", "segments": [{id, seek, start, end, text, tokens,
temperature, avg_logprob, compression_ratio, no_speech_prob}], "language"}``.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from whisperx_tpu_torch.decoding.decode import DecodingOptions, DecodingResult, decode
from whisperx_tpu_torch.decoding.tokenizer import get_tokenizer
from whisperx_tpu_torch.utils.languages import normalize_language


def _decode_with_fallback(
    model, mel, options: DecodingOptions, temperatures, thresholds, seed: int = 0
) -> DecodingResult:
    compression_ratio_threshold, logprob_threshold, no_speech_threshold = thresholds
    result = None
    for t in temperatures:
        opts = DecodingOptions(
            **{
                **options.__dict__,
                "temperature": t,
                # beam/patience apply only at t==0; best_of only at t>0
                "beam_size": options.beam_size if t == 0 else None,
                "patience": options.patience if t == 0 else None,
                "best_of": options.best_of if t > 0 else None,
            }
        )
        generator = None
        if t > 0:
            generator = torch.Generator(device=mel.device).manual_seed(seed)
        result = decode(model, mel, opts, generator=generator)
        needs_fallback = False
        if (
            compression_ratio_threshold is not None
            and result.compression_ratio > compression_ratio_threshold
        ):
            needs_fallback = True
        if (
            logprob_threshold is not None
            and result.avg_logprob < logprob_threshold
        ):
            needs_fallback = True
        if (
            no_speech_threshold is not None
            and result.no_speech_prob > no_speech_threshold
        ):
            # confident silence is not a quality failure: don't climb the
            # temperature ladder re-decoding a silent window
            needs_fallback = False
        if not needs_fallback:
            break
    return result


def split_timestamp_segments(
    tokens: np.ndarray,
    *,
    timestamp_begin: int,
    segment_size: int,
    time_precision: float = 0.02,
    input_stride: int = 2,
):
    """Partition one window's decoded tokens into timestamped sub-segments.

    Pure arithmetic shared by the seek loop and the gold-replay parity tests
    (reference contract: the segment `tokens`/`start`/`end`/`seek` fields of
    the gold 30m.json artifact — every sub-segment spans
    [t_open … t_close] inclusive and times are (token - timestamp_begin) ×
    time_precision relative to the window start).

    Returns ``(segments, seek_advance, single_timestamp_ending)`` where
    ``segments`` is a list of ``(start, end, token_list)`` with times
    relative to the window start and ``seek_advance`` is in mel frames.
    """
    tokens = np.asarray(tokens)
    timestamp_tokens = tokens >= timestamp_begin
    single_timestamp_ending = (
        len(timestamp_tokens) >= 2
        and bool(timestamp_tokens[-1])
        and not bool(timestamp_tokens[-2])
    ) or (len(timestamp_tokens) == 1 and bool(timestamp_tokens[-1]))

    consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1
    segments = []
    if len(consecutive) > 0:
        slices = consecutive.tolist()
        if single_timestamp_ending:
            slices.append(len(tokens))
        last_slice = 0
        for current_slice in slices:
            sliced = tokens[last_slice:current_slice]
            start_pos = int(sliced[0]) - timestamp_begin
            end_pos = int(sliced[-1]) - timestamp_begin
            segments.append(
                (
                    start_pos * time_precision,
                    end_pos * time_precision,
                    sliced.tolist(),
                )
            )
            last_slice = current_slice
        if single_timestamp_ending:
            seek_advance = segment_size
        else:
            last_ts_pos = int(tokens[last_slice - 1]) - timestamp_begin
            seek_advance = last_ts_pos * input_stride
    else:
        duration = segment_size * (time_precision / input_stride)
        ts = tokens[timestamp_tokens]
        if len(ts) > 0 and int(ts[-1]) != timestamp_begin:
            duration = (int(ts[-1]) - timestamp_begin) * time_precision
        segments.append((0.0, duration, tokens.tolist()))
        seek_advance = segment_size
    return segments, seek_advance, single_timestamp_ending


def transcribe(
    model,
    audio: Union[str, np.ndarray],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    hallucination_silence_threshold: Optional[float] = None,
    language: Optional[str] = None,
    task: str = "transcribe",
    seed: int = 0,
    **decode_options,
) -> dict:
    if hallucination_silence_threshold is not None and not word_timestamps:
        warnings.warn(
            "hallucination_silence_threshold requires word_timestamps=True;"
            " ignoring it."
        )

    if isinstance(audio, str):
        from whisperx_tpu_torch.audio import load_audio

        audio = load_audio(audio)
    audio = np.asarray(audio, np.float32)

    # [n_mels, frames] on the model's device, padded by 30 s of silence
    mel_full = log_mel_spectrogram(
        audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device
    )
    content_frames = mel_full.shape[-1] - N_FRAMES
    content_duration = content_frames * HOP_LENGTH / SAMPLE_RATE

    language = normalize_language(language)
    if language is None:
        if not model.is_multilingual:
            language = "en"
        else:
            from whisperx_tpu_torch.decoding.decode import detect_language

            tok0 = get_tokenizer(
                True, num_languages=model.num_languages, vocab_path=model.vocab_path
            )
            head = pad_or_trim(mel_full[:, :N_FRAMES].T[None], N_FRAMES, axis=1)
            codes, _ = detect_language(model, head, tok0)
            language = codes[0]
            if verbose:
                print(f"Detected language: {language}")

    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task=task,
        vocab_path=model.vocab_path,
    )

    if isinstance(temperature, (int, float)):
        temperatures = [float(temperature)]
    else:
        temperatures = list(temperature)

    time_precision = 0.02
    input_stride = 2  # mel frames per audio token
    time_per_frame = HOP_LENGTH / SAMPLE_RATE

    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0
    if initial_prompt is not None:
        initial_prompt_tokens = (
            list(initial_prompt)
            if isinstance(initial_prompt, (list, tuple))
            else tokenizer.encode(" " + initial_prompt.strip())
        )
        all_tokens.extend(initial_prompt_tokens)

    seek = 0
    last_speech_timestamp = 0.0

    def new_segment(start, end, tokens, result: DecodingResult):
        tokens = [t for t in tokens]
        text_tokens = [t for t in tokens if t < tokenizer.eot]
        return {
            "seek": seek,
            "start": start,
            "end": end,
            "text": tokenizer.decode(text_tokens),
            "tokens": tokens,
            "temperature": result.temperature,
            "avg_logprob": result.avg_logprob,
            "compression_ratio": result.compression_ratio,
            "no_speech_prob": result.no_speech_prob,
        }

    base_opts = {
        k: v
        for k, v in decode_options.items()
        if k in DecodingOptions.__dataclass_fields__
        and k not in ("temperature", "prompt", "language", "task")
    }

    while seek < content_frames:
        time_offset = seek * time_per_frame
        segment_size = min(N_FRAMES, content_frames - seek)
        # the window, cut and padded on the device: [N_FRAMES, n_mels]
        mel_in = pad_or_trim(mel_full[:, seek : seek + N_FRAMES], N_FRAMES, axis=-1).T

        # prompt_reset_since already sits past the initial prompt when
        # conditioning is off, so the upstream slice covers every case
        prompt = all_tokens[prompt_reset_since:]
        options = DecodingOptions(
            task=task,
            language=language,
            prompt=list(prompt) if prompt else None,
            **base_opts,
        )
        result = _decode_with_fallback(
            model,
            mel_in,
            options,
            temperatures,
            (compression_ratio_threshold, logprob_threshold, no_speech_threshold),
            seed=seed,
        )
        tokens = np.asarray(result.tokens)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if (
                logprob_threshold is not None
                and result.avg_logprob > logprob_threshold
            ):
                # confident text despite no_speech: don't skip
                should_skip = False
            if should_skip:
                seek += segment_size
                continue

        previous_seek = seek
        raw_segments, seek_advance, single_timestamp_ending = split_timestamp_segments(
            tokens,
            timestamp_begin=tokenizer.timestamp_begin,
            segment_size=segment_size,
            time_precision=time_precision,
            input_stride=input_stride,
        )
        current_segments = [
            new_segment(time_offset + s, time_offset + e, toks, result)
            for s, e, toks in raw_segments
        ]
        seek += seek_advance

        if word_timestamps:
            from whisperx_tpu_torch.timing import add_word_timestamps

            # the PREVIOUS window's last speech is the gap baseline of both
            # word timing and the hallucination filter
            prev_speech_timestamp = last_speech_timestamp
            add_word_timestamps(
                segments=current_segments,
                model=model,
                tokenizer=tokenizer,
                mel=mel_in,
                num_frames=segment_size,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=prev_speech_timestamp,
            )

            # word ends are finer than timestamp tokens: when the window ends
            # mid-segment, resume exactly where speech stopped
            if not single_timestamp_ending:
                last_word_end = _last_word_end(current_segments)
                if last_word_end is not None and last_word_end > time_offset:
                    seek = round(last_word_end * FRAMES_PER_SECOND)

            if hallucination_silence_threshold is not None:
                threshold = hallucination_silence_threshold
                window_end_time = (previous_seek + N_FRAMES) * time_per_frame
                segment_duration = segment_size * time_per_frame

                # a trailing unconsumed region longer than the threshold is
                # silence worth re-seeking into; shorter, the window is spent
                if not single_timestamp_ending:
                    last_word_end = _last_word_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        remaining = window_end_time - last_word_end
                        if remaining > threshold:
                            seek = round(last_word_end * FRAMES_PER_SECOND)
                        else:
                            seek = previous_seek + segment_size

                # an anomalous FIRST segment after a long leading gap is a
                # hallucination conjured from silence: skip the gap and
                # re-decode from where it claimed to start
                first_segment = _next_words_segment(current_segments)
                if first_segment is not None and _is_segment_anomaly(first_segment):
                    gap = first_segment["start"] - time_offset
                    if gap > threshold:
                        seek = previous_seek + round(gap * FRAMES_PER_SECOND)
                        continue

                # evict an anomalous segment surrounded by silence (or by more
                # anomalies) and all after it, then re-seek to just before it,
                # at least 1 s further on
                kept, evicted = evict_surrounded_anomalies(
                    current_segments,
                    threshold=threshold,
                    time_offset=time_offset,
                    window_end_time=window_end_time,
                    segment_duration=segment_duration,
                    last_speech_timestamp=prev_speech_timestamp,
                )
                if evicted is not None:
                    seek = round(max(time_offset + 1, evicted["start"]) * FRAMES_PER_SECOND)
                    if content_duration - evicted["end"] < threshold:
                        seek = content_frames
                    current_segments = kept

            # the speech baseline advances from the surviving segments only
            last_word_end = _last_word_end(current_segments)
            if last_word_end is not None:
                last_speech_timestamp = last_word_end

        if verbose:
            for segment in current_segments:
                print(
                    f"[{segment['start']:.2f} --> {segment['end']:.2f}] "
                    f"{segment['text']}"
                )

        for segment in current_segments:
            if segment["start"] == segment["end"] or not segment["text"].strip():
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []
        all_segments.extend(
            {"id": i, **seg}
            for i, seg in enumerate(current_segments, start=len(all_segments))
        )
        all_tokens.extend(
            t for seg in current_segments for t in seg["tokens"] if t < tokenizer.eot
        )
        if not condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)

    all_segments = [s for s in all_segments if s["text"]]
    for i, seg in enumerate(all_segments):  # keep ids contiguous post-filter
        seg["id"] = i
    return {
        "text": "".join(s["text"] for s in all_segments),
        "segments": all_segments,
        "language": language,
    }


# punctuation-only "words" carry no timing evidence for anomaly scoring
_ANOMALY_PUNCTUATION = "\"'“¿([{-" + "\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: dict) -> float:
    """How implausible one word's (probability, duration) pair is.

    Whisper's hallucination heuristic: low-confidence words, impossibly
    fast words (<133 ms) and implausibly slow ones (>2 s) each add to the
    score; a segment of such words is a hallucination candidate.
    """
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment.get("words"):
        return False
    words = [
        w for w in segment["words"] if w["word"] not in _ANOMALY_PUNCTUATION
    ][:8]
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _next_words_segment(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s.get("words")), None)


def evict_surrounded_anomalies(
    segments: List[dict],
    *,
    threshold: float,
    time_offset: float,
    window_end_time: float,
    segment_duration: float,
    last_speech_timestamp: float,
    keep_tail: bool = False,
):
    """Drop anomalous segments that are surrounded by silence (or by more
    anomalies).

    Shared between the seek loop and the batched pipeline, whose recovery
    abilities differ: the seek loop re-seeks to the evicted segment's
    start and re-decodes everything after it, so the tail is dropped here
    (``keep_tail=False``, upstream semantics); the batched pipeline's
    VAD-bounded chunks have nothing to re-seek into, so it must keep the
    already-decoded tail (``keep_tail=True``) and only the surrounded
    anomalies themselves are removed — the scan continues past each one.
    Returns ``(kept_segments, first_evicted_segment_or_None)``.
    """
    hal_last_end = last_speech_timestamp
    drop: set = set()
    first_evicted = None
    for si, segment in enumerate(segments):
        if not segment.get("words"):
            continue
        if _is_segment_anomaly(segment):
            next_segment = _next_words_segment(segments[si + 1 :])
            if next_segment is not None:
                hal_next_start = next_segment["words"][0]["start"]
            else:
                hal_next_start = time_offset + segment_duration
            silence_before = (
                segment["start"] - hal_last_end > threshold
                or segment["start"] < threshold
                or segment["start"] - time_offset < 2.0
            )
            silence_after = (
                hal_next_start - segment["end"] > threshold
                or _is_segment_anomaly(next_segment)
                or window_end_time - segment["end"] < 2.0
            )
            if silence_before and silence_after:
                if not keep_tail:
                    return segments[:si], segment
                drop.add(si)
                if first_evicted is None:
                    first_evicted = segment
                # an evicted hallucination is not speech: the silence
                # baseline for the NEXT candidate must not advance past it
                continue
        hal_last_end = segment["end"]
    if drop:
        return [s for i, s in enumerate(segments) if i not in drop], first_evicted
    return segments, None


def _last_word_end(segments: List[dict]) -> Optional[float]:
    """End time of the last word across segments (whisper's get_end)."""
    return next(
        (
            w["end"]
            for s in reversed(segments)
            for w in reversed(s.get("words", []))
        ),
        None,
    )
