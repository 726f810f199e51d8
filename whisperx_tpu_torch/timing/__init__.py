"""Word-level timestamps from the cross-attention of the alignment heads.

Counterpart of ``whisperx_tpu/timing/__init__.py`` (reference
``mlx_whisper.timing.add_word_timestamps``): a teacher-forced decoder pass
captures the pre-softmax cross-attention scores at the model's alignment
heads; a temperature-sharpened softmax over the live frames, a per-token
z-norm, a median filter (width 7) and the mean over heads give a token ×
frame matrix; DTW on its negation gives each token's frame, and tokens group
into words with punctuation merging and the duration-anomaly heuristics.

The capture (``_capture_cross_qk``) runs the encoder (the K1 kernel on a
CUDA device) and the decoder on the model's device, over groups of windows
(``WHISPERX_TPU_ALIGN_BATCH``, 8 by default); the decoder keeps only the
alignment heads' planes, layer by layer, and the next-token probabilities
are taken on the device, as in JAX. Where JAX then copies the selected
planes to the host, the port also normalises and filters them and averages
the heads on the device, and copies one [tokens, frames] matrix per window:
for large-v3's default heads (every head of the upper 16 layers) that is
320 times fewer bytes. DTW and the word grouping run on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import (
    HOP_LENGTH,
    SAMPLE_RATE,
    TOKENS_PER_SECOND,
)
from whisperx_tpu_torch.models.whisper.model import (
    KVCache,
    decoder_forward,
    encoder_forward,
    new_self_cache,
    precompute_cross_kv,
)
from whisperx_tpu_torch.timing.dtw import dtw, median_filter

MEDFILT_WIDTH = 7
QK_SCALE = 1.0
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def _teacher_forced_rows(tokenizer, text_token_lists: List[List[int]], device):
    """Right-padded [B, L] token matrix of sot_seq + notimestamps + text +
    eot rows (L bucketed to 32, as in JAX), plus each row's true length.
    Right padding is safe under causal attention."""
    prefix = [*tokenizer.sot_sequence, tokenizer.no_timestamps]
    rows = [prefix + list(tt) + [tokenizer.eot] for tt in text_token_lists]
    lengths = [len(r) for r in rows]
    lmax = -(-max(lengths) // 32) * 32
    toks = np.full((len(rows), lmax), tokenizer.eot, np.int64)
    for i, r in enumerate(rows):
        toks[i, : len(r)] = r
    return torch.from_numpy(toks).to(device), lengths


@torch.no_grad()
def _capture_cross_qk(model, tokens: torch.Tensor, mels: torch.Tensor, eot: int):
    """One teacher-forced pass over [B, L] tokens and [B, 3000, n_mels] mels;
    returns, on the model's device, (P(next token) [B, L-1] under the
    text-restricted softmax, the alignment heads' pre-softmax scores
    [A, B, L, 1500] f32)."""
    dims = model.dims
    b = tokens.shape[0]
    feats = encoder_forward(model.encoder, mels.to(model.dtype), dims.n_audio_head)
    ck, cv = precompute_cross_kv(model.decoder, feats, dims.n_text_head)
    cache = KVCache(*new_self_cache(model.decoder, b, dims.n_text_ctx, dims.n_text_head), ck, cv)
    logits, sel = decoder_forward(
        model.decoder, tokens, cache, 0, dims.n_text_head,
        capture_cross_qk=True, capture_heads=model.alignment_heads,
    )
    text_probs = torch.softmax(logits[:, :-1, :eot].float(), dim=-1)
    safe = tokens[:, 1:].clamp(0, eot - 1)
    probs = text_probs.gather(-1, safe[..., None])[..., 0]
    return probs, sel


def _alignment_from_capture(
    probs_row: torch.Tensor,
    cqk_row: torch.Tensor,
    text_tokens: List[int],
    num_frames: int,
    tokenizer,
    medfilt_width: int,
    qk_scale: float,
) -> List[WordTiming]:
    """One window: ``probs_row`` [T_row-1] and ``cqk_row`` [A, T_row, 1500],
    sliced to the row's true token length, → its words. The softmax over the
    live frames, the per-token z-norm, the median filter and the mean over
    heads run on the tensors' device; DTW and the grouping on the host."""
    sot_len = len(tokenizer.sot_sequence)
    text_token_probs = (
        probs_row[sot_len : sot_len + len(text_tokens)].cpu().numpy().tolist()
    )

    heads = cqk_row[:, :, : num_frames // 2].float()  # [A, T_row, frames]
    weights = torch.softmax(heads * qk_scale, dim=-1)  # over frames
    mean = weights.mean(dim=-2, keepdim=True)
    std = weights.std(dim=-2, keepdim=True, unbiased=False) + 1e-9
    weights = median_filter((weights - mean) / std, medfilt_width)
    matrix = weights.mean(dim=0)[sot_len:-1]  # rows of the text tokens + eot

    text_indices, time_indices = dtw(-matrix.cpu().numpy())

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot]
    )
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j])) if j > i else 0.0
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]
    return [
        WordTiming(word, tokens_, float(start), float(end), probability)
        for word, tokens_, start, end, probability in zip(
            words[:-1], word_tokens[:-1], start_times, end_times, word_probabilities
        )
    ]


def find_alignment(
    model,
    tokenizer,
    text_tokens: List[int],
    mel: torch.Tensor,
    num_frames: int,
    *,
    medfilt_width: int = MEDFILT_WIDTH,
    qk_scale: float = QK_SCALE,
) -> List[WordTiming]:
    """mel: [3000, n_mels], one window. Returns its words' timings."""
    if len(text_tokens) == 0:
        return []
    tokens, lengths = _teacher_forced_rows(tokenizer, [text_tokens], model.device)
    mel = torch.as_tensor(mel, device=model.device)
    probs, cqk = _capture_cross_qk(model, tokens, mel[None], tokenizer.eot)
    n = lengths[0]
    return _alignment_from_capture(
        probs[0, : n - 1], cqk[:, 0, :n], text_tokens, num_frames,
        tokenizer, medfilt_width, qk_scale,
    )


def find_alignment_batch(
    model,
    tokenizer,
    text_token_lists: List[List[int]],
    mels: torch.Tensor,
    num_frames_list: List[int],
    *,
    medfilt_width: int = MEDFILT_WIDTH,
    qk_scale: float = QK_SCALE,
) -> List[List[WordTiming]]:
    """Word timings of many 30 s windows (``mels`` [N, 3000, n_mels]), one
    teacher-forced pass per group of windows with text. The group size
    (``WHISPERX_TPU_ALIGN_BATCH``, default 8) bounds the capture's memory."""
    n = len(text_token_lists)
    results: List[List[WordTiming]] = [[] for _ in range(n)]
    live = [i for i in range(n) if len(text_token_lists[i]) > 0]
    if not live:
        return results
    group = max(1, int(os.environ.get("WHISPERX_TPU_ALIGN_BATCH", "8")))
    mels = torch.as_tensor(mels, device=model.device)
    for base in range(0, len(live), group):
        idxs = live[base : base + group]
        tokens, lengths = _teacher_forced_rows(
            tokenizer, [text_token_lists[i] for i in idxs], model.device
        )
        rows = mels[torch.as_tensor(idxs, device=mels.device)]
        probs, cqk = _capture_cross_qk(model, tokens, rows, tokenizer.eot)
        for j, i in enumerate(idxs):
            length = lengths[j]
            results[i] = _alignment_from_capture(
                probs[j, : length - 1], cqk[:, j, :length], text_token_lists[i],
                num_frames_list[i], tokenizer, medfilt_width, qk_scale,
            )
    return results


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str) -> None:
    """Attach leading/trailing punctuation to the neighbouring words, in
    place (whisper semantics)."""
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1

    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def _text_tokens(segment: dict, eot: int) -> List[int]:
    return [t for t in segment["tokens"] if t < eot]


def add_word_timestamps(
    *,
    segments: List[dict],
    model,
    tokenizer,
    mel: torch.Tensor,
    num_frames: int,
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
    last_speech_timestamp: float = 0.0,
) -> None:
    """Attach ``words`` lists to one window's segments, in place."""
    if len(segments) == 0:
        return
    per_segment = [_text_tokens(seg, tokenizer.eot) for seg in segments]
    text_tokens = [t for seg in per_segment for t in seg]
    alignment = find_alignment(model, tokenizer, text_tokens, mel, num_frames)
    _attach_word_timings(
        segments, per_segment, alignment, prepend_punctuations,
        append_punctuations, last_speech_timestamp,
    )


def add_word_timestamps_batched(
    *,
    chunk_segments: List[List[dict]],
    model,
    tokenizer,
    mels: torch.Tensor,
    num_frames_list: List[int],
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
) -> None:
    """The batched pipeline's word timing: one chunk is one 30 s window; the
    windows' captures are batched (``find_alignment_batch``), then each
    chunk's segments get their words on their own (chunks are separate VAD
    regions, so the last speech time does not carry across them)."""
    token_lists = [
        [t for seg in segs for t in _text_tokens(seg, tokenizer.eot)]
        for segs in chunk_segments
    ]
    alignments = find_alignment_batch(model, tokenizer, token_lists, mels, num_frames_list)
    for segs, alignment in zip(chunk_segments, alignments):
        if not segs:
            continue
        _attach_word_timings(
            segs,
            [_text_tokens(seg, tokenizer.eot) for seg in segs],
            alignment,
            prepend_punctuations,
            append_punctuations,
            # word times are absolute: the chunk's own start is the
            # no-previous-speech baseline
            min(seg["start"] for seg in segs),
        )


def _attach_word_timings(
    segments: List[dict],
    text_tokens_per_segment: Sequence[List[int]],
    alignment: List[WordTiming],
    prepend_punctuations: str,
    append_punctuations: str,
    last_speech_timestamp: float,
) -> None:
    word_durations = np.array([t.end - t.start for t in alignment if t.end > t.start])
    median_duration = float(np.median(word_durations)) if len(word_durations) > 0 else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    # truncate long words at sentence boundaries (hallucination guard)
    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif i > 0 and alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, seg_text_tokens in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(seg_text_tokens):
            timing = alignment[word_index]
            word_index += 1
            if timing.word:
                words.append(
                    {
                        "word": timing.word,
                        "start": round(time_offset + timing.start, 2),
                        "end": round(time_offset + timing.end, 2),
                        "probability": timing.probability,
                    }
                )
            saved_tokens += len(timing.tokens)

        # duration-anomaly fixes at segment edges (whisper heuristics)
        if len(words) > 0:
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                words[0]["end"] - words[0]["start"] > max_duration
                or (
                    len(words) > 1
                    and words[1]["end"] - words[0]["start"] > max_duration * 2
                )
            ):
                if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if (
                segment["start"] < words[0]["end"]
                and segment["start"] - 0.5 > words[0]["start"]
            ):
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if (
                segment["end"] > words[-1]["start"]
                and segment["end"] + 0.5 < words[-1]["end"]
            ):
                words[-1]["end"] = max(words[-1]["start"] + median_duration, segment["end"])
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words


__all__ = [
    "WordTiming",
    "add_word_timestamps",
    "add_word_timestamps_batched",
    "dtw",
    "find_alignment",
    "find_alignment_batch",
    "median_filter",
    "merge_punctuations",
]
