"""Timestamp segmentation of one decoded window.

Only ``split_timestamp_segments`` of ``whisperx_tpu/decoding/transcribe.py``
is ported so far; the sequential seek loop comes with the decode variants
(ROADMAP.md, Queue 1, item 8).
"""

from __future__ import annotations

import numpy as np


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
