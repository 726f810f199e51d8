"""CTC trellis forced alignment: the forward DP and the backtracks, on the
host.

Counterpart of ``whisperx_tpu/alignment/trellis.py`` (reference
alignment.py:387-613: ``get_trellis`` with wildcard emissions, the greedy
backtrack, the width-limited beam backtrack, ``merge_repeats``). Every
segment has its own (frames, tokens) shape and the DP takes milliseconds in
numpy, so it runs on the host, as the JAX package's default path does. The
JAX package's ``use_jax=True`` scan has no counterpart: ``get_trellis``
takes no such argument (passing it raises ``TypeError``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

NEG_INF = float("-inf")


@dataclass
class Point:
    token_index: int
    time_index: int
    score: float


@dataclass
class CharSegment:
    label: str
    start: int
    end: int
    score: float

    @property
    def length(self) -> int:
        return self.end - self.start


def wildcard_token_scores(
    emission: np.ndarray, tokens: np.ndarray, blank_id: int = 0
) -> np.ndarray:
    """Per-frame emission scores of each token; a wildcard (-1) takes the
    best non-blank score (reference get_wildcard_emission,
    alignment.py:407-437). emission: [T, V] → [T, N]."""
    tokens = np.asarray(tokens, dtype=np.int64)  # int64 even when empty
    safe = np.clip(tokens, 0, None)
    scores = emission[:, safe]
    masked = emission.copy()
    masked[:, blank_id] = NEG_INF
    max_valid = masked.max(axis=1)
    return np.where(tokens[None, :] == -1, max_valid[:, None], scores)


def get_trellis(emission: np.ndarray, tokens: List[int], blank_id: int = 0) -> np.ndarray:
    """Trellis [T, N] of reference alignment.py:387-404, including the +inf
    tail of column 0 that forces the path to finish every token."""
    emission = np.asarray(emission, np.float32)
    tokens = list(tokens)
    num_frames = emission.shape[0]
    num_tokens = len(tokens)
    blank = emission[:, blank_id]
    # column 0: the cumulative blank score, with the reference's +inf tail
    # installed BEFORE the DP (alignment.py:392-394)
    col0 = np.concatenate([[0.0], np.cumsum(blank[1:])]).astype(np.float32)
    col0[num_frames - num_tokens + 1 :] = np.float32(np.inf)
    tok_scores = wildcard_token_scores(emission, np.asarray(tokens[1:]), blank_id)

    trellis = np.empty((num_frames, num_tokens), np.float32)
    trellis[:, 0] = col0
    trellis[0, 1:] = NEG_INF
    row = trellis[0]
    for t in range(num_frames - 1):
        new = np.empty(num_tokens, np.float32)
        new[0] = col0[t + 1]
        np.maximum(row[1:] + blank[t], row[:-1] + tok_scores[t], out=new[1:])
        trellis[t + 1] = new
        row = new
    return trellis


def _token_frame_score(emission: np.ndarray, t: int, token: int, blank_id: int) -> float:
    if token == -1:
        masked = emission[t].copy()
        masked[blank_id] = NEG_INF
        return float(masked.max())
    return float(emission[t, token])


def backtrack(
    trellis: np.ndarray, emission: np.ndarray, tokens: List[int], blank_id: int = 0
) -> Optional[List[Point]]:
    """Greedy backtrack (reference alignment.py:447-481)."""
    t, j = trellis.shape[0] - 1, trellis.shape[1] - 1
    path = [Point(j, t, float(np.exp(emission[t, blank_id])))]
    while j > 0:
        assert t > 0
        p_stay = float(emission[t - 1, blank_id])
        p_change = _token_frame_score(emission, t - 1, tokens[j], blank_id)
        stayed = trellis[t - 1, j] + p_stay
        changed = trellis[t - 1, j - 1] + p_change
        t -= 1
        if changed > stayed:
            j -= 1
        prob = math.exp(p_change if changed > stayed else p_stay)
        path.append(Point(j, t, prob))
    while t > 0:
        prob = float(np.exp(emission[t - 1, blank_id]))
        path.append(Point(j, t - 1, prob))
        t -= 1
    return path[::-1]


@dataclass
class _BeamState:
    token_index: int
    time_index: int
    score: float
    path: List[Point]


def backtrack_beam(
    trellis: np.ndarray,
    emission: np.ndarray,
    tokens: List[int],
    blank_id: int = 0,
    beam_width: int = 2,
) -> Optional[List[Point]]:
    """Width-limited beam backtrack (reference alignment.py:500-579)."""
    t_max, j_max = trellis.shape[0] - 1, trellis.shape[1] - 1
    beams = [
        _BeamState(
            j_max, t_max, float(trellis[t_max, j_max]),
            [Point(j_max, t_max, float(np.exp(emission[t_max, blank_id])))],
        )
    ]

    while beams and beams[0].token_index > 0:
        next_beams = []
        for beam in beams:
            t, j = beam.time_index, beam.token_index
            if t <= 0:
                continue
            p_stay = float(emission[t - 1, blank_id])
            p_change = _token_frame_score(emission, t - 1, tokens[j], blank_id)
            stay_score = float(trellis[t - 1, j])
            change_score = float(trellis[t - 1, j - 1]) if j > 0 else NEG_INF

            if not math.isinf(stay_score):
                next_beams.append(
                    _BeamState(
                        j, t - 1, stay_score,
                        beam.path + [Point(j, t - 1, math.exp(p_stay))],
                    )
                )
            if j > 0 and not math.isinf(change_score):
                next_beams.append(
                    _BeamState(
                        j - 1, t - 1, change_score,
                        beam.path + [Point(j - 1, t - 1, math.exp(p_change))],
                    )
                )
        beams = sorted(next_beams, key=lambda b: b.score, reverse=True)[:beam_width]
        if not beams:
            break

    if not beams:
        return None
    best = beams[0]
    t, j = best.time_index, best.token_index
    while t > 0:
        best.path.append(Point(j, t - 1, float(np.exp(emission[t - 1, blank_id]))))
        t -= 1
    return best.path[::-1]


def merge_repeats(path: List[Point], transcript: str) -> List[CharSegment]:
    """Collapse repeated token frames to char segments (reference
    alignment.py:597-613)."""
    i1, i2 = 0, 0
    segments = []
    while i1 < len(path):
        while i2 < len(path) and path[i1].token_index == path[i2].token_index:
            i2 += 1
        score = sum(path[k].score for k in range(i1, i2)) / (i2 - i1)
        segments.append(
            CharSegment(
                transcript[path[i1].token_index],
                path[i1].time_index,
                path[i2 - 1].time_index + 1,
                score,
            )
        )
        i1 = i2
    return segments
