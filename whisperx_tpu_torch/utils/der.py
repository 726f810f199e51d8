"""Diarization error rate (DER) + RTTM interchange.

Counterpart of ``whisperx_tpu/utils/der.py``, kept as its own copy. No
reference counterpart: sooth/whisperx-mlx ships diarization
(whisperx/diarize.py) but no way to score it. This module completes the
accuracy-measurement story for the diarization subsystem the same way
``utils/wer.py`` does for ASR: NIST md-eval semantics —

    DER = (missed speech + false alarm + speaker confusion) / total ref speech

scored over a piecewise-constant timeline with a ±collar exclusion around
every REFERENCE turn boundary, overlap regions included (``skip_overlap=True``
drops intervals where the reference has >1 concurrent speaker, md-eval's
other standard mode). Speaker labels are matched by a one-to-one mapping
maximizing total attributed time (Hungarian when scipy is present,
exhaustive permutation for ≤8 speakers, greedy beyond).

Turn lists accept (start, end, speaker) tuples, ``{"start","end","speaker"}``
dicts (the rows of the ``TurnTable`` that ``DiarizationPipeline`` returns),
or a DataFrame. RTTM helpers
round-trip the standard SPEAKER-line exchange format.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

Turn = Tuple[float, float, str]


def _as_turns(turns) -> List[Turn]:
    """Normalize tuples / dicts / a diarization DataFrame to [(s, e, spk)]."""
    if hasattr(turns, "itertuples") and hasattr(turns, "columns"):  # DataFrame
        return [
            (float(r.start), float(r.end), str(r.speaker))
            for r in turns.itertuples()
        ]
    out: List[Turn] = []
    for t in turns:
        if isinstance(t, dict):
            out.append((float(t["start"]), float(t["end"]), str(t["speaker"])))
        else:
            s, e, spk = t
            out.append((float(s), float(e), str(spk)))
    return [(s, e, spk) for s, e, spk in out if e > s]


def _active_at(turns: List[Turn], lo: float, hi: float) -> List[str]:
    """Speakers active over the whole elementary interval [lo, hi) —
    boundaries are breakpoints, so activity is constant inside."""
    mid = 0.5 * (lo + hi)
    return [spk for s, e, spk in turns if s <= mid < e]


def _scored_intervals(
    ref: List[Turn], hyp: List[Turn], collar: float, skip_overlap: bool
) -> List[Tuple[float, float]]:
    """Elementary intervals to score: timeline breakpoints from both turn
    sets, minus the ±collar zones around reference boundaries (and minus
    ref-overlap regions when skip_overlap)."""
    points = set()
    for s, e, _ in ref + hyp:
        points.update((s, e))
    # collar exclusion zones are part of the breakpoint structure too
    zones = []
    if collar > 0:
        for s, e, _ in ref:
            zones.append((s - collar, s + collar))
            zones.append((e - collar, e + collar))
        for a, b in zones:
            points.update((a, b))
    pts = sorted(points)
    out = []
    for lo, hi in zip(pts[:-1], pts[1:]):
        if hi - lo <= 1e-12:
            continue
        mid = 0.5 * (lo + hi)
        if any(a <= mid < b for a, b in zones):
            continue
        if skip_overlap and len(_active_at(ref, lo, hi)) > 1:
            continue
        out.append((lo, hi))
    return out


def _optimal_mapping(
    ref: List[Turn], hyp: List[Turn], intervals: List[Tuple[float, float]]
) -> Dict[str, str]:
    """One-to-one ref→hyp speaker mapping maximizing attributed time."""
    ref_spk = sorted({spk for _, _, spk in ref})
    hyp_spk = sorted({spk for _, _, spk in hyp})
    if not ref_spk or not hyp_spk:
        return {}
    overlap = np.zeros((len(ref_spk), len(hyp_spk)))
    r_idx = {s: i for i, s in enumerate(ref_spk)}
    h_idx = {s: i for i, s in enumerate(hyp_spk)}
    for lo, hi in intervals:
        dur = hi - lo
        for r in _active_at(ref, lo, hi):
            for h in _active_at(hyp, lo, hi):
                overlap[r_idx[r], h_idx[h]] += dur
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        return {
            ref_spk[r]: hyp_spk[c] for r, c in zip(rows, cols)
            if overlap[r, c] > 0
        }
    except ImportError:
        pass
    # exhaustive over the smaller axis for ≤8 speakers, greedy beyond
    nr, nh = len(ref_spk), len(hyp_spk)
    if min(nr, nh) <= 8:
        best, best_val = {}, -1.0
        if nr <= nh:
            for perm in itertools.permutations(range(nh), nr):
                val = sum(overlap[i, p] for i, p in enumerate(perm))
                if val > best_val:
                    best_val = val
                    best = {
                        ref_spk[i]: hyp_spk[p]
                        for i, p in enumerate(perm)
                        if overlap[i, p] > 0
                    }
        else:
            for perm in itertools.permutations(range(nr), nh):
                val = sum(overlap[p, j] for j, p in enumerate(perm))
                if val > best_val:
                    best_val = val
                    best = {
                        ref_spk[p]: hyp_spk[j]
                        for j, p in enumerate(perm)
                        if overlap[p, j] > 0
                    }
        return best
    mapping: Dict[str, str] = {}
    taken = set()
    order = np.argsort(overlap, axis=None)[::-1]
    for flat in order:
        i, j = divmod(int(flat), nh)
        if overlap[i, j] <= 0:
            break
        if ref_spk[i] in mapping or hyp_spk[j] in taken:
            continue
        mapping[ref_spk[i]] = hyp_spk[j]
        taken.add(hyp_spk[j])
    return mapping


def diarization_error_rate(
    reference,
    hypothesis,
    *,
    collar: float = 0.25,
    skip_overlap: bool = False,
) -> dict:
    """NIST-style DER of ``hypothesis`` against ``reference`` turns.

    Returns ``{"der", "miss", "false_alarm", "confusion", "total",
    "mapping"}`` — time components in seconds, ``total`` = scored
    reference speech time (DER denominator), ``mapping`` the optimal
    ref→hyp label assignment. ``der`` is 0.0 when both sides are empty
    and ``inf`` when the reference has no scored speech but the
    hypothesis does (false alarms with a zero denominator).
    """
    ref = _as_turns(reference)
    hyp = _as_turns(hypothesis)
    intervals = _scored_intervals(ref, hyp, collar, skip_overlap)
    mapping = _optimal_mapping(ref, hyp, intervals)

    miss = fa = conf = total = 0.0
    for lo, hi in intervals:
        dur = hi - lo
        r = _active_at(ref, lo, hi)
        h = set(_active_at(hyp, lo, hi))
        nr, nh = len(r), len(h)
        total += nr * dur
        miss += max(0, nr - nh) * dur
        fa += max(0, nh - nr) * dur
        correct = sum(1 for spk in r if mapping.get(spk) in h)
        conf += (min(nr, nh) - correct) * dur

    errors = miss + fa + conf
    if total > 0:
        der = errors / total
    else:
        der = 0.0 if errors == 0 else float("inf")
    return {
        "der": der,
        "miss": miss,
        "false_alarm": fa,
        "confusion": conf,
        "total": total,
        "mapping": mapping,
    }


# -- RTTM interchange ---------------------------------------------------------


def load_rttm(path: str) -> List[Turn]:
    """Parse SPEAKER lines of an RTTM file → [(start, end, speaker)]."""
    turns: List[Turn] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            start, dur = float(parts[3]), float(parts[4])
            turns.append((start, start + dur, parts[7]))
    return turns


def save_rttm(turns, path: str, uri: str = "audio") -> None:
    """Write turns as RTTM SPEAKER lines (the standard diarization
    exchange format; consumable by dscore/pyannote.metrics)."""
    with open(path, "w") as f:
        for s, e, spk in _as_turns(turns):
            f.write(
                f"SPEAKER {uri} 1 {s:.3f} {e - s:.3f} "
                f"<NA> <NA> {spk} <NA> <NA>\n"
            )


__all__ = ["diarization_error_rate", "load_rttm", "save_rttm"]
