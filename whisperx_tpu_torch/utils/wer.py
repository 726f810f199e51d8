"""Word/character error rate (dependency-free jiwer replacement).

Counterpart of ``whisperx_tpu/utils/wer.py``, kept as its own copy.

The reference measures accuracy with jiwer against gold transcripts
(accuracy_test.py:50-58); this provides the same WER/CER via a standard
Levenshtein alignment with insert/delete/substitute counts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence


@dataclass
class ErrorRate:
    errors: int
    substitutions: int
    insertions: int
    deletions: int
    length: int

    @property
    def rate(self) -> float:
        return self.errors / self.length if self.length else 0.0


def _levenshtein_counts(ref: Sequence, hyp: Sequence) -> ErrorRate:
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels)
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], *prev[j - 1][1:])]
            else:
                cand = [
                    (prev[j - 1][0] + 1, prev[j - 1][1] + 1, prev[j - 1][2], prev[j - 1][3])
                ]
            cand.append((cur[j - 1][0] + 1, cur[j - 1][1], cur[j - 1][2] + 1, cur[j - 1][3]))
            cand.append((prev[j][0] + 1, prev[j][1], prev[j][2], prev[j][3] + 1))
            cur.append(min(cand))
        prev = cur
    cost, subs, ins, dels = prev[m]
    return ErrorRate(cost, subs, ins, dels, max(n, 1))


def normalize_text(text: str) -> str:
    """Basic ASR normalization: lowercase, strip punctuation, squeeze space."""
    text = text.lower()
    text = re.sub(r"[^\w\s']", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    return _levenshtein_counts(reference.split(), hypothesis.split()).rate


def cer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    return _levenshtein_counts(list(reference), list(hypothesis)).rate


def wer_details(reference: str, hypothesis: str, normalize: bool = True) -> ErrorRate:
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    return _levenshtein_counts(reference.split(), hypothesis.split())
