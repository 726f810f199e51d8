"""WhisperX's forced alignment of one segment, written again in numpy from
its published semantics (``whisperx/alignment.py``: the transcript's
cleaning, ``get_trellis`` with wildcard emissions, ``backtrack_beam`` at
width 2, ``merge_repeats``), and the path arithmetic the check judges with.

A path is given as ``js``: for each of the segment's T frames, the index of
the transcript's character it belongs to (0 at the first frame, the last at
the last, each step 0 or 1). WhisperX scores frame t of a path by the
probability of what the backtrack takes from it: the blank where the next
frame keeps the character, the next frame's character where it moves on,
the blank at the last frame. A character's score is the mean over its frames.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

LANGUAGES_WITHOUT_SPACES = ("ja", "zh")
STATES = 8  # ``path_margin`` keeps the ways of the other beam that cost least


def clean(text: str, dictionary: dict, language: str) -> Tuple[List[int], List[int]]:
    """The transcript's alignable characters: (their indices in ``text``,
    their ids), leading and trailing white space left out, a space as "|"
    where the language has spaces, a character outside the dictionary as
    the wildcard -1."""
    lead = len(text) - len(text.lstrip())
    trail = len(text) - len(text.rstrip())
    idx, ids = [], []
    for i, ch in enumerate(text):
        if i < lead or i > len(text) - trail - 1:
            continue
        c = ch.lower()
        if language not in LANGUAGES_WITHOUT_SPACES:
            c = c.replace(" ", "|")
        idx.append(i)
        ids.append(dictionary.get(c, -1))
    return idx, ids


def blank_of(dictionary: dict) -> int:
    for tok in ("[pad]", "<pad>"):
        if tok in dictionary:
            return dictionary[tok]
    return 0


def token_scores(em: np.ndarray, tokens: List[int], blank: int) -> np.ndarray:
    """[T, V] → [T, len(tokens)]: each token's log-probability at each
    frame; the wildcard (-1) takes the best non-blank one."""
    tokens = np.asarray(tokens, np.int64)
    best = np.delete(em, blank, axis=1).max(axis=1) if em.shape[1] > 1 else np.full(len(em), -np.inf, em.dtype)
    return np.where(tokens[None, :] < 0, best[:, None], em[:, np.clip(tokens, 0, None)])


def trellis(em: np.ndarray, tokens: List[int], blank: int) -> np.ndarray:
    """WhisperX's trellis [T, N] in float32: column 0 the blank's running
    sum from frame 1 with its last N - 1 frames +inf, row 0 -inf past
    column 0, then stay (blank) or advance (the next token)."""
    em = np.asarray(em, np.float32)
    t_n, n = em.shape[0], len(tokens)
    out = np.zeros((t_n, n), np.float32)
    out[1:, 0] = np.cumsum(em[1:, blank])
    out[0, 1:] = -np.inf
    out[t_n - n + 1:, 0] = np.inf
    adv = token_scores(em, tokens[1:], blank).astype(np.float32)
    for t in range(t_n - 1):
        out[t + 1, 1:] = np.maximum(out[t, 1:] + em[t, blank], out[t, :-1] + adv[t])
    return out


def backtrack(tr: np.ndarray, width: int = 2) -> Optional[np.ndarray]:
    """WhisperX's beam backtrack: from the last frame and token, each beam
    stays or steps back a token, the ``width`` best by the trellis's value
    at the new cell are kept (a stable sort), until the best beam reaches
    token 0; then it stays there to frame 0. Returns ``js``, or None where
    no beam reaches token 0."""
    t_n, n = tr.shape
    beams = [(n - 1, t_n - 1, float(tr[t_n - 1, n - 1]), None)]  # (j, t, score, parent)
    while beams and beams[0][0] > 0:
        nxt = []
        for beam in beams:
            j, t = beam[0], beam[1]
            if t <= 0:
                continue
            stay = float(tr[t - 1, j])
            move = float(tr[t - 1, j - 1]) if j > 0 else -math.inf
            if not math.isinf(stay):
                nxt.append((j, t - 1, stay, beam))
            if j > 0 and not math.isinf(move):
                nxt.append((j - 1, t - 1, move, beam))
        beams = sorted(nxt, key=lambda b: b[2], reverse=True)[:width]
    if not beams:
        return None
    js = np.zeros(t_n, np.int64)
    node = beams[0]
    while node is not None:
        js[node[1]] = node[0]
        node = node[3]
    return js


def frame_log_probs(em: np.ndarray, tokens: List[int], blank: int, js: np.ndarray) -> np.ndarray:
    """[T]: the log-probability WhisperX scores each frame of the path by."""
    em = np.asarray(em, np.float64)
    t_n = len(js)
    nxt = np.concatenate([js[1:], js[-1:]])
    moves = nxt != js
    moves[-1] = False
    tok = token_scores(em, tokens, blank)[np.arange(t_n), nxt]
    return np.where(moves, tok, em[:, blank])


def path_margin(tr: np.ndarray, js: np.ndarray) -> float:
    """How far the trellis ``tr`` would have to move, in nats, for
    ``backtrack`` (width 2) to take the path ``js``: the least, over the
    ways the backtrack's other beam can have run, of the largest lift of a
    trellis value that some step needs. A step needs the path's next cell
    among the two best candidates, above any candidate at token 0 (which
    would end the backtrack there), and, where the other beam is ahead of
    the path's and steps onto the path's cell, the path's beam ahead of it
    a frame before (two beams at one cell keep their order for good). Which
    candidate becomes the other beam costs the gap to the best one; the
    path ends where its beam, at token 0, ranks first. 0 for the
    backtrack's own path, about the trellis's rounding where a near-tie
    went the other way; +inf where the path steps onto a cell the backtrack
    never takes (an infinite value). Only the ``STATES`` cheapest ways are
    followed, so the least is bounded from above."""
    def value(t: int, k: int) -> float:
        return float(tr[t, k])

    states = {(-1, False): 0.0}  # (the other beam's token or -1, it is ahead) → the largest lift so far
    best = math.inf
    for t in range(tr.shape[0] - 1, 0, -1):
        j, nxt = int(js[t]), int(js[t - 1])
        mine = value(t - 1, nxt)
        if math.isinf(mine):
            return math.inf
        nxt_states: dict = {}

        def keep(key, lift):
            if lift < nxt_states.get(key, math.inf):
                nxt_states[key] = lift

        for (r, ahead), worst in states.items():
            if worst >= best:
                continue
            cells = [k for k in (j, j - 1) if k >= 0 and k != nxt]
            theirs = [k for k in (r, r - 1) if r >= 0 and k >= 0]
            lift = value(t, r) - value(t, j) if ahead and nxt in theirs else 0.0
            rivals = sorted(((value(t - 1, k), k) for k in cells + theirs
                             if k != nxt and not math.isinf(tr[t - 1, k])), reverse=True)
            if len(rivals) >= 2:
                lift = max(lift, rivals[1][0] - mine)
            lift = max([lift] + [v - mine for v, k in rivals if k == 0])
            worst, lifted = max(worst, lift), mine + lift
            if nxt == 0:
                best = min(best, max([worst] + [v - lifted for v, _ in rivals]))
            cands = rivals + ([(lifted, nxt)] if nxt in theirs else [])
            if not cands:
                keep((-1, False), worst)
            for v, k in cands:
                cost = max(worst, cands[0][0] - v if k != nxt else max(0.0, rivals[0][0] - v) if rivals else 0.0)
                if v > lifted:
                    keep((k, True), cost)
                    keep((k, False), max(cost, v - mine))
                else:
                    keep((k, False), cost)
        states = dict(sorted(nxt_states.items(), key=lambda kv: kv[1])[:STATES])
    return best


def char_scores(em: np.ndarray, tokens: List[int], blank: int, js: np.ndarray) -> np.ndarray:
    """Each character's mean probability over its frames."""
    p = np.exp(frame_log_probs(em, tokens, blank, js))
    counts = np.bincount(js, minlength=len(tokens))
    return np.bincount(js, weights=p, minlength=len(tokens)) / np.maximum(counts, 1)


def align(em: np.ndarray, tokens: List[int], blank: int) -> Optional[np.ndarray]:
    """The path WhisperX takes through ``em``, or None."""
    return backtrack(trellis(em, tokens, blank))
