"""Dynamic time warping on the token × frame alignment cost, and the median
filter of word timing.

Counterpart of ``whisperx_tpu/timing/dtw.py`` (reference
median_filter_fix.py:6-35; the whisper ``dtw`` contract). The cost
recursion runs on the host as a numpy sweep along anti-diagonals: every
cell of one anti-diagonal depends only on the two before it, so each
diagonal is one vectorized step (N + M steps for an N × M matrix, where a
Python double loop would take N · M). The f32 sums and minima are the ones
the JAX scan computes, so the cost matrix is bit-identical to it, and the
backtrace (``argmin`` over diagonal, up, left: ties go in that order) is
the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _dtw_cost(x: np.ndarray) -> np.ndarray:
    """x: [N, M] → accumulated cost [N+1, M+1]: cost[0, 0] = 0, the other
    border cells inf, and cost[i, j] = x[i-1, j-1] + min(cost[i-1, j-1],
    cost[i-1, j], cost[i, j-1])."""
    n, m = x.shape
    width = m + 1
    cost = np.full((n + 1) * width, np.inf, np.float32)
    cost[0] = 0.0
    xf = x.reshape(-1)
    for d in range(2, n + m + 1):  # i + j = d
        i = np.arange(max(1, d - m), min(n, d - 1) + 1)
        cell = i * width + (d - i)
        best = np.minimum(
            np.minimum(cost[cell - width - 1], cost[cell - width]), cost[cell - 1]
        )
        cost[cell] = xf[(i - 1) * m + (d - i - 1)] + best
    return cost.reshape(n + 1, width)


def dtw(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost monotonic path through ``x`` [N, M]; returns
    (text_indices, time_indices), the whisper ``dtw`` contract."""
    x = np.asarray(x, np.float32)
    n, m = x.shape
    cost = _dtw_cost(x)

    i, j = n, m
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            moves = (cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1])
            k = int(np.argmin(moves))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
    return np.array(text_indices[::-1]), np.array(time_indices[::-1])


def median_filter(x: torch.Tensor, width: int = 7) -> torch.Tensor:
    """Median over a sliding window of odd ``width`` along the last axis,
    with numpy's reflect padding at the edges (scipy.signal.medfilt's role),
    on the tensor's device. Where the axis is shorter than the pad, the
    reflection wraps again, as numpy's does: period 2·(n-1)."""
    pad = width // 2
    n = x.shape[-1]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        idx = torch.zeros_like(i)
    else:
        m = torch.remainder(i, 2 * (n - 1))
        idx = torch.where(m < n, m, 2 * (n - 1) - m)
    return x[..., idx].unfold(-1, width, 1).median(dim=-1).values
