"""Statistics of a window: percentiles over every request due in it (a
request that failed or never came counts as missing, +inf), and a rate over
the time to the last completion."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0–100) by linear interpolation between closest
    ranks; +inf entries (missing requests) sort last."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q / 100 * (len(xs) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies(requests: List[dict]) -> List[float]:
    """Seconds from each request's due time to its result; +inf where it
    failed or never came."""
    return [r["done"] - r["due"] if r.get("done") is not None and not r.get("error") else math.inf
            for r in requests]


def rate(work: float, start: float, ends: Sequence[float]) -> Optional[float]:
    """Work over the time from ``start`` to the last completion."""
    if not ends or max(ends) <= start:
        return None
    return work / (max(ends) - start)
