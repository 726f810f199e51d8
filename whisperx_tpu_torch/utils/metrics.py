"""Per-stage wall-time and real-time-factor accounting for the pipeline."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    audio_s: float = 0.0
    # per-call extremes: a first call that builds kernels hides in totals;
    # min_s is the steady-state cost, max_s the worst call
    min_s: float = float("inf")
    max_s: float = 0.0

    @property
    def rtf(self) -> float:
        return self.audio_s / self.total_s if self.total_s > 0 else 0.0


@dataclass
class RTFTracker:
    """Per-stage wall time + real-time factor, plus free-form counters
    (tokens decoded, batch fill). A stage's time is host wall time: the
    pipeline synchronises the device where a stage's result is read back."""

    stages: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats)
    )
    counters: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )

    @contextlib.contextmanager
    def track(self, stage: str, audio_seconds: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(stage, time.perf_counter() - t0, audio_seconds)

    def add(self, counter: str, value: float = 1.0) -> None:
        self.counters[counter] += value

    def observe(self, stage: str, seconds: float, audio_seconds: float = 0.0) -> None:
        """Record an externally timed interval against a stage."""
        s = self.stages[stage]
        s.calls += 1
        s.total_s += seconds
        s.audio_s += audio_seconds
        s.min_s = min(s.min_s, seconds)
        s.max_s = max(s.max_s, seconds)

    def reset(self) -> None:
        self.stages.clear()
        self.counters.clear()

    def report(self) -> Dict[str, dict]:
        return {
            name: {
                "calls": s.calls,
                "total_s": s.total_s,
                "audio_s": s.audio_s,
                "rtf": s.rtf,
                "min_s": s.min_s if s.calls else 0.0,
                "max_s": s.max_s,
            }
            for name, s in dict(self.stages).items()
        }


GLOBAL_TRACKER = RTFTracker()
