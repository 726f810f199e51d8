"""Per-stage wall-time and real-time-factor accounting for the pipeline."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional


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

    def emit_jsonl(self, path: Optional[str] = None, extra: Optional[dict] = None) -> str:
        """Structured export (the CLI's ``--log_json``): one JSON line per
        stage, then a summary line with tokens/s and batch fill. Appended to
        ``path`` when given; the text is returned either way."""
        lines = []
        stages = dict(self.stages)
        for name, s in stages.items():
            lines.append(
                json.dumps(
                    {
                        "event": "stage",
                        "stage": name,
                        "calls": s.calls,
                        "total_s": round(s.total_s, 4),
                        "audio_s": round(s.audio_s, 2),
                        "rtf": round(s.rtf, 2),
                        "min_s": round(s.min_s, 4) if s.calls else 0.0,
                        "max_s": round(s.max_s, 4),
                    }
                )
            )
        total_s = sum(s.total_s for s in stages.values())
        audio_s = max((s.audio_s for s in stages.values()), default=0.0)
        summary = {
            "event": "summary",
            "total_s": round(total_s, 4),
            "audio_s": round(audio_s, 2),
            "rtf": round(audio_s / total_s, 2) if total_s > 0 else 0.0,
        }
        decode = stages.get("decode")
        if self.counters.get("tokens_decoded") and decode and decode.total_s > 0:
            summary["tokens_per_s"] = round(
                self.counters["tokens_decoded"] / decode.total_s, 1
            )
        if self.counters.get("batch_slots"):
            summary["batch_fill"] = round(
                self.counters["batch_used"] / self.counters["batch_slots"], 3
            )
        summary.update(extra or {})
        lines.append(json.dumps(summary))
        text = "\n".join(lines) + "\n"
        if path:
            with open(path, "a") as f:
                f.write(text)
        return text


GLOBAL_TRACKER = RTFTracker()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler``: host (CPU) activity, and the
    device's kernels and copies when a GPU is present. On exit a Chrome
    trace, ``<host>_<pid>.<ms>.pt.trace.json``, is written into ``log_dir``
    (default ``whisperx_tpu_torch_trace`` in the temporary directory, which
    honours ``TMPDIR``; TensorBoard's PyTorch profiler plugin and
    ``chrome://tracing`` read it)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "whisperx_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def device_memory_report() -> Dict[str, dict]:
    """The caching allocator's statistics per visible CUDA device
    (``pipeline.batch_processor.optimize_memory``); empty without a GPU."""
    from whisperx_tpu_torch.pipeline.batch_processor import optimize_memory

    return optimize_memory()
