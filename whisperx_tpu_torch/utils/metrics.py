"""Per-stage wall-time and real-time-factor accounting for the pipeline,
and the spans inside it on the device clock.

Every stage or span has a name: ``a.b`` is a part of ``a`` (``decode.steps``
of ``decode``, whose ``parent`` it is), and a name without a dot is a
top-level stage, the only kind ``emit_jsonl`` writes. Aggregates are always
on: calls, host seconds and audio seconds per name (``report``), and
counters (``add``). A span opened with a ``device`` also takes that
device's time: on CUDA from two timing events recorded on the device's
current stream at its edges, read only after the code has read back a
result that follows them (``settle``, called where a decode's results come
back); on the CPU the host's time. A span's device seconds are the counter
``<name>.device_s``, so that whoever reads counters reads them too.

Records of single spans (name, start, end, thread, the id that all spans of
one request or decode share, and the enclosing span) are kept only once
``record_spans`` is called, in a bounded buffer, and ``write_spans`` exports
them as one Chrome trace on the clock of ``torch.profiler``'s traces: in
both, ``ts`` · 1000 + ``baseTimeNanoseconds`` is the time of day in ns.
The spans are not profiler annotations (``record_function``), so a
profiler's trace of the same run names its idle gaps after host operators.

One lock guards every update: the batcher's worker, the data-parallel
replicas' threads and the caller may record at once.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

MAX_RECORDS = 100_000

# the innermost recorded span open in this context: (its number, its ids)
_OPEN: contextvars.ContextVar = contextvars.ContextVar("whisperx_tpu_torch_span", default=None)


def parent_of(name: str) -> Optional[str]:
    """``decode`` for ``decode.steps``; None for a top-level stage."""
    return name.rsplit(".", 1)[0] if "." in name else None


def device_mark(device, event=None, stream=None):
    """A point on ``device``'s clock: on CUDA a timing event (``event``, or
    a new one) recorded on ``stream``, by default the device's current
    stream; elsewhere the host clock."""
    if getattr(device, "type", None) != "cuda":
        return time.perf_counter()
    import torch

    if event is None:
        event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device) if stream is None else stream)
    return event


def mark_elapsed_s(a, b) -> float:
    """Seconds between two ``device_mark`` points; events only once the
    later has completed."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


def _ready(mark) -> bool:
    return isinstance(mark, float) or mark.query()


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
    """Per-stage and per-span wall time + real-time factor, device time of
    the spans that ask for it, plus free-form counters (tokens decoded,
    batch fill, replays)."""

    stages: Dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats)
    )
    counters: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # device readings not yet taken: (the last mark they need, their reader)
    _pending: List[tuple] = field(default_factory=list, repr=False)
    _records: Optional[collections.deque] = field(default=None, repr=False)
    _numbers: itertools.count = field(default_factory=lambda: itertools.count(1), repr=False)
    _base_ns: int = 0  # the time of day at perf_counter() == 0

    @contextlib.contextmanager
    def span(self, name: str, audio_seconds: float = 0.0, device=None, **ids):
        """Time the block as ``name``; with ``device``, that device's time
        too. ``ids`` go into the block's records and those of the spans
        opened inside it (records only)."""
        t0 = time.perf_counter()
        start = device_mark(device) if device is not None else None
        rec = self._open(ids) if self._records is not None else None
        try:
            yield
        finally:
            if device is not None:
                end = device_mark(device)
                self.add_later(end, lambda: {name + ".device_s": mark_elapsed_s(start, end)})
            t1 = time.perf_counter()
            self.observe(name, t1 - t0, audio_seconds)
            if rec is not None:
                self._close(name, t0, t1, rec)

    def track(self, stage: str, audio_seconds: float = 0.0):
        """A span on the host clock alone."""
        return self.span(stage, audio_seconds)

    def add(self, counter: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[counter] += value

    def observe(self, stage: str, seconds: float, audio_seconds: float = 0.0,
                start: Optional[float] = None, **ids) -> None:
        """Record an externally timed interval against a stage; with
        ``start`` (on ``time.perf_counter``'s clock) and records on, one
        record from ``start`` with ``ids``."""
        with self._lock:
            s = self.stages[stage]
            s.calls += 1
            s.total_s += seconds
            s.audio_s += audio_seconds
            s.min_s = min(s.min_s, seconds)
            s.max_s = max(s.max_s, seconds)
            if start is not None and self._records is not None:
                self._records.append((stage, start, start + seconds, threading.get_ident(),
                                      next(self._numbers), None, ids))

    def add_later(self, last, read: Callable[[], Dict[str, float]]) -> None:
        """Add ``read()``'s counters once the mark ``last`` is reached:
        now on the host clock, at a later ``settle`` on CUDA."""
        if isinstance(last, float):
            values = read()
            with self._lock:
                for k, v in values.items():
                    self.counters[k] += v
            return
        with self._lock:
            self._pending.append((last, read))

    def settle(self) -> None:
        """Take the device readings whose last event has completed, with no
        wait: called after a read-back, which the events precede."""
        with self._lock:
            pending, self._pending = self._pending, []
            for item in pending:
                if _ready(item[0]):
                    for k, v in item[1]().items():
                        self.counters[k] += v
                else:
                    self._pending.append(item)

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()
            self.counters.clear()
            self._pending.clear()
            if self._records is not None:
                self._records.clear()

    def report(self) -> Dict[str, dict]:
        """Each stage and span: calls, host seconds, audio seconds, its
        ``parent`` and, for a span with device time, ``device_s``."""
        self.settle()
        with self._lock:
            out = {}
            for name, s in self.stages.items():
                out[name] = {
                    "calls": s.calls,
                    "total_s": s.total_s,
                    "audio_s": s.audio_s,
                    "rtf": s.rtf,
                    "min_s": s.min_s if s.calls else 0.0,
                    "max_s": s.max_s,
                    "parent": parent_of(name),
                }
                if name + ".device_s" in self.counters:
                    out[name]["device_s"] = self.counters[name + ".device_s"]
            return out

    # -- records ---------------------------------------------------------------

    def record_spans(self, max_records: Optional[int] = MAX_RECORDS) -> None:
        """Keep a record of every span from now on (the last
        ``max_records``); None stops and drops the records."""
        with self._lock:
            if max_records is None:
                self._records = None
                return
            perf_ns, wall_ns = time.perf_counter_ns(), time.time_ns()
            self._base_ns = wall_ns - perf_ns
            self._records = collections.deque(maxlen=max_records)

    @contextlib.contextmanager
    def ids(self, **ids):
        """The spans opened inside the block carry ``ids`` in their records."""
        if self._records is None:
            yield
            return
        outer = _OPEN.get()
        token = _OPEN.set((outer[0] if outer else None, {**(outer[1] if outer else {}), **ids}))
        try:
            yield
        finally:
            _OPEN.reset(token)

    def _open(self, ids: dict) -> tuple:
        outer = _OPEN.get()
        ids = {**(outer[1] if outer else {}), **ids}
        with self._lock:
            number = next(self._numbers)
        ids.setdefault("id", number)  # a span with no id around it starts one
        return number, outer[0] if outer else None, ids, _OPEN.set((number, ids))

    def _close(self, name: str, t0: float, t1: float, rec: tuple) -> None:
        number, parent, ids, token = rec
        _OPEN.reset(token)
        with self._lock:
            if self._records is not None:
                self._records.append((name, t0, t1, threading.get_ident(), number, parent, ids))

    def write_spans(self, path: str) -> int:
        """Write the records as one Chrome trace JSON; returns how many."""
        with self._lock:
            records = list(self._records or ())
            base_ns = self._base_ns
        pid = os.getpid()
        events = [
            {
                "name": name, "ph": "X", "cat": "span", "pid": pid, "tid": tid,
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "args": {**ids, "span": number, "parent": parent},
            }
            for name, t0, t1, tid, number, parent, ids in records
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns}, f)
        return len(events)

    # -- export ------------------------------------------------------------------

    def emit_jsonl(self, path: Optional[str] = None, extra: Optional[dict] = None) -> str:
        """Structured export (the CLI's ``--log_json``): one JSON line per
        top-level stage, then a summary line with their total, tokens/s over
        the decode's step loop (``decode.steps``) and batch fill. Appended
        to ``path`` when given; the text is returned either way."""
        lines = []
        with self._lock:
            stages = {n: s for n, s in self.stages.items() if parent_of(n) is None}
            steps = self.stages.get("decode.steps")
            counters = dict(self.counters)
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
        if counters.get("tokens_decoded") and steps and steps.total_s > 0:
            summary["tokens_per_s"] = round(counters["tokens_decoded"] / steps.total_s, 1)
        if counters.get("batch_slots"):
            summary["batch_fill"] = round(
                counters["batch_used"] / counters["batch_slots"], 3
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
