"""The profiled slice of a traced run, read from ``torch.profiler``'s Chrome
trace (the way ``chip_smoke.py::device_events`` reads it: the JSON the
profiler writes in C++, not ``key_averages()``, which builds a Python object
for each of a decode's ~10^6 events).

The slice is marked by a ``record_function`` span on the thread that opens
it. From the device's kernels, copies and fills inside it the summary gives
the time the device was busy (the union of their intervals), the time by
kernel name, and the idle gaps, each named after the host event (an
operator or a CUDA runtime call, on any thread) that overlaps it most.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
SLICE = "benchmark_slice"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval of ``busy`` (merged) covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def summarize(events: List[dict], top: int = 10) -> Optional[Dict]:
    """The slice's busy and idle time, device time by name and the idle
    gaps by host event, from a Chrome trace's events (times in µs)."""
    marks = [e for e in events if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = marks[0]["ts"]
    hi = lo + marks[0]["dur"]
    dev = []
    by_name: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
    busy = union(dev)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e and e.get("name") != SLICE)
    idle_by: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    i = 0
    for s, t in gaps(busy, lo, hi):  # one sweep: gaps and host events by start
        while i < len(host) and host[i][0] < t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > s]
        best, name = 0.0, "no host event"
        for hs, he, hn in active:
            ov = min(he, t) - max(hs, s)
            if ov > best:
                best, name = ov, hn
        idle_by[name] = idle_by.get(name, 0.0) + (t - s)
    busy_us = sum(t - s for s, t in busy)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, us / 1e6] for n, us in sorted(idle_by.items(), key=lambda x: -x[1])[:top]],
        "kernel_s": {n: us / 1e6 for n, us in by_name.items()},
        "kernel_calls": _calls(events, lo, hi),
    }


def _calls(events: List[dict], lo: float, hi: float) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel" and lo <= e["ts"] < hi:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


class Slice:
    """``with Slice(on):`` profiles the block when ``on``. The trace is
    exported and read by ``finish()``, after the window, so the export takes
    no time from it; ``finish`` returns ``summarize``'s dict (None when off
    or empty). A process's first profiled block starts its tracer, which
    takes seconds: the set-up profiles an empty block first."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self._span = None
        self._started = False

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._started = True
            self._span = record_function(SLICE)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            self._prof.stop()
        return False

    def finish(self) -> Optional[Dict]:
        if self._prof is None or not self._started:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return summarize(events)
