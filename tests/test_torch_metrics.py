"""The port's tracker (``whisperx_tpu_torch/utils/metrics.py``): spans and
counters that lose nothing across threads, ``--log_json``'s top-level
stages, span records off unless switched on, and their clock against
``torch.profiler``'s Chrome trace."""

import json
import sys
import threading
import time

import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from whisperx_tpu_torch.decoding.step_graph import GraphCache
from whisperx_tpu_torch.utils.metrics import RTFTracker


def test_two_threads_recording_at_once_lose_no_call():
    """Threads (more than the cores of a small host, the interpreter
    switching every microsecond) record spans, counters and timed intervals
    into one tracker at once: no call is lost."""
    t = RTFTracker()
    t.record_spans()
    n_threads, n = 8, 500
    go = threading.Barrier(n_threads)

    def work():
        go.wait()
        for _ in range(n):
            with t.span("decode.steps", device=torch.device("cpu")):
                t.add("step_replays")
            t.observe("serve.drain_wait", 1e-6, start=time.perf_counter())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    report = t.report()
    assert report["decode.steps"]["calls"] == report["serve.drain_wait"]["calls"] == n_threads * n
    assert t.counters["step_replays"] == n_threads * n
    assert report["decode.steps"]["device_s"] == t.counters["decode.steps.device_s"] > 0
    assert len(t._records) == 2 * n_threads * n


def test_emit_jsonl_writes_top_level_stages_and_their_total():
    """Parts of a stage (``decode.steps``) are not lines and not in the
    total; tokens/s is over the step loop."""
    t = RTFTracker()
    t.observe("vad", 0.25, 60.0)
    t.observe("decode.encoder", 0.5)
    t.observe("decode.steps", 2.0)
    t.observe("decode", 3.0, 60.0)
    t.add("tokens_decoded", 100)
    lines = [json.loads(line) for line in t.emit_jsonl().splitlines()]
    assert [d.get("stage") for d in lines] == ["vad", "decode", None]
    summary = lines[-1]
    assert summary["total_s"] == 3.25 and summary["tokens_per_s"] == 50.0
    assert t.report()["decode.steps"]["parent"] == "decode"


def test_span_records_are_off_unless_switched_on(tmp_path):
    t = RTFTracker()
    with t.ids(call=1), t.span("decode", device=torch.device("cpu")):
        t.observe("serve.call", 0.1, start=time.perf_counter(), request=1)
    assert t._records is None
    assert t.write_spans(str(tmp_path / "none.json")) == 0
    assert t.report()["decode"]["calls"] == 1
    t.record_spans()
    with t.span("decode"):
        pass
    t.record_spans(None)
    assert t._records is None
    assert GraphCache().stats() == {
        "captures": 0, "replays": 0, "entries": 0, "static_bytes": 0, "pool_bytes": 0
    }


def test_span_records_share_the_profilers_clock(tmp_path):
    """A ``record_function`` block and a span around the same block start
    within 1 ms once each file's ``ts`` · 1000 + ``baseTimeNanoseconds`` is
    taken; the span is not a profiler event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    t = RTFTracker()
    t.record_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("first"):  # the process's first block sets up for a millisecond
            pass
        with record_function("block"), t.span("block.span"):
            time.sleep(0.005)
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    t.write_spans(str(tmp_path / "spans.json"))

    def start_ns(path, name):
        trace = json.load(open(path))
        (event,) = [e for e in trace["traceEvents"] if e.get("name") == name]
        return event["ts"] * 1000 + trace["baseTimeNanoseconds"]

    profiled = json.load(open(tmp_path / "profile.json"))["traceEvents"]
    assert not [e for e in profiled if e.get("name") == "block.span"]
    gap_ns = start_ns(tmp_path / "spans.json", "block.span") - start_ns(tmp_path / "profile.json", "block")
    assert abs(gap_ns) < 1e6
