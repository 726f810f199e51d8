"""Served clips: an open loop of requests into ``serve.ContinuousBatcher``,
configured as the server configures it (``BatchConfig``: ``max_batch_size``
requests coalesced per call, ``max_wait_ms`` of straggler window, the
default duration buckets; the pipeline's own device batch).

Parameters: ``rate_per_s``, the offered load; ``clip_s``, the [shortest,
longest] clip, the lengths log-uniform; ``max_batch_size``, ``max_wait_ms``,
``batch_size``, ``sample_len``; ``schedule_seed``. The schedule is the
cell's, the same for every run: the lengths are the quantiles of the
log-uniform law and the gaps between arrivals the quantiles of the
exponential law at the rate, each shuffled by ``schedule_seed``, so the
arrivals are Poisson in distribution. The run's seed draws where each clip
is cut from the audio pool, and the weights.

Each request is timed from when it was due to its result (the batcher's
callback), so a stall charges every request due behind it; a request that
fails or has not come a minute after the window closed is missing. A traced
run profiles about a twentieth of the window: from the first result after
45% of it to the first after 50%, and at least a fortieth of the window
after the profiler has started (one call's results come one after another:
where the opening result comes late, or the profiler's start stalls, the
next result of the same call would close a slice with no device work in
it); its per-layer counters (the batcher's, the tracker's) are read up to
where the slice opens, since the profiler's start stalls the generator for
seconds.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

from harness import stats, trace


def _batcher(ctx):
    from whisperx_tpu_torch.serve import BatchConfig, ContinuousBatcher

    p = ctx.workload["params"]
    cfg = BatchConfig(max_batch_size=int(p["max_batch_size"]), max_wait_ms=float(p["max_wait_ms"]))
    return ContinuousBatcher(ctx.pipeline, cfg)


def _requests(ctx) -> list:
    p = ctx.workload["params"]
    n = max(1, round(p["rate_per_s"] * ctx.seconds))
    q = (np.arange(n) + 0.5) / n
    lo, hi = p["clip_s"]
    lengths = lo * (hi / lo) ** q
    gaps = -np.log1p(-q) / p["rate_per_s"]
    gaps *= ctx.seconds / gaps.sum()  # the arrivals span the window
    order = np.random.default_rng(p["schedule_seed"])  # the cell's schedule, the same for every seed
    lengths, gaps = order.permutation(lengths), order.permutation(gaps)
    rng = np.random.default_rng([ctx.seed, 3])
    due = np.cumsum(gaps) - gaps[0]
    out = []
    for d, length in zip(due, lengths):
        n_samples = int(length * 16000)
        out.append({"offset": int(rng.integers(0, len(ctx.pool) - n_samples)), "n": n_samples,
                    "at": float(d)})
    return out


def warm(ctx) -> None:
    """The batcher started, and one coalesced call of the longest and the
    shortest clip through it. A traced run also starts and stops the
    profiler once on the batcher's worker thread, where the window's slice
    is switched: a thread's first start takes seconds."""
    ctx.batcher = _batcher(ctx)
    ctx.batcher.start()
    lo, hi = ctx.workload["params"]["clip_s"]

    cycled = threading.Event()

    def cycle(_result):
        try:
            with trace.Slice(True):
                pass
        finally:
            cycled.set()

    reqs = [ctx.batcher.submit(ctx.pool[: int(s * 16000)], callback=cycle if ctx.trace and s == hi else None)
            for s in (hi, lo)]
    for r in reqs:
        r.done.wait()
    if ctx.trace:
        cycled.wait()
        if isinstance(r.result, dict) and "error" in r.result:
            raise RuntimeError(f"warm-up request failed: {r.result['error']}")


def window(ctx) -> dict:
    planned = _requests(ctx)
    ctx.batcher_before = ctx.batcher.stats_snapshot()
    lock = threading.Lock()
    count = {"done": 0}
    all_done = threading.Event()

    # a traced run switches the profiler on the batcher's worker thread, the
    # one that drives the device, in a result's callback: between calls,
    # with nothing of its own in flight
    start = time.perf_counter()
    lo, hi, least = start + 0.45 * ctx.seconds, start + 0.5 * ctx.seconds, 0.025 * ctx.seconds
    sl = ctx.slice(ctx.trace)
    state = ["before" if ctx.trace else "after"]
    marks = {}  # the slice's opening and closing, on the host clock

    def finished(req, result):
        req["done"] = time.perf_counter()
        req["result"] = result
        if isinstance(result, dict) and "error" in result:
            req["error"] = result["error"]
        try:  # the worker thread must outlive a profiler that fails
            if state[0] == "before" and req["done"] >= lo:
                state[0] = "in"
                sl.__enter__()
                marks["opened"] = time.perf_counter()
            elif state[0] == "in" and req["done"] >= max(hi, marks.get("opened", lo) + least):
                state[0] = "after"
                marks["closed"] = time.perf_counter()
                sl.__exit__(None, None, None)
        except Exception as e:
            ctx.slice_error = f"{type(e).__name__}: {e}"
        with lock:
            count["done"] += 1
            if count["done"] == len(planned):
                all_done.set()

    def wait_until(t: float) -> None:
        wait = t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    for req in planned:
        req["due"] = start + req["at"]
        wait_until(req["due"])
        req["sent"] = time.perf_counter()
        req["handle"] = ctx.batcher.submit(ctx.audio(req), callback=lambda res, r=req: finished(r, res))
        ctx.requests.append(req)
    all_done.wait(timeout=max(0.0, start + ctx.seconds + 60.0 - time.perf_counter()))
    for req in ctx.requests:  # a failed call sets its requests' results, with no callback
        h = req.pop("handle")
        if "done" not in req and h.done.is_set():
            req["error"] = str(h.result.get("error")) if isinstance(h.result, dict) else "no result"
    ctx.window_s = max([r["done"] for r in ctx.requests if "done" in r], default=start + ctx.seconds) - start
    if ctx.batcher_after is None:  # a traced run's counters close where its slice opens
        ctx.batcher_after = ctx.batcher.stats_snapshot()
    ctx.batcher.stop()
    if state[0] == "in":  # no result came after the slice's end: the worker has stopped
        marks["closed"] = time.perf_counter()
        sl.__exit__(None, None, None)
    if "opened" in marks:
        print(f"profiled slice: {marks['opened'] - start:.3f} s to {marks['closed'] - start:.3f} s "
              "of the window", file=sys.stderr)
    if getattr(ctx, "slice_error", None):
        raise RuntimeError(f"the profiled slice failed: {ctx.slice_error}")
    lat = stats.latencies(ctx.requests)
    ctx.lateness_s = max(r["sent"] - r["due"] for r in ctx.requests)
    return {"latency_p50_s": stats.percentile(lat, 50), "latency_p95_s": stats.percentile(lat, 95)}
