"""The arithmetic of the per-layer metrics, over the window's deltas of the
port's tracker (``utils/metrics.py::GLOBAL_TRACKER``: stages and counters),
the batcher's ``stats`` and the profiled slice. Each metric's own file under
``metrics/`` names the function it reads with. Every function returns None
where its window gives it nothing to read."""

from __future__ import annotations

from typing import Optional

from harness import flops

K1_KERNEL = "wholek_attention_bf16_kernel"


def _stage(ctx, name: str) -> Optional[dict]:
    st = ctx.tracker.get("stages", {}).get(name)
    return st if st and st["calls"] else None


def batch_fill(ctx) -> Optional[float]:
    """Real rows over device rows, %."""
    c = ctx.tracker.get("counters", {})
    return 100.0 * c["batch_used"] / c["batch_slots"] if c.get("batch_slots") else None


def vad_ms_per_min(ctx) -> Optional[float]:
    """The ``vad`` stage's ms per minute of audio."""
    st = _stage(ctx, "vad")
    return st["total_s"] * 1e3 / (st["audio_s"] / 60.0) if st and st["audio_s"] > 0 else None


def decode_ms_per_step(ctx) -> Optional[float]:
    """The ``decode`` stage's ms (encoder, cross-KV, prefill and steps of
    each batch) over the decode steps run."""
    st = _stage(ctx, "decode")
    steps = ctx.tracker.get("counters", {}).get("decode_steps", 0.0)
    return st["total_s"] * 1e3 / steps if st and steps else None


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the real rows (encoder pass, cross-KV, prefill and
    steps) over the counters' time at the bf16 peak, %. Every batch is
    taken to run the mean number of steps, which is exact where none ends
    early (random weights all but never emit EOT)."""
    st = _stage(ctx, "decode")
    c = ctx.tracker.get("counters", {})
    if not st or not c.get("batch_used") or not ctx.counters_s:
        return None
    d = ctx.dims
    steps = c.get("decode_steps", 0.0) / st["calls"]
    # <|startoftranscript|><|en|><|transcribe|>, and <|notimestamps|> without timestamps
    n_init = 4 if ctx.config["asr_options"]["without_timestamps"] else 3
    per_row = flops.encoder_flops(d) + flops.cross_kv_flops(d) + flops.decode_flops(d, n_init + steps)
    return 100.0 * c["batch_used"] * per_row / (ctx.counters_s * flops.PEAK_BF16_FLOPS)


def k1_roofline(ctx) -> Optional[float]:
    """K1's launches in the slice times its bound at the cell's device
    batch, over its device time in the trace, %."""
    s = ctx.trace_summary
    if not s or not ctx.k1_launches:
        return None
    t = sum(v for n, v in s["kernel_s"].items() if K1_KERNEL in n)
    if t <= 0:
        return None
    bound = ctx.k1_launches * flops.k1_bound_s(ctx.dims, int(ctx.workload["params"]["batch_size"]))
    return 100.0 * bound / t


def device_idle(ctx) -> Optional[float]:
    """The share of the slice with no kernel, copy or fill running, %."""
    s = ctx.trace_summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s and s["window_s"] > 0 else None


def _batcher_delta(ctx, key: str) -> Optional[float]:
    if ctx.batcher_before is None or ctx.batcher_after is None:
        return None
    return ctx.batcher_after[key] - ctx.batcher_before[key]


def queue_wait_ms(ctx) -> Optional[float]:
    """Mean ms from a request's submission to the start of its
    ``transcribe_many`` call (the batcher's ``total_wait_s``)."""
    n = _batcher_delta(ctx, "requests")
    return _batcher_delta(ctx, "total_wait_s") * 1e3 / n if n else None


def requests_per_call(ctx) -> Optional[float]:
    """Requests per ``transcribe_many`` call (the batcher's counts)."""
    b = _batcher_delta(ctx, "batches")
    return _batcher_delta(ctx, "requests") / b if b else None
