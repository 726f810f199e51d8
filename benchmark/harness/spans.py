"""The arithmetic of the per-layer metrics that read the port's spans and
counters inside the decode, its graph cache and the batcher: the window's
deltas of ``utils/metrics.py::GLOBAL_TRACKER`` (a span's calls among the
stages, its device seconds as the counter ``<span>.device_s``) and of the
batcher's ``stats``. Each metric's own file under ``metrics/`` names the
function it reads with. Every function returns None where its window gives
it nothing to read, as on a checkout whose program has no such span or
counter."""

from __future__ import annotations

from typing import Optional


def _counters(ctx) -> dict:
    return ctx.tracker.get("counters", {})


def _device_ms_per_call(ctx, span: str) -> Optional[float]:
    st = ctx.tracker.get("stages", {}).get(span)
    device_s = _counters(ctx).get(span + ".device_s")
    return device_s * 1e3 / st["calls"] if st and st["calls"] and device_s is not None else None


def encoder_ms(ctx) -> Optional[float]:
    """Device ms of one encoder pass (the span ``decode.encoder``: one
    device batch)."""
    return _device_ms_per_call(ctx, "decode.encoder")


def prefill_ms(ctx) -> Optional[float]:
    """Device ms of one decode's prefill (the span ``decode.prefill``: the
    cross-KV and its int8 quantize, the buffers' start, the eager prefill
    pass, the no-speech probabilities)."""
    return _device_ms_per_call(ctx, "decode.prefill")


def step_replay_ms(ctx) -> Optional[float]:
    """Device ms of one replayed decode step: ``step_replay_device_s`` over
    ``step_replays``."""
    c = _counters(ctx)
    n, device_s = c.get("step_replays"), c.get("step_replay_device_s")
    return device_s * 1e3 / n if n and device_s is not None else None


def step_gap(ctx) -> Optional[float]:
    """The share of the step loops' device time outside the replays, %:
    1 − ``step_replay_device_s`` / ``step_loop_device_s`` (the device waits
    for the host's read of each step and its next launch)."""
    c = _counters(ctx)
    loop_s, replay_s = c.get("step_loop_device_s"), c.get("step_replay_device_s")
    return 100.0 * (1.0 - replay_s / loop_s) if loop_s and replay_s is not None else None


def graph_builds(ctx) -> Optional[float]:
    """Step graphs warmed up or captured in the window (``graph_warmups``
    + ``graph_captures``). A program that counts its steps
    (``step_replays``) counts its builds too, so a window with the one and
    not the others built none."""
    c = _counters(ctx)
    if "step_replays" not in c:
        return None
    return c.get("graph_warmups", 0.0) + c.get("graph_captures", 0.0)


def _batcher_delta(ctx, key: str) -> Optional[float]:
    if ctx.batcher_before is None or ctx.batcher_after is None or key not in ctx.batcher_after:
        return None
    return ctx.batcher_after[key] - ctx.batcher_before.get(key, 0.0)


def _per_request_ms(ctx, key: str) -> Optional[float]:
    n, wait_s = _batcher_delta(ctx, "requests"), _batcher_delta(ctx, key)
    return wait_s * 1e3 / n if n and wait_s is not None else None


def drain_wait_ms(ctx) -> Optional[float]:
    """Mean ms from a request's submission until the batcher's drain takes
    it (the batcher's ``drain_wait_s``)."""
    return _per_request_ms(ctx, "drain_wait_s")


def bucket_wait_ms(ctx) -> Optional[float]:
    """Mean ms from the drain until the request's duration bucket's
    ``transcribe_many`` call starts, behind the drain's earlier buckets
    (the batcher's ``bucket_wait_s``)."""
    return _per_request_ms(ctx, "bucket_wait_s")
