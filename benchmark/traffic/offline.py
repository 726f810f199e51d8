"""Offline files: a closed loop of one file at a time through
``TranscriptionPipeline.transcribe``.

Parameters (the cell's ``params``): ``durations_s``, the files' lengths,
played in the listed order cycle after cycle (the same sequence for every
seed, so the batches a window holds do not change with it; the seed draws
each file's offset in the audio pool, and the weights); ``batch_size`` and
``sample_len``, the pipeline's rows per device batch and tokens per window.

The window starts with the first file. Files keep starting until the window
has closed; the one in flight then finishes. ``audio_s_per_s`` is the audio
of every file completed over the time from the window's start to the last
completion. A traced run profiles the window's third file whole; its
per-layer counters are read over the files before it.
"""

from __future__ import annotations

import time

import numpy as np

from harness import stats


def _file(ctx, rng, duration_s: float) -> dict:
    n = int(duration_s * 16000)
    offset = int(rng.integers(0, len(ctx.pool) - n))
    return {"offset": offset, "n": n}


def warm(ctx) -> None:
    """The shortest file: every shape the window uses (the device batch is
    always ``batch_size`` rows, padded; one captured decode step)."""
    rng = np.random.default_rng([ctx.seed, 0])
    f = _file(ctx, rng, min(ctx.workload["params"]["durations_s"]))
    ctx.pipeline.transcribe(ctx.audio(f))


def window(ctx) -> dict:
    durations = ctx.workload["params"]["durations_s"]
    rng = np.random.default_rng([ctx.seed, 2])
    start = time.perf_counter()
    end = start + ctx.seconds
    while time.perf_counter() < end or not ctx.requests:
        f = _file(ctx, rng, durations[len(ctx.requests) % len(durations)])
        f["due"] = time.perf_counter()
        with ctx.slice(len(ctx.requests) == 2):
            try:
                f["result"] = ctx.pipeline.transcribe(ctx.audio(f))
            except Exception as e:  # a failed file counts, and the loop goes on
                f["error"] = f"{type(e).__name__}: {e}"
        f["done"] = time.perf_counter()
        ctx.requests.append(f)
    ends = [f["done"] for f in ctx.requests]
    ctx.window_s = max(ends) - start
    work = sum(f["n"] for f in ctx.requests if not f.get("error")) / 16000
    return {"audio_s_per_s": stats.rate(work, start, ends)}
