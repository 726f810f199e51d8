"""Offline files with word times: ``offline.py``'s closed loop (the same
files, order, seeds, window, rate and profiled third file), each file
through ``TranscriptionPipeline.transcribe`` and then
``alignment.align(result["segments"], aligner, metadata, audio, ...)`` with
the configuration's aligner and its ``align`` section's
``interpolate_method``, always with ``return_char_alignments=True``: the
check reads each served path back from its characters' times. A file
completes when its alignment has returned; a traced run's profiled file
holds both stages.

The file's result is the transcription's, with the alignment's under
``aligned``: the check reads the transcript's tokens and the aligned
characters' times and scores (``check.compare_alignment``). Under
``stage_s`` it holds the host seconds of the two calls (each returns its
results on the host, so each has waited for its device work), for the
per-layer readers of a cell that aligns.
"""

from __future__ import annotations

import os
import time

import numpy as np

from harness import spec

_offline = spec.traffic("offline", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Words:
    """The pipeline as ``offline.py`` drives it, with each file aligned
    after its transcription."""

    def __init__(self, ctx):
        self.pipeline, self.ctx = ctx.pipeline, ctx
        self.aligner, self.metadata = ctx.aligner
        self.interpolate_method = ctx.config["align"]["interpolate_method"]

    def transcribe(self, audio: np.ndarray) -> dict:
        from whisperx_tpu_torch import alignment

        t0 = time.perf_counter()
        result = self.pipeline.transcribe(audio)
        t1 = time.perf_counter()
        aligned = alignment.align(result["segments"], self.aligner, self.metadata, audio,
                                  device=str(self.ctx.device),
                                  interpolate_method=self.interpolate_method, return_char_alignments=True)
        stage_s = {"transcribe": t1 - t0, "align": time.perf_counter() - t1}
        return {**result, "aligned": aligned, "stage_s": stage_s}


def _driving(ctx, drive):
    inner = ctx.pipeline
    ctx.pipeline = _Words(ctx)
    try:
        return drive(ctx)
    finally:
        ctx.pipeline = inner


def warm(ctx) -> None:
    """``offline.py``'s warm-up file, aligned too, and one emissions pass
    of the aligner at each sample bucket up to a 30 s window's."""
    _driving(ctx, _offline.warm)
    aligner = ctx.aligner[0]
    bucket = 4096
    while bucket < 2 * 30 * 16000:
        aligner.emissions(np.zeros(bucket, np.float32))
        bucket *= 2


def window(ctx) -> dict:
    return _driving(ctx, _offline.window)
