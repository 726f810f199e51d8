"""Continuous batching for transcription serving.

Counterpart of ``whisperx_tpu/serve/batching.py``: a host-side scheduler
feeding padded device batches (reference backends/mlx_continuous_batching.py:
priority request queue :41-92, length bucketing :94-153, memory-aware
splitting :229-237). The duration buckets decide which requests share one
``transcribe_many`` call, and so which chunks share a device batch: they are
part of the result, and kept as in JAX.

The reference's queue-depth DynamicBatchScheduler (:394-418) is
deliberately NOT replicated: depth sampled at drain time under-reads
concurrent bursts (peers haven't enqueued yet), and here the serving
batch size only caps how many REQUESTS coalesce — device shapes come
from the pipeline's own batch size. The anchored straggler window in
``RequestQueue.get_batch`` subsumes it: batch fill adapts to arrival
rate with a hard per-request latency bound.

A request's wait before its ``transcribe_many`` call (``stats``'
``total_wait_s``) is two waits, each a span of the tracker
(``utils/metrics.py::GLOBAL_TRACKER``) and a key of ``stats``:
``serve.drain_wait`` / ``drain_wait_s``, from its submission until the
worker's drain takes it, and ``serve.bucket_wait`` / ``bucket_wait_s``,
from then until its duration bucket's call starts, behind the drain's
earlier buckets. ``serve.call`` is the call. The three carry the request's
and the call's ids in the tracker's records.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER


@dataclass(order=True)
class TranscriptionRequest:
    priority: int
    seq: int = field(compare=True)
    audio: np.ndarray = field(compare=False, default=None)
    request_id: str = field(compare=False, default="")
    submitted_at: float = field(compare=False, default=0.0)
    callback: Optional[Callable] = field(compare=False, default=None)
    result: Any = field(compare=False, default=None)
    done: threading.Event = field(compare=False, default_factory=threading.Event)
    # per-request decode options (language/task/prompt); None = pipeline
    # default
    language: Optional[str] = field(compare=False, default=None)
    task: Optional[str] = field(compare=False, default=None)
    initial_prompt: Optional[str] = field(compare=False, default=None)


@dataclass
class BatchConfig:
    max_batch_size: int = 8
    max_wait_ms: float = 100.0
    # duration bucket boundaries in seconds (reference :100-138)
    bucket_boundaries: tuple = (5.0, 10.0, 20.0, 30.0, 60.0)
    # how long stop() waits for the worker to exit before giving up
    # (a large-v3 decode with kernel builds can run minutes; callers fall
    # back to inline draining while the old worker winds down)
    stop_join_s: float = 5.0
    # backpressure: submit() raises QueueFullError past this many pending
    # requests (0 = unbounded). 1024 pending 30 s f32 clips ≈ 2 GB of
    # host audio — bound it rather than OOM under a flood.
    max_queue_depth: int = 1024


class QueueFullError(RuntimeError):
    """Backpressure signal: the request queue is at max_queue_depth.
    Callers should shed the request (HTTP 503 + Retry-After) instead of
    letting an unbounded queue absorb a flood until the host OOMs."""


class RequestQueue:
    """Thread-safe priority queue (lower priority value = served first)."""

    def __init__(self):
        self._heap: List[TranscriptionRequest] = []
        self._cond = threading.Condition()
        self._counter = itertools.count()

    def put(
        self, request: TranscriptionRequest, max_depth: int = 0
    ) -> None:
        """Enqueue; with ``max_depth`` > 0, raise QueueFullError instead
        of growing past it (internal sentinels pass 0 to bypass)."""
        with self._cond:
            if max_depth and len(self._heap) >= max_depth:
                raise QueueFullError(
                    f"request queue at capacity ({max_depth})"
                )
            heapq.heappush(self._heap, request)
            self._cond.notify()

    def get_batch(
        self, max_size: int, max_wait_s: float,
        initial_wait_s: Optional[float] = None,
    ) -> List[TranscriptionRequest]:
        """Block until at least one request, then drain up to max_size
        (waiting at most max_wait_s for stragglers).

        ``initial_wait_s`` bounds the initial block-for-work wait: when the
        queue stays empty that long, return [] instead of blocking forever
        (used by the workerless inline-drain path, where another thread may
        have drained this caller's request already). None = block forever
        (the dedicated worker, which is unblocked by a sentinel on stop).

        The straggler window is anchored at the OLDEST pending request's
        submission time, not at drain start: a request that already aged
        in the queue while the worker decoded the previous batch drains
        immediately (no second max_wait_s of added latency), while a
        concurrent burst — peers arriving within max_wait_s of the first
        submit — still coalesces."""
        with self._cond:
            if initial_wait_s is None:
                while not self._heap:
                    self._cond.wait()
            else:
                empty_deadline = time.monotonic() + initial_wait_s
                while not self._heap:
                    remaining = empty_deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._cond.wait(timeout=remaining)
            anchor = min(r.submitted_at for r in self._heap)
            deadline = anchor + max_wait_s
            while len(self._heap) < max_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    break
            batch = []
            while self._heap and len(batch) < max_size:
                batch.append(heapq.heappop(self._heap))
            return batch

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)


def bucket_requests(
    requests: List[TranscriptionRequest], boundaries
) -> Dict[int, List[TranscriptionRequest]]:
    """Group requests by duration bucket; sort within bucket by length so
    padded batches waste minimal compute (reference :100-138)."""
    buckets: Dict[int, List[TranscriptionRequest]] = {}
    for r in requests:
        dur = len(r.audio) / SAMPLE_RATE
        b = next(
            (i for i, bound in enumerate(boundaries) if dur <= bound),
            len(boundaries),
        )
        buckets.setdefault(b, []).append(r)
    for reqs in buckets.values():
        reqs.sort(key=lambda r: len(r.audio))
    return buckets


class ContinuousBatcher:
    """Serving loop: queue → bucketed padded batches → pooled decode.

    When ``pipeline`` exposes ``transcribe_many`` (TranscriptionPipeline
    does), chunks from ALL requests in a bucket share one decode stream —
    true cross-request coalescing, not per-request batching. Otherwise it
    falls back to per-request ``transcribe(audio, batch_size=...)``.
    """

    def __init__(self, pipeline, config: Optional[BatchConfig] = None):
        self.pipeline = pipeline
        self.config = config or BatchConfig()
        self.queue = RequestQueue()
        # writers (the worker AND concurrent workerless drainers) hold
        # _stats_lock around read-modify-write updates; readers take a
        # locked copy via stats_snapshot()
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "errors": 0,
            "total_audio_s": 0.0,
            "total_wall_s": 0.0,
            "total_wait_s": 0.0,
            "drain_wait_s": 0.0,
            "bucket_wait_s": 0.0,
        }
        self._seq = itertools.count()
        self._calls = itertools.count()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    # -- public API --------------------------------------------------------

    def submit(
        self,
        audio: np.ndarray,
        priority: int = 10,
        request_id: str = "",
        callback: Optional[Callable] = None,
        language: Optional[str] = None,
        task: Optional[str] = None,
        initial_prompt: Optional[str] = None,
    ) -> TranscriptionRequest:
        req = TranscriptionRequest(
            priority=priority,
            seq=next(self._seq),
            audio=np.asarray(audio, np.float32),
            request_id=request_id,
            submitted_at=time.monotonic(),
            callback=callback,
            language=language,
            task=task,
            initial_prompt=initial_prompt,
        )
        # the stop sentinel must always land (it unblocks the worker's
        # queue wait), so it bypasses the depth cap
        max_depth = (
            0 if request_id == "__stop__" else self.config.max_queue_depth
        )
        self.queue.put(req, max_depth=max_depth)
        return req

    def transcribe(self, audio: np.ndarray, timeout: Optional[float] = None,
                   priority: int = 10, language: Optional[str] = None,
                   task: Optional[str] = None,
                   initial_prompt: Optional[str] = None):
        req = self.submit(audio, priority=priority, language=language,
                          task=task, initial_prompt=initial_prompt)
        # no live worker (never started, stopped, or stopping): drain
        # inline — but a CONCURRENT workerless caller may drain this
        # request into ITS batch, so never block forever on an empty
        # queue; once the queue stays empty, the request is in someone's
        # in-flight batch and done.wait below is the correct place to park
        while not self._worker_live() and not req.done.is_set():
            if not self._drain_once(initial_wait_s=0.05):
                break
        if not req.done.wait(timeout):
            raise TimeoutError("transcription request timed out")
        return req.result

    def start(self) -> None:
        if self._worker is not None:
            if self._worker.is_alive() and not self._stop.is_set():
                return  # already running
            # a stop() was requested (or the thread already exited): wait
            # for the old worker to fully exit before replacing it — two
            # live workers would drive the device concurrently
            self._worker.join()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True
        )
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        # snapshot: stop() runs concurrently on shutdown (the SIGTERM
        # handler's shutdown() races serve_forever's finally), and the
        # other caller may null self._worker between our checks
        w = self._worker
        if w is not None:
            # unblock the queue wait
            self.submit(np.zeros(160, np.float32), priority=10**9, request_id="__stop__")
            w.join(timeout=self.config.stop_join_s)
            # mid-decode (a first call builds the kernels) the join can
            # time out; keep the handle so a later start() finishes the
            # join instead of spawning a second worker
            if not w.is_alive():
                self._worker = None

    # -- internals ---------------------------------------------------------

    def _worker_live(self) -> bool:
        """Whether a dedicated worker will drain new submissions. False
        once stop() is requested — even if the old worker's join timed
        out mid-decode — so transcribe() falls back to inline draining
        instead of parking forever behind a dying worker."""
        w = self._worker
        return w is not None and w.is_alive() and not self._stop.is_set()

    def _run(self, stop: threading.Event) -> None:
        # `stop` is THIS worker's event, passed by value: a stop()/start()
        # cycle creates a fresh Event, so clearing it can never revive a
        # previous worker's loop
        while not stop.is_set():
            self._drain_once()

    def _drain_once(self, initial_wait_s: Optional[float] = None) -> bool:
        """Drain and decode one coalesced batch; returns whether any
        request was processed."""
        batch = self.queue.get_batch(
            self.config.max_batch_size, self.config.max_wait_ms / 1000.0,
            initial_wait_s=initial_wait_s,
        )
        drained = time.monotonic()
        batch = [r for r in batch if r.request_id != "__stop__"]
        if not batch:
            return False
        # the tracker's records are on perf_counter's clock, these times on
        # monotonic's
        shift = time.perf_counter() - time.monotonic()
        buckets = bucket_requests(batch, self.config.bucket_boundaries)
        for reqs in buckets.values():
            call = next(self._calls)
            t0 = time.monotonic()
            try:
                # NOTE: the DEVICE decode batch size is the pipeline's own
                # batch_size; max_batch_size only caps how many REQUESTS
                # coalesce per serving batch — don't conflate them here.
                with GLOBAL_TRACKER.ids(call=call):
                    if hasattr(self.pipeline, "transcribe_many"):
                        # cross-request coalescing: one pooled chunk stream
                        # fills shared device batches, results demuxed per
                        # request; per-request language/task ride along
                        results = self.pipeline.transcribe_many(
                            [r.audio for r in reqs],
                            language=[r.language for r in reqs],
                            task=[r.task for r in reqs],
                            initial_prompt=[r.initial_prompt for r in reqs],
                        )
                    else:
                        results = [
                            self.pipeline.transcribe(
                                r.audio, language=r.language, task=r.task,
                                initial_prompt=r.initial_prompt,
                            )
                            for r in reqs
                        ]
            except Exception as e:
                # fail the batch's requests, never the worker thread: a bad
                # request (or transient decode error) must not hang every
                # later caller behind a dead worker
                err = {"error": f"{type(e).__name__}: {e}"}
                for req in reqs:
                    req.result = err
                    req.done.set()
                with self._stats_lock:
                    self.stats["errors"] += len(reqs)
                continue
            t1 = time.monotonic()
            wait_s = drain_s = bucket_s = audio_s = 0.0
            for req, result in zip(reqs, results):
                req.result = result
                req.done.set()
                if req.callback:
                    req.callback(result)
                audio_s += len(req.audio) / SAMPLE_RATE
                wait_s += t0 - req.submitted_at
                drain_s += drained - req.submitted_at
                bucket_s += t0 - drained
                ids = {"request": req.request_id or req.seq, "call": call}
                GLOBAL_TRACKER.observe("serve.drain_wait", drained - req.submitted_at,
                                       start=req.submitted_at + shift, **ids)
                GLOBAL_TRACKER.observe("serve.bucket_wait", t0 - drained, start=drained + shift, **ids)
                GLOBAL_TRACKER.observe("serve.call", t1 - t0, start=t0 + shift, **ids)
            # += is a read-modify-write: concurrent workerless drainers
            # would lose updates without the lock
            with self._stats_lock:
                self.stats["requests"] += len(reqs)
                self.stats["total_audio_s"] += audio_s
                self.stats["total_wait_s"] += wait_s
                self.stats["drain_wait_s"] += drain_s
                self.stats["bucket_wait_s"] += bucket_s
                self.stats["batches"] += 1
                self.stats["total_wall_s"] += time.monotonic() - t0
        return True

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._stats_lock:
            return self.stats.copy()

    @property
    def throughput_rtf(self) -> float:
        """Seconds of audio served per second the worker spent in its calls
        (``total_wall_s``, the busy time alone): not a rate over time,
        which also counts the time the worker waited for requests."""
        snap = self.stats_snapshot()
        w = snap["total_wall_s"]
        return snap["total_audio_s"] / w if w > 0 else 0.0
