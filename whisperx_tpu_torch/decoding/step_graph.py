"""The decode step as one captured CUDA graph, replayed once per token.

Counterpart of the JAX package's ``lax.while_loop`` decodes
(``whisperx_tpu/decoding/decode.py::_decode_jit``, ``beam.py::
_beam_decode_jit``, ``speculative.py::_spec_batch_jit``), which run every
step on the device with no host read. Here the host keeps the loop and its
one read per step (``finished.all()``, the beam banks' counts, or whether
a speculative row is still active), and each step is one replay of a graph
captured from the step's static body: about 1,600 launches from Python
become one (a speculative iteration's γ draft passes, verify pass and γ+1
acceptance steps too).

A step body reads and writes only static buffers, in place: the self-KV
cache, the cross-KV, the filter state and masks, the token buffer and the
loop's counters (``decode.py::_SampleBuffers``, ``beam.py::_BeamBuffers``,
``speculative.py::_SpecBuffers``). No Python value inside it depends on the
step number: the offset, the filter state's ``step`` and the token index
are device tensors. A graph does not keep alive what it reads: every tensor
a replay reads that the capture did not allocate is the decoder's (keyed
by ``weights_fingerprint``) or the entry's buffers'. The CPU, and the decodes that stay eager on the card
(tensor-parallel ones), run the same body uncaptured, on buffers of their
own. A data-parallel split captures as a single-card decode does: each
replica's decode checks out an entry of its own, and replicas on one
device share its decoder and cache.

On the card each decoder keeps a ``GraphCache``: up to ``MAX_ENTRIES``
idle ``StepGraph`` entries, the least recently used evicted first, each
checked out by one decode at a time, so two threads never replay one
entry's buffers at once. An entry's first step runs uncaptured on the
cache's capture stream (the warm-up: the kernels' nvcc build and their
``cudaFuncSetAttribute`` calls, cuBLAS's handle and its workspace for that
stream); its second is captured there (``capture_error_mode=
"thread_local"``, so other threads may go on working) and every step after
is a replay. A graph reads the decoder's weights by address, so the key
holds the address, dtype and shape of every decoder tensor: a quantized,
placed, moved or reloaded decoder misses, and the entries of its old
weights are dropped. The cache lives on the decoder and goes with it. A
step that reads more than one decoder (a speculative iteration: the
target's and the draft's) is keyed on the tensors of all of them, in the
cache its caller names.

Kernel launches are counted as on the eager path: during a capture the
wrappers' counts go to the entry's record (``ops.recording_launches``),
and each replay adds the record once (``ops.add_launches``); so do the
tracker's counters of ``ops.count_pass`` (the cross-attention passes by
route).

The tracker (``utils/metrics.py::GLOBAL_TRACKER``) counts each decode's
steps run through the runner (``step_replays``: the replays on the card,
every step on the CPU and in an uncaptured decode) and their device time
(``StepClock``), and the cache's ``graph_warmups``, ``graph_captures`` and
``graph_evictions``.

A failed capture or replay raises; there is no eager fallback on the card.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Callable, List, Optional

import torch

from whisperx_tpu_torch.ops import add_launches, recording_launches
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER, device_mark, mark_elapsed_s
from whisperx_tpu_torch.utils.precision import reference_matmul

MAX_ENTRIES = 4

# one warm-up or capture at a time in the process: both run on a cache's
# capture stream, and a capture must record only its own step's work
_CAPTURE_LOCK = threading.Lock()
_CACHE_LOCK = threading.Lock()  # makes each decoder's cache once


def _leaves(x) -> list:
    """The tensors of a nested structure: lists, tuples (``QuantizedKV``,
    ``FilterState``) and dataclasses (``KVCache``, the step buffers)."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _leaves(y)]
    if hasattr(x, "__dataclass_fields__"):
        return _leaves(list(vars(x).values()))
    return []


def tensor_bytes(x) -> int:
    """Bytes of the distinct tensors of ``x``: a tensor held twice (a
    ``self:N`` draft's cross-KV, the target's first layers) counts once."""
    return sum(t.numel() * t.element_size() for t in {id(t): t for t in _leaves(x)}.values())


class StepClock:
    """The device time of one decode's steps: a ``device_mark`` pair around
    each, from a pool of events kept for the next decode (on the card,
    made by the first decode that needs them), or the host clock on the
    CPU. ``commit`` adds ``step_replays`` to the tracker and, once the
    events can be read, ``step_replay_device_s`` (the pairs' sum) and
    ``step_loop_device_s`` (the first step's start to the last's end)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._marks: list = []
        self._unread = [False]  # whether the tracker still holds the marks
        self._stream = None  # the decode's stream, looked up once a decode
        self.n = 0

    def begin(self) -> None:
        if self._unread[0]:  # the last decode's events are not read yet
            self._marks, self._unread = [], [False]
        self.n = 0
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)

    def time(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` between two marks."""
        i = 2 * self.n
        if i + 2 > len(self._marks):
            self._marks.extend([None, None])
        m = self._marks
        m[i] = device_mark(self.device, m[i], self._stream)
        fn()
        m[i + 1] = device_mark(self.device, m[i + 1], self._stream)
        self.n += 1

    def commit(self) -> None:
        n, marks, unread = self.n, self._marks, self._unread
        GLOBAL_TRACKER.add("step_replays", n)
        if not n:
            return
        unread[0] = True

        def read():
            unread[0] = False
            return {
                "step_replay_device_s": sum(mark_elapsed_s(marks[2 * i], marks[2 * i + 1]) for i in range(n)),
                "step_loop_device_s": mark_elapsed_s(marks[0], marks[2 * n - 1]),
            }

        GLOBAL_TRACKER.add_later(marks[2 * n - 1], read)


class StepGraph:
    """One cache entry: a decode's static ``buffers`` and the graph of its
    step. ``launches`` is what one replay launches, ``(fn, attr) → n``;
    ``pool_bytes`` what its capture added to the reserved device memory:
    the graph's private pool (and whatever another thread allocated
    meanwhile)."""

    def __init__(self, key, buffers, stream: Optional["torch.cuda.Stream"] = None):
        self.key = key
        self.buffers = buffers
        self.stream = stream  # the cache's capture stream
        self.graph = None
        self.launches: dict = {}
        self.warmed = False
        self.done = None  # event after the last decode's work on the buffers
        self.nbytes = tensor_bytes(buffers)
        self.pool_bytes = 0
        self.clock = StepClock(stream.device if stream is not None else torch.device("cpu"))
        self.captures = self.replays = 0  # since checkout

    def step(self, body: Callable[[], None]) -> None:
        """One decode step: a replay. The entry's first step runs ``body``
        uncaptured on the capture stream (the warm-up), its second captures
        it there before the replay."""
        scope = (
            torch.cuda.device(self.stream.device) if self.stream is not None
            else contextlib.nullcontext()
        )
        with scope:
            if self.graph is None:
                with _CAPTURE_LOCK:
                    if not self.warmed:
                        self._warm_up(body)
                        return
                    self._capture(body)
            self.clock.time(self.graph.replay)
        add_launches(self.launches)
        self.replays += 1

    def _warm_up(self, body) -> None:
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), reference_matmul():
            body()
        current.wait_stream(self.stream)
        self.warmed = True
        GLOBAL_TRACKER.add("graph_warmups")

    def _capture(self, body) -> None:
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream())
        with recording_launches() as record, reference_matmul():
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                # read after the capture's start has emptied the allocator's cache
                reserved = torch.cuda.memory_reserved(self.stream.device)
                body()
        self.pool_bytes = torch.cuda.memory_reserved(self.stream.device) - reserved
        self.graph, self.launches = graph, record
        self.captures += 1
        GLOBAL_TRACKER.add("graph_captures")


class GraphCache:
    """A decoder's idle ``StepGraph`` entries, the most recently used first,
    at most ``max_entries``. ``checkout`` hands an entry to one decode,
    which gives it back with ``checkin``; an entry out is in no list, so no
    other decode can get it."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._idle: List[StepGraph] = []
        self._weights = None  # the fingerprint the idle entries were captured on
        self._stream = None
        self.captures = self.replays = 0  # over every checked-in decode

    def __reduce__(self):  # a copied or pickled model starts with no graphs
        return (GraphCache, (self.max_entries,))

    def checkout(self, weights, key, make: Callable[[], object], device: torch.device) -> StepGraph:
        """The idle entry of ``key`` captured on ``weights``, or a new one
        around ``make()``'s buffers. Entries of other weights are dropped."""
        entry = None
        with self._lock:
            if weights != self._weights:
                _evicted(len(self._idle))
                self._idle.clear()
                self._weights = weights
            for i, e in enumerate(self._idle):
                if e.key == key:
                    entry = self._idle.pop(i)
                    break
            if self._stream is None and device.type == "cuda":
                self._stream = torch.cuda.Stream(device)
        if entry is None:
            return StepGraph(key, make(), self._stream)
        if entry.done is not None:  # the last decode's reads of its outputs
            torch.cuda.current_stream(device).wait_event(entry.done)
        entry.captures = entry.replays = 0
        return entry

    def checkin(self, weights, entry: StepGraph) -> None:
        if entry.stream is not None:
            entry.done = torch.cuda.Event()
            entry.done.record(torch.cuda.current_stream(entry.stream.device))
        with self._lock:
            self.captures += entry.captures
            self.replays += entry.replays
            if weights != self._weights:
                _evicted(1)
                return  # captured on weights that are gone
            self._idle.insert(0, entry)
            _evicted(len(self._idle[self.max_entries:]))
            del self._idle[self.max_entries:]

    def stats(self) -> dict:
        """Captures and replays of the checked-in decodes, the idle entries,
        their static buffers' bytes and their graphs' pools' bytes."""
        with self._lock:
            return {
                "captures": self.captures,
                "replays": self.replays,
                "entries": len(self._idle),
                "static_bytes": sum(e.nbytes for e in self._idle),
                "pool_bytes": sum(e.pool_bytes for e in self._idle),
            }


def _evicted(n: int) -> None:
    if n:
        GLOBAL_TRACKER.add("graph_evictions", n)


def graph_cache(dec, attr: str = "_step_graphs") -> GraphCache:
    """The ``GraphCache`` held in the decoder module's attribute ``attr``,
    made at first use: by default its plain and beam decodes'."""
    cache = getattr(dec, attr, None)
    if cache is None:
        with _CACHE_LOCK:
            cache = getattr(dec, attr, None)
            if cache is None:
                cache = GraphCache()
                setattr(dec, attr, cache)
    return cache


def weights_fingerprint(*decs) -> tuple:
    """Name, address, dtype and shape of every tensor of the decoders, in
    order: what a captured step reads by address."""
    return tuple(
        (name, t.data_ptr(), t.dtype, tuple(t.shape))
        for dec in decs
        for name, t in itertools.chain(dec.named_parameters(), dec.named_buffers())
    )


def graph_key(dec, shape: tuple) -> tuple:
    """The cache key of a step: the decode's ``shape`` key (kind, rows,
    cache length, static configuration...) and the decoder's device and
    dtype (with the cache's kind, which ``shape`` holds, the dtype picks
    K3's route inside the step)."""
    return (*shape, dec.tok_emb.device, dec.tok_emb.dtype)


def graphable(model) -> bool:
    """Whether a decode of ``model`` replays captured steps: on CUDA, when
    no decoder block is split over devices (a tensor-parallel decode stays
    eager)."""
    dec = model.decoder
    return dec.tok_emb.is_cuda and all(blk.tp is None for blk in dec.blocks)


@contextlib.contextmanager
def step_runner(
    models: tuple, capture: bool, shape: tuple, make: Callable[[], object],
    cache: Optional[GraphCache] = None,
):
    """Yields ``(buffers, run)``: ``run(body)`` performs one decode step on
    ``buffers``. ``models``: the models whose decoders the step reads, the
    first the one it decodes. With ``capture`` and every model
    ``graphable``: a checked-out entry's buffers and its replay, from
    ``cache`` (by default the first decoder's own), keyed on every
    decoder's tensors; otherwise ``make()``'s buffers and ``body`` called as
    it is (the CPU, tensor-parallel decodes, the yardstick). The entry goes
    back to the cache only after a decode that raised nothing."""
    if not (capture and all(graphable(m) for m in models)):
        clock = StepClock(models[0].decoder.tok_emb.device)
        clock.begin()

        def run(body):
            with reference_matmul():
                clock.time(body)

        yield make(), run
        clock.commit()
        return
    dec = models[0].decoder
    cache = graph_cache(dec) if cache is None else cache
    weights = weights_fingerprint(*(m.decoder for m in models))
    entry = cache.checkout(weights, graph_key(dec, shape), make, dec.tok_emb.device)
    entry.clock.begin()
    yield entry.buffers, entry.step
    entry.clock.commit()
    cache.checkin(weights, entry)


def load_cache(cache, cross_k, cross_v) -> None:
    """A decode's start on its KV buffers: the self-KV zeroed (JAX's
    ``init_kv_cache_like``) and this decode's cross-KV copied in, unless the
    buffers are this decode's own tensors."""
    for t in _leaves([cache.self_k, cache.self_v]):
        t.zero_()
    for dst, src in zip((*cache.cross_k, *cache.cross_v), (*cross_k, *cross_v)):
        if dst is not src:
            for d, s in zip(_leaves(dst), _leaves(src)):
                d.copy_(s)
