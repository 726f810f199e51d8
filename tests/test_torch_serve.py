"""The port's serving core (``whisperx_tpu_torch.serve``: ring buffer,
chunker, request queue, batcher, streaming transcriber, incremental
decoder, speaker registry) against the JAX package's.

The scenarios of ``tests/test_serve.py`` that use a fake pipeline run
against the port's classes; on f32 ``test-nano`` with the JAX package's
weights bridged through one checkpoint, the incremental decoder's tokens,
a stream's final entries, online speaker labels and the streaming warm-up's
call count must equal the JAX package's. Last, the three thread-safety
repairs that serving needs: the shared precision scopes, one build per
kernel source, and launch counts that lose nothing.
"""

import dataclasses
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_speech
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from whisperx_tpu_torch.serve import (
    AudioRingBuffer,
    BatchConfig,
    ContinuousBatcher,
    RequestQueue,
    SpeakerRegistry,
    StreamingChunker,
    StreamingConfig,
    StreamingTranscriber,
    TranscriptionRequest,
    bucket_requests,
)

OPTS = {"temperatures": (0.0,), "sample_len": 16}


@pytest.fixture(autouse=True, scope="module")
def fresh_tokenizer_caches():
    """Both packages memoize tokenizers process-wide, and a tokenizer warns
    only when it is built: leave the caches empty for the next module of
    this worker, as a fresh process has them."""
    yield
    from whisperx_tpu.decoding import tokenizer as jtok
    from whisperx_tpu_torch.decoding import tokenizer as ttok

    jtok._cached_tokenizer.cache_clear()
    ttok._cached_tokenizer.cache_clear()


class FakePipeline:
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def transcribe(self, audio, batch_size=8, **kw):
        self.calls.append(len(audio))
        return {
            "segments": [{"start": 0.0, "end": len(audio) / 16000, "text": "ok"}],
            "language": "en",
        }


class FakeCoalescingPipeline(FakePipeline):
    def __init__(self):
        super().__init__()
        self.many_calls = []

    def transcribe_many(self, audios, batch_size=8, **kw):
        self.many_calls.append(len(audios))
        return [
            {
                "segments": [{"start": 0.0, "end": len(a) / 16000, "text": f"len{len(a)}"}],
                "language": "en",
            }
            for a in audios
        ]


# -- ring buffer, queue, buckets ---------------------------------------------


@pytest.mark.parametrize(
    "capacity, writes, reads, want",
    [
        # wraparound: 60 in, 50 out, 80 more wrap past the end
        (100, [range(60), range(100, 180)], [50, None],
         [list(range(50)), list(range(50, 60)) + list(range(100, 180))]),
        # overflow keeps the newest samples
        (10, [range(25)], [None], [list(range(15, 25))]),
    ],
    ids=["wraparound", "overflow keeps newest"],
)
def test_ring_buffer(capacity, writes, reads, want):
    buf = AudioRingBuffer(capacity)
    got = []
    for i, w in enumerate(writes):
        buf.write(np.array(list(w), np.float32))
        if i < len(reads) - 1:
            got.append(buf.read(reads[i]).tolist())
    got.append(buf.read(reads[-1]).tolist())
    assert got == want
    assert len(buf) == 0


def test_ring_buffer_peek_does_not_consume():
    buf = AudioRingBuffer(10)
    buf.write(np.arange(5, dtype=np.float32))
    assert buf.peek().tolist() == [0, 1, 2, 3, 4]
    assert len(buf) == 5


def test_request_queue_priority_order():
    q = RequestQueue()
    for prio, rid in [(5, "b"), (1, "a"), (9, "c")]:
        q.put(TranscriptionRequest(priority=prio, seq=prio, audio=np.zeros(10), request_id=rid))
    assert [r.request_id for r in q.get_batch(3, 0.01)] == ["a", "b", "c"]


def test_request_queue_aged_request_drains_immediately():
    """The straggler window anchors at the oldest pending submission: a
    request that already waited must not pay another max_wait_s."""
    q = RequestQueue()
    q.put(TranscriptionRequest(
        priority=5, seq=0, audio=np.zeros(10), request_id="aged",
        submitted_at=time.monotonic() - 1.0,
    ))
    t0 = time.monotonic()
    batch = q.get_batch(8, max_wait_s=0.2)
    assert [r.request_id for r in batch] == ["aged"]
    assert time.monotonic() - t0 < 0.15


def test_request_queue_fresh_burst_still_coalesces():
    q = RequestQueue()
    q.put(TranscriptionRequest(
        priority=5, seq=0, audio=np.zeros(10), request_id="first",
        submitted_at=time.monotonic(),
    ))

    def late_peer():
        time.sleep(0.1)
        q.put(TranscriptionRequest(
            priority=5, seq=1, audio=np.zeros(10), request_id="peer",
            submitted_at=time.monotonic(),
        ))

    t = threading.Thread(target=late_peer)
    t.start()
    batch = q.get_batch(2, max_wait_s=2.0)
    t.join()
    assert sorted(r.request_id for r in batch) == ["first", "peer"]


def test_request_queue_initial_wait_returns_empty():
    q = RequestQueue()
    t0 = time.monotonic()
    assert q.get_batch(4, 0.01, initial_wait_s=0.05) == []
    assert time.monotonic() - t0 < 1.0


def test_bucket_requests_by_duration():
    """The (20, 30] s bucket holds 21, 25 and 29 s together (the serving
    phase of chip_smoke.py relies on it)."""
    reqs = [
        TranscriptionRequest(0, i, audio=np.zeros(int(d * 16000)))
        for i, d in enumerate([2.0, 8.0, 25.0, 3.0, 21.0, 29.0])
    ]
    buckets = bucket_requests(reqs, BatchConfig().bucket_boundaries)
    durations = {b: [len(r.audio) / 16000 for r in rs] for b, rs in buckets.items()}
    assert durations == {0: [2.0, 3.0], 1: [8.0], 3: [21.0, 25.0, 29.0]}


# -- the batcher --------------------------------------------------------------


def test_continuous_batcher_sync():
    batcher = ContinuousBatcher(FakePipeline(), BatchConfig(max_wait_ms=5))
    result = batcher.transcribe(np.zeros(16000, np.float32), timeout=10)
    assert result["segments"][0]["text"] == "ok"
    assert batcher.stats["requests"] == 1
    assert batcher.throughput_rtf > 0


def test_continuous_batcher_threaded():
    batcher = ContinuousBatcher(FakePipeline(), BatchConfig(max_wait_ms=5))
    batcher.start()
    reqs = [batcher.submit(np.zeros(8000, np.float32)) for _ in range(5)]
    for r in reqs:
        assert r.done.wait(timeout=20)
    batcher.stop()
    assert batcher.stats_snapshot()["requests"] >= 5


def test_workerless_concurrent_transcribe_no_deadlock():
    """Two workerless callers: one drains both requests; the other must
    get its result instead of blocking forever inside get_batch."""
    batcher = ContinuousBatcher(FakePipeline(), BatchConfig(max_wait_ms=300))
    results = {}

    def call(name):
        results[name] = batcher.transcribe(np.zeros(16000, np.float32), timeout=30)

    threads = [threading.Thread(target=call, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "workerless caller deadlocked"
    assert results["a"]["segments"] and results["b"]["segments"]


def test_stop_timeout_keeps_serving_inline():
    """stop() whose join times out (worker stuck mid-decode) must not wedge
    transcribe(): callers fall back to inline draining."""
    entered, release, calls = threading.Event(), threading.Event(), []

    class SlowPipeline:
        def transcribe(self, audio, batch_size=8, **kw):
            calls.append(len(audio))
            if len(calls) == 1:
                entered.set()
                release.wait(10)
            return {"segments": [{"start": 0.0, "end": 1.0, "text": "ok"}], "language": "en"}

    batcher = ContinuousBatcher(SlowPipeline(), BatchConfig(max_wait_ms=5, stop_join_s=0.1))
    batcher.start()
    req_a = batcher.submit(np.zeros(16000, np.float32))
    assert entered.wait(10)
    batcher.stop()
    t0 = time.monotonic()
    r = batcher.transcribe(np.zeros(8000, np.float32), timeout=10)
    assert r["segments"][0]["text"] == "ok"
    assert time.monotonic() - t0 < 5
    release.set()
    assert req_a.done.wait(10)
    batcher.start()
    batcher.stop()


def test_stop_then_start_single_worker():
    batcher = ContinuousBatcher(FakePipeline(), BatchConfig(max_wait_ms=5))
    batcher.start()
    first = batcher._worker
    batcher.stop()
    batcher.start()
    second = batcher._worker
    assert second is not first and second.is_alive()
    assert not first.is_alive()
    assert batcher.transcribe(np.zeros(8000, np.float32), timeout=20)["segments"][0]["text"] == "ok"
    batcher.stop()


def test_concurrent_stop_is_safe():
    b = ContinuousBatcher(FakePipeline(), BatchConfig(max_wait_ms=5))
    b.start()
    errs = []

    def s():
        try:
            b.stop()
        except Exception as e:  # pragma: no cover - the fault under test
            errs.append(e)

    ts = [threading.Thread(target=s) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs


def test_batcher_coalesces_across_requests():
    """Requests of one bucket go through ONE transcribe_many call, with
    per-request language/task/prompt lists and per-request results."""
    pipe = FakeCoalescingPipeline()
    seen = []
    real = pipe.transcribe_many
    pipe.transcribe_many = lambda audios, **kw: (seen.append(kw), real(audios, **kw))[1]
    batcher = ContinuousBatcher(pipe, BatchConfig(max_wait_ms=200))
    reqs = [
        batcher.submit(np.zeros(16000 + i, np.float32), language=["en", None, "de", "fr"][i])
        for i in range(4)
    ]
    batcher.start()
    for r in reqs:
        assert r.done.wait(timeout=20)
    batcher.stop()
    assert pipe.calls == [] and pipe.many_calls[0] == 4
    assert seen[0]["language"] == ["en", None, "de", "fr"]
    assert seen[0]["task"] == [None] * 4 and seen[0]["initial_prompt"] == [None] * 4
    for r in reqs:
        assert r.result["segments"][0]["text"] == f"len{len(r.audio)}"


def test_batcher_wait_is_drain_wait_and_bucket_wait(tmp_path):
    """One drain of a 3 s and an 8 s clip makes two calls, one per duration
    bucket: each request's wait before its call is its wait for the drain
    plus its wait behind the drain's earlier buckets (``drain_wait_s`` +
    ``bucket_wait_s`` == ``total_wait_s``), and the second bucket's request
    waited out the first call. The tracker's records carry each request's
    and call's ids."""
    from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

    pipe = FakeCoalescingPipeline()
    real = pipe.transcribe_many
    pipe.transcribe_many = lambda audios, **kw: (time.sleep(0.05), real(audios, **kw))[1]
    batcher = ContinuousBatcher(pipe, BatchConfig(max_wait_ms=0))
    GLOBAL_TRACKER.reset()
    GLOBAL_TRACKER.record_spans()
    try:
        reqs = [batcher.submit(np.zeros(n * 16000, np.float32), request_id=f"r{n}") for n in (3, 8)]
        time.sleep(0.02)
        assert batcher._drain_once(initial_wait_s=1.0)
        GLOBAL_TRACKER.write_spans(str(tmp_path / "spans.json"))
    finally:
        GLOBAL_TRACKER.record_spans(None)
    assert pipe.many_calls == [1, 1] and all(r.done.is_set() for r in reqs)
    st = batcher.stats_snapshot()
    assert st["drain_wait_s"] + st["bucket_wait_s"] == pytest.approx(st["total_wait_s"], rel=1e-12)
    assert st["drain_wait_s"] >= 2 * 0.02
    events = json.load(open(tmp_path / "spans.json"))["traceEvents"]
    waits = {(e["name"], e["args"]["request"]): (e["dur"] / 1e6, e["args"]["call"]) for e in events}
    assert waits[("serve.bucket_wait", "r3")][0] < 0.05 <= waits[("serve.bucket_wait", "r8")][0]
    assert [waits[("serve.call", r)][1] for r in ("r3", "r8")] == [0, 1]
    report = GLOBAL_TRACKER.report()
    assert {report[n]["calls"] for n in ("serve.drain_wait", "serve.bucket_wait", "serve.call")} == {2}
    GLOBAL_TRACKER.reset()


# -- the chunker and the streaming transcriber -------------------------------


@pytest.mark.parametrize(
    "pieces, max_latency, n_chunks",
    [
        ("speech 2 s + 1 s silence", 60.0, 1),  # flushes on silence
        ("13 x speech 5 s + 1 s silence", 60.0, 3),  # bursty push: <= 30 s pieces
        ("6 x speech 5 s + 200 samples", 60.0, None),  # forced: no tiny tail
    ],
)
def test_streaming_chunker(speech_5s, pieces, max_latency, n_chunks):
    cfg = StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=max_latency)
    chunker = StreamingChunker(cfg)
    sr = cfg.sample_rate
    audio = {
        "speech 2 s + 1 s silence": np.concatenate([speech_5s[:32000], np.zeros(16000, np.float32)]),
        "13 x speech 5 s + 1 s silence": np.concatenate([np.tile(speech_5s, 13), np.zeros(16000, np.float32)]),
        "6 x speech 5 s + 200 samples": np.concatenate([np.tile(speech_5s, 6), speech_5s[:200]]),
    }[pieces]
    chunks = chunker.push(audio)
    assert chunks
    if n_chunks is not None:
        assert len(chunks) == n_chunks
    assert all(int(cfg.min_chunk_seconds * sr) <= len(c) <= 30 * sr for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), audio)


def test_streaming_transcriber_sync(speech_5s):
    st = StreamingTranscriber(FakePipeline(), StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=0.0))
    st.feed(speech_5s[:16000])
    st.process_available()
    results = st.stop()
    assert results and results[-1]["end"] > 0


def test_max_latency_flush_without_new_feed(speech_5s):
    st = StreamingTranscriber(FakePipeline(), StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=5.0))
    st.feed(speech_5s[:32000])
    st.process_available()
    assert not st.results
    st.chunker._last_emit -= 6.0
    st.process_available()
    assert st.results and st.results[-1]["end"] == pytest.approx(2.0)


def test_streaming_final_decodes_bucket_to_whole_seconds(speech_5s):
    pipe = FakePipeline()
    st = StreamingTranscriber(pipe, StreamingConfig(min_chunk_seconds=0.2, max_latency_seconds=1.0))
    st.feed(speech_5s[: int(16000 * 2.37)])
    st.process_available()
    results = st.stop()
    assert pipe.calls and all(n % 16000 == 0 for n in pipe.calls), pipe.calls
    assert results and abs(results[-1]["end"] - 2.37) < 0.05


def test_streaming_feed_times_pruned(speech_5s):
    tr = StreamingTranscriber(FakePipeline(), StreamingConfig())
    piece = np.concatenate([speech_5s, np.zeros(16000, np.float32)])
    for start in range(0, len(piece), 800):
        tr.feed(piece[start:start + 800])
    assert len(tr._feed_times) > 100
    tr.process_available()
    assert tr._consumed > 0 and len(tr._feed_times) < 10


def test_streaming_segments_rebased_to_stream_clock():
    class WordPipeline(FakePipeline):
        def transcribe(self, audio, batch_size=8, **kw):
            return {
                "segments": [{
                    "start": 0.25, "end": min(0.75, len(audio) / 16000), "text": "hi",
                    "words": [{"word": " hi", "start": 0.3, "end": 0.6}, {"word": " ?"}],
                }],
                "language": "en",
            }

    st = StreamingTranscriber(WordPipeline(), StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=0.0))
    chunk = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    for _ in range(2):
        st.feed(chunk)
        st.process_available()
    finals = [r for r in st.stop() if not r["provisional"]]
    assert len(finals) >= 2
    s0, s1 = finals[0]["segments"][0], finals[1]["segments"][0]
    base1 = finals[1]["start"]
    assert s0["start"] == pytest.approx(0.25, abs=1e-3) and base1 > 0
    assert s1["start"] == pytest.approx(base1 + 0.25, abs=1e-3)
    assert s1["end"] <= finals[1]["end"] + 1e-6
    assert s1["words"][0]["start"] == pytest.approx(base1 + 0.3, abs=1e-3)
    assert "start" not in s1["words"][1]


def test_speaker_registry_identity_and_update():
    reg = SpeakerRegistry(threshold=0.5)
    a, b, a2 = np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0.95, 0.05, 0])
    assert [reg.assign(a, 2.0), reg.assign(b, 2.0), reg.assign(a2, 1.0)] == [0, 1, 0]
    assert len(reg.centroids) == 2
    assert abs(np.linalg.norm(reg.centroids[0]) - 1.0) < 1e-9
    capped = SpeakerRegistry(threshold=0.99, max_speakers=1)
    assert [capped.assign(a, 1.0), capped.assign(b, 1.0)] == [0, 0]


# -- parity with the JAX package on bridged test-nano weights -----------------


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    from whisperx_tpu.convert.checkpoint import save_checkpoint
    from whisperx_tpu.models.whisper.config import MODEL_DIMS
    from whisperx_tpu.models.whisper.model import init_params

    dims = MODEL_DIMS["test-nano"]
    path = str(tmp_path_factory.mktemp("nano_serve"))
    save_checkpoint(
        path, init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32),
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(dims)},
    )
    return path


@pytest.fixture(scope="module")
def pipelines(nano_ckpt):
    import whisperx_tpu
    import whisperx_tpu_torch

    kw = dict(compute_type="float32", vad_method="energy", asr_options=OPTS, language="en", batch_size=2)
    return {
        "jax": whisperx_tpu.load_model(nano_ckpt, device="cpu", **kw),
        "torch": whisperx_tpu_torch.load_model(nano_ckpt, device="cpu", **kw),
    }


def _serve(pkg):
    import importlib

    return importlib.import_module(f"{'whisperx_tpu' if pkg == 'jax' else 'whisperx_tpu_torch'}.serve.streaming")


@pytest.mark.parametrize(
    "budget, ends_s, seed",
    [
        (64, (2.0, 3.0, 3.5, 4.0, 4.0), 8),  # a growing utterance, then a repeat
        (48, (4.0,) * 6, 9),  # the committed prefix outgrows the budget
    ],
    ids=["growing", "outgrows budget 48"],
)
def test_incremental_decoder_matches_jax(pipelines, budget, ends_s, seed):
    """LocalAgreement partials: the same tokens and committed tokens at
    every step; the committed prefix never shrinks or mutates."""
    audio = synth_speech(5.0, seed=seed)
    steps = {}
    for pkg, pipe in pipelines.items():
        dec = _serve(pkg).IncrementalUtteranceDecoder(pipe.model, language="en", token_budget=budget)
        steps[pkg] = [dec.partial(audio[: int(e * 16000)]) for e in ends_s]
    assert steps["torch"] == steps["jax"]
    prev = []
    for info in steps["torch"]:
        stable = info["stable_tokens"]
        assert stable == info["tokens"][: len(stable)] and stable[: len(prev)] == prev
        prev = stable
    assert len(prev) > (16 if budget == 48 else 0)  # it did commit


def _stream_audio():
    """Speech with pauses: 3 s, 1 s of silence, 2.5 s, 1 s of silence, 1.7 s."""
    gap = np.zeros(16000, np.float32)
    return np.concatenate([synth_speech(3.0, seed=4), gap, synth_speech(2.5, seed=5), gap, synth_speech(1.7, seed=6)])


def test_streaming_finals_match_jax(pipelines):
    """A stream fed in 0.5 s pieces and drained after each: silence flushes
    (max latency out of reach, so no flush depends on the wall clock), then
    stop()'s tail. The final entries (text, times, segments, prompts) are
    the JAX package's, latency aside."""
    audio = _stream_audio()
    finals = {}
    for pkg, pipe in pipelines.items():
        mod = _serve(pkg)
        st = mod.StreamingTranscriber(pipe, mod.StreamingConfig(max_latency_seconds=1e9))
        for i in range(0, len(audio), 8000):
            st.feed(audio[i : i + 8000])
            st.process_available()
        finals[pkg] = [{k: v for k, v in r.items() if k != "latency_s"} for r in st.stop()]
    assert finals["torch"] == finals["jax"]
    assert len(finals["torch"]) >= 2 and finals["torch"][-1]["final"]
    ends = [0.0] + [r["end"] for r in finals["torch"]]
    assert [r["start"] for r in finals["torch"]] == ends[:-1]
    assert ends[-1] == pytest.approx(len(audio) / 16000)


def test_streaming_partials_arrive_before_stream_end(pipelines):
    """With partial_interval_seconds, provisional results arrive while the
    utterance grows, each with a latency; the same entries as JAX's."""
    speech = synth_speech(4.0, seed=6)
    seen = {}
    for pkg, pipe in pipelines.items():
        mod = _serve(pkg)
        st = mod.StreamingTranscriber(pipe, mod.StreamingConfig(
            min_chunk_seconds=0.25, max_latency_seconds=1e9, partial_interval_seconds=1.0,
            partial_token_budget=48,
        ))
        seen[pkg] = []
        st.on_result = seen[pkg].append
        for i in range(0, len(speech), 8000):
            st.feed(speech[i : i + 8000])
            st.process_available()
        assert [r for r in seen[pkg] if r["provisional"]], pkg
        assert all(r["latency_s"] >= 0 for r in seen[pkg])
        results = st.stop()
        assert results[-1]["final"] and "partial_mean_s" in st.latency_stats()
        seen[pkg] = [{k: v for k, v in r.items() if k != "latency_s"} for r in results]
    assert seen["torch"] == seen["jax"]


def test_streaming_prompt_tokens_match_jax(pipelines):
    """Prev-text prompts are exactly PROMPT_TOKENS token ids once enough
    text has accumulated (None before), the JAX package's ids."""
    got = {}
    for pkg, pipe in pipelines.items():
        st = _serve(pkg).StreamingTranscriber(pipe)
        st._prev_text = "short"
        first = st._prompt_tokens()
        st._prev_text = " ".join(["conditioning"] * 60)
        got[pkg] = (first, st._prompt_tokens())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] is None and len(got["torch"][1]) == StreamingTranscriber.PROMPT_TOKENS


def test_transcribe_takes_a_prompt_token_list(pipelines):
    """``_emit`` passes the prompt as a token list; the port's pipeline
    takes it as JAX's does, with the same segments."""
    audio = synth_speech(3.0, seed=2)
    prompt = list(range(300, 300 + StreamingTranscriber.PROMPT_TOKENS))
    got = {pkg: p.transcribe(audio, initial_prompt=prompt) for pkg, p in pipelines.items()}
    assert got["torch"] == got["jax"] and got["torch"]["segments"]


def _two_voices():
    sr = 16000
    t = np.arange(sr) / sr
    low = (0.4 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    high = (
        0.3 * np.sin(2 * np.pi * 2400 * t) + 0.05 * np.random.default_rng(0).standard_normal(len(t))
    ).astype(np.float32)
    return low, high


def test_streaming_online_diarization_matches_jax():
    """config.diarize tags chunk-finals with labels that stay consistent
    across chunks (the port reads its diarizer's TurnTable, built on the
    pipeline's device): the same voice keeps its label, another voice gets
    a new one, and the labels are the JAX package's."""
    low, high = _two_voices()
    labels = {}
    for pkg in ("jax", "torch"):
        mod = _serve(pkg)
        st = mod.StreamingTranscriber(
            FakePipeline(),
            mod.StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=0.0, diarize=True),
        )
        for chunk in (low, high, low):
            st.feed(chunk)
            st.process_available()
        finals = [r for r in st.stop() if not r["provisional"]]
        labels[pkg] = [f["segments"][0].get("speaker") for f in finals]
        if pkg == "torch":
            assert st._diarizer.device == torch.device("cpu")
    spk = labels["torch"]
    assert labels["torch"] == labels["jax"]
    assert len(spk) >= 3 and spk[0] is not None and spk[1] is not None
    assert spk[0] == spk[2] != spk[1], spk


def test_warmup_streaming_matches_jax(pipelines):
    """warmup_streaming makes the JAX package's calls: 3 chunk buckets
    (1..3 s), 1 prompted, 1 first partial, 1 prefix bucket (32 of 64)."""
    counts = {
        pkg: _serve(pkg).warmup_streaming(pipe, max_latency_seconds=2.0, partial_token_budget=64)
        for pkg, pipe in pipelines.items()
    }
    assert counts == {"jax": 6, "torch": 6}


# -- the thread-safety repairs ------------------------------------------------


def test_precision_scopes_shared_across_threads():
    """Two threads interleave the precision scopes: the flags stay strict
    while either scope is open, and the caller's values come back only
    after both have left."""
    from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul

    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)

    def flags():
        return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32)

    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = cudnn.allow_tf32 = True
    barrier = threading.Barrier(2, timeout=10)
    seen = {"a": [], "b": []}

    def a():
        with reference_matmul(), no_tf32_cudnn():
            barrier.wait()  # 1: both inside
            seen["a"].append(flags())
            barrier.wait()  # 2
        barrier.wait()  # 3: a has left, b still inside
        barrier.wait()  # 4: b checked

    def b():
        barrier.wait()  # 1 (b enters after a)
        with reference_matmul(), no_tf32_cudnn():
            pass
        with reference_matmul(), no_tf32_cudnn():
            seen["b"].append(flags())
            barrier.wait()  # 2
            barrier.wait()  # 3
            seen["b"].append(flags())
            barrier.wait()  # 4

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        after = flags()
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = saved
    assert seen == {"a": [(False,) * 3], "b": [(False,) * 3] * 2}
    assert after == (True,) * 3


def test_first_load_builds_once_across_threads(tmp_path, monkeypatch):
    """Eight threads make the first load of one kernel: one compiler run,
    one library, and the same library for all eight."""
    import subprocess

    from whisperx_tpu_torch.ops import _build

    runs = []
    lock = threading.Lock()

    def fake_nvcc(cmd, stdout=None, stderr=None):
        with lock:
            runs.append(cmd)
        time.sleep(0.2)  # a build takes a while: the others arrive meanwhile
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0)

    libs = []
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: libs.append(path) or object())
    barrier = threading.Barrier(8, timeout=10)
    got = []

    def first_load():
        barrier.wait()
        got.append(_build.load("flash_attention"))

    threads = [threading.Thread(target=first_load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert len(runs) == 1 and len(libs) == 1
    assert len(got) == 8 and len({id(lib) for lib in got}) == 1
    lib = libs[0].rsplit("/", 1)[-1]  # and no temporary file is left behind
    assert sorted(p.name for p in tmp_path.iterdir()) == [lib, f"{lib}.log"]


def _meta(*shape, dtype=torch.float32):
    """A tensor with no storage and not on the CPU: the wrappers take their
    kernel's branch for it."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _k4_call(qm):
    qp = types.SimpleNamespace(
        bits=8, qw=_meta(128, 16, dtype=torch.int8), scale=_meta(2, 16), group_size=64
    )
    return qm.quant_matmul(_meta(4, 128), qp)


# (module, call of the real wrapper, counted function, its count attribute)
WRAPPER_LAUNCHES = {
    "K1": ("flash_attention", lambda m: m.flash_attention(*[_meta(1, 8, 2, 4)] * 3),
           "flash_attention", "launches"),
    "K1b": ("flash_attention", lambda m: m.wholek_attention(*[_meta(2, 8, 4)] * 3, mxu_sum=True),
            "wholek_attention", "mxu_sum_launches"),
    "K2": ("flash_attention", lambda m: m.flash_attention(*[_meta(1, 8, 2, 4)] * 3, causal=True),
           "flash_attention_tiled", "launches"),
    "K3": ("cross_attention_decode",
           lambda m: m.cross_attention_decode(_meta(1, 1, 2, 4), *[_meta(1, 8, 2, 4, dtype=torch.int8)] * 2),
           "cross_attention_decode", "launches"),
    "K3 spread": ("cross_attention_decode",
                  lambda m: m.cross_decode(_meta(1, 2, 8), *[_meta(1, 8, 8, dtype=torch.int8)] * 2),
                  "cross_attention_decode", "launches"),
    "K3kt": ("cross_attention_decode",
             lambda m: m.cross_decode_kt(_meta(1, 2, 8), *[_meta(1, 8, 8, dtype=torch.int8)] * 2),
             "cross_decode_kt", "launches"),
    "K3i8": ("cross_attention_decode",
             lambda m: m.cross_decode_i8(_meta(1, 2, 8, dtype=torch.int8), _meta(1, 2, 1),
                                         *[_meta(1, 8, 8, dtype=torch.int8)] * 2),
             "cross_decode_i8", "launches"),
    "K4": ("quant_matmul", _k4_call, "quant_matmul", "launches"),
}


def _fake_launch(*args, **kw):
    """Stands for a module's ``_launch``: the output's shape, no kernel."""
    if "n_head" in kw:  # cross_attention_decode: [B, 1, D] f32
        v = args[2]
        return _meta(v.shape[0], 1, v.shape[2])
    if len(args) == 4 and args[1].dtype == torch.int8:  # quant_matmul
        x, qw = args[0], args[1]
        return _meta(x.shape[0], qw.shape[1], dtype=x.dtype)
    return torch.empty_like(args[0])  # flash_attention


class _CountingLock:
    """The launch-count lock, counting how often a count was taken under it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self._lock.acquire()
        self.taken += 1

    def __exit__(self, *exc):
        self._lock.release()


@pytest.mark.parametrize("kernel", list(WRAPPER_LAUNCHES))
def test_launch_counts_lose_nothing_across_threads(kernel, monkeypatch):
    """Eight threads call a kernel's real wrapper at once (the launch itself
    stubbed, the tensors on no CPU): every launch is counted, in the
    attribute chip_smoke.py reads, and each count is taken under the lock.
    A bare ``+= 1`` in a wrapper would leave the lock untaken."""
    import importlib
    import sys

    import whisperx_tpu_torch.ops as ops

    module, call, fn, attr = WRAPPER_LAUNCHES[kernel]
    mod = importlib.import_module(f"whisperx_tpu_torch.ops.{module}")
    target = getattr(mod, fn)
    monkeypatch.setattr(mod, "_launch", _fake_launch)
    lock = _CountingLock()
    monkeypatch.setattr(ops, "_COUNT_LOCK", lock)
    monkeypatch.setattr(target, attr, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    barrier = threading.Barrier(8, timeout=10)
    calls = 50

    def launch():
        barrier.wait()
        for _ in range(calls):
            call(mod)

    try:
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert getattr(target, attr) == 8 * calls
    assert lock.taken == 8 * calls
