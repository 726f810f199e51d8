"""The port's HTTP server (``whisperx_tpu_torch.serve.server``) against the
JAX package's.

The scenarios of ``tests/test_server.py`` that use a fake pipeline run over
real sockets against the port's server. Then, on f32 ``test-nano`` with the
JAX package's weights bridged through one checkpoint, the same POSTs (a
WAV, raw PCM at 44.1 kHz, a multipart upload rendered as SRT; with
``?align=true`` over a JAX-written aligner and with ``?diarize=true``) to
JAX's server over JAX's pipeline and to the port's over the port's give the
same bodies, apart from ``request_id`` and ``wall_s``. Last, the entry
point ``python -m whisperx_tpu_torch.serve``.
"""

import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import synth_speech
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

from whisperx_tpu_torch.serve.batching import BatchConfig
from whisperx_tpu_torch.serve.server import TranscriptionServer, _decode_body

REPO = Path(__file__).parent.parent
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
    device = torch.device("cpu")  # the aligner and diarizer run here

    def __init__(self):
        self.calls = []
        self.language = "en"
        self.task = "transcribe"

    def transcribe(self, audio, batch_size=8, **kw):
        self.calls.append((len(audio), kw))
        return {
            "segments": [
                {"start": 0.0, "end": len(audio) / 16000, "text": "ok"}
            ],
            "language": kw.get("language") or "en",
        }


def _wav_bytes(audio: np.ndarray, sr: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _post(url, body, headers=None, method="POST"):
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture
def server():
    srv = TranscriptionServer(
        FakePipeline(), model_name="fake", batch_config=BatchConfig(max_wait_ms=5)
    )
    port = srv.start_background(port=0)
    yield srv, f"http://127.0.0.1:{port}"
    srv.shutdown()


def test_healthz(server):
    srv, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        payload = json.loads(resp.read())
    assert payload["status"] == "ok"
    assert payload["model"] == "fake"
    assert "queue_depth" in payload and "stats" in payload


def test_metrics_endpoint(server):
    srv, base = server
    # generate one request so batcher counters move
    _post(base + "/v1/audio/transcriptions", _wav_bytes(synth_speech(1.0)),
          {"Content-Type": "audio/wav"})
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    assert "whisperx_queue_depth" in text
    assert "whisperx_requests 1" in text
    assert "whisperx_throughput_rtf" in text


def test_transcription_wav_roundtrip(server):
    srv, base = server
    audio = synth_speech(2.0)
    status, payload = _post(
        base + "/v1/audio/transcriptions", _wav_bytes(audio),
        {"Content-Type": "audio/wav"},
    )
    assert status == 200
    assert payload["language"] == "en"
    assert payload["segments"][0]["text"] == "ok"
    assert abs(payload["segments"][0]["end"] - 2.0) < 0.05
    assert "request_id" in payload and "wall_s" in payload


def test_transcription_raw_pcm_f32_and_i16(server):
    srv, base = server
    audio = synth_speech(1.0)
    for fmt, body in (
        ("f32", audio.astype(np.float32).tobytes()),
        ("i16", (audio * 32767).astype(np.int16).tobytes()),
    ):
        status, payload = _post(
            base + "/v1/audio/transcriptions", body,
            {"Content-Type": "audio/x-raw-pcm", "X-Format": fmt,
             "X-Sample-Rate": "16000"},
        )
        assert status == 200
        assert abs(payload["segments"][0]["end"] - 1.0) < 0.05


def test_per_request_language_and_task_params(server):
    """?language= and ?task= query params ride through the batcher to the
    pipeline per request."""
    srv, base = server
    status, payload = _post(
        base + "/v1/audio/transcriptions?language=fr&task=translate",
        _wav_bytes(synth_speech(1.0)), {"Content-Type": "audio/wav"},
    )
    assert status == 200
    assert payload["language"] == "fr"
    pipe = srv.pipeline
    assert pipe.calls[-1][1].get("language") == "fr"
    assert pipe.calls[-1][1].get("task") == "translate"


def test_resampled_wav_body(server):
    """8 kHz WAV body → resampled to 16 kHz before transcription."""
    srv, base = server
    audio = synth_speech(2.0)[::2]  # crude 8 kHz signal
    status, payload = _post(
        base + "/v1/audio/transcriptions", _wav_bytes(audio, sr=8000),
        {"Content-Type": "audio/wav"},
    )
    assert status == 200
    # duration preserved through resampling
    assert abs(payload["segments"][0]["end"] - 2.0) < 0.1


def test_error_routes(server):
    srv, base = server
    # unknown route → 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/nope", b"x")
    assert e.value.code == 404
    # empty body → 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/audio/transcriptions", b"",
              {"Content-Type": "audio/x-raw-pcm"})
    assert e.value.code == 400
    # garbage container → 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/audio/transcriptions", b"\x00" * 64,
              {"Content-Type": "application/octet-stream"})
    assert e.value.code == 400
    # unknown stream id → 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/stream/deadbeef0000/audio", b"\x00" * 2048,
              {"Content-Type": "audio/x-raw-pcm"})
    assert e.value.code == 404


def test_bad_params_return_400_and_worker_survives(server):
    """Unvalidated client input must never kill the batcher worker: bad
    language/task/priority/partial_interval → 400, and the endpoint still
    serves afterwards (regression: ?language=klingon used to crash the
    worker thread and hang every later request)."""
    srv, base = server
    wav = _wav_bytes(synth_speech(1.0))
    for qs in ("?language=klingon", "?task=summarize", "?priority=high"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/audio/transcriptions" + qs, wav,
                  {"Content-Type": "audio/wav"})
        assert e.value.code == 400, qs
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/stream/start?partial_interval=abc", b"")
    assert e.value.code == 400
    # odd-length raw PCM is a client error, not a 500
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/v1/audio/transcriptions", b"\x00" * 7,
              {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"})
    assert e.value.code == 400
    # endpoint still alive and serving
    status, payload = _post(base + "/v1/audio/transcriptions", wav,
                            {"Content-Type": "audio/wav"})
    assert status == 200 and payload["segments"]


def test_pipeline_exception_fails_batch_not_worker():
    """A pipeline error fails that request with a 500-surfaced error but
    the worker thread keeps draining subsequent requests."""
    class FlakyPipeline(FakePipeline):
        def transcribe(self, audio, batch_size=8, **kw):
            if len(audio) == 160:  # poison marker
                raise RuntimeError("decode exploded")
            return super().transcribe(audio, batch_size=batch_size, **kw)

    srv = TranscriptionServer(FlakyPipeline(), model_name="flaky",
                              batch_config=BatchConfig(max_wait_ms=5))
    port = srv.start_background(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/audio/transcriptions",
                  np.zeros(160, np.float32).tobytes(),
                  {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"})
        assert e.value.code == 500
        assert "decode exploded" in json.loads(e.value.read())["error"]
        status, payload = _post(
            base + "/v1/audio/transcriptions", _wav_bytes(synth_speech(1.0)),
            {"Content-Type": "audio/wav"})
        assert status == 200 and payload["segments"]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["stats"].get("errors") == 1
    finally:
        srv.shutdown()


def test_stream_ttl_reaps_abandoned_sessions():
    srv = TranscriptionServer(FakePipeline(), stream_ttl_s=0.2)
    port = srv.start_background(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        _, p1 = _post(base + "/v1/stream/start", b"")
        import time as _t

        _t.sleep(0.4)
        _, p2 = _post(base + "/v1/stream/start", b"")  # triggers the reap
        assert p1["stream_id"] != p2["stream_id"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + f"/v1/stream/{p1['stream_id']}/end", b"")
        assert e.value.code == 404  # reaped
        status, _ = _post(base + f"/v1/stream/{p2['stream_id']}/end", b"")
        assert status == 200  # fresh one unaffected
    finally:
        srv.shutdown()


def _multipart(fields: dict) -> tuple:
    """Build a multipart/form-data body: name -> bytes (file part) or str."""
    boundary = "testboundary123"
    out = b""
    for name, val in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(val, bytes):
            out += (
                f'Content-Disposition: form-data; name="{name}"; '
                f'filename="clip.wav"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n"
            ).encode() + val + b"\r\n"
        else:
            out += (
                f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                f"{val}\r\n"
            ).encode()
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def test_multipart_upload_openai_shape(server):
    """An OpenAI-SDK-shaped multipart POST (file + model + response_format
    form fields) transcribes and renders per response_format."""
    srv, base = server
    wav = _wav_bytes(synth_speech(2.0))
    body, ctype = _multipart(
        {"file": wav, "model": "whisper-1", "response_format": "text"}
    )
    req = urllib.request.Request(
        base + "/v1/audio/transcriptions", data=body,
        headers={"Content-Type": ctype},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert resp.read().decode().strip() == "ok"
    # missing file field is a clean 400
    body2, ctype2 = _multipart({"model": "whisper-1"})
    req2 = urllib.request.Request(
        base + "/v1/audio/transcriptions", data=body2,
        headers={"Content-Type": ctype2},
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req2, timeout=10)
    assert e.value.code == 400
    assert "file" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("fmt,check", [
    ("text", lambda b, h: b.decode().strip() == "ok"),
    ("srt", lambda b, h: b.decode().startswith("1\n00:00:00,000 --> ")),
    ("vtt", lambda b, h: b.decode().startswith("WEBVTT")),
    ("tsv", lambda b, h: b.decode().splitlines()[0] == "start\tend\ttext"),
    ("verbose_json", lambda b, h: (
        json.loads(b)["text"] == "ok" and "duration" in json.loads(b)
        and h["Content-Type"].startswith("application/json"))),
    # no ?diarize -> no speaker labels -> valid empty RTTM (route + writer
    # wiring is what's under test; labelled RTTM is pinned in test_writers)
    ("rttm", lambda b, h: b.decode() == ""),
])
def test_response_format_rendering(server, fmt, check):
    srv, base = server
    req = urllib.request.Request(
        base + f"/v1/audio/transcriptions?response_format={fmt}",
        data=np.zeros(16000, np.float32).tobytes(),
        headers={"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200
        assert check(resp.read(), resp.headers)


def test_prompt_param_reaches_pipeline(server):
    """?prompt= (or the multipart 'prompt' field) rides the request into
    the pipeline as initial_prompt."""
    srv, base = server
    req = urllib.request.Request(
        base + "/v1/audio/transcriptions?prompt=glossary:%20XLA",
        data=np.zeros(1600, np.float32).tobytes(),
        headers={"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 200
    assert any(
        kw.get("initial_prompt") == "glossary: XLA"
        for _, kw in srv.pipeline.calls
    )


def test_unknown_response_format_400(server):
    srv, base = server
    req = urllib.request.Request(
        base + "/v1/audio/transcriptions?response_format=yaml",
        data=np.zeros(1600, np.float32).tobytes(),
        headers={"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"},
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400
    assert "response_format" in json.loads(e.value.read())["error"]


def test_oversized_body_rejected_with_413():
    """Bodies over max_body_bytes are refused BEFORE being read (reading
    them would be the memory DoS the cap prevents) and the connection
    closes, since the unread body would desync keep-alive."""
    srv = TranscriptionServer(
        FakePipeline(), batch_config=BatchConfig(max_wait_ms=5),
        max_body_bytes=1000,
    )
    port = srv.start_background(port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/transcriptions",
            data=b"\x00" * 2000,
            headers={"Content-Type": "audio/x-raw-pcm", "X-Format": "i16"},
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 413
        assert e.value.headers.get("Connection", "").lower() == "close"
        # under the cap still works
        ok = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/transcriptions",
            data=np.zeros(400, np.int16).tobytes(),
            headers={"Content-Type": "audio/x-raw-pcm", "X-Format": "i16"},
        )
        with urllib.request.urlopen(ok, timeout=30) as resp:
            assert resp.status == 200
    finally:
        srv.shutdown()


def test_max_streams_cap_returns_429():
    srv = TranscriptionServer(FakePipeline(), max_streams=2)
    port = srv.start_background(port=0)
    base = f"http://127.0.0.1:{port}"
    try:
        _post(base + "/v1/stream/start", b"")
        _post(base + "/v1/stream/start", b"")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/stream/start", b"")
        assert e.value.code == 429
        assert "max_streams" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()


def test_queue_backpressure_returns_503():
    """With the worker stuck decoding and the queue at max_queue_depth,
    new requests shed with 503 + Retry-After instead of queueing
    unboundedly."""
    import threading
    import time as _t

    entered = threading.Event()
    release = threading.Event()

    class BlockingPipeline(FakePipeline):
        def transcribe(self, audio, batch_size=8, **kw):
            entered.set()
            release.wait(10)
            return super().transcribe(audio, batch_size=batch_size, **kw)

    srv = TranscriptionServer(
        BlockingPipeline(),
        batch_config=BatchConfig(max_wait_ms=5, max_queue_depth=1),
    )
    port = srv.start_background(port=0)
    base = f"http://127.0.0.1:{port}/v1/audio/transcriptions"
    pcm = {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"}
    body = np.zeros(1600, np.float32).tobytes()
    t = threading.Thread(target=lambda: _post(base, body, pcm))
    try:
        t.start()
        assert entered.wait(10)  # worker is busy inside the decode
        srv.batcher.submit(np.zeros(1600, np.float32))  # fills depth 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, body, pcm)
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
    finally:
        release.set()
        t.join(timeout=15)
        srv.shutdown()


def test_chunked_body_rejected_with_411():
    """A Transfer-Encoding: chunked POST gets a clean 411 and the server
    closes the connection — unread chunked frames must never be parsed
    as the next request line on the keep-alive socket."""
    import http.client

    srv = TranscriptionServer(
        FakePipeline(), batch_config=BatchConfig(max_wait_ms=5)
    )
    port = srv.start_background(port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.putrequest("POST", "/v1/audio/transcriptions")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.putheader("Content-Type", "audio/x-raw-pcm")
        conn.endheaders()
        try:  # server may reply + close before the frames land
            conn.send(b"4\r\nabcd\r\n0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass
        resp = conn.getresponse()
        assert resp.status == 411
        assert "Content-Length" in json.loads(resp.read())["error"]
        assert resp.headers.get("Connection", "").lower() == "close"
        conn.close()
    finally:
        srv.shutdown()


def test_reap_abandons_without_final_decode():
    """TTL reaping runs on /healthz and POST handler threads, so it must
    be O(1): no final-tail decode of the abandoned stream (the client is
    gone; the output would be discarded) and no blocking worker join."""
    import time as _t

    pipe = FakePipeline()
    srv = TranscriptionServer(pipe, stream_ttl_s=0.1)
    sid = srv.open_stream()
    sess = srv.stream(sid)
    # leave a pending tail that stop() WOULD decode
    sess.transcriber.feed(synth_speech(2.0).astype(np.float32))
    calls_before = len(pipe.calls)
    _t.sleep(0.25)
    t0 = _t.monotonic()
    srv._reap_streams()
    assert _t.monotonic() - t0 < 0.5
    assert len(pipe.calls) == calls_before, "reap ran the discarded decode"
    assert sid not in srv.streams
    srv.shutdown()


def test_stream_language_override(server):
    """?language= on /v1/stream/start pins the language of every chunk
    decode in that session."""
    srv, base = server
    _, payload = _post(base + "/v1/stream/start?language=fr", b"")
    sid = payload["stream_id"]
    body = np.concatenate(
        [synth_speech(2.0), np.zeros(16000, np.float32)]
    ).tobytes()
    _post(base + f"/v1/stream/{sid}/audio", body,
          {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"})
    _post(base + f"/v1/stream/{sid}/end", b"")
    pipe = srv.pipeline
    stream_calls = [kw for _, kw in pipe.calls if "language" in kw]
    assert stream_calls and all(
        kw["language"] == "fr" for kw in stream_calls
    )


def test_stream_session_lifecycle(server):
    srv, base = server
    status, payload = _post(base + "/v1/stream/start", b"")
    assert status == 200
    sid = payload["stream_id"]

    # speech then a long silence tail → the chunker flushes mid-stream
    speech = synth_speech(2.0)
    silence = np.zeros(16000, np.float32)
    got_midstream = []
    for piece in (speech[:16000], speech[16000:], silence):
        status, payload = _post(
            base + f"/v1/stream/{sid}/audio",
            piece.astype(np.float32).tobytes(),
            {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"},
        )
        assert status == 200
        got_midstream.extend(payload["results"])

    status, payload = _post(base + f"/v1/stream/{sid}/end", b"")
    assert status == 200
    texts = [r["text"] for r in payload["all_results"]]
    assert texts and all(t == "ok" for t in texts)
    # partial results arrived BEFORE stream end (the serving contract)
    assert got_midstream, "no mid-stream results returned"
    # the session is gone afterwards
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + f"/v1/stream/{sid}/end", b"")
    assert e.value.code == 404


def test_streaming_prev_text_conditioning():
    """Committed text must reach the next chunk's decode as initial_prompt
    (regression: the conditional was inverted and the kwarg dropped)."""
    from whisperx_tpu_torch.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    pipe = FakePipeline()
    tr = StreamingTranscriber(
        pipe, StreamingConfig(condition_on_previous_text=True)
    )
    speech = synth_speech(2.0)
    tr.feed(np.concatenate([speech, np.zeros(16000, np.float32)]))
    tr.process_available()
    tr.feed(np.concatenate([speech, np.zeros(16000, np.float32)]))
    tr.process_available()
    tr.stop()
    assert len(pipe.calls) >= 2
    # first chunk: no prompt; later chunks: committed text as prompt
    assert "initial_prompt" not in pipe.calls[0][1]
    assert pipe.calls[1][1].get("initial_prompt") == "ok"


def test_decode_body_rejects_bad_format():
    with pytest.raises(ValueError):
        _decode_body(b"\x00" * 8, "audio/x-raw-pcm", {"X-Format": "f64"})


def test_concurrent_clients_all_served_and_coalesced():
    """16 simultaneous POSTs: every client gets its own result back and
    the batcher coalesces requests into far fewer pipeline calls."""
    import threading

    class CoalescingPipeline(FakePipeline):
        def __init__(self):
            super().__init__()
            self.many_calls = []
            self.lock = threading.Lock()

        def transcribe_many(self, audios, batch_size=8, **kw):
            with self.lock:
                self.many_calls.append(len(audios))
            return [
                {
                    "segments": [
                        {"start": 0.0, "end": len(a) / 16000,
                         "text": f"len{len(a)}"}
                    ],
                    "language": "en",
                }
                for a in audios
            ]

    pipe = CoalescingPipeline()
    srv = TranscriptionServer(pipe, batch_config=BatchConfig(
        max_batch_size=8, max_wait_ms=150))
    port = srv.start_background(port=0)
    base = f"http://127.0.0.1:{port}"
    results = {}
    errors = []

    def client(i):
        # distinct lengths → distinct texts prove per-client demux
        n = 16000 + i * 160
        body = np.zeros(n, np.float32).tobytes()
        try:
            _, payload = _post(
                base + "/v1/audio/transcriptions", body,
                {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"})
            results[i] = payload["segments"][0]["text"]
        except Exception as e:  # pragma: no cover
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(results) == 16
        for i, text in results.items():
            assert text == f"len{16000 + i * 160}", (i, text)
        # coalescing actually happened: fewer batches than clients
        assert sum(pipe.many_calls) == 16
        assert len(pipe.many_calls) < 16
    finally:
        srv.shutdown()


def test_align_param_attaches_word_scaffolding(server):
    """?align=true runs stage-3 (wav2vec2 alignment) per request: the
    result gains word_segments and per-segment word lists (conftest sets
    WHISPERX_TPU_ALLOW_RANDOM_ALIGN, so the random-weight aligner runs a
    real forward; a hermetic install without it returns empty words via
    the alignment/__init__.py guard — both are structurally aligned)."""
    srv, base = server
    status, payload = _post(
        base + "/v1/audio/transcriptions?align=true",
        _wav_bytes(synth_speech(2.0)),
        {"Content-Type": "audio/wav"},
    )
    assert status == 200
    assert "word_segments" in payload
    assert isinstance(payload["segments"][0]["words"], list)
    assert "wall_s" in payload


def test_diarize_param_labels_speakers(server):
    """?diarize=true runs stage-4 per request (weightless spectral path
    on a hermetic install) and labels segments with speakers."""
    srv, base = server
    status, payload = _post(
        base + "/v1/audio/transcriptions?diarize=true&max_speakers=2",
        _wav_bytes(synth_speech(3.0)),
        {"Content-Type": "audio/wav"},
    )
    assert status == 200
    assert payload["segments"][0].get("speaker", "").startswith("SPEAKER_")


def test_bad_align_param_is_400(server):
    srv, base = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(
            base + "/v1/audio/transcriptions?align=maybe",
            _wav_bytes(synth_speech(0.5)),
            {"Content-Type": "audio/wav"},
        )
    assert exc.value.code == 400


def test_stream_diarize_param_tracks_speakers(server):
    """/v1/stream/start?diarize=true wires online speaker tracking: the
    chunk-final results carry cross-chunk-consistent speaker labels
    (weightless spectral path)."""
    srv, base = server
    _, p = _post(base + "/v1/stream/start?diarize=true&max_speakers=2", b"")
    sid = p["stream_id"]
    sr = 16000
    t = np.arange(2 * sr) / sr
    low = (
        0.4 * np.sin(2 * np.pi * 180 * t)
        * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    ).astype(np.float32)
    _post(
        base + f"/v1/stream/{sid}/audio",
        low.tobytes(),
        {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"},
    )
    status, payload = _post(base + f"/v1/stream/{sid}/end", b"")
    assert status == 200
    finals = [r for r in payload["all_results"] if not r["provisional"]]
    assert finals
    speakers = [
        s.get("speaker") for r in finals for s in r["segments"]
    ]
    assert speakers and all(
        sp is not None and sp.startswith("SPEAKER_") for sp in speakers
    )


# -- parity with the JAX package's server on bridged test-nano weights --------


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    from whisperx_tpu.convert.checkpoint import save_checkpoint
    from whisperx_tpu.models.whisper.config import MODEL_DIMS
    from whisperx_tpu.models.whisper.model import init_params

    dims = MODEL_DIMS["test-nano"]
    path = str(tmp_path_factory.mktemp("nano_server"))
    save_checkpoint(
        path, init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32),
        {"name": "test-nano", "family": "whisper", "dims": dataclasses.asdict(dims)},
    )
    return path


@pytest.fixture(scope="module")
def align_ckpt(tmp_path_factory):
    """A wav2vec2 TEST_CONFIG aligner written by the JAX package under
    ``<dir>/en``, with the base-960h dictionary."""
    from whisperx_tpu.alignment import DEFAULT_EN_VOCAB
    from whisperx_tpu.convert.checkpoint import save_checkpoint
    from whisperx_tpu.models.wav2vec2 import model as w2v

    root = tmp_path_factory.mktemp("align_server")
    save_checkpoint(
        str(root / "en"), w2v.init_params(w2v.TEST_CONFIG, jax.random.PRNGKey(3)),
        {"family": "wav2vec2", "name": "test", "dictionary": dict(DEFAULT_EN_VOCAB),
         "config": dataclasses.asdict(w2v.TEST_CONFIG)},
    )
    return root


@pytest.fixture(scope="module")
def both_servers(nano_ckpt):
    import whisperx_tpu
    import whisperx_tpu.serve as jserve
    import whisperx_tpu_torch
    import whisperx_tpu_torch.serve as tserve

    kw = dict(compute_type="float32", vad_method="energy", asr_options=OPTS, batch_size=2)
    servers = {
        "jax": jserve.TranscriptionServer(
            whisperx_tpu.load_model(nano_ckpt, device="cpu", **kw), model_name="nano",
            batch_config=jserve.BatchConfig(max_wait_ms=5),
        ),
        "torch": tserve.TranscriptionServer(
            whisperx_tpu_torch.load_model(nano_ckpt, device="cpu", **kw), model_name="nano",
            batch_config=tserve.BatchConfig(max_wait_ms=5),
        ),
    }
    bases = {pkg: f"http://127.0.0.1:{srv.start_background(port=0)}" for pkg, srv in servers.items()}
    yield servers, bases
    for srv in servers.values():
        srv.shutdown()


def _request(pkg_base, case):
    """(url, body, headers) of one parity case."""
    audio = synth_speech(9.0, seed=12)
    url = pkg_base + "/v1/audio/transcriptions"
    if case == "wav":
        return url + "?language=en", _wav_bytes(audio), {"Content-Type": "audio/wav"}
    if case == "pcm 44.1 kHz":
        t = np.arange(int(44100 * 7.0)) / 44100
        pcm = (0.3 * np.sin(2 * np.pi * 180 * t) * (np.sin(2 * np.pi * 0.4 * t) > -0.3) * 32767)
        return url, pcm.astype(np.int16).tobytes(), {
            "Content-Type": "audio/x-raw-pcm", "X-Format": "i16", "X-Sample-Rate": "44100"}
    if case == "multipart srt":
        body, ctype = _multipart({"file": _wav_bytes(audio), "response_format": "srt", "language": "en"})
        return url, body, {"Content-Type": ctype}
    if case == "verbose_json":
        return url + "?language=en&response_format=verbose_json", _wav_bytes(audio), {"Content-Type": "audio/wav"}
    if case in ("align", "diarize"):
        return url + f"?language=en&{case}=true", _wav_bytes(audio), {"Content-Type": "audio/wav"}
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["wav", "pcm 44.1 kHz", "multipart srt", "verbose_json", "align", "diarize"]
)
def test_server_bodies_match_jax(both_servers, align_ckpt, monkeypatch, case):
    servers, bases = both_servers
    if case == "align":  # the same aligner for both: the JAX-written checkpoint
        monkeypatch.setenv("WHISPERX_TPU_ALIGN_DIR", str(align_ckpt))
    bodies = {}
    for pkg, base in bases.items():
        url, body, headers = _request(base, case)
        req = urllib.request.Request(url, data=body, headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200, pkg
            bodies[pkg] = (resp.headers["Content-Type"], resp.read())
    assert bodies["torch"][0] == bodies["jax"][0]
    if case in ("multipart srt",):
        assert bodies["torch"][1] == bodies["jax"][1] and bodies["torch"][1].startswith(b"1\n")
        return
    got, want = (json.loads(bodies[pkg][1]) for pkg in ("torch", "jax"))
    for payload in (got, want):
        for key in ("request_id", "wall_s"):
            payload.pop(key, None)
    assert got == want
    assert got["segments"]
    if case == "align":
        assert got["word_segments"]
        assert servers["torch"]._aligners["en"][1]["random_weights"] is False
    if case == "diarize":
        assert all(s["speaker"].startswith("SPEAKER_") for s in got["segments"])
        assert servers["torch"]._diarizer.device == torch.device("cpu")


def test_stream_sessions_match_jax(both_servers):
    """A long-poll stream session fed the same frames gives the same
    results per POST and the same finals."""
    _, bases = both_servers
    gap = np.zeros(16000, np.float32)
    audio = np.concatenate([synth_speech(2.5, seed=4), gap, synth_speech(2.0, seed=5)])
    pcm = {"Content-Type": "audio/x-raw-pcm", "X-Format": "f32"}
    got = {}
    for pkg, base in bases.items():
        _, p = _post(base + "/v1/stream/start?language=en", b"")
        sid = p["stream_id"]
        seen = []
        for i in range(0, len(audio), 8000):
            _, payload = _post(base + f"/v1/stream/{sid}/audio", audio[i:i + 8000].tobytes(), pcm)
            seen.append(payload["results"])
        _, end = _post(base + f"/v1/stream/{sid}/end", b"")
        strip = lambda rs: [{k: v for k, v in r.items() if k != "latency_s"} for r in rs]  # noqa: E731
        got[pkg] = ([strip(r) for r in seen], strip(end["all_results"]))
    assert got["torch"] == got["jax"]
    finals = got["torch"][1]
    assert finals and finals[-1]["final"]
    assert finals[-1]["end"] == pytest.approx(len(audio) / 16000)


# -- the entry point -----------------------------------------------------------


def _flags(main, argv, capsys):
    sys_argv = sys.argv
    sys.argv = ["serve", *argv]
    try:
        with pytest.raises(SystemExit):
            main()
    finally:
        sys.argv = sys_argv
    return capsys.readouterr().out


def test_help_shows_jax_flags_with_cuda_default(capsys):
    import re

    from whisperx_tpu.serve.__main__ import main as jax_main
    from whisperx_tpu_torch.serve.__main__ import build_parser, main

    want = set(re.findall(r"--\w+", _flags(jax_main, ["--help"], capsys)))
    got = set(re.findall(r"--\w+", _flags(main, ["--help"], capsys)))
    assert got == want | {"--trace_spans"} and "--device" in got  # the port's span records
    defaults = vars(build_parser().parse_args([]))
    assert defaults["device"] == "cuda" and defaults["port"] == 9090
    assert defaults["data_parallel"] == "auto" and defaults["n_model"] == 1


@pytest.mark.parametrize("argv", [["--data_parallel", "on"], ["--n_model", "2"]])
def test_data_parallel_raises_before_loading(argv, monkeypatch):
    """Scale-out is ported: the parser keeps both flags and nothing is
    refused before the model loads (the load is stubbed to stop there)."""
    import whisperx_tpu_torch.asr as asr
    from whisperx_tpu_torch.serve.__main__ import build_parser, main

    class Loading(Exception):
        pass

    def stop(*a, **k):
        raise Loading

    args = build_parser().parse_args(argv)
    assert (args.data_parallel, args.n_model) == (
        ("on", 1) if argv[0] == "--data_parallel" else ("auto", 2)
    )
    monkeypatch.setattr(asr, "load_model", stop)
    with pytest.raises(Loading):
        main(["--device", "cpu", *argv])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cpu_answers_and_exits_on_sigterm(nano_ckpt):
    """``python -m whisperx_tpu_torch.serve --device cpu`` answers /healthz
    and one POST, then exits 0 within 10 s of SIGTERM. The POST is silence,
    which the VAD leaves undecoded: the entry point's flags have no
    ``sample_len``, and a 224-step decode of random weights would cost 13 s
    here (the parity tests above decode through the same server class)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisperx_tpu_torch.serve", "--model", nano_ckpt,
         "--device", "cpu", "--port", str(port), "--compute_type", "float32",
         "--vad_method", "energy", "--language", "en", "--no_warmup",
         "--temperature_increment_on_fallback", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO),
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    assert json.loads(r.read())["status"] == "ok"
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.25)
        status, payload = _post(
            f"http://127.0.0.1:{port}/v1/audio/transcriptions",
            _wav_bytes(np.zeros(48000, np.float32)), {"Content-Type": "audio/wav"},
        )
        assert status == 200 and payload["language"] == "en" and payload["segments"] == []
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
        assert "serving" in proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
