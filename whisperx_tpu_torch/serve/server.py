"""HTTP transcription server (stdlib-only, no web framework).

Counterpart of ``whisperx_tpu/serve/server.py``, with the same endpoints,
status codes and limits. Deployable front end for the serving layer: batch
requests flow through
``ContinuousBatcher`` (cross-request coalescing into shared device
batches), live audio through per-session ``StreamingTranscriber``s.  The
reference ships the scheduler/streaming *classes* but no server
(backends/mlx_continuous_batching.py, mlx_streaming.py) — this completes
them into something a client can actually call.

Endpoints
---------
GET  /healthz                     liveness + model + queue/throughput stats
POST /v1/audio/transcriptions     body = WAV bytes (any container when
                                  ffmpeg is present) or raw PCM with
                                  Content-Type audio/x-raw-pcm and headers
                                  X-Sample-Rate / X-Format (f32|i16).
                                  Query: ?language=..&priority=N
                                  ?align=true (wav2vec2 word alignment)
                                  ?diarize=true&num/min/max_speakers=K
                                  (speaker labels on segments/words)
                                  → JSON {segments, language, request_id,
                                          wall_s}
POST /v1/stream/start             → {stream_id}; query params configure
                                  (?language=fr per-stream override,
                                  ?partial_interval=0.5 for provisional
                                  partials, ?diarize=true[&max_speakers=K]
                                  for online speaker tracking with
                                  cross-chunk-consistent labels); idle
                                  sessions reaped after stream_ttl_s
POST /v1/stream/{id}/audio        body = raw PCM chunk (same headers)
                                  → {results: [...new since last call]}
POST /v1/stream/{id}/end          → {results, latency: {...}} and closes
GET  /v1/ws                       RFC 6455 WebSocket upgrade: binary
                                  frames = raw PCM in (?format=f32|i16,
                                  ?sample_rate=); results are PUSHED as
                                  JSON text frames the moment they exist
                                  (see serve/ws.py); text {"op":"end"}
                                  finalizes. Same session params as
                                  /v1/stream/start.

Run:  python -m whisperx_tpu_torch.serve --model large-v3 --port 9090

Design notes: one process, one model on one device (``device``: the
pipeline's, else ``cuda``; the aligner and the diarizer are built there
too). HTTP handler threads only queue work (ThreadingHTTPServer); the
batcher's single worker drives the decode batches. Streaming sessions drain
synchronously inside the audio POST (long-poll style) — robust with any
HTTP client, no full-duplex assumptions.
"""

from __future__ import annotations

import io
import json
import re
import tempfile
import threading
import time
import uuid
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer as _ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE
from whisperx_tpu_torch.serve.batching import (
    BatchConfig,
    ContinuousBatcher,
    QueueFullError,
)
from whisperx_tpu_torch.serve.streaming import StreamingConfig, StreamingTranscriber


class ThreadingHTTPServer(_ThreadingHTTPServer):
    # the stdlib default listen backlog (5) resets connections under a
    # burst of concurrent clients; the batcher is built for exactly that
    request_queue_size = 128
    daemon_threads = True


class _BadRequest(ValueError):
    pass


class _LengthRequired(Exception):
    """Request body without a Content-Length (chunked transfer coding):
    answered 411 and the connection closed, since an unread body would
    desync the keep-alive socket."""


class _TooLarge(Exception):
    """Request body over max_body_bytes: answered 413 and the connection
    closed (reading the oversized body would be the memory DoS the cap
    exists to prevent)."""


class _ServerBusy(Exception):
    """Stream-session table at max_streams: answered 429."""


def _decode_body(body: bytes, content_type: str, headers) -> np.ndarray:
    """Request body → float32 mono 16 kHz samples."""
    ctype = (content_type or "").split(";")[0].strip().lower()
    if ctype in ("audio/x-raw-pcm", "application/x-raw-pcm"):
        fmt = (headers.get("X-Format") or "f32").lower()
        if fmt not in ("f32", "i16"):  # outside the try: _BadRequest IS a
            # ValueError and must not be rewrapped as "bad PCM body"
            raise _BadRequest(f"unknown X-Format {fmt!r} (use f32 or i16)")
        try:
            sr = int(headers.get("X-Sample-Rate") or SAMPLE_RATE)
        except ValueError:
            raise _BadRequest("X-Sample-Rate must be an integer")
        if sr <= 0:
            raise _BadRequest(f"X-Sample-Rate must be positive, got {sr}")
        try:
            if fmt == "f32":
                audio = np.frombuffer(body, np.float32)
            else:
                audio = (
                    np.frombuffer(body, np.int16).astype(np.float32) / 32768.0
                )
        except ValueError as e:  # e.g. body length not a sample multiple
            raise _BadRequest(f"bad PCM body: {e}") from e
        if sr != SAMPLE_RATE:
            from whisperx_tpu_torch.audio.io import _resample

            audio = _resample(audio, sr, SAMPLE_RATE)
        return np.ascontiguousarray(audio, np.float32)
    # container bytes: try the stdlib WAV fast path, fall back to the full
    # loader (native decoder / ffmpeg) via a temp file
    if body[:4] == b"RIFF":
        try:
            with wave.open(io.BytesIO(body), "rb") as w:
                if w.getsampwidth() == 2:
                    frames = np.frombuffer(
                        w.readframes(w.getnframes()), np.int16
                    ).astype(np.float32) / 32768.0
                    if w.getnchannels() > 1:
                        frames = frames.reshape(-1, w.getnchannels()).mean(1)
                    if w.getframerate() != SAMPLE_RATE:
                        from whisperx_tpu_torch.audio.io import _resample

                        frames = _resample(
                            frames, w.getframerate(), SAMPLE_RATE
                        )
                    return np.ascontiguousarray(frames, np.float32)
        except wave.Error:
            pass
    from whisperx_tpu_torch.audio.io import load_audio

    suffix = ".wav" if body[:4] == b"RIFF" else ".bin"
    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(body)
        f.flush()
        try:
            return load_audio(f.name)
        except Exception as e:
            raise _BadRequest(f"cannot decode audio body: {e}") from e


def _parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser (stdlib-only; cgi was removed
    in 3.13): name → (filename | None, raw bytes). Framing per RFC 7578:
    ``--boundary CRLF headers CRLF CRLF content CRLF`` repeated, closed by
    ``--boundary--``. Exactly one CRLF is trimmed around content — binary
    payloads may legitimately start/end with 0x0d/0x0a bytes."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise _BadRequest("multipart body without a boundary parameter")
    delim = b"--" + m.group(1).encode()
    parts = {}
    for seg in body.split(delim)[1:]:
        if seg.startswith(b"--"):
            break  # closing delimiter
        if seg.startswith(b"\r\n"):
            seg = seg[2:]
        if seg.endswith(b"\r\n"):
            seg = seg[:-2]
        header_blob, sep, content = seg.partition(b"\r\n\r\n")
        if not sep:
            continue
        disposition = header_blob.decode("utf-8", "replace")
        nm = re.search(r'name="([^"]*)"', disposition)
        if not nm:
            continue
        fn = re.search(r'filename="([^"]*)"', disposition)
        parts[nm.group(1)] = (fn.group(1) if fn else None, content)
    if not parts:
        raise _BadRequest("empty multipart body")
    return parts


def _format_result(result: dict, fmt: str):
    """Render a transcription result per OpenAI-style ``response_format``.
    Returns (content_type, payload bytes). ``json`` is handled by the
    caller (it keeps the richer native schema + request_id/wall_s)."""
    segs = result.get("segments", [])
    if fmt == "text":
        text = "\n".join(s["text"].strip() for s in segs)
        return "text/plain; charset=utf-8", text.encode()
    if fmt == "verbose_json":
        payload = {
            "task": result.get("task", "transcribe"),
            "language": result.get("language"),
            "duration": round(max((s["end"] for s in segs), default=0.0), 3),
            "text": " ".join(s["text"].strip() for s in segs).strip(),
            "segments": segs,
        }
        return (
            "application/json",
            json.dumps(payload, ensure_ascii=False).encode(),
        )
    from whisperx_tpu_torch.utils.writers import OPTIONAL_WRITERS, WRITERS

    cls = {**WRITERS, **OPTIONAL_WRITERS}.get(fmt)
    if cls is None:
        raise _BadRequest(
            f"unknown response_format {fmt!r} (use json, verbose_json, "
            "text, srt, vtt, tsv, aud, or rttm)"
        )
    buf = io.StringIO()
    cls(output_dir="").write_result(result, file=buf, options={})
    return "text/plain; charset=utf-8", buf.getvalue().encode()


def _parse_int(value, name: str, default: int) -> int:
    if value is None:
        return default
    try:
        return int(value)
    except ValueError:
        raise _BadRequest(f"{name} must be an integer, got {value!r}")


def _parse_float(value, name: str):
    if value is None:
        return None
    try:
        return float(value)
    except ValueError:
        raise _BadRequest(f"{name} must be a number, got {value!r}")


def _parse_bool(value, name: str) -> bool:
    if value is None:
        return False
    v = str(value).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("", "0", "false", "no", "off"):
        return False
    raise _BadRequest(f"{name} must be a boolean, got {value!r}")


def _validated_language(value):
    """Normalize a client-supplied language or raise _BadRequest — client
    input must never reach the batcher worker unvalidated."""
    if value is None:
        return None
    from whisperx_tpu_torch.utils.languages import normalize_language

    try:
        return normalize_language(value)
    except ValueError as e:
        raise _BadRequest(str(e)) from e


def _validated_task(value):
    if value is None:
        return None
    if value not in ("transcribe", "translate"):
        raise _BadRequest(f"task must be transcribe or translate, got {value!r}")
    return value


class _StreamSession:
    def __init__(self, transcriber: StreamingTranscriber):
        self.transcriber = transcriber
        self.lock = threading.Lock()
        self.cursor = 0  # results already delivered
        self.created = time.monotonic()
        self.last_used = time.monotonic()

    def take_new(self):
        results = self.transcriber.results
        new = results[self.cursor:]
        self.cursor = len(results)
        return new


class TranscriptionServer:
    """Owns the pipeline, the batcher, and live stream sessions.

    The per-request aligner and diarizer run on the pipeline's ``device``
    attribute, or on ``cuda`` when it has none."""

    def __init__(
        self,
        pipeline,
        model_name: str = "",
        batch_config: Optional[BatchConfig] = None,
        stream_ttl_s: float = 900.0,
        max_body_bytes: int = 256 * 1024 * 1024,  # ≈2.3 h of f32 PCM
        max_streams: int = 64,
        align_model: Optional[str] = None,
        diarize_model: Optional[str] = None,
    ):
        self.pipeline = pipeline
        self.device = getattr(pipeline, "device", None) or "cuda"
        self.model_name = model_name
        self.batcher = ContinuousBatcher(pipeline, batch_config)
        self.streams: dict[str, _StreamSession] = {}
        self._streams_lock = threading.Lock()
        self.stream_ttl_s = stream_ttl_s
        self.max_body_bytes = max_body_bytes
        self.max_streams = max_streams
        self.align_model = align_model
        self.diarize_model = diarize_model
        self._ws_active = 0  # live WebSocket sessions (share max_streams)
        # lazily built post-stages (stage 3/4 of the UnifiedPipeline);
        # the lock guards construction only — inference runs from
        # concurrent handler threads, which the port makes safe: its
        # precision scopes are shared across threads, its kernels are
        # built once per process and their launch counts are locked
        self._aligners: dict[str, tuple] = {}
        self._diarizer = None
        self._post_lock = threading.Lock()
        self.started_at = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- request handling ----------------------------------------------------

    def transcribe(self, audio: np.ndarray, priority: int = 10, timeout=600.0,
                   language: Optional[str] = None, task: Optional[str] = None,
                   initial_prompt: Optional[str] = None):
        t0 = time.monotonic()
        # batcher.transcribe owns the workerless inline-drain fallback
        # (and its concurrent-caller semantics) — don't duplicate it here
        result = dict(
            self.batcher.transcribe(
                audio, timeout=timeout, priority=priority,
                language=language, task=task,
                initial_prompt=initial_prompt,
            )
            or {}
        )
        if set(result) == {"error"}:  # batch failed; surface, don't fake a 200
            raise RuntimeError(result["error"])
        result["wall_s"] = round(time.monotonic() - t0, 3)
        return result

    def _get_aligner(self, language: str):
        with self._post_lock:
            if language not in self._aligners:
                from whisperx_tpu_torch.alignment import load_align_model

                try:
                    self._aligners[language] = load_align_model(
                        language, device=self.device,
                        model_name=self.align_model,
                    )
                except ValueError as e:  # no align model for this language
                    raise _BadRequest(str(e)) from e
            return self._aligners[language]

    def _get_diarizer(self):
        with self._post_lock:
            if self._diarizer is None:
                from whisperx_tpu_torch.diarize import DiarizationPipeline

                self._diarizer = DiarizationPipeline(
                    model_name=self.diarize_model, device=self.device
                )
            return self._diarizer

    def postprocess(
        self,
        audio: np.ndarray,
        result: dict,
        *,
        align: bool = False,
        diarize: bool = False,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ) -> dict:
        """Per-request stages 3/4 of the UnifiedPipeline (reference
        pipeline.py:201-246): wav2vec2 word alignment and speaker
        diarization over the already-decoded audio. Runs in the handler
        thread — only the ASR decode goes through the batcher, since
        align/diarize inputs (segment lists, per-request audio) don't
        coalesce across requests. Post-stage time is folded into the
        result's wall_s."""
        t0 = time.monotonic()
        if align and result.get("segments"):
            from whisperx_tpu_torch.alignment import align as _align

            model, meta = self._get_aligner(result.get("language") or "en")
            aligned = _align(result["segments"], model, meta, audio)
            result = {**result, **aligned}
        if diarize:
            from whisperx_tpu_torch.diarize import assign_word_speakers

            df = self._get_diarizer()(
                audio,
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
            )
            result = assign_word_speakers(df, result)
        if "wall_s" in result:
            result["wall_s"] = round(
                result["wall_s"] + (time.monotonic() - t0), 3
            )
        return result

    def open_stream(self, partial_interval=None, language=None,
                    diarize=False, max_speakers=None) -> str:
        self._reap_streams()
        cfg = StreamingConfig()
        if partial_interval:
            cfg.partial_interval_seconds = float(partial_interval)
        if language:
            cfg.language = language
        if diarize:
            cfg.diarize = True
            cfg.max_speakers = max_speakers
        tr = StreamingTranscriber(self.pipeline, cfg)
        sid = uuid.uuid4().hex[:12]
        with self._streams_lock:
            # each session pins a ring buffer + results; cap the table so
            # a client flood degrades to 429s, not an OOM. WS sessions
            # share the budget — count BOTH directions of the split.
            if len(self.streams) + self._ws_active >= self.max_streams:
                raise _ServerBusy(
                    f"at max_streams ({self.max_streams}); retry later"
                )
            self.streams[sid] = _StreamSession(tr)
        return sid

    def _ws_acquire(self) -> None:
        """Reserve a WebSocket session slot. WS sessions share the
        max_streams budget with long-poll sessions: both pin a ring
        buffer + a decode-capable worker, so the flood-degrades-to-429
        cap must count them together."""
        with self._streams_lock:
            if len(self.streams) + self._ws_active >= self.max_streams:
                raise _ServerBusy(
                    f"at max_streams ({self.max_streams}); retry later"
                )
            self._ws_active += 1

    def _ws_release(self) -> None:
        with self._streams_lock:
            self._ws_active = max(0, self._ws_active - 1)

    def stream(self, sid: str) -> _StreamSession:
        with self._streams_lock:
            sess = self.streams.get(sid)
        if sess is None:
            raise KeyError(sid)
        sess.last_used = time.monotonic()
        return sess

    def _reap_streams(self) -> None:
        """Drop sessions whose client vanished without POSTing /end — each
        pins a ring buffer + results, so abandonment must not leak.
        Called from every POST and from /healthz (monitoring scrapes), so
        leaked sessions are collected as long as the server sees ANY
        traffic — not only when a new stream is opened."""
        now = time.monotonic()
        with self._streams_lock:
            dead = [
                sid for sid, s in self.streams.items()
                if now - s.last_used > self.stream_ttl_s
            ]
            sessions = [self.streams.pop(sid) for sid in dead]
        for sess in sessions:
            try:
                # abandon, not stop(): the client is gone, so the final-tail
                # decode would be discarded anyway, and stop()'s 10 s join +
                # device work must not run on the /healthz or POST handler
                # thread (a liveness probe that lands on an expired TTL
                # would stall for the length of a decode)
                sess.transcriber.abandon()
            except Exception:
                pass

    def close_stream(self, sid: str):
        sess = self.stream(sid)
        with sess.lock:
            final = sess.transcriber.stop()
            new = sess.take_new()
            stats = sess.transcriber.latency_stats()
        with self._streams_lock:
            self.streams.pop(sid, None)
        return new, final, stats

    def health(self) -> dict:
        self._reap_streams()
        return {
            "status": "ok",
            "model": self.model_name,
            "uptime_s": round(time.time() - self.started_at, 1),
            "queue_depth": len(self.batcher.queue),
            "active_streams": len(self.streams),
            "active_ws": self._ws_active,
            "stats": self.batcher.stats_snapshot(),
            "throughput_rtf": round(self.batcher.throughput_rtf, 2),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition: batcher gauges/counters + the
        per-stage pipeline tracker (upload/vad/mel/dispatch/decode/...)."""
        from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER

        lines = [
            "# TYPE whisperx_uptime_seconds gauge",
            f"whisperx_uptime_seconds {time.time() - self.started_at:.1f}",
            "# TYPE whisperx_queue_depth gauge",
            f"whisperx_queue_depth {len(self.batcher.queue)}",
            "# TYPE whisperx_active_streams gauge",
            f"whisperx_active_streams {len(self.streams)}",
            "# TYPE whisperx_throughput_rtf gauge",
            f"whisperx_throughput_rtf {self.batcher.throughput_rtf:.3f}",
        ]
        # snapshots: the batcher worker and pipeline threads mutate these
        # dicts concurrently; .copy()/report() take C-level-atomic copies
        for key, val in self.batcher.stats_snapshot().items():
            lines.append(f"# TYPE whisperx_{key} counter")
            lines.append(f"whisperx_{key} {val}")
        for stage, s in GLOBAL_TRACKER.report().items():
            tag = f'{{stage="{stage}"}}'
            lines.append(f"whisperx_stage_calls{tag} {s['calls']}")
            lines.append(f"whisperx_stage_seconds_total{tag} {s['total_s']}")
            lines.append(f"whisperx_stage_audio_seconds_total{tag} {s['audio_s']}")
        for counter, val in GLOBAL_TRACKER.counters.copy().items():
            lines.append(f'whisperx_counter{{name="{counter}"}} {val}')
        return "\n".join(lines) + "\n"

    # -- lifecycle -------------------------------------------------------------

    def serve_forever(self, host: str = "127.0.0.1", port: int = 9090):
        self.batcher.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        try:
            self._httpd.serve_forever()
        finally:
            self.batcher.stop()

    def start_background(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start in a daemon thread; returns the bound port (for tests).
        It polls for ``shutdown`` every 50 ms (JAX: the stdlib's 0.5 s), so
        that a test's server stops at once."""
        self.batcher.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        ).start()
        return self._httpd.server_address[1]

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.batcher.stop()


_STREAM_RE = re.compile(r"^/v1/stream/([0-9a-f]+)/(audio|end)$")


def _make_handler(app: TranscriptionServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- helpers --
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                # we don't parse chunked framing; the unread frames would
                # be interpreted as the next request line and desync every
                # later request on this keep-alive socket
                raise _LengthRequired()
            n = int(self.headers.get("Content-Length") or 0)
            if n > app.max_body_bytes:
                raise _TooLarge(
                    f"body {n} bytes exceeds max_body_bytes "
                    f"({app.max_body_bytes})"
                )
            return self.rfile.read(n) if n else b""

        def _reject_and_close(self, code: int, message: str):
            """Error out WITHOUT reading the request body (oversized or
            unsized): the connection must close, since leftover body
            bytes would desync the next keep-alive request."""
            body = json.dumps({"error": message}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            self.close_connection = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- routes --
        def do_GET(self):
            try:
                self._body()  # drain any (unusual) GET body — keep-alive safety
            except _LengthRequired:
                self._reject_and_close(
                    411, "Transfer-Encoding: chunked is unsupported; "
                         "send Content-Length")
                return
            except _TooLarge as e:
                self._reject_and_close(413, str(e))
                return
            url = urlparse(self.path)
            path = url.path
            if path == "/healthz":
                self._json(200, app.health())
            elif path == "/v1/ws":
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                self._handle_ws(q)
            elif path == "/metrics":
                body = app.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def _handle_ws(self, q):
            """GET /v1/ws — RFC 6455 upgrade into a push streaming session
            (serve/ws.py). Parameter and capacity errors are answered on
            plain HTTP BEFORE the upgrade, so a misconfigured client gets
            a readable 4xx instead of a dropped socket."""
            from whisperx_tpu_torch.serve import ws as wsmod

            key = self.headers.get("Sec-WebSocket-Key")
            upgrade = (self.headers.get("Upgrade") or "").strip().lower()
            if upgrade != "websocket" or not key:
                self._json(400, {
                    "error": "expected a WebSocket upgrade (Upgrade: "
                             "websocket + Sec-WebSocket-Key)"
                })
                return
            if (self.headers.get("Sec-WebSocket-Version") or "") != "13":
                # RFC 6455 §4.4: advertise the version we do speak
                body = json.dumps(
                    {"error": "unsupported WebSocket version"}
                ).encode()
                self.send_response(426)
                self.send_header("Sec-WebSocket-Version", "13")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                language = _validated_language(q.get("language"))
                partial_interval = _parse_float(
                    q.get("partial_interval"), "partial_interval"
                )
                diarize = _parse_bool(q.get("diarize"), "diarize")
                ms = q.get("max_speakers")
                max_speakers = (
                    None if ms is None else _parse_int(ms, "max_speakers", 0)
                )
                fmt = (q.get("format") or "f32").lower()
                if fmt not in ("f32", "i16"):
                    raise _BadRequest(
                        f"unknown format {fmt!r} (use f32 or i16)"
                    )
                sr = _parse_int(q.get("sample_rate"), "sample_rate",
                                SAMPLE_RATE)
                if sr <= 0:
                    raise _BadRequest(f"sample_rate must be positive, got {sr}")
            except _BadRequest as e:
                self._json(400, {"error": str(e)})
                return
            try:
                app._ws_acquire()
            except _ServerBusy as e:
                self._json(429, {"error": str(e)})
                return
            try:
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header(
                    "Sec-WebSocket-Accept", wsmod.make_accept(key)
                )
                self.end_headers()
                self.wfile.flush()
                sock = wsmod.WebSocket(
                    self.rfile, self.wfile, conn=self.connection,
                    max_message_bytes=app.max_body_bytes,
                )
                wsmod.stream_session(
                    sock, app.pipeline,
                    language=language,
                    partial_interval=partial_interval,
                    diarize=diarize,
                    max_speakers=max_speakers,
                    pcm_format=fmt,
                    sample_rate=sr,
                    idle_timeout_s=app.stream_ttl_s,
                )
            finally:
                app._ws_release()
                self.close_connection = True

        def do_POST(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            # ALWAYS drain the body first: connections are keep-alive
            # (HTTP/1.1), so an unread body would be parsed as the next
            # request line and desync every later request on the socket —
            # including on routes that ignore bodies (/stream/start, 404)
            try:
                body = self._body()
            except _LengthRequired:
                self._reject_and_close(
                    411, "Transfer-Encoding: chunked is unsupported; "
                         "send Content-Length")
                return
            except _TooLarge as e:
                self._reject_and_close(413, str(e))
                return
            app._reap_streams()
            try:
                if url.path == "/v1/audio/transcriptions":
                    ctype_full = self.headers.get("Content-Type") or ""
                    fields = {}
                    if (
                        ctype_full.split(";")[0].strip().lower()
                        == "multipart/form-data"
                    ):
                        # OpenAI-SDK-shaped upload: file + form fields
                        fields = _parse_multipart(body, ctype_full)
                        if "file" not in fields:
                            raise _BadRequest(
                                "multipart body missing a 'file' field"
                            )
                        audio = _decode_body(
                            fields["file"][1], "application/octet-stream",
                            self.headers,
                        )
                    else:
                        audio = _decode_body(body, ctype_full, self.headers)
                    if len(audio) == 0:
                        raise _BadRequest("empty audio body")

                    def fval(name):
                        v = fields.get(name)
                        return (
                            v[1].decode("utf-8", "replace").strip()
                            if v else None
                        )

                    # query params win over form fields
                    fmt = (
                        q.get("response_format") or fval("response_format")
                        or "json"
                    ).lower()
                    if fmt not in (
                        "json", "verbose_json", "text", "srt", "vtt",
                        "tsv", "aud", "rttm",
                    ):
                        raise _BadRequest(
                            f"unknown response_format {fmt!r} (use json, "
                            "verbose_json, text, srt, vtt, tsv, aud, or rttm)"
                        )
                    do_align = _parse_bool(
                        q.get("align") or fval("align"), "align"
                    )
                    do_diarize = _parse_bool(
                        q.get("diarize") or fval("diarize"), "diarize"
                    )

                    def spk(name):
                        v = q.get(name) or fval(name)
                        return (
                            None if v is None else _parse_int(v, name, 0)
                        )

                    result = app.transcribe(
                        audio,
                        priority=_parse_int(q.get("priority"), "priority", 10),
                        language=_validated_language(
                            q.get("language") or fval("language")
                        ),
                        task=_validated_task(q.get("task") or fval("task")),
                        initial_prompt=q.get("prompt") or fval("prompt"),
                    )
                    if do_align or do_diarize:
                        result = app.postprocess(
                            audio,
                            result,
                            align=do_align,
                            diarize=do_diarize,
                            num_speakers=spk("num_speakers"),
                            min_speakers=spk("min_speakers"),
                            max_speakers=spk("max_speakers"),
                        )
                    if fmt == "json":
                        result["request_id"] = uuid.uuid4().hex[:12]
                        self._json(200, result)
                    else:
                        ctype_out, payload = _format_result(result, fmt)
                        self.send_response(200)
                        self.send_header("Content-Type", ctype_out)
                        self.send_header(
                            "Content-Length", str(len(payload))
                        )
                        self.end_headers()
                        self.wfile.write(payload)
                elif url.path == "/v1/stream/start":
                    ms = q.get("max_speakers")
                    sid = app.open_stream(
                        partial_interval=_parse_float(
                            q.get("partial_interval"), "partial_interval"
                        ),
                        language=_validated_language(q.get("language")),
                        diarize=_parse_bool(q.get("diarize"), "diarize"),
                        max_speakers=(
                            None if ms is None
                            else _parse_int(ms, "max_speakers", 0)
                        ),
                    )
                    self._json(200, {"stream_id": sid})
                elif m := _STREAM_RE.match(url.path):
                    sid, action = m.group(1), m.group(2)
                    sess = app.stream(sid)
                    if action == "audio":
                        audio = _decode_body(
                            body,
                            self.headers.get("Content-Type")
                            or "audio/x-raw-pcm",
                            self.headers,
                        )
                        with sess.lock:
                            sess.transcriber.feed(audio)
                            # synchronous drain: decode whatever flushed,
                            # return partials in this response (long-poll)
                            sess.transcriber.process_available()
                            new = sess.take_new()
                        self._json(200, {"results": new})
                    else:  # end
                        new, final, stats = app.close_stream(sid)
                        self._json(
                            200,
                            {"results": new, "all_results": final,
                             "latency": stats},
                        )
                else:
                    self._json(404, {"error": "not found"})
            except _BadRequest as e:
                self._json(400, {"error": str(e)})
            except KeyError:
                self._json(404, {"error": "unknown stream"})
            except _ServerBusy as e:
                self._json(429, {"error": str(e)})
            except QueueFullError as e:
                # shed load instead of queueing unboundedly; the client
                # should back off briefly and retry
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # pragma: no cover - defensive
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler
