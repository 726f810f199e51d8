"""The port's WebSocket transport (``whisperx_tpu_torch.serve.ws`` and the
/v1/ws route) over a real socket, with the scenarios of ``tests/test_ws.py``:
a minimal RFC 6455 client (masked frames, as the RFC requires of clients)
against the port's server over a fake pipeline.
"""

import base64
import hashlib
import json
import os
import socket
import struct
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from whisperx_tpu_torch.serve.batching import BatchConfig
from whisperx_tpu_torch.serve.server import TranscriptionServer
from whisperx_tpu_torch.serve.ws import make_accept


class FakePipeline:
    """Echoes one segment per transcribe call (no device work)."""

    device = "cpu"

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


@pytest.fixture
def server():
    srv = TranscriptionServer(
        FakePipeline(), model_name="fake",
        batch_config=BatchConfig(max_wait_ms=5),
    )
    port = srv.start_background(port=0)
    yield srv, port
    srv.shutdown()


class WSClient:
    """Minimal RFC 6455 client: handshake + masked frames."""

    def __init__(self, port, path="/v1/ws", timeout=15.0):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout)
        self.key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(
            (
                f"GET {path} HTTP/1.1\r\n"
                f"Host: 127.0.0.1:{port}\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {self.key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        self.buf = b""
        # read HTTP response head
        while b"\r\n\r\n" not in self.buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                break
            self.buf += chunk
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        self.head = head.decode("latin-1")
        self.status = int(self.head.split(" ", 2)[1])

    def accept_header(self):
        for line in self.head.split("\r\n"):
            if line.lower().startswith("sec-websocket-accept:"):
                return line.split(":", 1)[1].strip()
        return None

    def _recv_exact(self, n):
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send_frame(self, opcode, payload, fin=True, mask=True):
        b1 = (0x80 if fin else 0) | opcode
        header = bytearray([b1])
        ln = len(payload)
        mbit = 0x80 if mask else 0
        if ln < 126:
            header.append(mbit | ln)
        elif ln < 1 << 16:
            header.append(mbit | 126)
            header += struct.pack(">H", ln)
        else:
            header.append(mbit | 127)
            header += struct.pack(">Q", ln)
        if mask:
            mk = os.urandom(4)
            header += mk
            payload = bytes(b ^ mk[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(bytes(header) + payload)

    def recv_frame(self):
        b1, b2 = self._recv_exact(2)
        fin, opcode = bool(b1 & 0x80), b1 & 0x0F
        ln = b2 & 0x7F
        if ln == 126:
            (ln,) = struct.unpack(">H", self._recv_exact(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", self._recv_exact(8))
        assert not (b2 & 0x80), "server frames must be unmasked"
        return fin, opcode, self._recv_exact(ln)

    def recv_json(self):
        fin, op, payload = self.recv_frame()
        assert op == 0x1, f"expected text frame, got opcode {op}"
        return json.loads(payload)

    def send_json(self, payload):
        self.send_frame(0x1, json.dumps(payload).encode())

    def send_audio(self, audio: np.ndarray, fmt="f32"):
        data = (
            audio.astype(np.float32).tobytes()
            if fmt == "f32"
            else (audio * 32767).astype(np.int16).tobytes()
        )
        self.send_frame(0x2, data)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _speech(seconds=2.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def test_handshake_accept_key(server):
    srv, port = server
    c = WSClient(port)
    assert c.status == 101
    expected = base64.b64encode(
        hashlib.sha1(
            (c.key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
        ).digest()
    ).decode()
    assert c.accept_header() == expected
    assert make_accept(c.key) == expected
    c.close()


def test_stream_roundtrip_push_results(server):
    srv, port = server
    c = WSClient(port, "/v1/ws?language=en")
    assert c.status == 101
    # feed 8 s of audio: the chunker flushes on max-latency (5 s), so at
    # least one result should be PUSHED without any poll from us
    for _ in range(4):
        c.send_audio(_speech(2.0))
    msgs = []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        msg = c.recv_json()
        msgs.append(msg)
        if msg["op"] == "result":
            break
    assert any(m["op"] == "result" and m["text"] == "ok" for m in msgs)
    # finalize: tail decode + summary + close frame
    c.send_json({"op": "end"})
    got_end = False
    while True:
        fin, op, payload = c.recv_frame()
        if op == 0x8:  # close
            break
        if op == 0x1:
            msg = json.loads(payload)
            if msg["op"] == "end":
                got_end = True
                assert "latency" in msg and msg["result_count"] >= 1
    assert got_end
    c.close()


def test_i16_format_and_fragmented_message(server):
    srv, port = server
    c = WSClient(port, "/v1/ws?format=i16")
    assert c.status == 101
    data = (_speech(6.0) * 32767).astype(np.int16).tobytes()
    # split one logical binary message across three frames
    third = len(data) // 3
    c.send_frame(0x2, data[:third], fin=False)
    c.send_frame(0x0, data[third:2 * third], fin=False)
    c.send_frame(0x0, data[2 * third:], fin=True)
    c.send_json({"op": "end"})
    texts = []
    while True:
        fin, op, payload = c.recv_frame()
        if op == 0x8:
            break
        if op == 0x1:
            msg = json.loads(payload)
            if msg["op"] == "result":
                texts.append(msg["text"])
    assert texts and all(t == "ok" for t in texts)
    # the fragmented message arrived as ONE feed: pipeline saw 6 s total
    fed = sum(n for n, _ in srv.pipeline.calls)
    assert fed >= 6 * 16000
    c.close()


def test_ping_answered_with_pong(server):
    srv, port = server
    c = WSClient(port)
    c.send_frame(0x9, b"hello")  # ping
    fin, op, payload = c.recv_frame()
    assert op == 0xA and payload == b"hello"
    c.send_json({"op": "end"})
    c.close()


def test_unmasked_client_frame_is_rejected(server):
    srv, port = server
    c = WSClient(port)
    c.send_frame(0x2, b"\x00" * 64, mask=False)
    # server must close (a close frame, then EOF)
    saw_close = False
    try:
        while True:
            fin, op, payload = c.recv_frame()
            if op == 0x8:
                saw_close = True
    except ConnectionError:
        pass
    assert saw_close
    c.close()


def test_bad_params_rejected_before_upgrade(server):
    srv, port = server
    c = WSClient(port, "/v1/ws?format=mp3")
    assert c.status == 400
    c.close()
    c = WSClient(port, "/v1/ws?language=klingon")
    assert c.status == 400
    c.close()


def test_missing_upgrade_headers_is_400(server):
    srv, port = server
    sock = socket.create_connection(("127.0.0.1", port), 10)
    sock.sendall(
        b"GET /v1/ws HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n"
    )
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            break
        buf += chunk
    assert b" 400 " in buf.split(b"\r\n", 1)[0]
    sock.close()


def test_ws_sessions_share_max_streams_budget(server):
    srv, port = server
    srv.max_streams = 1
    c1 = WSClient(port)
    assert c1.status == 101
    c2 = WSClient(port)
    assert c2.status == 429
    c2.close()
    c1.send_json({"op": "end"})
    # drain until close so the server releases the slot
    try:
        while True:
            fin, op, payload = c1.recv_frame()
            if op == 0x8:
                break
    except ConnectionError:
        pass
    c1.close()
    deadline = time.monotonic() + 5
    while srv._ws_active and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv._ws_active == 0
    c3 = WSClient(port)
    assert c3.status == 101
    c3.send_json({"op": "end"})
    c3.close()


def test_long_poll_start_counts_ws_sessions(server):
    """The max_streams budget is shared in BOTH directions: with a live
    WS session occupying the last slot, POST /v1/stream/start must 429."""
    import urllib.error
    import urllib.request

    srv, port = server
    srv.max_streams = 1
    c = WSClient(port)
    assert c.status == 101
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/stream/start", data=b"", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 429
    c.send_json({"op": "end"})
    c.close()


def test_feed_backpressure_loses_no_audio():
    """A client pumping faster than the decode must not overwrite the
    ring buffer: _feed_backpressured blocks until the worker drains, so
    the pipeline sees every fed sample exactly once."""
    import whisperx_tpu_torch.serve.ws as wsmod
    from whisperx_tpu_torch.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    class CountingPipeline:
        def __init__(self):
            self.samples_seen = 0
            self.language = "en"
            self.task = "transcribe"

        def transcribe(self, audio, **kw):
            # count only true (unpadded) samples: _emit pads to whole
            # seconds with zeros, audio here is nonzero
            self.samples_seen += int(np.count_nonzero(audio))
            return {"segments": [], "language": "en"}

    pipe = CountingPipeline()
    cfg = StreamingConfig(
        buffer_seconds=1.0,          # tiny ring: 16000 samples
        min_chunk_seconds=0.25,
        max_latency_seconds=0.0,     # worker flushes every tick
        silence_flush_seconds=0.01,
    )
    tr = StreamingTranscriber(pipe, cfg)
    tr.start()
    dead = __import__("threading").Event()
    total = 3 * 16000  # 3x the ring capacity
    audio = np.full(total, 0.25, np.float32)
    wsmod._feed_backpressured(tr, audio, dead, poll_s=0.01)
    tr.stop()
    assert pipe.samples_seen == total

    # dead worker: the fallback feeds the remainder instead of hanging
    tr2 = StreamingTranscriber(pipe, cfg)  # never started
    wsmod._feed_backpressured(
        tr2, np.full(2 * 16000, 0.25, np.float32), dead, poll_s=0.01
    )
    assert len(tr2.buffer) == 16000  # ring holds last capacity's worth


def test_idle_ticks_skip_vad_until_flush_due():
    """process_available with no new samples must not rerun VAD over the
    pending buffer every tick — only once the force-flush is due."""
    from whisperx_tpu_torch.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    pipe = FakePipeline()
    tr = StreamingTranscriber(
        pipe, StreamingConfig(min_chunk_seconds=0.5, max_latency_seconds=60.0)
    )
    calls = {"n": 0}
    real = tr.chunker.vad.speech_probs

    def counting(x):
        calls["n"] += 1
        return real(x)

    tr.chunker.vad.speech_probs = counting
    tr.feed(np.full(32000, 0.3, np.float32))
    tr.process_available()
    base = calls["n"]
    for _ in range(5):
        tr.process_available()  # idle, latency not due
    assert calls["n"] == base
    tr.chunker._last_emit -= 61.0
    tr.process_available()  # now due → one more VAD pass + flush
    assert calls["n"] == base + 1
    assert tr.results


def test_health_reports_ws_sessions(server):
    srv, port = server
    import urllib.request

    c = WSClient(port)
    assert c.status == 101
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    ) as resp:
        payload = json.loads(resp.read())
    assert payload["active_ws"] == 1
    c.send_json({"op": "end"})
    c.close()


def test_unknown_control_op_gets_error_frame(server):
    srv, port = server
    c = WSClient(port)
    c.send_json({"op": "warp"})
    msg = c.recv_json()
    assert msg["op"] == "error" and "warp" in msg["error"]
    c.send_json({"op": "end"})
    c.close()
