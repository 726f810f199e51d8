"""WebSocket (RFC 6455) push transport for live streaming transcription.

The long-poll HTTP stream endpoints (``server.py`` /v1/stream/*) are the
robust default — they work with any HTTP client and never assume a
full-duplex socket. This module adds the push transport on top of the
same ``StreamingTranscriber``: results are sent the moment the worker
emits them (via the ``on_result`` callback) instead of waiting for the
client's next poll, so partial latency is bounded by the decode, not the
client's polling cadence.

Counterpart of ``whisperx_tpu/serve/ws.py``, unchanged but for the port's
imports. The reference ships streaming *classes* but no network transport
at all (reference backends/mlx_streaming.py:198-357 — the worker-thread +
callback design this module's session mirrors); both transports here are
original serving surface.

Protocol (stdlib-only, no websockets dependency)
------------------------------------------------
``GET /v1/ws`` with an ``Upgrade: websocket`` handshake. Query params
mirror ``/v1/stream/start``: ``language``, ``partial_interval``,
``diarize``, ``max_speakers``; plus ``format`` (``f32``|``i16``, default
f32) and ``sample_rate`` (default 16000) describing the binary frames.

- client → server BINARY frame: raw PCM chunk in the negotiated format
- client → server TEXT frame: JSON control, ``{"op": "end"}`` finalizes
  (decodes the buffered tail, sends the summary, closes)
- server → client TEXT frames: ``{"op": "result", ...entry}`` per
  incremental result (same entry schema as the long-poll endpoints),
  then ``{"op": "end", "latency": {...}, "result_count": N}``
- pings are answered with pongs; a client close frame tears the session
  down without the final-tail decode (same semantics as TTL abandon)
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes (RFC 6455 §5.2)
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def make_accept(key: str) -> str:
    """Sec-WebSocket-Accept for a client Sec-WebSocket-Key (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((key.strip() + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


class WSProtocolError(Exception):
    """Peer violated WebSocket framing; the connection must be dropped."""


class WebSocket:
    """Server-side frame codec over the handler's buffered socket files.

    Writes are serialized with an internal lock: the transcriber worker
    pushes results from its own thread while the handler thread answers
    pings and sends the final summary.
    """

    def __init__(self, rfile, wfile, conn=None,
                 max_message_bytes: int = 64 * 1024 * 1024):
        self.rfile = rfile
        self.wfile = wfile
        self.conn = conn  # raw socket, for timeout control (may be None)
        self.max_message_bytes = max_message_bytes
        self._wlock = threading.Lock()
        self._closed = False

    # -- receive ---------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        data = self.rfile.read(n)
        if data is None or len(data) != n:
            raise WSProtocolError("connection closed mid-frame")
        return data

    def _read_frame(self):
        """One raw frame → (fin, opcode, payload). Client frames MUST be
        masked (RFC 6455 §5.1 — a server closes on unmasked input)."""
        b1, b2 = self._read_exact(2)
        if b1 & 0x70:
            raise WSProtocolError("RSV bits set without a negotiated extension")
        fin, opcode = bool(b1 & 0x80), b1 & 0x0F
        masked, ln = bool(b2 & 0x80), b2 & 0x7F
        if not masked:
            raise WSProtocolError("client frame not masked")
        if ln == 126:
            (ln,) = struct.unpack(">H", self._read_exact(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", self._read_exact(8))
        if ln > self.max_message_bytes:
            raise WSProtocolError(
                f"frame of {ln} bytes exceeds max_message_bytes "
                f"({self.max_message_bytes})"
            )
        if opcode in (OP_CLOSE, OP_PING, OP_PONG) and (ln > 125 or not fin):
            raise WSProtocolError("control frame over 125 bytes or fragmented")
        mask = self._read_exact(4)
        payload = self._read_exact(ln) if ln else b""
        if ln:
            # numpy XOR unmask: audio frames run to megabytes, a Python
            # byte loop would dominate the receive path
            data = np.frombuffer(payload, np.uint8)
            key = np.frombuffer((mask * ((ln + 3) // 4))[:ln], np.uint8)
            payload = (data ^ key).tobytes()
        return fin, opcode, payload

    def recv_message(self):
        """Next complete data message → (opcode, payload), or None once a
        close frame arrives (the close reply is sent here). Pings are
        answered inline; interleaved control frames mid-fragmentation are
        handled per RFC 6455 §5.4."""
        parts: list[bytes] = []
        opcode: Optional[int] = None
        total = 0
        while True:
            fin, op, payload = self._read_frame()
            if op == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                self.send_close(echo=payload)
                return None
            if op == OP_CONT:
                if opcode is None:
                    raise WSProtocolError("continuation frame without a start")
            elif op in (OP_TEXT, OP_BINARY):
                if opcode is not None:
                    raise WSProtocolError("new data frame inside a fragmented message")
                opcode = op
            else:
                raise WSProtocolError(f"unknown opcode 0x{op:x}")
            total += len(payload)
            if total > self.max_message_bytes:
                raise WSProtocolError(
                    f"message over max_message_bytes ({self.max_message_bytes})"
                )
            parts.append(payload)
            if fin:
                return opcode, b"".join(parts)

    # -- send ------------------------------------------------------------

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        header = bytearray([0x80 | opcode])
        ln = len(payload)
        if ln < 126:
            header.append(ln)
        elif ln < 1 << 16:
            header.append(126)
            header += struct.pack(">H", ln)
        else:
            header.append(127)
            header += struct.pack(">Q", ln)
        with self._wlock:
            if self._closed:
                raise ConnectionError("websocket already closed")
            self.wfile.write(bytes(header) + payload)
            self.wfile.flush()

    def send_json(self, payload: dict) -> None:
        self._send_frame(OP_TEXT, json.dumps(payload, ensure_ascii=False).encode())

    def send_close(self, code: int = 1000, reason: str = "", echo: bytes = None) -> None:
        """Send a close frame once; later sends raise. ``echo`` replays the
        peer's close payload (status echo per RFC 6455 §5.5.1)."""
        body = echo if echo is not None else (
            struct.pack(">H", code) + reason.encode()[:123]
        )
        try:
            self._send_frame(OP_CLOSE, body)
        except (ConnectionError, OSError):
            pass
        with self._wlock:
            self._closed = True


def _decode_pcm(data: bytes, fmt: str, sample_rate: int) -> np.ndarray:
    """Binary frame bytes → float32 mono 16 kHz samples."""
    from whisperx_tpu_torch.audio.constants import SAMPLE_RATE

    if fmt == "i16":
        audio = np.frombuffer(
            data[: len(data) - (len(data) % 2)], np.int16
        ).astype(np.float32) / 32768.0
    else:
        audio = np.frombuffer(
            data[: len(data) - (len(data) % 4)], np.float32
        )
    if sample_rate != SAMPLE_RATE:
        from whisperx_tpu_torch.audio.io import _resample

        audio = _resample(audio, sample_rate, SAMPLE_RATE)
    return np.ascontiguousarray(audio, np.float32)


def stream_session(
    ws: WebSocket,
    pipeline,
    *,
    language: Optional[str] = None,
    partial_interval: Optional[float] = None,
    diarize: bool = False,
    max_speakers: Optional[int] = None,
    pcm_format: str = "f32",
    sample_rate: int = 16000,
    idle_timeout_s: float = 900.0,
) -> None:
    """Drive one WebSocket streaming session to completion.

    The transcriber worker thread decodes on its own cadence and pushes
    every result through ``on_result`` the moment it exists; this (the
    handler) thread only feeds audio and handles control traffic. A dead
    client (send failure or ``idle_timeout_s`` of receive silence) tears
    the session down via ``abandon()`` — no final-tail decode for output
    nobody will read.
    """
    from whisperx_tpu_torch.serve.streaming import StreamingConfig, StreamingTranscriber

    cfg = StreamingConfig()
    if partial_interval:
        cfg.partial_interval_seconds = float(partial_interval)
    if language:
        cfg.language = language
    if diarize:
        cfg.diarize = True
        cfg.max_speakers = max_speakers

    dead = threading.Event()

    def on_result(entry: dict) -> None:
        if dead.is_set():
            return
        try:
            ws.send_json({"op": "result", **entry})
        except (ConnectionError, OSError):
            dead.set()

    tr = StreamingTranscriber(pipeline, cfg, on_result=on_result)
    tr.start()
    if ws.conn is not None:
        # idle clamp: a vanished client must not pin the session forever
        ws.conn.settimeout(idle_timeout_s)
    try:
        while not dead.is_set():
            try:
                msg = ws.recv_message()
            except socket.timeout:
                tr.abandon()
                ws.send_close(code=1001, reason="idle timeout")
                return
            if msg is None:  # client close frame
                tr.abandon()
                return
            op, data = msg
            if op == OP_BINARY:
                if data:
                    _feed_backpressured(
                        tr, _decode_pcm(data, pcm_format, sample_rate), dead
                    )
                continue
            # TEXT control
            try:
                ctl = json.loads(data.decode("utf-8"))
                if not isinstance(ctl, dict):
                    raise ValueError("control message must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                ws.send_json({"op": "error", "error": f"bad control frame: {e}"})
                continue
            if ctl.get("op") == "end":
                results = tr.stop()  # final tail emits through on_result
                ws.send_json(
                    {
                        "op": "end",
                        "result_count": len(results),
                        "latency": tr.latency_stats(),
                    }
                )
                ws.send_close()
                return
            ws.send_json(
                {"op": "error", "error": f"unknown op {ctl.get('op')!r}"}
            )
    except (WSProtocolError, ConnectionError, OSError) as e:
        tr.abandon()
        try:
            ws.send_close(code=1002, reason=str(e)[:80])
        except Exception:
            pass
    finally:
        dead.set()
        # belt-and-braces: never leave a worker thread running
        tr.abandon()


def _feed_backpressured(
    tr, audio: np.ndarray, dead: threading.Event, poll_s: float = 0.05
) -> None:
    """Feed without overrunning the transcriber's ring buffer.

    A WS client can pump audio far faster than the worker decodes
    (examples/ws_client.py sends a whole file at socket speed unless
    --realtime); the ring buffer silently overwrites its oldest samples
    on overflow, which would DROP transcript audio. Blocking here stalls
    the receive loop, TCP flow control propagates the stall to the
    client, and nothing is lost. The long-poll transport gets the same
    property from its synchronous per-POST drain."""
    pos = 0
    while pos < len(audio) and not dead.is_set():
        free = tr.buffer.capacity - len(tr.buffer)
        if free <= 0:
            worker = tr._worker
            if worker is None or not worker.is_alive():
                # nobody is draining (worker died/stopped): feeding the
                # rest loses the oldest samples, but spinning here would
                # hang the session forever
                tr.feed(audio[pos:])
                return
            time.sleep(poll_s)
            continue
        n = min(free, len(audio) - pos)
        tr.feed(audio[pos : pos + n])
        pos += n
