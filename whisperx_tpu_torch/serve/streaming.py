"""Streaming transcription: ring buffer + VAD-aware chunker + worker.

Counterpart of ``whisperx_tpu/serve/streaming.py`` (reference
backends/mlx_streaming.py: circular AudioBuffer :34-117, StreamingChunker
flushing on ≥0.3 s silence or max latency :119-196, StreamingTranscriber
worker with previous-text conditioning :198-357). Each flushed chunk goes
through the pipeline's ordinary 30 s decode. The JAX package's buckets
(whole-second chunk padding, 32-token prompts, prefix replay rounded to 32
tokens) kept its compiled shapes few; they also decide what the VAD, the
mel and the decoder see, so the port keeps them, and gives the same results.

Online speaker tracking reads the diarizer's ``TurnTable`` (the port's
DataFrame, a deliberate difference), and builds its diarizer on the
pipeline's device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE


@dataclass
class StreamingConfig:
    sample_rate: int = SAMPLE_RATE
    buffer_seconds: float = 60.0
    min_chunk_seconds: float = 1.0
    max_latency_seconds: float = 5.0
    silence_flush_seconds: float = 0.3
    vad_threshold: float = 0.5
    condition_on_previous_text: bool = True
    # emit PROVISIONAL transcripts of the still-growing utterance every
    # this many seconds of new speech (None = only flush-complete chunks).
    # Partials reuse previously committed tokens as a decode prefix
    # (LocalAgreement), so each re-decode generates only the tail.
    partial_interval_seconds: Optional[float] = None
    # token budget per partial decode (prefix + generated tail)
    partial_token_budget: int = 224
    # per-stream language override (None = pipeline language / auto-detect)
    language: Optional[str] = None
    # ONLINE speaker tracking: diarize each chunk-final and keep speaker
    # labels consistent ACROSS chunks via an embedding registry (the
    # offline DiarizationPipeline labels restart per call). No reference
    # counterpart — its diarization is offline-only (diarize.py).
    diarize: bool = False
    # cosine-similarity floor for matching a chunk-local speaker to an
    # already-seen one; below it a new global speaker is registered
    diarize_threshold: float = 0.5
    # hard cap on distinct global speakers (None = unbounded)
    max_speakers: Optional[int] = None


class AudioRingBuffer:
    """Thread-safe circular float32 buffer (reference :34-117)."""

    def __init__(self, capacity_samples: int):
        self.capacity = capacity_samples
        self._buf = np.zeros(capacity_samples, np.float32)
        self._lock = threading.Lock()
        self._write = 0
        self._count = 0

    def write(self, samples: np.ndarray) -> int:
        samples = np.asarray(samples, np.float32).reshape(-1)
        with self._lock:
            n = min(len(samples), self.capacity)
            samples = samples[-n:]
            end = (self._write + n) % self.capacity
            if self._write + n <= self.capacity:
                self._buf[self._write : self._write + n] = samples
            else:
                split = self.capacity - self._write
                self._buf[self._write :] = samples[:split]
                self._buf[:end] = samples[split:]
            self._write = end
            self._count = min(self._count + n, self.capacity)
            return n

    def read(self, n: Optional[int] = None) -> np.ndarray:
        """Pop up to n oldest samples."""
        with self._lock:
            n = self._count if n is None else min(n, self._count)
            start = (self._write - self._count) % self.capacity
            if start + n <= self.capacity:
                out = self._buf[start : start + n].copy()
            else:
                split = self.capacity - start
                out = np.concatenate([self._buf[start:], self._buf[: n - split]])
            self._count -= n
            return out

    def peek(self, n: Optional[int] = None) -> np.ndarray:
        with self._lock:
            n = self._count if n is None else min(n, self._count)
            start = (self._write - self._count) % self.capacity
            if start + n <= self.capacity:
                return self._buf[start : start + n].copy()
            split = self.capacity - start
            return np.concatenate([self._buf[start:], self._buf[: n - split]])

    def __len__(self) -> int:
        with self._lock:
            return self._count


class StreamingChunker:
    """Accumulate speech; emit a chunk on trailing silence or max latency."""

    def __init__(self, config: StreamingConfig, vad=None):
        self.config = config
        if vad is None:
            from whisperx_tpu_torch.vad import EnergyVAD

            vad = EnergyVAD(vad_onset=config.vad_threshold)
        self.vad = vad
        self._pending = np.zeros(0, np.float32)
        self._last_emit = time.monotonic()

    def force_due(self) -> bool:
        """True when push() would force-flush the pending audio even with
        no new samples (max-latency elapsed or the 30 s hard cap) — lets
        idle callers skip the VAD pass that push() would otherwise rerun
        over the whole pending buffer every tick."""
        sr = self.config.sample_rate
        if len(self._pending) < int(self.config.min_chunk_seconds * sr):
            return False
        return (
            time.monotonic() - self._last_emit
            >= self.config.max_latency_seconds
            or len(self._pending) >= 30 * sr
        )

    def push(self, samples: np.ndarray) -> List[np.ndarray]:
        """Feed samples; returns zero or more complete chunks."""
        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, np.float32).reshape(-1)]
        )
        sr = self.config.sample_rate
        chunks: List[np.ndarray] = []

        min_samples = int(self.config.min_chunk_seconds * sr)
        if len(self._pending) < min_samples:
            return chunks

        force = (
            time.monotonic() - self._last_emit >= self.config.max_latency_seconds
            or len(self._pending) >= 30 * sr
        )

        probs = self.vad.speech_probs(self._pending)
        silence_windows = int(self.config.silence_flush_seconds * sr / 512)
        trailing_silent = (
            len(probs) > silence_windows
            and bool((probs[-silence_windows:] < self.config.vad_threshold).all())
        )
        has_speech = bool((probs >= self.config.vad_threshold).any())

        if (trailing_silent and has_speech) or force:
            pending, self._pending = self._pending, np.zeros(0, np.float32)
            self._last_emit = time.monotonic()
            # A bursty feed (a client pushing a whole file at socket
            # speed) can land tens of seconds in one push — emitted
            # whole, one chunk would be of an arbitrary size no live
            # feed makes. Split into pieces no larger than the biggest
            # bucket warmup_streaming warms (ceil(max_latency)+1 s — the
            # size real-time pacing emits anyway, capped by the 30 s
            # decode window), and place each cut at the least-speechy VAD
            # window near the cap so a word is not torn across two decodes.
            cap = min(30, int(np.ceil(self.config.max_latency_seconds)) + 1) * sr
            start = 0
            # second loop guard: never leave a tail shorter than the
            # chunker's own minimum (a few-ms remainder would become its
            # own micro-decode)
            while (
                len(pending) - start > cap
                and len(pending) - start >= 2 * min_samples
            ):
                hi = min(start + cap, len(pending) - min_samples)
                lo = start + max(min_samples, int(0.6 * cap))
                wlo = -(-lo // 512)
                whi = min(hi // 512, len(probs))
                if whi > wlo:
                    cut = (int(np.argmin(probs[wlo:whi])) + wlo) * 512
                else:
                    # fallback when the VAD search window is empty: keep the
                    # chunk itself <= cap (an oversized chunk is the very
                    # thing the splitter exists to prevent) while leaving a
                    # >= min_samples tail
                    cut = max(
                        start + min_samples,
                        min(start + cap, len(pending) - min_samples),
                    )
                chunks.append(pending[start:cut])
                start = cut
            chunks.append(pending[start:])
        return chunks

    def flush(self) -> Optional[np.ndarray]:
        if len(self._pending) == 0:
            return None
        out, self._pending = self._pending, np.zeros(0, np.float32)
        return out


class IncrementalUtteranceDecoder:
    """Prefix-reusing partial decoding of a growing utterance.

    Whisper's encoder attends globally, so encoder features for old audio
    genuinely change as the window grows — feature-level reuse would alter
    output. What IS reusable across partial decodes are the TOKENS: tokens
    that two consecutive partials agree on (LocalAgreement-2, the public
    streaming-whisper recipe) are committed and fed back as the decode
    ``prefix``, so each re-decode generates only the unstable tail. The
    decode itself is the ordinary production decode, on the model's device.
    """

    # replayed-prefix lengths are rounded DOWN to this bucket, and the
    # sample budget shrinks in step (JAX's reason: few distinct decode
    # shapes, each an XLA compile). The replay length decides which tokens
    # the next partial regenerates and so which get committed: it is part
    # of the result, and kept as in JAX.
    PREFIX_BUCKET = 32
    TOKEN_BUDGET = 224

    def __init__(
        self,
        model,
        language: str = "en",
        task: str = "transcribe",
        token_budget: Optional[int] = None,
    ):
        self.model = model
        self.language = language
        self.task = task
        if token_budget is not None:
            self.TOKEN_BUDGET = token_budget
        self.stable: List[int] = []
        self._last_full: Optional[List[int]] = None
        self._tok = None  # built once; construction reads the ranks file

    def reset(self) -> None:
        self.stable = []
        self._last_full = None

    def _tokenizer(self):
        if self._tok is None:
            from whisperx_tpu_torch.decoding import get_tokenizer

            self._tok = get_tokenizer(
                self.model.is_multilingual,
                num_languages=self.model.num_languages,
                language=self.language,
                task=self.task,
                vocab_path=self.model.vocab_path,
            )
        return self._tok

    def partial(self, audio: np.ndarray) -> dict:
        """Decode the utterance-so-far; returns {text, stable_text,
        tokens, stable_tokens}."""
        from whisperx_tpu_torch.audio import N_SAMPLES, pad_or_trim
        from whisperx_tpu_torch.audio.mel import log_mel_spectrogram
        from whisperx_tpu_torch.decoding import DecodingOptions, decode

        head = np.asarray(pad_or_trim(np.asarray(audio, np.float32), N_SAMPLES))
        mel = log_mel_spectrogram(
            head, self.model.dims.n_mels, device=self.model.device
        ).T  # [T, n_mels]
        # the committed prefix can outgrow the budget (agreement keeps
        # extending it); cap the REPLAYED part so at least one bucket of
        # generation budget always remains — sample_len must stay positive
        # (clamped: a budget below one bucket means nothing is replayed,
        # never a negative slice)
        max_replay = max(0, self.TOKEN_BUDGET - self.PREFIX_BUCKET)
        replay_len = min(
            (len(self.stable) // self.PREFIX_BUCKET) * self.PREFIX_BUCKET,
            (max_replay // self.PREFIX_BUCKET) * self.PREFIX_BUCKET,
        )
        replay = self.stable[:replay_len]
        opts = DecodingOptions(
            language=self.language,
            task=self.task,
            without_timestamps=True,  # prefix replay has no timestamp grammar
            prefix=list(replay) or None,
            sample_len=self.TOKEN_BUDGET - len(replay),
        )
        result = decode(self.model, mel, opts, tokenizer=self._tokenizer())
        # committed tokens are FINAL (the LocalAgreement contract): the
        # regenerated span inside [len(replay), len(stable)) is discarded
        # in favor of the committed tokens, and the fresh tail splices on
        skip = len(self.stable) - len(replay)
        full = list(self.stable) + list(result.tokens[skip:])

        # LocalAgreement-2: commit the longest common prefix of this and
        # the previous full hypothesis
        if self._last_full is not None:
            n = 0
            for a, b in zip(self._last_full, full):
                if a != b:
                    break
                n += 1
            if n > len(self.stable):
                self.stable = full[:n]
        self._last_full = full

        tok = self._tokenizer()
        return {
            "text": tok.decode(full).strip(),
            "stable_text": tok.decode(self.stable).strip(),
            "tokens": full,
            "stable_tokens": list(self.stable),
            # decode-shape diagnostics (latency ~ 8 ms/token generated):
            # surfaced into the result entries so tail latencies in
            # latency_stats() carry their own explanation
            "replayed": len(replay),
            "generated": len(result.tokens),
        }


class SpeakerRegistry:
    """Cross-chunk speaker identity for live streams.

    Per-chunk diarization labels are local — SPEAKER_00 restarts with
    every chunk. The registry matches each chunk-local centroid to a
    global speaker by cosine similarity (embeddings are unit-norm, both
    the spectral-stat fallback and converted neural checkpoints), or
    registers a new one when nothing clears ``threshold``. Global
    centroids update as duration-weighted running means, so an identity
    sharpens the longer its speaker talks. With ``max_speakers`` set, a
    full registry snaps to the nearest existing speaker instead."""

    def __init__(self, threshold: float = 0.5,
                 max_speakers: Optional[int] = None):
        self.threshold = threshold
        self.max_speakers = max_speakers
        self.centroids: List[np.ndarray] = []
        self.weights: List[float] = []

    def assign(self, embedding, duration_s: float) -> int:
        """Chunk-local centroid → global speaker index."""
        v = np.asarray(embedding, np.float64).reshape(-1)
        n = float(np.linalg.norm(v))
        v = v / n if n > 0 and np.isfinite(n) else v
        w = max(float(duration_s), 1e-3)
        if self.centroids:
            sims = np.array([float(c @ v) for c in self.centroids])
            best = int(sims.argmax())
            full = (
                self.max_speakers is not None
                and len(self.centroids) >= self.max_speakers
            )
            if sims[best] >= self.threshold or full:
                c = self.centroids[best] * self.weights[best] + v * w
                cn = float(np.linalg.norm(c))
                self.centroids[best] = c / cn if cn > 0 else c
                self.weights[best] += w
                return best
        self.centroids.append(v)
        self.weights.append(w)
        return len(self.centroids) - 1


class StreamingTranscriber:
    """Background worker turning a live audio feed into incremental results."""

    def __init__(
        self,
        pipeline,
        config: Optional[StreamingConfig] = None,
        on_result: Optional[Callable[[dict], None]] = None,
    ):
        self.pipeline = pipeline
        self.config = config or StreamingConfig()
        self.on_result = on_result
        self.buffer = AudioRingBuffer(
            int(self.config.buffer_seconds * self.config.sample_rate)
        )
        self.chunker = StreamingChunker(self.config)
        self.results: List[dict] = []
        self._prev_text = ""
        self._offset_s = 0.0
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # serializes decode passes (worker ticks, sync callers, stop()'s
        # tail flush): if stop()'s bounded join times out mid-decode, the
        # tail flush must not mutate chunker/buffer state concurrently
        # with the still-running pass
        self._proc_lock = threading.Lock()
        # latency accounting: (cumulative samples fed, wall time)
        self._fed = 0
        self._consumed = 0
        self._feed_times: List[tuple] = []
        self._last_partial_len = 0
        self._incremental: Optional[IncrementalUtteranceDecoder] = None
        # online speaker tracking (config.diarize): lazily-built chunk
        # diarizer + the cross-chunk identity registry
        self._diarizer = None
        self._speakers = SpeakerRegistry(
            threshold=self.config.diarize_threshold,
            max_speakers=self.config.max_speakers,
        )

    def feed(self, samples: np.ndarray) -> None:
        n = self.buffer.write(samples)
        self._fed += n
        self._feed_times.append((self._fed, time.monotonic()))

    def _feed_time_for(self, cum_samples: int) -> Optional[float]:
        """Wall time at which the cum_samples-th sample was fed.

        Entries below the already-consumed watermark can never be queried
        again, so they are pruned here — a live-mic stream feeding small
        packets would otherwise grow the list without bound and rescan it
        from the start on every emit."""
        drop = 0
        for c, _ in self._feed_times:
            if c < self._consumed and c < cum_samples:
                drop += 1
            else:
                break
        if drop:
            del self._feed_times[:drop]
        for c, ts in self._feed_times:
            if c >= cum_samples:
                return ts
        return self._feed_times[-1][1] if self._feed_times else None

    def latency_stats(self) -> dict:
        """Summary of emit latencies (seconds from newest-sample-fed to
        result emitted), split by partial vs chunk-final results."""
        lats = [r["latency_s"] for r in self.results if "latency_s" in r]
        partials = [
            r["latency_s"]
            for r in self.results
            if r.get("provisional") and "latency_s" in r
        ]
        out = {}
        if lats:
            out["first_result_s"] = round(self.results[0].get("latency_s", 0), 3)
            out["mean_s"] = round(float(np.mean(lats)), 3)
            out["median_s"] = round(float(np.median(lats)), 3)
            out["p90_s"] = round(float(np.percentile(lats, 90)), 3)
            out["max_s"] = round(float(np.max(lats)), 3)
            # the tail must explain itself: the slowest result's shape
            # diagnostics (what kind it was, how much audio, how many
            # tokens replayed/generated, which padding bucket)
            worst = max(
                (r for r in self.results if "latency_s" in r),
                key=lambda r: r["latency_s"],
            )
            out["max_detail"] = {
                k: worst[k]
                for k in (
                    "latency_s",
                    "provisional",
                    "final",
                    "audio_s",
                    "bucket_s",
                    "prompted",
                    "replayed",
                    "generated",
                )
                if k in worst
            }
        if partials:
            out["partial_mean_s"] = round(float(np.mean(partials)), 3)
            out["partial_median_s"] = round(float(np.median(partials)), 3)
            out["partial_p90_s"] = round(float(np.percentile(partials, 90)), 3)
            out["partial_max_s"] = round(float(np.max(partials)), 3)
        return out

    def start(self) -> None:
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def abandon(self) -> None:
        """Tear down without the final-tail decode or a blocking join —
        for TTL reaping of vanished clients, where the output would be
        discarded and the caller (an HTTP handler or health probe) must
        stay O(1). The daemon worker exits on its next stop check."""
        self._stop.set()
        self._worker = None

    def stop(self) -> List[dict]:
        self._stop.set()
        if self._worker:
            self._worker.join(timeout=10)
            self._worker = None
        # _proc_lock: if the join timed out because the worker is inside a
        # long decode (a first call builds the kernels), wait for that pass
        # to finish rather than flushing chunker/_pending underneath it —
        # the worker re-checks _stop after its pass and exits, so no
        # further results can land after this flush returns
        with self._proc_lock:
            tail = self.chunker.flush()
            pending = self.buffer.read()
        remainder = (
            np.concatenate([tail, pending]) if tail is not None else pending
        )
        if len(remainder) >= 400:
            self._emit(remainder, final=True)
        return self.results

    def process_available(self) -> None:
        """Synchronous drain (also the worker's tick; serialized with
        stop()'s tail flush via _proc_lock)."""
        with self._proc_lock:
            self._process_available_locked()

    def _process_available_locked(self) -> None:
        samples = self.buffer.read()
        # push with no NEW samples too, but only once the force-flush is
        # actually due: the max-latency flush is wall-clock-gated inside
        # push(), so a client that feeds once and then waits (e.g. over
        # the WebSocket push transport) must still get its chunk after
        # max_latency_s — while gating on force_due() keeps the idle
        # 50 ms worker ticks from rerunning VAD over the whole pending
        # buffer every time
        if len(samples) or self.chunker.force_due():
            chunks = self.chunker.push(samples)
        else:
            chunks = []
        for chunk in chunks:
            self._emit(chunk, final=False)
            self._last_partial_len = 0
            if self._incremental is not None:
                self._incremental.reset()
        if self.config.partial_interval_seconds is not None and not chunks:
            pend = self.chunker._pending
            step = int(self.config.partial_interval_seconds * self.config.sample_rate)
            if len(pend) - self._last_partial_len >= step:
                self._emit_partial(pend.copy())
                self._last_partial_len = len(pend)

    def _emit_partial(self, pending: np.ndarray) -> None:
        """Provisional transcript of the still-growing utterance: committed
        tokens replay as the decode prefix (IncrementalUtteranceDecoder),
        so only the unstable tail is re-generated."""
        if self._incremental is None:
            self._incremental = IncrementalUtteranceDecoder(
                self.pipeline.model,
                language=self.config.language
                or getattr(self.pipeline, "language", None)
                or "en",
                task=getattr(self.pipeline, "task", "transcribe"),
                token_budget=self.config.partial_token_budget,
            )
        info = self._incremental.partial(pending)
        t_fed = self._feed_time_for(self._consumed + len(pending))
        entry = {
            "text": info["text"],
            "stable_text": info["stable_text"],
            "start": self._offset_s,
            "end": self._offset_s + len(pending) / self.config.sample_rate,
            "final": False,
            "provisional": True,
            "segments": [],
            "audio_s": round(len(pending) / self.config.sample_rate, 2),
            "replayed": info.get("replayed", 0),
            "generated": info.get("generated", 0),
        }
        if t_fed is not None:
            entry["latency_s"] = round(time.monotonic() - t_fed, 4)
        self.results.append(entry)
        if self.on_result:
            self.on_result(entry)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.process_available()
            time.sleep(0.05)

    PROMPT_TOKENS = 32  # fixed prev-text prompt length, as in JAX

    def _prompt_tokens(self):
        """Prev-text conditioning as EXACTLY PROMPT_TOKENS token ids (or
        none), passed to ``transcribe`` as a token list. JAX fixed the
        length so that a stream runs two decode programs (unprompted,
        prompted) instead of one compile per flush; the prompt is part of
        the decode prefix, so the port keeps it for the same tokens.
        Conditioning quality is unaffected: prev-text is a rolling window
        anyway (reference mlx_streaming.py keeps a text suffix)."""
        from whisperx_tpu_torch.decoding import get_tokenizer

        model = getattr(self.pipeline, "model", None)
        if model is None:  # pipeline without a tokenizer surface: raw text
            return self._prev_text[-200:]
        tok = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            vocab_path=model.vocab_path,
        )
        ids = tok.encode(" " + self._prev_text[-200:].strip())
        if len(ids) < self.PROMPT_TOKENS:
            return None  # wait until a full window accumulates
        return ids[-self.PROMPT_TOKENS:]

    def _attach_speakers(
        self, chunk: np.ndarray, segments: List[dict], base_s: float
    ) -> None:
        """Online diarization of one chunk-final: diarize the chunk,
        resolve its local speaker labels to GLOBAL identities through the
        registry, and tag the (already stream-absolute) segments/words in
        place. Failures degrade to untagged segments — a diarization
        hiccup must not kill the transcript stream."""
        import warnings

        if self._diarizer is None:
            from whisperx_tpu_torch.diarize import DiarizationPipeline

            # the pipeline's device: a CPU pipeline streams on the CPU
            self._diarizer = DiarizationPipeline(
                device=getattr(self.pipeline, "device", None) or "cuda"
            )
        try:
            out = self._diarizer(
                chunk,
                max_speakers=self.config.max_speakers,
                return_embeddings=True,
            )
        except Exception as e:  # degraded, not fatal
            warnings.warn(f"stream diarization failed for a chunk: {e}")
            return
        table, embeds = out
        if len(table) == 0 or not embeds:
            return
        starts = np.asarray(table["start"], np.float64)
        ends = np.asarray(table["end"], np.float64)
        local = [str(s) for s in table["speaker"]]
        rename = {}
        for name, emb in embeds.items():
            mask = np.array([s == name for s in local])
            dur = float((ends[mask] - starts[mask]).sum())
            gid = self._speakers.assign(emb, dur)
            rename[name] = f"SPEAKER_{gid:02d}"
        from whisperx_tpu_torch.diarize import TurnTable, assign_word_speakers

        shifted = TurnTable(
            zip(
                (starts + base_s).tolist(),
                (ends + base_s).tolist(),
                [rename.get(s, s) for s in local],
            )
        )
        assign_word_speakers(shifted, {"segments": segments})

    def _rebase_segment(self, seg: dict, chunk_extent_s: float) -> dict:
        """Rebase a chunk-relative segment (and any DTW words on it) onto
        the stream clock, so consumers can assemble a live transcript /
        caption track without knowing chunk boundaries. Times are clamped
        to the chunk's true extent first: the decode ran on the padded
        bucket, and a timestamp landing in the trailing silence pad would
        otherwise bleed past this entry's window. The reference's
        streaming emitter leaves segment times chunk-relative
        (mlx_streaming.py:300-312 only tags the whole result)."""
        base = self._offset_s

        def shift(t):
            return round(min(float(t), chunk_extent_s) + base, 3)

        out = dict(seg)
        out["start"], out["end"] = shift(seg["start"]), shift(seg["end"])
        if seg.get("words"):
            # word timing can fail for individual words (no start/end key)
            out["words"] = [
                {
                    **w,
                    **{k: shift(w[k]) for k in ("start", "end") if k in w},
                }
                for w in seg["words"]
            ]
        return out

    def _emit(self, chunk: np.ndarray, final: bool) -> None:
        kwargs = {}
        if self.config.condition_on_previous_text and self._prev_text:
            # previous committed text conditions the next chunk's decode
            # (reference mlx_streaming.py prev-text via initial_prompt)
            toks = self._prompt_tokens()
            if toks:
                kwargs = {"initial_prompt": toks}
        if self.config.language:
            kwargs["language"] = self.config.language
        # Bucket the flushed chunk to a whole-second grid before decoding,
        # as JAX does: streaming flushes are naturally ragged (silence
        # boundaries / max-latency cuts), and there every distinct length
        # was its own XLA program. The padding changes what the VAD's
        # percentiles and the mel see, so the port keeps it for the same
        # results. Trailing zeros are silence: VAD drops them, timestamps
        # and text are unaffected; all bookkeeping below uses the true
        # length.
        sr = self.config.sample_rate
        bucket = -(-len(chunk) // sr) * sr
        padded = (
            np.pad(chunk, (0, bucket - len(chunk)))
            if bucket > len(chunk) else chunk
        )
        result = self.pipeline.transcribe(padded, **kwargs)
        self._consumed += len(chunk)
        t_fed = self._feed_time_for(self._consumed)
        true_extent = len(chunk) / self.config.sample_rate
        segments = [
            self._rebase_segment(s, true_extent)
            for s in result["segments"]
        ]
        if self.config.diarize and segments:
            self._attach_speakers(chunk, segments, self._offset_s)
        text = " ".join(s["text"].strip() for s in segments).strip()
        entry = {
            "text": text,
            "start": self._offset_s,
            "end": self._offset_s + true_extent,
            "final": final,
            "provisional": False,
            "segments": segments,
            "audio_s": round(true_extent, 2),
            "bucket_s": bucket // sr,
            "prompted": "initial_prompt" in kwargs,
        }
        if t_fed is not None:
            entry["latency_s"] = round(time.monotonic() - t_fed, 4)
        self._offset_s = entry["end"]
        if text:
            self._prev_text = (self._prev_text + " " + text).strip()
        self.results.append(entry)
        if self.on_result:
            self.on_result(entry)


def warmup_streaming(
    pipeline,
    *,
    max_latency_seconds: float = 5.0,
    partial_token_budget: int = 224,
    partials: bool = True,
    language: Optional[str] = None,
) -> int:
    """Drive every decode shape a live stream can reach, before traffic,
    with the JAX package's calls: each whole-second chunk bucket
    1..ceil(max_latency)+1 s, one prompted chunk
    (``StreamingTranscriber.PROMPT_TOKENS``), and with ``partials`` one
    partial per committed-prefix bucket (``PREFIX_BUCKET`` steps up to the
    token budget). On the card these calls build the kernels and warm
    cuDNN and the allocator. Returns the number of warm calls made."""
    from whisperx_tpu_torch.asr import warmup_audio

    secs = int(np.ceil(max_latency_seconds)) + 1
    audio = warmup_audio(float(secs))
    lang_kw = {"language": language} if language else {}
    calls = 0
    for s in range(1, secs + 1):
        pipeline.transcribe(audio[: s * SAMPLE_RATE], **lang_kw)
        calls += 1
    prompt = list(range(300, 300 + StreamingTranscriber.PROMPT_TOKENS))
    pipeline.transcribe(
        audio[: secs * SAMPLE_RATE], initial_prompt=prompt, **lang_kw
    )
    calls += 1
    model = getattr(pipeline, "model", None)
    if partials and model is not None:
        warm = IncrementalUtteranceDecoder(
            model,
            language=language or getattr(pipeline, "language", None) or "en",
            task=getattr(pipeline, "task", "transcribe") or "transcribe",
            token_budget=partial_token_budget,
        )
        warm.partial(audio[: 2 * SAMPLE_RATE])
        calls += 1
        # walk every committed-prefix bucket the utterance can reach —
        # same recipe tools/streaming_latency.py validated on chip
        for n_stable in range(
            warm.PREFIX_BUCKET, partial_token_budget, warm.PREFIX_BUCKET
        ):
            warm.stable = list(range(200, 200 + n_stable))
            warm._last_full = None
            warm.partial(audio[: 2 * SAMPLE_RATE])
            calls += 1
    return calls
