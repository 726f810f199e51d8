"""ASR pipeline: VAD segmentation + truly batched Whisper decode.

Counterpart of ``whisperx_tpu/asr.py``. The batched mode:

  1. the waveform is uploaded once; the VAD reads the resident tensor;
  2. merged VAD chunks are cut and turned into log-mels on the device;
  3. chunks are packed into fixed-size, zero-padded batches, one decode each
     (encoder with the K1 attention kernel, cross-KV, prefill, step loop);
  4. temperature fallback re-batches only the chunks that fail the
     compression-ratio / log-prob gates;
  5. each chunk's tokens are split into timestamped segments;
  6. with ``word_timestamps``, word timing (``timing/``) over every chunk's
     window, batched, and with ``hallucination_silence_threshold`` the
     per-chunk eviction of anomalous segments surrounded by silence.

``transcribe_many`` pools the chunks of many requests into the same device
batches. Without a VAD, or with ``decode_mode="sequential"`` (the
``backend="sequential"`` of ``load_model``), the sequential seek loop of
``decoding/transcribe.py`` decodes the whole file, or each VAD chunk, one
30 s window at a time. With a ``draft_model``, the greedy batches (temperature
0, no beam) go through the speculative decoder
(``decoding/speculative.py``); the fallback temperatures decode normally.
"""

from __future__ import annotations

import bisect
import math
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio import (
    FRAMES_PER_SECOND,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    pad_or_trim,
)
from whisperx_tpu_torch.audio.device_chunk import DeviceAudio, chunk_mels, upload_audio
from whisperx_tpu_torch.decoding import DecodingOptions, get_tokenizer
from whisperx_tpu_torch.decoding.decode import decode_dispatch, decode_finalize
from whisperx_tpu_torch.decoding.decode import detect_language as _detect_language
from whisperx_tpu_torch.decoding.transcribe import (
    evict_surrounded_anomalies,
    split_timestamp_segments,
)
from whisperx_tpu_torch.decoding.transcribe import transcribe as seq_transcribe
from whisperx_tpu_torch.types import TranscriptionResult
from whisperx_tpu_torch.utils.languages import normalize_language
from whisperx_tpu_torch.utils.metrics import GLOBAL_TRACKER as _tracker
from whisperx_tpu_torch.vad import load_vad_model, merge_chunks

DEFAULT_ASR_OPTIONS = {
    "beam_size": None,
    "best_of": None,
    "patience": None,
    "length_penalty": None,
    "temperatures": (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    "compression_ratio_threshold": 2.4,
    "log_prob_threshold": -1.0,
    "no_speech_threshold": 0.6,
    "condition_on_previous_text": False,
    "initial_prompt": None,
    "suppress_tokens": "-1",
    "suppress_blank": True,
    # timestamps ON by default: each 30 s chunk splits into timestamped
    # sub-segments
    "without_timestamps": False,
    "max_initial_timestamp": 1.0,
    "word_timestamps": False,
    "hallucination_silence_threshold": None,
    "sample_len": None,  # max tokens per chunk (None = n_text_ctx // 2)
    "suppress_numerals": False,
    # int8 cross-KV cache (per-channel scales folded into q and the output)
    "kv_quant": True,
    "draft_model": None,
    "spec_gamma": 4,
}

DEFAULT_VAD_OPTIONS = {
    "chunk_size": 30,
    "vad_onset": 0.500,
    "vad_offset": 0.363,
}


def _greedy_only(options: dict) -> dict:
    """Speculative decoding is greedy-only (token-identical to greedy):
    with a ``draft_model``, a ``beam_size`` would silently win the decode's
    gate and the draft would never load, so it is dropped, with a warning
    (the JAX package's constructor does this; the port does it for a
    per-call draft too)."""
    if options.get("draft_model") is None or options.get("beam_size") is None:
        return options
    warnings.warn(
        "draft_model requests speculative decoding, which is greedy-only; "
        f"ignoring beam_size={options['beam_size']}."
    )
    return {**options, "beam_size": None}


def warmup_audio(duration_s: float = 65.0) -> np.ndarray:
    """Synthetic speech-like signal: a speech-band carrier with syllable-rate
    (3 Hz) amplitude modulation, loud enough to trip the VAD."""
    t = np.arange(int(duration_s * SAMPLE_RATE), dtype=np.float32) / np.float32(
        SAMPLE_RATE
    )
    carrier = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(
        2 * np.pi * 440.0 * t
    )
    return (carrier * (0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t))).astype(
        np.float32
    )


def _max_decode_rows(model, *, kv_quant: bool, sample_len: Optional[int]) -> int:
    """Max concurrent decode rows (batch × beam/best_of tiles) whose cross-KV +
    self-KV fit the cache budget: ``WHISPERX_TPU_KV_HBM_GB`` GiB, 8 unless
    set, with the JAX package's formula."""
    dims = model.dims
    if sample_len is None:
        sample_len = dims.n_text_ctx // 2
    cache_len = min(dims.n_text_ctx, -(-(8 + sample_len + 1) // 64) * 64)
    cross_bytes = 1 if kv_quant else 2
    per_row = 2 * dims.n_text_layer * dims.n_text_state * (
        1500 * cross_bytes + cache_len * 2
    )
    budget = float(os.environ.get("WHISPERX_TPU_KV_HBM_GB", "8")) * 2**30
    return max(1, int(budget // per_row))


def _sync(device: torch.device) -> None:
    """Barrier so a stage's device work is charged to that stage."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TranscriptionPipeline:
    """VAD → batched ASR pipeline (role of reference MLXWhisperPipeline)."""

    model: object
    vad_model: Optional[object] = None  # None: the seek loop over the file
    asr_options: dict = field(default_factory=dict)
    language: Optional[str] = None
    task: str = "transcribe"
    batch_size: int = 8
    decode_mode: str = "batched"  # "batched" | "sequential"
    seed: int = 0  # seeds the sampling generator of each decode at T > 0

    def __post_init__(self):
        self.asr_options = _greedy_only(
            {**DEFAULT_ASR_OPTIONS, **(self.asr_options or {})}
        )
        self._spec_decoder = None

    def _spec(self, o: dict):
        """The SpeculativeDecoder of the options ``o`` (``draft_model``: a
        model name, a checkpoint path, or ``"self:N"``, the target's own
        first N decoder layers; ``spec_gamma``), or None without a draft.
        Built at first use and cached; rebuilt when a call's draft or gamma
        differ from the cached decoder's. JAX keeps the first one it built,
        so a per-call draft there reuses a stale decoder (ADVICE r5,
        asr.py:268); the port builds the one that was asked for."""
        from whisperx_tpu_torch.decoding.speculative import (
            SpeculativeDecoder,
            truncated_self_draft,
        )
        from whisperx_tpu_torch.models.whisper import load_model as load_whisper

        draft = o.get("draft_model")
        if draft is None:
            return None
        gamma = int(o.get("spec_gamma") or 4)
        key = (draft if isinstance(draft, str) else id(draft), gamma)
        if self._spec_decoder is None or self._spec_decoder[0] != key:
            if isinstance(draft, str) and draft.startswith("self:"):
                # weights shared, no second checkpoint: the mechanism is
                # exact; the speedup depends on how often the early exit
                # agrees with the full model
                draft = truncated_self_draft(self.model, int(draft.split(":", 1)[1]))
            elif isinstance(draft, str):
                draft = load_whisper(draft, dtype=self.model.dtype, device=self.device)
            self._spec_decoder = (key, SpeculativeDecoder(self.model, draft, gamma=gamma))
        return self._spec_decoder[1]

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _tokenizer(self, **kw):
        return get_tokenizer(
            self.model.is_multilingual,
            num_languages=self.model.num_languages,
            vocab_path=self.model.vocab_path,
            **kw,
        )

    def detect_language(self, audio: np.ndarray) -> str:
        head = np.asarray(pad_or_trim(audio, N_SAMPLES), np.float32)
        mel = log_mel_spectrogram(head, self.model.dims.n_mels, device=self.device)
        codes, _ = _detect_language(self.model, mel.T[None], self._tokenizer())
        return codes[0]

    def warmup(
        self, batch_size: Optional[int] = None, duration_s: float = 65.0
    ) -> TranscriptionResult:
        """Drive the whole path once on synthetic speech (builds the CUDA
        kernels and warms the allocator before real traffic)."""
        return self.transcribe(warmup_audio(duration_s), batch_size=batch_size)

    def transcribe(
        self,
        audio: Union[str, np.ndarray],
        batch_size: Optional[int] = None,
        chunk_size: float = 30,
        language: Optional[str] = None,
        task: Optional[str] = None,
        print_progress: bool = False,
        combined_progress: bool = False,
        verbose: bool = False,
        initial_prompt: Optional[str] = None,
        **kwargs,
    ) -> TranscriptionResult:
        """``combined_progress`` is accepted for the reference's signature
        (its progress scale spans transcription and alignment) and changes
        nothing here, as in JAX.

        Per-call ASR options (``kwargs``, keys of DEFAULT_ASR_OPTIONS) apply
        to a copy for this call only: ``self.asr_options`` is never touched.
        JAX swaps them into ``self.asr_options`` for the call's duration
        (ADVICE r5, asr.py:267); the port keeps the intended behavior."""
        if kwargs:
            unknown = set(kwargs) - set(DEFAULT_ASR_OPTIONS)
            if unknown:
                raise TypeError(
                    f"Unknown transcribe option(s): {sorted(unknown)}. "
                    "Valid keys are those of DEFAULT_ASR_OPTIONS."
                )
            options = _greedy_only({**self.asr_options, **kwargs})
        else:
            options = self.asr_options
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        batch_size = batch_size or self.batch_size
        language = normalize_language(language or self.language)
        task = task or self.task

        if self.vad_model is None:
            # no VAD: the sequential seek loop over the whole file
            result = seq_transcribe(
                self.model,
                audio,
                language=language,
                task=task,
                verbose=verbose if verbose else None,
                seed=self.seed,
                **self._seq_options(o=options, initial_prompt=initial_prompt),
            )
            return {
                "segments": [
                    # word_timestamps=True attaches words: keep them
                    {k: s[k] for k in ("start", "end", "text")}
                    | ({"words": s["words"]} if "words" in s else {})
                    for s in result["segments"]
                ],
                "language": result["language"],
            }

        with _tracker.track("upload", len(audio) / SAMPLE_RATE):
            audio_dev = upload_audio(audio, self.device)
            _sync(self.device)
        with _tracker.track("vad", len(audio) / SAMPLE_RATE):
            chunks = self._segment_with_vad(audio_dev, chunk_size)
        if not chunks:
            return {"segments": [], "language": language or "en"}

        if language is None:
            if self.model.is_multilingual:
                s0 = int(chunks[0]["start"] * SAMPLE_RATE)
                e0 = int(chunks[0]["end"] * SAMPLE_RATE)
                language = self.detect_language(audio[s0:e0])
                if print_progress or verbose:
                    print(f"Detected language: {language}")
            else:
                language = "en"

        if self.decode_mode == "sequential":
            segments = self._transcribe_chunks_sequential(
                audio, chunks, options, language=language, task=task,
                verbose=verbose, initial_prompt=initial_prompt,
            )
        else:
            segments = self._transcribe_chunks(
                audio_dev,
                chunks,
                options,
                batch_size=batch_size,
                language=language,
                task=task,
                print_progress=print_progress,
                verbose=verbose,
                initial_prompt=initial_prompt,
            )
        return {"segments": segments, "language": language}

    def transcribe_many(
        self,
        audios: List[np.ndarray],
        *,
        batch_size: Optional[int] = None,
        chunk_size: float = 30,
        language: Optional[Union[str, List[Optional[str]]]] = None,
        task: Optional[Union[str, List[Optional[str]]]] = None,
        initial_prompt: Optional[Union[str, List[Optional[str]]]] = None,
    ) -> List[TranscriptionResult]:
        """Cross-request coalescing: VAD every audio, pool all requests'
        chunks into one shared decode stream (chunks of different requests
        fill the same device batch), then demultiplex the segments back per
        request.

        ``language`` / ``task`` / ``initial_prompt`` are one value for all
        requests or a per-request list (``None`` entries detect / default).
        Requests are grouped by (language, task, prompt), each group sharing
        device batches (the prompt is part of the decode prefix, so it is
        uniform within a batch). The languages to detect are detected in one
        batched call. Without a VAD each audio goes through ``transcribe``
        (the seek loop is stateful per audio: nothing to pool)."""
        n_req = len(audios)

        def _per_request(opt, default):
            if isinstance(opt, (list, tuple)):
                if len(opt) != n_req:
                    raise ValueError(
                        f"per-request option length {len(opt)} != {n_req} requests"
                    )
                return [v if v is not None else default for v in opt]
            return [opt if opt is not None else default] * n_req

        batch_size = batch_size or self.batch_size
        req_tasks = _per_request(task, self.task)
        req_prompts = [  # tuples: prompts key the decode groups
            tuple(p) if isinstance(p, list) else p
            for p in _per_request(initial_prompt, None)
        ]
        req_langs = [normalize_language(lg) for lg in _per_request(language, self.language)]
        audios = [np.asarray(a, np.float32) for a in audios]
        if not audios:
            return []
        if self.vad_model is None:
            return [
                self.transcribe(
                    a, batch_size=batch_size, chunk_size=chunk_size,
                    language=lg, task=tk, initial_prompt=pr,
                )
                for a, lg, tk, pr in zip(audios, req_langs, req_tasks, req_prompts)
            ]

        audio_s = sum(len(a) for a in audios) / SAMPLE_RATE
        # upload and mel are host spans here (nothing waits for the device):
        # their device work runs on into the next stage that reads back
        with _tracker.track("upload", audio_s):
            devs = [upload_audio(a, self.device) for a in audios]
        with _tracker.track("vad", audio_s):
            per_chunks = [self._segment_with_vad(d, chunk_size) for d in devs]

        langs: List[Optional[str]] = []
        detect_idx: List[int] = []
        for r, (chs, lg) in enumerate(zip(per_chunks, req_langs)):
            if lg is not None:
                langs.append(lg)
            elif not chs or not self.model.is_multilingual:
                langs.append("en")
            else:
                langs.append(None)
                detect_idx.append(r)
        n_mels = self.model.dims.n_mels
        if detect_idx:
            first_mels = torch.cat(
                [chunk_mels(devs[r], per_chunks[r][:1], n_mels) for r in detect_idx]
            )
            codes, _ = _detect_language(self.model, first_mels, self._tokenizer())
            for r, code in zip(detect_idx, codes):
                langs[r] = code

        # the requests on one virtual timeline (whole-second bases with a
        # 1 s guard gap) so that timestamps demultiplex back per request;
        # the audio itself never lies on it: each request's chunk mels are
        # cut from its own resident waveform and concatenated
        bases: List[float] = []
        offset = 0.0
        for a in audios:
            bases.append(offset)
            offset += math.ceil(len(a) / SAMPLE_RATE) + 1.0

        results: List[TranscriptionResult] = [
            {"segments": [], "language": lg} for lg in langs
        ]
        groups: dict = {}
        for r, lg in enumerate(langs):
            if per_chunks[r]:
                groups.setdefault((lg, req_tasks[r], req_prompts[r]), []).append(r)

        for (lg, tk, prompt), req_idxs in groups.items():
            pooled: List[dict] = []
            group_bases = [bases[r] for r in req_idxs]
            for r in req_idxs:
                pooled.extend(
                    {"start": ch["start"] + bases[r], "end": ch["end"] + bases[r]}
                    for ch in per_chunks[r]
                )
            with _tracker.track("mel", sum(c["end"] - c["start"] for c in pooled)):
                mels = torch.cat([chunk_mels(devs[r], per_chunks[r], n_mels) for r in req_idxs])
            segments = self._transcribe_chunks(
                None, pooled, self.asr_options, batch_size=batch_size,
                language=lg, task=tk, initial_prompt=prompt, mels=mels,
            )
            for seg in segments:
                g = bisect.bisect_right(group_bases, seg["start"] + 1e-6) - 1
                r = req_idxs[g]
                out = {
                    **seg,
                    "start": round(seg["start"] - bases[r], 3),
                    "end": round(seg["end"] - bases[r], 3),
                }
                if "words" in seg:
                    out["words"] = [
                        {
                            **w,
                            "start": round(w["start"] - bases[r], 2),
                            "end": round(w["end"] - bases[r], 2),
                        }
                        for w in seg["words"]
                    ]
                results[r]["segments"].append(out)
        return results

    def _transcribe_chunks_sequential(
        self,
        audio: np.ndarray,
        chunks: List[dict],
        o: dict,
        *,
        language: str,
        task: str,
        verbose: bool = False,
        initial_prompt: Optional[str] = None,
    ) -> List[dict]:
        """The seek loop over each VAD chunk, its segments shifted to the
        file's timeline and clamped to the chunk's real extent."""
        opts = self._seq_options(o=o, initial_prompt=initial_prompt)
        segments: List[dict] = []
        for ch in chunks:
            s = int(ch["start"] * SAMPLE_RATE)
            e = int(ch["end"] * SAMPLE_RATE)
            result = seq_transcribe(
                self.model,
                audio[s:e],
                language=language,
                task=task,
                verbose=verbose if verbose else None,
                seed=self.seed,
                **opts,
            )
            win = ch["end"] - ch["start"]
            for seg in result["segments"]:
                # clamp to the chunk's real extent (see _transcribe_chunks)
                if seg["start"] >= win:
                    continue
                end_rel = min(seg["end"], win)
                if end_rel <= seg["start"]:
                    continue
                entry = {
                    "start": round(seg["start"] + ch["start"], 3),
                    "end": round(end_rel + ch["start"], 3),
                    "text": seg["text"],
                }
                if "words" in seg:
                    # chunk-relative words to the file's timeline, clamped
                    # to the segment's extent; a word that starts at or past
                    # the clamped end is dropped, as in JAX
                    entry["words"] = [
                        {
                            **w,
                            **(
                                {
                                    "start": round(min(w["start"], end_rel) + ch["start"], 3),
                                    "end": round(min(w["end"], end_rel) + ch["start"], 3),
                                }
                                if "start" in w and "end" in w
                                else {}
                            ),
                        }
                        for w in seg["words"]
                        if not ("start" in w and "end" in w and w["start"] >= end_rel)
                    ]
                segments.append(entry)
        return segments

    @staticmethod
    def _seq_options(o: dict, initial_prompt: Optional[str] = None) -> dict:
        """The seek loop's options from the pipeline's, as the JAX package
        passes them (``kv_quant`` and ``sample_len`` are not among them, so
        each window decodes with the cross-KV in the model's dtype)."""
        if initial_prompt is None:
            initial_prompt = o["initial_prompt"]
        return {
            "temperature": o["temperatures"],
            "compression_ratio_threshold": o["compression_ratio_threshold"],
            "logprob_threshold": o["log_prob_threshold"],
            "no_speech_threshold": o["no_speech_threshold"],
            "condition_on_previous_text": o["condition_on_previous_text"],
            "initial_prompt": initial_prompt,
            "word_timestamps": o["word_timestamps"],
            "hallucination_silence_threshold": o.get("hallucination_silence_threshold"),
            "beam_size": o["beam_size"],
            "best_of": o["best_of"],
            "suppress_tokens": o["suppress_tokens"],
        }

    def _segment_with_vad(self, audio: DeviceAudio, chunk_size: float) -> List[dict]:
        """Device audio goes straight to device-capable VADs (only the prob
        vector comes back); others get the host array."""
        if getattr(self.vad_model, "supports_device_audio", False):
            payload = {
                "waveform": audio.data,
                "sample_rate": SAMPLE_RATE,
                "length": audio.length,
            }
        else:
            payload = {
                "waveform": audio.data[: audio.length].cpu().numpy(),
                "sample_rate": SAMPLE_RATE,
            }
        vad_segments = self.vad_model(payload, max_speech_duration_s=chunk_size)
        if not vad_segments:
            return []
        onset = getattr(self.vad_model, "vad_onset", 0.5)
        offset = getattr(self.vad_model, "vad_offset", 0.363)
        return merge_chunks(vad_segments, chunk_size, onset=onset, offset=offset)

    def _transcribe_chunks(
        self,
        audio_dev: Optional[DeviceAudio],
        chunks: List[dict],
        o: dict,
        *,
        batch_size: int,
        language: str,
        task: str,
        print_progress: bool = False,
        verbose: bool = False,
        initial_prompt: Optional[str] = None,
        mels: Optional[torch.Tensor] = None,
    ) -> List[dict]:
        """``mels``: the chunks' log-mels when the caller has cut them
        (``transcribe_many``); ``audio_dev`` is then not read."""
        if initial_prompt is None:
            initial_prompt = o["initial_prompt"]
        n_mels = self.model.dims.n_mels

        # one mel per chunk, cut on the device from the resident waveform
        # and zero-padded to 30 s BEFORE the mel (silence has a mel floor)
        if mels is None:
            with _tracker.track("mel", sum(c["end"] - c["start"] for c in chunks)):
                mels = chunk_mels(audio_dev, chunks, n_mels)
                _sync(self.device)

        temperatures = (
            [o["temperatures"]]
            if isinstance(o["temperatures"], (int, float))
            else list(o["temperatures"])
        )
        results: List[Optional[object]] = [None] * len(chunks)
        pending = list(range(len(chunks)))

        for t_idx, temperature in enumerate(temperatures):
            if not pending:
                break
            opts = DecodingOptions(
                task=task,
                language=language,
                temperature=temperature,
                sample_len=o["sample_len"],
                beam_size=o["beam_size"] if temperature == 0 else None,
                best_of=o["best_of"] if temperature > 0 else None,
                patience=o["patience"] if temperature == 0 else None,
                length_penalty=o["length_penalty"],
                prompt=(
                    self.model_prompt(initial_prompt) if initial_prompt else None
                ),
                suppress_tokens=o["suppress_tokens"],
                suppress_blank=o["suppress_blank"],
                suppress_numerals=o.get("suppress_numerals", False),
                kv_quant=o.get("kv_quant", True),
                without_timestamps=o["without_timestamps"],
                max_initial_timestamp=o["max_initial_timestamp"],
            )
            # beam search multiplies live decode rows by K, best_of sampling
            # by n candidates: cap the tiled row count so the KV caches fit
            # the cache budget
            tile = opts.beam_size or (
                int(opts.best_of) if opts.best_of and opts.best_of > 1 else 1
            )
            if tile > 1:
                max_rows = _max_decode_rows(
                    self.model, kv_quant=opts.kv_quant, sample_len=o["sample_len"]
                )
                bs_eff = max(1, min(batch_size, max_rows // tile))
            else:
                bs_eff = batch_size
            # speculative decoding serves the greedy (temperature-0,
            # un-tiled) batches; fallback temperatures decode normally
            spec = (
                self._spec(o)
                if temperature == 0 and opts.beam_size is None and tile == 1
                else None
            )
            still_pending = []
            for base in range(0, len(pending), bs_eff):
                idxs = pending[base : base + bs_eff]
                rows = mels[torch.as_tensor(idxs, device=mels.device)]
                if len(idxs) < bs_eff:  # fixed-size batches, zero rows padded
                    rows = torch.cat(
                        [rows, rows.new_zeros((bs_eff - len(idxs), N_FRAMES, n_mels))]
                    )
                _tracker.add("batch_slots", bs_eff)
                _tracker.add("batch_used", len(idxs))
                generator = None
                if temperature > 0:
                    generator = torch.Generator(device=self.device).manual_seed(
                        self.seed
                    )
                audio_s = sum(chunks[i]["end"] - chunks[i]["start"] for i in idxs)
                with _tracker.track("decode", audio_s):
                    if spec is not None:
                        handle = spec.decode_batch_dispatch(rows, opts, n_real=len(idxs))
                        batch_results = spec.decode_batch_finalize(handle)
                    else:
                        handle = decode_dispatch(
                            self.model, rows, opts, generator=generator
                        )
                        batch_results = decode_finalize(handle)
                _tracker.add("decode_steps", handle["steps"])
                for j, idx in enumerate(idxs):
                    r = batch_results[j]
                    _tracker.add("tokens_decoded", len(r.tokens))
                    if t_idx < len(temperatures) - 1 and self._needs_fallback(r, o):
                        still_pending.append(idx)
                    else:
                        results[idx] = r
                if print_progress:
                    done = len(chunks) - len(pending) + base + len(idxs)
                    print(f"Progress: {min(100, 100 * done // len(chunks))}%...")
            pending = still_pending

        _t_tok = time.perf_counter()
        tokenizer = self._tokenizer(language=language, task=task)
        _tracker.observe("tokenizer", time.perf_counter() - _t_tok)
        with_timestamps = not o["without_timestamps"]

        # each chunk's segments, with the tokens and the window's seek that
        # word timing reads
        chunk_segs: List[List[dict]] = [[] for _ in chunks]
        _t_assemble = time.perf_counter()
        for idx, (ch, r) in enumerate(zip(chunks, results)):
            if r is None:
                continue
            if (
                o["no_speech_threshold"] is not None
                and r.no_speech_prob > o["no_speech_threshold"]
                and (
                    o["log_prob_threshold"] is None
                    or r.avg_logprob < o["log_prob_threshold"]
                )
            ):
                continue  # silent chunk
            seek = int(round(ch["start"] * FRAMES_PER_SECOND))
            if with_timestamps and r.tokens:
                # split the window's tokens into timestamped sub-segments
                subs, _, _ = split_timestamp_segments(
                    np.asarray(r.tokens, np.int64),
                    timestamp_begin=tokenizer.timestamp_begin,
                    segment_size=N_FRAMES,
                )
                win = ch["end"] - ch["start"]
                for s_rel, e_rel, toks in subs:
                    # clamp to the window's REAL audio extent: timestamps in
                    # the zero-padded tail of a short chunk are silence
                    if s_rel >= win:
                        continue
                    e_rel = min(e_rel, win)
                    if e_rel <= s_rel:
                        continue
                    text = tokenizer.decode(toks).strip()
                    if text:
                        chunk_segs[idx].append(
                            {
                                "start": round(ch["start"] + s_rel, 3),
                                "end": round(ch["start"] + e_rel, 3),
                                "text": text,
                                "tokens": toks,
                                "seek": seek,
                            }
                        )
            else:
                text = r.text.strip()
                if text:
                    chunk_segs[idx].append(
                        {
                            "start": round(ch["start"], 3),
                            "end": round(ch["end"], 3),
                            "text": text,
                            "tokens": list(r.tokens),
                            "seek": seek,
                        }
                    )
        _tracker.observe("assemble", time.perf_counter() - _t_assemble)
        hst = o.get("hallucination_silence_threshold")
        if o["word_timestamps"]:
            self._add_words(chunks, chunk_segs, mels, tokenizer, hst)
        elif hst is not None:
            warnings.warn(
                "hallucination_silence_threshold requires "
                "word_timestamps=True; ignoring it."
            )

        segments = []
        for segs in chunk_segs:
            for seg in segs:
                if verbose:
                    print(f"[{seg['start']:.2f} --> {seg['end']:.2f}] {seg['text']}")
                out = {"start": seg["start"], "end": seg["end"], "text": seg["text"]}
                if "words" in seg:
                    out["words"] = seg["words"]
                segments.append(out)
        return segments

    def _add_words(self, chunks, chunk_segs, mels, tokenizer, hst) -> None:
        """Word timing over every chunk's window (one teacher-forced capture
        per group of windows), then, with a hallucination-silence threshold,
        each chunk's eviction of anomalous segments surrounded by silence.
        VAD-bounded chunks have nothing to re-seek into, so the decoded tail
        is kept (``keep_tail``), as in JAX."""
        from whisperx_tpu_torch.timing import add_word_timestamps_batched

        num_frames = [
            min(N_FRAMES, int(round((c["end"] - c["start"]) * FRAMES_PER_SECOND)))
            for c in chunks
        ]
        with _tracker.track("word_timing", sum(c["end"] - c["start"] for c in chunks)):
            add_word_timestamps_batched(
                chunk_segments=chunk_segs,
                model=self.model,
                tokenizer=tokenizer,
                mels=mels,
                num_frames_list=num_frames,
            )
            _sync(self.device)
        if hst is None:
            return
        for idx, ch in enumerate(chunks):
            if chunk_segs[idx]:
                chunk_segs[idx], _ = evict_surrounded_anomalies(
                    chunk_segs[idx],
                    threshold=hst,
                    time_offset=ch["start"],
                    window_end_time=ch["end"],
                    segment_duration=ch["end"] - ch["start"],
                    last_speech_timestamp=ch["start"],
                    keep_tail=True,
                )

    @staticmethod
    def _needs_fallback(r, o: dict) -> bool:
        crt = o["compression_ratio_threshold"]
        lpt = o["log_prob_threshold"]
        nst = o["no_speech_threshold"]
        if nst is not None and r.no_speech_prob > nst:
            return False  # silence: no point retrying hotter
        if crt is not None and np.isfinite(r.compression_ratio) and r.compression_ratio > crt:
            return True
        if lpt is not None and r.avg_logprob < lpt:
            return True
        return False

    def model_prompt(self, initial_prompt):
        """Prompt text → token ids; pre-tokenized sequences pass through."""
        if isinstance(initial_prompt, (list, tuple)):
            return list(initial_prompt)
        return self._tokenizer().encode(" " + initial_prompt.strip())


def load_model(
    whisper_arch: str,
    device: str = "cuda",
    device_index: int = 0,
    compute_type: str = "bfloat16",
    asr_options: Optional[dict] = None,
    language: Optional[str] = None,
    vad_method: Optional[str] = "silero",
    vad_options: Optional[dict] = None,
    task: str = "transcribe",
    download_root: Optional[str] = None,
    local_files_only: bool = False,
    threads: int = 4,
    backend: str = "auto",
    batch_size: int = 8,
    seed: int = 0,
    **kwargs,
) -> TranscriptionPipeline:
    """Load a Whisper pipeline (API parity: reference asr.py:150-275).

    ``whisper_arch``: a converted checkpoint directory or a known
    architecture name (random weights from ``seed``). ``device``: "cuda"
    (default; raises without a GPU), "cuda:N" or "cpu". ``compute_type``:
    bfloat16 (default), float16 (run as bfloat16, as in the JAX package),
    float32, or int8 / int4: bf16 weights with the decoder's linears
    weight-only quantized (``quant.quantize_model``; int8 runs kernel K4 on
    CUDA). ``vad_method`` None or "none": no VAD, the seek loop over the
    whole file; the VAD runs on ``device`` too. ``backend`` "sequential" (or
    "standard"): the seek loop over each VAD chunk; anything else the
    batched decode. ``asr_options={"draft_model": "self:4", "spec_gamma":
    4}``: speculative decoding of the greedy batches.

    ``device_index``, ``download_root``, ``local_files_only``, ``threads``
    and any other keyword are the reference's and are accepted and ignored,
    as in JAX (``device="cuda:N"`` picks a card; nothing is downloaded).
    """
    from whisperx_tpu_torch.models.whisper import load_model as load_whisper

    dtype_map = {
        "bfloat16": torch.bfloat16,
        "float16": torch.bfloat16,
        "float32": torch.float32,
    }
    quantization = compute_type if compute_type in ("int8", "int4") else None
    if quantization is None and compute_type not in dtype_map:
        raise ValueError(f"unknown compute_type {compute_type!r}")
    vad_model = None
    if vad_method and vad_method != "none":
        opts = {**DEFAULT_VAD_OPTIONS, **(vad_options or {})}
        vad_model = load_vad_model(
            vad_method,
            vad_onset=opts["vad_onset"],
            vad_offset=opts["vad_offset"],
            chunk_size=opts["chunk_size"],
            device=device,
        )
    model = load_whisper(
        whisper_arch,
        dtype=torch.bfloat16 if quantization else dtype_map[compute_type],
        device=device,
        seed=seed,
    )
    if quantization is not None:
        from whisperx_tpu_torch.quant import quantize_model

        model = quantize_model(model, mode=quantization)
    return TranscriptionPipeline(
        model=model,
        vad_model=vad_model,
        asr_options=asr_options,
        language=normalize_language(language),
        task=task,
        batch_size=batch_size,
        decode_mode="sequential" if backend in ("sequential", "standard") else "batched",
        seed=seed,
    )
