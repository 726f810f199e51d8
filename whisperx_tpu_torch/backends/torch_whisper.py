"""PyTorch Whisper backends implementing the WhisperBackend contract.

Counterpart of ``whisperx_tpu/backends/jax_whisper.py``. Both are thin
adapters over one ``TranscriptionPipeline`` without a VAD, built by
``asr.load_model`` (which owns dtype, device and quantization):

  - ``BatchedTorchBackend``: the pipeline's ``transcribe`` (without a VAD,
    as in the JAX package, the seek loop over the file);
    ``transcribe_batch`` decodes pre-sliced VAD segments as device batches;
  - ``SequentialTorchBackend``: the 30 s seek loop per audio
    (``condition_on_previous_text``, the per-window fallback ladder), with
    the JAX backend's defaults for the options not given.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np

from whisperx_tpu_torch.backends.base import WhisperBackend
from whisperx_tpu_torch.types import TranscriptionResult
from whisperx_tpu_torch.utils.languages import LANGUAGE_CODES


class _TorchBackendBase(WhisperBackend):
    def __init__(
        self,
        model: str,
        device: str = "cuda",
        device_index: int = 0,
        compute_type: str = "bfloat16",
        download_root: Optional[str] = None,
        local_files_only: bool = False,
        threads: int = 4,
        asr_options: Optional[dict] = None,
        language: Optional[str] = None,
        task: str = "transcribe",
        batch_size: int = 8,
        **kwargs,
    ):
        from whisperx_tpu_torch.asr import load_model

        name = model
        if download_root and os.path.isdir(os.path.join(download_root, model)):
            name = os.path.join(download_root, model)
        self.pipeline = load_model(
            name,
            device=f"cuda:{device_index}" if device == "cuda" else device,
            compute_type=compute_type,
            asr_options=asr_options,
            language=language,
            vad_method="none",
            task=task,
            batch_size=batch_size,
        )
        self.model = self.pipeline.model
        self.asr_options = asr_options or {}  # as given, without the defaults
        self.language = language
        self.task = task
        self.batch_size = batch_size

    @property
    def supported_languages(self) -> List[str]:
        if not self.is_multilingual:
            return ["en"]
        return list(LANGUAGE_CODES[: self.model.num_languages])

    @property
    def is_multilingual(self) -> bool:
        return self.model.is_multilingual

    def detect_language(self, audio: np.ndarray) -> str:
        return self.pipeline.detect_language(np.asarray(audio, np.float32))


class BatchedTorchBackend(_TorchBackendBase):
    def transcribe(
        self,
        audio: Union[str, np.ndarray],
        batch_size: Optional[int] = None,
        num_workers: int = 0,
        language: Optional[str] = None,
        task: Optional[str] = None,
        chunk_size: int = 30,
        print_progress: bool = False,
        combined_progress: bool = False,
        verbose: bool = False,
        **kwargs,
    ) -> TranscriptionResult:
        return self.pipeline.transcribe(
            audio,
            batch_size=batch_size or self.batch_size,
            chunk_size=chunk_size,
            language=language,
            task=task,
            print_progress=print_progress,
            verbose=verbose,
        )

    def transcribe_batch(
        self, segments: List[dict], batch_size: Optional[int] = None, **kwargs
    ) -> TranscriptionResult:
        """Decode pre-sliced VAD segments (each with an 'audio' key) as one
        device-batched call."""
        from whisperx_tpu_torch.audio.device_chunk import upload_audio

        pipeline = self.pipeline
        audio_parts = [np.asarray(s["audio"], np.float32) for s in segments]
        chunks = [{"start": s["start"], "end": s["end"]} for s in segments]
        # one timeline, so that the pipeline's chunk mels apply
        total = int(max(s["end"] for s in segments) * 16000) if segments else 0
        audio = np.zeros(total, np.float32)
        for s, part in zip(segments, audio_parts):
            beg = int(s["start"] * 16000)
            audio[beg : beg + len(part)] = part[: max(0, total - beg)]
        language = self.language or (
            pipeline.detect_language(audio_parts[0]) if segments else "en"
        )
        segments_out = pipeline._transcribe_chunks(
            upload_audio(audio, pipeline.device),
            chunks,
            pipeline.asr_options,
            batch_size=batch_size or self.batch_size,
            language=language,
            task=self.task,
        )
        return {"segments": segments_out, "language": language}


class SequentialTorchBackend(_TorchBackendBase):
    def transcribe(
        self,
        audio: Union[str, np.ndarray],
        batch_size: Optional[int] = None,
        num_workers: int = 0,
        language: Optional[str] = None,
        task: Optional[str] = None,
        chunk_size: int = 30,
        print_progress: bool = False,
        combined_progress: bool = False,
        verbose: bool = False,
        **kwargs,
    ) -> TranscriptionResult:
        from whisperx_tpu_torch.decoding.transcribe import transcribe as seq_transcribe

        o = self.asr_options
        result = seq_transcribe(
            self.model,
            audio,
            language=language or self.language,
            task=task or self.task,
            verbose=verbose or None,
            temperature=o.get("temperatures", (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)),
            compression_ratio_threshold=o.get("compression_ratio_threshold", 2.4),
            logprob_threshold=o.get("log_prob_threshold", -1.0),
            no_speech_threshold=o.get("no_speech_threshold", 0.6),
            condition_on_previous_text=o.get("condition_on_previous_text", True),
            initial_prompt=o.get("initial_prompt"),
            word_timestamps=o.get("word_timestamps", False),
            hallucination_silence_threshold=o.get("hallucination_silence_threshold"),
        )
        return {
            "segments": [
                {k: s[k] for k in ("start", "end", "text")}
                | ({"words": s["words"]} if "words" in s else {})
                for s in result["segments"]
            ],
            "language": result["language"],
        }


def load_backend(kind: str = "batched", **kwargs) -> WhisperBackend:
    kind = (kind or "batched").lower()
    if kind in ("auto", "batched", "batch"):
        return BatchedTorchBackend(**kwargs)
    if kind in ("sequential", "standard"):
        return SequentialTorchBackend(**kwargs)
    raise ValueError(f"Unknown backend: {kind}")
