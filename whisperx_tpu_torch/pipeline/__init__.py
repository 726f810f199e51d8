"""Unified four-stage pipeline: VAD → ASR → align → diarize in one call.

Counterpart of ``whisperx_tpu/pipeline/__init__.py`` (reference
whisperx/pipeline.py:37-413: UnifiedPipeline, load_pipeline,
load_mlx_pipeline). Every stage is built on first use, and every neural
stage runs on ``PipelineConfig.device`` (default ``"cuda"``; CUDA without a
GPU raises), the port's explicit device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from whisperx_tpu_torch.audio import load_audio


@dataclass
class PipelineConfig:
    """The reference's pipeline.py:22-35, plus the device of every stage."""

    model_name: str = "small"
    language: Optional[str] = None
    task: str = "transcribe"
    batch_size: int = 8
    chunk_size: int = 30
    compute_type: str = "bfloat16"
    vad_method: str = "silero"
    vad_onset: float = 0.5
    vad_offset: float = 0.363
    align: bool = True
    align_model: Optional[str] = None
    interpolate_method: str = "nearest"
    return_char_alignments: bool = False
    diarize: bool = False
    diarize_model: Optional[str] = None
    min_speakers: Optional[int] = None
    max_speakers: Optional[int] = None
    asr_options: dict = field(default_factory=dict)
    device: str = "cuda"


class UnifiedPipeline:
    """One-call transcription with optional alignment and diarization."""

    def __init__(self, config: Optional[PipelineConfig] = None, **overrides):
        self.config = config or PipelineConfig()
        for k, v in overrides.items():
            setattr(self.config, k, v)
        self._asr = None
        self._aligner = None
        self._align_meta = None
        self._diarizer = None

    # the stages, each built on first use

    @property
    def asr(self):
        if self._asr is None:
            from whisperx_tpu_torch.asr import load_model

            c = self.config
            self._asr = load_model(
                c.model_name,
                device=c.device,
                compute_type=c.compute_type,
                language=c.language,
                task=c.task,
                vad_method=c.vad_method,
                vad_options={
                    "chunk_size": c.chunk_size,
                    "vad_onset": c.vad_onset,
                    "vad_offset": c.vad_offset,
                },
                asr_options=c.asr_options,
                batch_size=c.batch_size,
            )
        return self._asr

    def _get_aligner(self, language: str):
        from whisperx_tpu_torch.alignment import load_align_model

        if self._aligner is None or self._align_meta["language"] != language:
            self._aligner, self._align_meta = load_align_model(
                language, self.config.device, model_name=self.config.align_model
            )
        return self._aligner, self._align_meta

    @property
    def diarizer(self):
        if self._diarizer is None:
            from whisperx_tpu_torch.diarize import DiarizationPipeline

            self._diarizer = DiarizationPipeline(
                model_name=self.config.diarize_model, device=self.config.device
            )
        return self._diarizer

    # the four-stage call

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        *,
        batch_size: Optional[int] = None,
        verbose: bool = False,
    ) -> dict:
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)

        c = self.config
        result = self.asr.transcribe(
            audio,
            batch_size=batch_size or c.batch_size,
            chunk_size=c.chunk_size,
            verbose=verbose,
        )

        if c.align and result["segments"]:
            from whisperx_tpu_torch.alignment import align

            aligner, meta = self._get_aligner(result.get("language", "en"))
            aligned = align(
                result["segments"],
                aligner,
                meta,
                audio,
                c.device,
                interpolate_method=c.interpolate_method,
                return_char_alignments=c.return_char_alignments,
            )
            aligned["language"] = result["language"]
            result = aligned

        if c.diarize:
            from whisperx_tpu_torch.diarize import assign_word_speakers

            turns = self.diarizer(audio, min_speakers=c.min_speakers, max_speakers=c.max_speakers)
            result = assign_word_speakers(turns, result)

        return result


def load_pipeline(
    model_name: str = "small", config: Optional[PipelineConfig] = None, **kw
) -> UnifiedPipeline:
    """The reference's pipeline.py:332-413."""
    if config is None:
        config = PipelineConfig(model_name=model_name, **kw)
    return UnifiedPipeline(config)


def load_tpu_pipeline(model_name: str = "small", **kw) -> UnifiedPipeline:
    """The JAX package's name for ``load_pipeline`` (the reference's
    ``load_mlx_pipeline``), kept so that callers of either package run."""
    return load_pipeline(model_name, **kw)


__all__ = ["PipelineConfig", "UnifiedPipeline", "load_pipeline", "load_tpu_pipeline"]
