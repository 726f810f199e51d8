"""Voice-activity detection: the energy VAD, the Silero segmenter and the
WhisperX chunk merge. Silero's network, pyannote and the hybrid selector
come later (ROADMAP.md, Queue 1, item 10)."""

from __future__ import annotations

import os
import warnings
from typing import Optional

from whisperx_tpu_torch.vad.energy import EnergyVAD
from whisperx_tpu_torch.vad.merge import merge_chunks
from whisperx_tpu_torch.vad.silero import probs_to_speech_timestamps
from whisperx_tpu_torch.vad.types import SpeechSegment


def load_vad_model(
    method: str = "silero",
    *,
    vad_onset: float = 0.5,
    vad_offset: float = 0.363,
    chunk_size: float = 30.0,
    model_path: Optional[str] = None,
):
    """VAD factory (reference asr.py vad_method dispatch). ``"silero"``
    without a converted checkpoint falls back to the energy VAD with the
    JAX package's warning; with one, it needs the Silero network."""
    method = (method or "silero").lower()
    if method == "silero":
        ckpt = model_path or os.environ.get("WHISPERX_TPU_SILERO_CKPT")
        if ckpt and (model_path or os.path.isdir(ckpt)):
            raise NotImplementedError(
                "the Silero VAD network comes with the other VADs "
                "(ROADMAP.md, Queue 1, item 10)"
            )
        warnings.warn(
            "No converted Silero checkpoint (set WHISPERX_TPU_SILERO_CKPT "
            "or pass model_path); falling back to the weightless energy "
            "VAD.",
            stacklevel=2,
        )
        return EnergyVAD(vad_onset=vad_onset, chunk_size=chunk_size)
    if method == "energy":
        return EnergyVAD(vad_onset=vad_onset, chunk_size=chunk_size)
    if method in ("pyannote", "hybrid"):
        raise NotImplementedError(
            f"vad_method={method!r} comes with the other VADs "
            "(ROADMAP.md, Queue 1, item 10)"
        )
    raise ValueError(f"Unknown VAD method: {method}")


__all__ = [
    "EnergyVAD",
    "SpeechSegment",
    "load_vad_model",
    "merge_chunks",
    "probs_to_speech_timestamps",
]
