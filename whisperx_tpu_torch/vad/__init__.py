"""Voice-activity detection (reference whisperx/vads/ parity).

Counterpart of ``whisperx_tpu/vad/__init__.py``. Methods: ``silero`` (the
LSTM network with a converted checkpoint, else the energy VAD, with a
warning), ``energy`` (weightless), ``pyannote`` (the PyanNet segmentation
model + Binarize min-cut; energy scores without a checkpoint) and ``hybrid``
(the best available backend).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import torch

from whisperx_tpu_torch.vad.batch import BatchVADProcessor
from whisperx_tpu_torch.vad.binarize import Binarize
from whisperx_tpu_torch.vad.energy import EnergyVAD
from whisperx_tpu_torch.vad.merge import merge_chunks
from whisperx_tpu_torch.vad.silero import SileroVAD, probs_to_speech_timestamps
from whisperx_tpu_torch.vad.types import SpeechSegment


class HybridVAD:
    """Pick the best available backend (reference vads/hybrid_vad.py: CPU
    Silero or MLX VAD; here real Silero weights win over the energy
    fallback)."""

    def __init__(
        self,
        vad_onset: float = 0.5,
        chunk_size: float = 30.0,
        device: Union[str, torch.device] = "cuda",
        **kw,
    ):
        self.backend = load_vad_model(
            "silero", vad_onset=vad_onset, chunk_size=chunk_size, device=device, **kw
        )
        self.stats = {"calls": 0}

    def __call__(self, audio_dict, **options):
        self.stats["calls"] += 1
        return self.backend(audio_dict, **options)

    def __getattr__(self, name):
        # the backend's capabilities and settings: without this, the
        # pipeline's getattr(vad, "supports_device_audio", False) would see
        # the wrapper and copy the resident audio back to the host
        return getattr(self.backend, name)


def load_vad_model(
    method: str = "silero",
    *,
    vad_onset: float = 0.5,
    vad_offset: float = 0.363,
    chunk_size: float = 30.0,
    model_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
):
    """VAD factory (reference asr.py vad_method dispatch), as the JAX
    package's: ``"silero"`` loads the network from ``model_path`` or the
    ``WHISPERX_TPU_SILERO_CKPT`` directory, and without either falls back to
    the energy VAD with a warning. A network runs on ``device``; CUDA
    without a GPU raises, whatever the method."""
    from whisperx_tpu_torch.models.whisper import resolve_device

    device = resolve_device(device)
    method = (method or "silero").lower()
    if method == "silero":
        if model_path:
            return SileroVAD.from_checkpoint(
                model_path, device=device, vad_onset=vad_onset, chunk_size=chunk_size
            )
        default = os.environ.get("WHISPERX_TPU_SILERO_CKPT")
        if default and os.path.isdir(default):
            return SileroVAD.from_checkpoint(
                default, device=device, vad_onset=vad_onset, chunk_size=chunk_size
            )
        # random LSTM weights would segment meaninglessly: the energy VAD
        # is the functional fallback
        warnings.warn(
            "No converted Silero checkpoint (set WHISPERX_TPU_SILERO_CKPT "
            "or pass model_path); falling back to the weightless energy "
            "VAD.",
            stacklevel=2,
        )
        return EnergyVAD(vad_onset=vad_onset, chunk_size=chunk_size)
    if method == "energy":
        return EnergyVAD(vad_onset=vad_onset, chunk_size=chunk_size)
    if method == "pyannote":
        from whisperx_tpu_torch.vad.pyannote_vad import PyannoteVAD

        return PyannoteVAD(
            vad_onset=vad_onset,
            vad_offset=vad_offset,
            chunk_size=chunk_size,
            model_path=model_path,
            device=device,
        )
    if method == "hybrid":
        return HybridVAD(vad_onset=vad_onset, chunk_size=chunk_size, device=device)
    raise ValueError(f"Unknown VAD method: {method}")


__all__ = [
    "BatchVADProcessor",
    "Binarize",
    "EnergyVAD",
    "HybridVAD",
    "SileroVAD",
    "SpeechSegment",
    "load_vad_model",
    "merge_chunks",
    "probs_to_speech_timestamps",
]
