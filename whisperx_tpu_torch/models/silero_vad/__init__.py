"""Silero-style VAD network: a stacked LSTM over 512-sample windows."""

from whisperx_tpu_torch.models.silero_vad.model import (
    WINDOW_SIZE_SAMPLES,
    SileroVADNet,
    frame_audio,
    init_params,
    speech_probs,
)

__all__ = ["WINDOW_SIZE_SAMPLES", "SileroVADNet", "frame_audio", "init_params", "speech_probs"]
