from whisperx_tpu_torch.audio.constants import (
    CHUNK_LENGTH,
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    N_SAMPLES_PER_TOKEN,
    SAMPLE_RATE,
    TOKENS_PER_SECOND,
)
from whisperx_tpu_torch.audio.io import load_audio, pad_or_trim, save_wav
from whisperx_tpu_torch.audio.mel import (
    log_mel_batch,
    log_mel_spectrogram,
    mel_filters,
)

__all__ = [
    "load_audio",
    "pad_or_trim",
    "save_wav",
    "log_mel_batch",
    "log_mel_spectrogram",
    "mel_filters",
    "SAMPLE_RATE",
    "N_FFT",
    "HOP_LENGTH",
    "CHUNK_LENGTH",
    "N_SAMPLES",
    "N_FRAMES",
    "N_SAMPLES_PER_TOKEN",
    "FRAMES_PER_SECOND",
    "TOKENS_PER_SECOND",
]
