from whisperx_tpu_torch.backends.base import WhisperBackend
from whisperx_tpu_torch.backends.torch_whisper import (
    BatchedTorchBackend,
    SequentialTorchBackend,
    load_backend,
)

__all__ = [
    "WhisperBackend",
    "BatchedTorchBackend",
    "SequentialTorchBackend",
    "load_backend",
]
