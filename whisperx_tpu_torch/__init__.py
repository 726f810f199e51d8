"""whisperx_tpu_torch — the PyTorch/CUDA port of whisperx_tpu, for NVIDIA
Hopper GPUs.

Lazy public API façade (mirrors ``whisperx_tpu/__init__.py``): the model and
torch-heavy imports happen on first attribute access.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    "load_model": ("whisperx_tpu_torch.asr", "load_model"),
    "load_audio": ("whisperx_tpu_torch.audio", "load_audio"),
    "load_align_model": ("whisperx_tpu_torch.alignment", "load_align_model"),
    "align": ("whisperx_tpu_torch.alignment", "align"),
    "assign_word_speakers": ("whisperx_tpu_torch.diarize", "assign_word_speakers"),
    "load_pipeline": ("whisperx_tpu_torch.pipeline", "load_pipeline"),
    "load_tpu_pipeline": ("whisperx_tpu_torch.pipeline", "load_tpu_pipeline"),
    "DiarizationPipeline": ("whisperx_tpu_torch.diarize", "DiarizationPipeline"),
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'whisperx_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
