"""Whisper model dimensions and the named-model registry.

The reference resolves user-facing names to MLX HF repos
(backends/mlx_whisper.py:40-58, backends/mlx_lightning.py:47-72); here names
resolve to architecture configs + optional local weight paths, since weights
are loaded from converted checkpoints (``weights.npz`` + ``config.json``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.is_multilingual)


def _dims(mels, actx, astate, ahead, alayer, vocab, tctx, tstate, thead, tlayer):
    return ModelDimensions(mels, actx, astate, ahead, alayer, vocab, tctx, tstate, thead, tlayer)


# (OpenAI Whisper public architecture table.)
MODEL_DIMS: dict[str, ModelDimensions] = {
    "tiny.en": _dims(80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "tiny": _dims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "base.en": _dims(80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "base": _dims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "small.en": _dims(80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "small": _dims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "medium.en": _dims(80, 1500, 1024, 16, 24, 51864, 448, 1024, 16, 24),
    "medium": _dims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "large-v1": _dims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": _dims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": _dims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large": _dims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large-v3-turbo": _dims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
    "turbo": _dims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
    "distil-large-v3": _dims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 2),
    "distil-large-v2": _dims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 2),
    # Tiny random-weight configs for unit tests / CI (SURVEY.md §4).
    "test-nano": _dims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2),
    "test-nano.en": _dims(80, 1500, 64, 2, 2, 51864, 448, 64, 2, 2),
}

# Alignment heads (layer, head) used for DTW word timing. OpenAI publishes
# these as compressed masks; the cross-attention QK capture works with any
# subset, and converters may override with checkpoint metadata. As a robust
# default we use the heads of the upper half of the decoder (the publicly
# documented heuristic for models without a mask).
ALIGNMENT_HEADS: dict[str, Optional[list]] = {}


def resolve_model_name(name: str) -> str:
    """Normalize user-facing model names (whisper-large-v3, -q4 suffixes...)."""
    n = name.lower()
    for prefix in ("openai/whisper-", "whisper-", "mlx-community/whisper-"):
        if n.startswith(prefix):
            n = n[len(prefix):]
    for suffix in ("-mlx", "-4bit", "-8bit", "-q4", "-q8", "-fp16"):
        if n.endswith(suffix):
            n = n[: -len(suffix)]
    if n in MODEL_DIMS:
        return n
    raise ValueError(
        f"Unknown model {name!r}. Known: {sorted(MODEL_DIMS)}"
    )


def get_dims(name: str) -> ModelDimensions:
    return MODEL_DIMS[resolve_model_name(name)]
