"""wav2vec2-CTC: config, modules, forward pass."""

from whisperx_tpu_torch.models.wav2vec2.model import (
    BASE_CONFIG,
    LARGE_XLSR_CONFIG,
    TEST_CONFIG,
    Wav2Vec2,
    Wav2Vec2Config,
    config_from_json,
    forward,
    init_params,
    output_lengths,
)

__all__ = [
    "BASE_CONFIG",
    "LARGE_XLSR_CONFIG",
    "TEST_CONFIG",
    "Wav2Vec2",
    "Wav2Vec2Config",
    "config_from_json",
    "forward",
    "init_params",
    "output_lengths",
]
