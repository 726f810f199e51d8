"""ResNet34 speaker-embedding network (wespeaker family)."""

from whisperx_tpu_torch.models.resnet_speaker.model import (
    TEST_CONFIG,
    ResNetSpeaker,
    ResNetSpeakerConfig,
    ResNetSpeakerEmbedding,
    config_from_json,
    embed,
    fbank,
    init_params,
)

__all__ = [
    "TEST_CONFIG",
    "ResNetSpeaker",
    "ResNetSpeakerConfig",
    "ResNetSpeakerEmbedding",
    "config_from_json",
    "embed",
    "fbank",
    "init_params",
]
