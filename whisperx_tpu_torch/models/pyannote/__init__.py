"""PyanNet segmentation network (pyannote/segmentation family)."""

from whisperx_tpu_torch.models.pyannote.model import (
    TEST_CONFIG,
    PyanNet,
    PyanNetConfig,
    config_from_json,
    forward,
    init_params,
)

__all__ = ["TEST_CONFIG", "PyanNet", "PyanNetConfig", "config_from_json", "forward", "init_params"]
