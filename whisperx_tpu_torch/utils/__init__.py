from whisperx_tpu_torch.utils.languages import (
    LANGUAGES,
    TO_LANGUAGE_CODE,
    LANGUAGES_WITHOUT_SPACES,
    normalize_language,
)
from whisperx_tpu_torch.utils.text import (
    compression_ratio,
    exact_div,
    format_timestamp,
    interpolate_nans,
    make_safe,
    optional_float,
    optional_int,
    str2bool,
)
from whisperx_tpu_torch.utils.writers import get_writer

# the diarization-error functions (utils/der.py) come with diarization
# (ROADMAP.md, Queue 1, item 12)

__all__ = [
    "LANGUAGES",
    "TO_LANGUAGE_CODE",
    "LANGUAGES_WITHOUT_SPACES",
    "normalize_language",
    "compression_ratio",
    "exact_div",
    "format_timestamp",
    "interpolate_nans",
    "make_safe",
    "optional_float",
    "optional_int",
    "str2bool",
    "get_writer",
]
