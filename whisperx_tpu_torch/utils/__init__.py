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
from whisperx_tpu_torch.utils.der import diarization_error_rate, load_rttm, save_rttm
from whisperx_tpu_torch.utils.writers import get_writer

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
    "diarization_error_rate",
    "load_rttm",
    "save_rttm",
]
