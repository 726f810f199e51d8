from whisperx_tpu_torch.decoding.decode import (
    DecodingOptions,
    DecodingResult,
    decode,
    detect_language,
)
from whisperx_tpu_torch.decoding.tokenizer import Tokenizer, get_tokenizer

__all__ = [
    "DecodingOptions",
    "DecodingResult",
    "decode",
    "detect_language",
    "Tokenizer",
    "get_tokenizer",
]
