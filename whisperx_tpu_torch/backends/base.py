"""Abstract backend contract (parity: reference backends/base.py:8-58).

Counterpart of ``whisperx_tpu/backends/base.py``: two decode strategies over
one PyTorch model, the truly batched decode (default) and the sequential
seek loop.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Union

import numpy as np

from whisperx_tpu_torch.types import TranscriptionResult


class WhisperBackend(ABC):
    @abstractmethod
    def __init__(
        self,
        model: str,
        device: str = "cuda",
        device_index: int = 0,
        compute_type: str = "bfloat16",
        download_root: Optional[str] = None,
        local_files_only: bool = False,
        threads: int = 4,
        **kwargs,
    ):
        ...

    @abstractmethod
    def transcribe(
        self,
        audio: Union[str, np.ndarray],
        batch_size: Optional[int] = None,
        num_workers: int = 0,
        language: Optional[str] = None,
        task: Optional[str] = None,
        chunk_size: int = 30,
        print_progress: bool = False,
        combined_progress: bool = False,
        verbose: bool = False,
        **kwargs,
    ) -> TranscriptionResult:
        ...

    @abstractmethod
    def detect_language(self, audio: np.ndarray) -> str:
        ...

    @property
    @abstractmethod
    def supported_languages(self) -> List[str]:
        ...

    @property
    @abstractmethod
    def is_multilingual(self) -> bool:
        ...
