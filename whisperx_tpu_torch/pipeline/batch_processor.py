"""Overlap-chunked batch processing for long segments.

Counterpart of ``whisperx_tpu/pipeline/batch_processor.py`` (reference
whisperx/batch_processor.py): splitting VAD segments longer than 30 s into
overlapping windows (:47-99), grouping into padded batches (:101-148), and
the overlap-dedup text merge that drops the leading ~20% of words in a
continuation chunk (:243-276). The device-side decode is the batched path of
``whisperx_tpu_torch.asr``; memory management maps to PyTorch's caching
allocator, whose statistics ``optimize_memory`` reports, instead of the
reference's Metal cache clears (:342-349).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE

OVERLAP_DROP_FRACTION = 0.2  # drop first 20 % of words in continuation chunks


@dataclass
class AudioChunk:
    audio: np.ndarray
    start: float
    end: float
    segment_index: int  # which VAD segment this chunk came from
    is_continuation: bool = False


class BatchProcessor:
    def __init__(
        self,
        chunk_duration: float = 30.0,
        overlap_duration: float = 0.5,
        batch_size: int = 8,
    ):
        if overlap_duration >= chunk_duration:
            raise ValueError(
                f"overlap_duration ({overlap_duration}) must be smaller than "
                f"chunk_duration ({chunk_duration}) — the chunk walk would "
                "never advance"
            )
        self.chunk_duration = chunk_duration
        self.overlap_duration = overlap_duration
        self.batch_size = batch_size

    # -- chunking (reference :47-99) ---------------------------------------

    def chunk_segments(
        self, audio: np.ndarray, segments: List[dict]
    ) -> List[AudioChunk]:
        """Split VAD segments into ≤chunk_duration windows with overlap."""
        chunks: List[AudioChunk] = []
        max_samples = int(self.chunk_duration * SAMPLE_RATE)
        overlap = int(self.overlap_duration * SAMPLE_RATE)
        for idx, seg in enumerate(segments):
            s = int(seg["start"] * SAMPLE_RATE)
            e = min(int(seg["end"] * SAMPLE_RATE), len(audio))
            if e - s <= max_samples:
                chunks.append(
                    AudioChunk(audio[s:e], s / SAMPLE_RATE, e / SAMPLE_RATE, idx)
                )
                continue
            pos = s
            first = True
            while pos < e:
                chunk_end = min(pos + max_samples, e)
                chunks.append(
                    AudioChunk(
                        audio[pos:chunk_end],
                        pos / SAMPLE_RATE,
                        chunk_end / SAMPLE_RATE,
                        idx,
                        is_continuation=not first,
                    )
                )
                if chunk_end >= e:
                    break
                pos = chunk_end - overlap
                first = False
        return chunks

    # -- batching (reference :101-148) -------------------------------------

    def group_batches(self, chunks: List[AudioChunk]) -> List[List[AudioChunk]]:
        return [
            chunks[i : i + self.batch_size]
            for i in range(0, len(chunks), self.batch_size)
        ]

    def pad_batch(self, batch: List[AudioChunk]) -> np.ndarray:
        """Stack chunk audio into [B, max_samples] zero-padded array."""
        max_len = int(self.chunk_duration * SAMPLE_RATE)
        out = np.zeros((len(batch), max_len), np.float32)
        for i, c in enumerate(batch):
            n = min(len(c.audio), max_len)
            out[i, :n] = c.audio[:n]
        return out

    # -- overlap text merge (reference :243-276) ---------------------------

    @staticmethod
    def merge_chunk_texts(texts: List[str], continuations: List[bool]) -> str:
        """Concatenate chunk transcripts, dropping the first ~20 % of words
        of each continuation chunk (they re-transcribe the overlap)."""
        parts = []
        for text, cont in zip(texts, continuations):
            words = text.split()
            if cont and words:
                drop = max(1, int(len(words) * OVERLAP_DROP_FRACTION))
                words = words[drop:]
            if words:
                parts.append(" ".join(words))
        return " ".join(parts)


def optimize_memory() -> dict:
    """Device-memory introspection (in place of the reference's Metal memory
    limit + cache clear, batch_processor.py:342-349): the caching
    allocator's statistics per visible CUDA device, under the JAX package's
    keys. Empty without a GPU, or for a device this process has not used."""
    import torch

    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            stats[f"cuda:{i}"] = {
                "bytes_in_use": s.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            }
    return stats


class MemoryEfficientProcessor(BatchProcessor):
    """Small-memory preset (reference MemoryEfficientProcessor, :366-423):
    shorter chunks + smaller batches so peak activation memory stays low."""

    def __init__(self, chunk_duration: float = 15.0, batch_size: int = 4):
        super().__init__(
            chunk_duration=chunk_duration,
            overlap_duration=0.5,
            batch_size=batch_size,
        )
