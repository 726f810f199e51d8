"""Batched VAD over several audio streams in one device call.

Counterpart of ``whisperx_tpu/vad/batch.py``: every stream's windows are
zero-padded into one [B, T, 512] tensor and one Silero forward gives every
stream's speech probabilities (the reference runs a thread pool over files).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from whisperx_tpu_torch.models.silero_vad.model import WINDOW_SIZE_SAMPLES, speech_probs
from whisperx_tpu_torch.vad.silero import probs_to_speech_timestamps
from whisperx_tpu_torch.vad.types import SpeechSegment


class BatchVADProcessor:
    def __init__(self, vad=None, device: Union[str, torch.device] = "cuda", **vad_options):
        if vad is None:
            # through the factory: a bare SileroVAD() would carry RANDOM
            # weights; the factory warns and falls back to the energy VAD
            from whisperx_tpu_torch.vad import load_vad_model

            vad = load_vad_model("silero", device=device, **vad_options)
        self.vad = vad
        self.stats: Dict[str, float] = {"files": 0, "batches": 0}

    def process_batch(self, audios: Sequence[np.ndarray], **options) -> List[List[SpeechSegment]]:
        """VAD for several audio streams with ONE device call."""
        if not audios:
            return []
        lengths = [len(a) for a in audios]
        # t_max >= 1 so that an all-empty batch still has valid [B, 1]
        # shapes; zero-length rows come out as "no speech"
        t_max = max(1, -(-max(lengths) // WINDOW_SIZE_SAMPLES))
        batch = np.zeros((len(audios), t_max * WINDOW_SIZE_SAMPLES), np.float32)
        for i, a in enumerate(audios):
            batch[i, : len(a)] = np.asarray(a, np.float32)
        model: Optional[torch.nn.Module] = getattr(self.vad, "model", None)
        if model is not None:  # the Silero network
            windows = torch.from_numpy(batch.reshape(len(audios), t_max, WINDOW_SIZE_SAMPLES))
            probs = speech_probs(model, windows.to(model.device)).cpu().numpy()
        else:  # the energy fallback: its percentile statistics are per
            # stream, so each row is scored at its TRUE length (a short
            # file's zero padding must not skew its threshold)
            probs = np.zeros((len(audios), t_max), np.float32)
            for i, n in enumerate(lengths):
                if n == 0:  # empty stream: no speech (and no statistics)
                    continue
                p = self.vad.speech_probs(batch[i, :n])
                probs[i, : len(p)] = p

        results = []
        for i, n in enumerate(lengths):
            t_real = -(-n // WINDOW_SIZE_SAMPLES)
            results.append(
                probs_to_speech_timestamps(
                    probs[i, :t_real],
                    n,
                    threshold=options.get("threshold", self.vad.vad_onset),
                    max_speech_duration_s=options.get(
                        "max_speech_duration_s", self.vad.chunk_size
                    ),
                )
            )
        self.stats["files"] += len(audios)
        self.stats["batches"] += 1
        return results

    def process_files(self, paths: Sequence[str], **options):
        from whisperx_tpu_torch.audio import load_audio

        audios = [load_audio(p) for p in paths]
        return dict(zip(paths, self.process_batch(audios, **options)))
