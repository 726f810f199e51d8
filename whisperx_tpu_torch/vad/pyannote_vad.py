"""PyAnnote-style VAD: segmentation network + hysteresis Binarize + min-cut.

Counterpart of ``whisperx_tpu/vad/pyannote_vad.py`` (reference
whisperx/vads/pyannote.py: sliding-window scores → Binarize with min-cut
splitting, vad_onset/vad_offset thresholds). With a converted segmentation
checkpoint, every 10 s window at a 1 s step goes through the PyanNet in one
batched forward on the VAD's device, and the overlapping windows are
averaged onto one monotone frame grid. Without one, the frame scores are the
energy detector's, as in JAX (its documented behaviour), so the Binarize and
min-cut path is still exercised.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE
from whisperx_tpu_torch.vad.binarize import Binarize
from whisperx_tpu_torch.vad.types import SpeechSegment


class PyannoteVAD:
    WINDOW_S = 10.0  # segmentation model window
    STEP_S = 1.0

    def __init__(
        self,
        vad_onset: float = 0.500,
        vad_offset: float = 0.363,
        chunk_size: float = 30.0,
        model_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        self.vad_onset = vad_onset
        self.vad_offset = vad_offset
        self.chunk_size = chunk_size
        self._model = None
        if model_path:
            from whisperx_tpu_torch.convert.checkpoint import (
                pyannote_from_numpy,
                read_checkpoint,
            )
            from whisperx_tpu_torch.models.pyannote.model import config_from_json
            from whisperx_tpu_torch.models.whisper import resolve_device

            flat, meta = read_checkpoint(model_path)
            self._model = pyannote_from_numpy(
                flat, config_from_json(meta["config"]), device=resolve_device(device)
            )

    def windows(self, audio: np.ndarray):
        """The 10 s windows at a 1 s step (the last zero-padded): (start
        times in s, [n_windows, samples] array)."""
        win = int(self.WINDOW_S * SAMPLE_RATE)
        step = int(self.STEP_S * SAMPLE_RATE)
        starts, chunks = [], []
        pos = 0
        while pos == 0 or pos + win // 2 < len(audio):
            chunk = audio[pos : pos + win]
            if len(chunk) < win:
                chunk = np.pad(chunk, (0, win - len(chunk)))
            starts.append(pos / SAMPLE_RATE)
            chunks.append(chunk)
            pos += step
            if pos + win >= len(audio) + step:
                break
        return starts, np.stack(chunks)

    def _frame_scores(self, audio: np.ndarray):
        """Returns (scores [T], timestamps [T])."""
        if self._model is not None:
            from whisperx_tpu_torch.models.pyannote.model import forward

            starts, chunks = self.windows(audio)
            # ONE batched forward for every sliding window
            log_scores = forward(self._model, torch.from_numpy(chunks).to(self._model.device))
            scores = np.exp(log_scores.cpu().numpy())
            speech = 1.0 - scores[:, :, 0]  # P(speech) = 1 - P(silence)
            # the overlapping windows (10 s stepped by 1 s) are AVERAGED onto
            # one monotone frame grid, as pyannote does: feeding each
            # window's frames in turn would hand Binarize duplicated,
            # non-monotone timestamps
            n_f = speech.shape[1]
            frame_dur = self.WINDOW_S / n_f
            total = int(np.ceil(len(audio) / SAMPLE_RATE / frame_dur)) + 1
            acc = np.zeros(total)
            cover = np.zeros(total)
            for start_s, row in zip(starts, speech):
                f0 = int(round(start_s / frame_dur))
                hi = min(f0 + n_f, total)
                acc[f0:hi] += row[: hi - f0]
                cover[f0:hi] += 1.0
            valid = cover > 0
            frames = acc[valid] / cover[valid]
            times = (np.flatnonzero(valid) + 0.5) * frame_dur
            keep = times <= len(audio) / SAMPLE_RATE + frame_dur
            return frames[keep], times[keep]

        from whisperx_tpu_torch.vad.energy import EnergyVAD

        probs = EnergyVAD().speech_probs(audio)
        times = (np.arange(len(probs)) + 0.5) * 512 / SAMPLE_RATE
        return probs, times

    def __call__(self, audio_dict, **options) -> List[SpeechSegment]:
        audio = np.asarray(audio_dict["waveform"], np.float32).reshape(-1)
        scores, times = self._frame_scores(audio)
        if len(scores) == 0:
            return []
        binarize = Binarize(
            onset=options.get("threshold", self.vad_onset),
            offset=self.vad_offset,
            max_duration=options.get("max_speech_duration_s", self.chunk_size),
            min_duration_on=0.0,
            min_duration_off=0.0,
        )
        segs = binarize(scores, times)
        return [
            SpeechSegment(max(0.0, s.start), min(len(audio) / SAMPLE_RATE, s.end)) for s in segs
        ]
