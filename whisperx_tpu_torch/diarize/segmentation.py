"""Segmentation-driven speaker activity (pyannote-3.1-class architecture).

Counterpart of ``whisperx_tpu/diarize/segmentation.py``. The pipeline of
``pyannote/speaker-diarization-3.1`` (reference whisperx/diarize.py:11-83):
  1. a PyanNet segmentation model slid over ~10 s windows, emitting
     per-frame POWERSET speaker activity (local speakers, overlap-aware);
  2. embeddings per (window, local speaker), from the frames where that
     speaker is active ALONE;
  3. constrained clustering of those embeddings → global speaker labels;
  4. aggregation of the window-local activities under the global labels.

This module holds steps 1–2's machinery: every window goes through the port's
PyanNet in ONE batched forward on the segmenter's device, the powerset
argmax and the multilabel gather stay there, and the activity array comes
back to the host once. Step 3 is ``diarize.clustering``; step 4 lives in
``DiarizationPipeline``.
"""

from __future__ import annotations

import itertools
from typing import Tuple, Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.constants import SAMPLE_RATE


def powerset_table(num_classes: int) -> np.ndarray:
    """Powerset-class → multilabel matrix [num_classes, n_speakers].

    pyannote's powerset order: subsets sorted by cardinality, then by
    member index — ∅, {0}, {1}, {2}, {0,1}, {0,2}, {1,2} for 3 speakers
    with ≤2 simultaneous. The (n_speakers, max_set_size) pair is recovered
    from ``num_classes`` alone.
    """
    for n_spk in range(1, 8):
        for max_size in range(1, n_spk + 1):
            n = sum(
                len(list(itertools.combinations(range(n_spk), k)))
                for k in range(max_size + 1)
            )
            if n == num_classes:
                table = np.zeros((num_classes, n_spk), np.float32)
                row = 0
                for k in range(max_size + 1):
                    for combo in itertools.combinations(range(n_spk), k):
                        table[row, list(combo)] = 1.0
                        row += 1
                return table
    raise ValueError(f"no (n_speakers, overlap) matches {num_classes} classes")


class SpeakerSegmenter:
    """Batched sliding-window PyanNet speaker segmentation on ``device``.

    ``activity(audio)`` → ``(act, starts, frame_dur)`` where ``act`` is
    [n_windows, frames, n_local_speakers] binary speaker activity, ``starts``
    the window start times (s), and ``frame_dur`` the seconds per output
    frame. Without a model, a ``PyanNet`` of ``config`` (default the test
    config, as in JAX) gets random weights from a ``torch.Generator`` seeded
    0 on ``device``.
    """

    def __init__(
        self,
        model=None,
        config=None,
        window_s: float = 10.0,
        step_s: float = 5.0,
        device: Union[str, torch.device] = "cuda",
    ):
        from whisperx_tpu_torch.models.pyannote.model import TEST_CONFIG, init_params
        from whisperx_tpu_torch.models.whisper import resolve_device

        if model is None:
            dev = resolve_device(device)
            model = init_params(config or TEST_CONFIG, torch.Generator(dev).manual_seed(0))
        self.model = model
        self.config = model.cfg
        self.window_s = float(window_s)
        self.step_s = float(step_s)
        self.table = powerset_table(self.config.num_classes)
        self.n_local_speakers = self.table.shape[1]

    @classmethod
    def from_checkpoint(
        cls, path: str, device: Union[str, torch.device] = "cuda", **kw
    ) -> "SpeakerSegmenter":
        from whisperx_tpu_torch.convert.checkpoint import pyannote_from_numpy, read_checkpoint
        from whisperx_tpu_torch.models.pyannote.model import config_from_json
        from whisperx_tpu_torch.models.whisper import resolve_device

        flat, meta = read_checkpoint(path)
        model = pyannote_from_numpy(
            flat, config_from_json(meta["config"]), device=resolve_device(device)
        )
        return cls(model, **kw)

    def windows(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Slice audio into the sliding windows: ([W, win_samples], starts)."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        win = int(self.window_s * SAMPLE_RATE)
        step = int(self.step_s * SAMPLE_RATE)
        if len(audio) <= win:
            chunk = np.pad(audio, (0, win - len(audio)))
            return chunk[None], np.zeros(1)
        starts = list(range(0, len(audio) - win + step, step))
        out = np.zeros((len(starts), win), np.float32)
        for i, s in enumerate(starts):
            seg = audio[s : s + win]
            out[i, : len(seg)] = seg
        return out, np.asarray(starts, np.float64) / SAMPLE_RATE

    @torch.no_grad()
    def activity(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
        from whisperx_tpu_torch.models.pyannote.model import forward

        chunks, starts = self.windows(audio)
        dev = self.model.device
        scores = forward(self.model, torch.from_numpy(chunks).to(dev))  # [W, F, C]
        # powerset argmax → multilabel lookup (one gather), then one copy
        table = torch.from_numpy(self.table).to(dev)
        act = table[scores.argmax(dim=-1)].cpu().numpy()  # [W, F, K]
        frame_dur = self.window_s / scores.shape[1]
        return act, starts, frame_dur


def clean_frame_masks(act: np.ndarray, min_frames: int = 4) -> np.ndarray:
    """Per-(window, speaker) embedding masks from single-speaker frames.

    act: [W, F, K] binary. Returns masks [W, K, F]: frames where speaker k
    is active ALONE in window w; falls back to all active frames when fewer
    than ``min_frames`` are clean, and to zeros when the speaker is absent.
    """
    total = act.sum(axis=2, keepdims=True)  # [W, F, 1]
    solo = (act * (total == 1)).transpose(0, 2, 1)  # [W, K, F]
    anyact = act.transpose(0, 2, 1)
    use_solo = solo.sum(axis=2, keepdims=True) >= min_frames
    return np.where(use_solo, solo, anyact).astype(np.float32)
