"""Speaker embeddings for diarization.

Counterpart of ``whisperx_tpu/diarize/embedding.py``. Backends share one
interface, ``embed(windows [B, samples]) -> [B, D] float32`` (unit norm):
  - ``SpectralEmbedding`` (the default, weightless): log-mel statistics and
    deltas, L2-normalized; it keeps diarization working with no converted
    checkpoint;
  - ``models.resnet_speaker.ResNetSpeakerEmbedding``, the wespeaker ResNet34
    of pyannote/speaker-diarization-3.1, from a converted checkpoint.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from whisperx_tpu_torch.audio.mel import log_mel_batch


class SpectralEmbedding:
    """Log-mel statistics embedding: per mel band the mean, the (population)
    standard deviation and the mean absolute delta over time, 240 values,
    L2-normalized. The log-mels and the statistics run on ``device`` in one
    batched pass; one [B, 240] array comes back to the host."""

    dim = 240

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        from whisperx_tpu_torch.models.whisper import resolve_device

        self.device = resolve_device(device)

    @torch.no_grad()
    def features(self, windows: torch.Tensor) -> torch.Tensor:
        """[B, samples] f32 on the device → [B, dim] unit-norm embeddings,
        on the same device."""
        mel = log_mel_batch(windows, 80)  # [B, T, 80]
        mu = mel.mean(dim=1)
        sd = mel.std(dim=1, correction=0)
        if mel.shape[1] > 1:
            delta = torch.diff(mel, dim=1).abs().mean(dim=1)
        else:
            delta = torch.zeros_like(mu)
        v = torch.cat([mu, sd, delta], dim=1)  # [B, 240]
        n = torch.linalg.norm(v, dim=1, keepdim=True)
        return v / torch.where(n > 0, n, 1.0)

    def embed(self, windows: np.ndarray) -> np.ndarray:
        """windows: [B, samples] → [B, dim] unit-norm embeddings."""
        windows = np.asarray(windows, np.float32)
        if windows.ndim != 2:
            raise ValueError(f"expected [B, samples], got {windows.shape}")
        if len(windows) == 0:
            return np.zeros((0, self.dim), np.float32)
        return self.features(torch.from_numpy(windows).to(self.device)).cpu().numpy()
