"""Seeded synthetic speech, the pool that files and clips are cut from.

The signal is the repository's ``synth_speech`` (``chip_smoke.py``):
amplitude-modulated harmonics of a gliding 120 Hz voice with silent gaps of
about a second every 4.76 s, plus a little noise, here computed with torch
on the device and rounded to 16-bit PCM (audio files are), so the port
uploads it as int16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 16000


def pool(seconds: float, seed: int, device) -> np.ndarray:
    """``seconds`` of speech-like audio from ``seed``, float32 on the host."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    n = int(seconds * SR)
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    f0 = 120 + 30 * torch.sin(2 * math.pi * 0.5 * t)
    phase = 2 * math.pi * torch.cumsum(f0, 0) / SR
    sig = sum((0.5 / k) * torch.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + torch.sin(2 * math.pi * 3.1 * t))
    gaps = (torch.sin(2 * math.pi * 0.21 * t) > -0.6).double()
    noise = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    out = sig * env * gaps + 0.005 * noise
    out = 0.3 * out / out.abs().max()
    pcm = torch.clamp(torch.round(out * 32768.0), -32768, 32767) / 32768.0
    return pcm.float().cpu().numpy()
