"""Silero-style VAD network in PyTorch: a stacked LSTM over audio windows.

Counterpart of ``whisperx_tpu/models/silero_vad/model.py``, which runs the
recurrence as one ``lax.scan``: here it is ``torch.nn.LSTM`` (cuDNN on the
card), batched over audio streams, followed by a dense sigmoid head. The JAX
layers' weights are ``wx [in, 4H]``, ``wh [H, 4H]`` and one bias ``b``, gates
in torch's order (i, f, g, o); ``convert.checkpoint.silero_from_numpy`` maps
them onto ``weight_ih = wxᵀ``, ``weight_hh = whᵀ``, ``bias_ih = b`` and a
zero ``bias_hh``. The forward runs in full f32 (no TF32 in cuDNN's
recurrence nor in the head's product).
"""

from __future__ import annotations

import math
from typing import Union

import torch
from torch import nn

from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul

WINDOW_SIZE_SAMPLES = 512  # 32 ms @ 16 kHz


class SileroVADNet(nn.Module):
    """``lstm``: ``num_layers`` stacked LSTM layers; ``head``: ``w`` [H, 1]
    and ``b`` [1], the JAX package's dense layout."""

    def __init__(
        self,
        input_size: int = WINDOW_SIZE_SAMPLES,
        hidden_size: int = 64,
        num_layers: int = 2,
        *,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.lstm = nn.LSTM(
            input_size, hidden_size, num_layers, batch_first=True, dtype=dtype, device=device
        )
        self.head = nn.Module()
        self.head.w = nn.Parameter(torch.empty((hidden_size, 1), dtype=dtype, device=device))
        self.head.b = nn.Parameter(torch.empty((1,), dtype=dtype, device=device))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.head.w.device


@torch.no_grad()
def init_params(
    generator: torch.Generator,
    input_size: int = WINDOW_SIZE_SAMPLES,
    hidden_size: int = 64,
    num_layers: int = 2,
    dtype: torch.dtype = torch.float32,
) -> SileroVADNet:
    """Random weights with the JAX package's distributions (``init_params``):
    ``wx ~ N(0,1)/√d_in``, ``wh ~ N(0,1)/√H``, zero biases, head
    ``N(0, 0.1²)``; drawn on the generator's device (the values are not
    JAX's: the two generators differ)."""
    device = generator.device
    model = SileroVADNet(input_size, hidden_size, num_layers, dtype=dtype, device=device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    d_in = input_size
    for i in range(num_layers):
        # the JAX layout [in, 4H], transposed into torch's [4H, in]
        getattr(model.lstm, f"weight_ih_l{i}").copy_(normal((d_in, 4 * hidden_size), 1 / math.sqrt(d_in)).T)
        getattr(model.lstm, f"weight_hh_l{i}").copy_(
            normal((hidden_size, 4 * hidden_size), 1 / math.sqrt(hidden_size)).T
        )
        getattr(model.lstm, f"bias_ih_l{i}").zero_()
        getattr(model.lstm, f"bias_hh_l{i}").zero_()
        d_in = hidden_size
    model.head.w.copy_(normal((hidden_size, 1), 0.1))
    model.head.b.zero_()
    return model.eval()


@torch.no_grad()
def speech_probs(model: SileroVADNet, windows: torch.Tensor) -> torch.Tensor:
    """windows: [B, T, input_size] → per-window speech prob [B, T]."""
    if windows.shape[1] == 0:  # cuDNN's recurrence refuses an empty sequence
        return windows.new_zeros(windows.shape[:2])
    with reference_matmul(), no_tf32_cudnn():
        ys, _ = model.lstm(windows.to(model.head.w.dtype))
        logits = ys @ model.head.w + model.head.b  # [B, T, 1]
    return torch.sigmoid(logits)[..., 0]


def frame_audio(audio: torch.Tensor, window: int = WINDOW_SIZE_SAMPLES) -> torch.Tensor:
    """[B, L] (or [L]) → [B, T, window] non-overlapping windows, the last
    zero-padded."""
    if audio.dim() == 1:
        audio = audio[None]
    b, n = audio.shape
    t = -(-n // window)
    audio = torch.nn.functional.pad(audio, (0, t * window - n))
    return audio.reshape(b, t, window)
