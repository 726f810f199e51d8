"""PyanNet-style segmentation network in PyTorch (pyannote/segmentation
family), for the pyannote VAD and, later, diarization's segmentation.

Counterpart of ``whisperx_tpu/models/pyannote/model.py``. The SincNet front
end's learned band-pass filters are materialized into ordinary conv kernels
at conversion time, so the runtime model is: the waveform's instance norm;
three VALID convolutions (``abs`` after the first only), each followed by a
max-pool and an instance norm and a leaky ReLU (0.01); stacked bidirectional
LSTMs; tanh linears; a classifier; ``log_softmax``.

The convolutions are ``F.conv1d`` and the recurrences one
``torch.nn.LSTM(bidirectional=True)`` (cuDNN on the card): JAX runs them as
``conv_general_dilated`` and ``lax.scan``, outside any Pallas kernel. The
modules hold torch's layouts (conv ``weight`` [O, I, K]; LSTM
``weight_ih``/``weight_hh``); ``convert.checkpoint.pyannote_from_numpy``
maps the JAX package's (conv ``w`` [K, I, O]; per direction ``wx [in, 4H]``,
``wh [H, 4H]``, one ``b``) onto them. The forward runs in full f32: no TF32
in cuDNN's convolutions and recurrences nor in the products.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul


@dataclasses.dataclass(frozen=True)
class PyanNetConfig:
    sincnet_filters: Tuple[int, ...] = (80, 60, 60)
    sincnet_kernels: Tuple[int, ...] = (251, 5, 5)
    sincnet_strides: Tuple[int, ...] = (10, 1, 1)
    pool_size: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dims: Tuple[int, ...] = (128, 128)
    num_classes: int = 7  # powerset for ≤3 speakers / ≤2 overlap


TEST_CONFIG = PyanNetConfig(
    sincnet_filters=(8, 8, 8),
    lstm_hidden=16,
    lstm_layers=1,
    linear_dims=(16,),
    num_classes=3,
)


def config_from_json(cfg: dict) -> PyanNetConfig:
    """A config from a checkpoint's ``config.json`` (lists for tuples)."""
    return PyanNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Norm(nn.Module):
    """Affine of an instance norm."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.g = _param((d,), dtype, device)
        self.b = _param((d,), dtype, device)


class Dense(nn.Module):
    """``w`` [in, out] (the JAX layout) and ``b`` [out]."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


class SincConv(nn.Module):
    """One front-end convolution, no bias: ``weight`` [O, I, K], and the
    instance norm after its pool."""

    def __init__(self, d_in: int, d_out: int, k: int, *, dtype, device):
        super().__init__()
        self.weight = _param((d_out, d_in, k), dtype, device)
        self.norm = Norm(d_out, dtype=dtype, device=device)


class PyanNet(nn.Module):
    def __init__(
        self,
        cfg: PyanNetConfig,
        *,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.wav_norm = Norm(1, **kw)
        d_in, convs = 1, []
        for f, k in zip(cfg.sincnet_filters, cfg.sincnet_kernels):
            convs.append(SincConv(d_in, f, k, **kw))
            d_in = f
        self.sincnet = nn.ModuleList(convs)
        self.lstm = (
            nn.LSTM(
                d_in, cfg.lstm_hidden, cfg.lstm_layers,
                batch_first=True, bidirectional=True, **kw,
            )
            if cfg.lstm_layers
            else None
        )
        d = 2 * cfg.lstm_hidden if cfg.lstm_layers else d_in
        linears = []
        for out in cfg.linear_dims:
            linears.append(Dense(d, out, **kw))
            d = out
        self.linear = nn.ModuleList(linears)
        self.classifier = Dense(d, cfg.num_classes, **kw)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.classifier.w.device


@torch.no_grad()
def init_params(
    cfg: PyanNetConfig, generator: torch.Generator, dtype: torch.dtype = torch.float32
) -> PyanNet:
    """Random weights with the JAX package's distributions (``init_params``:
    convs ``N(0, 0.02²)``, LSTM, linears and classifier ``N(0, 0.05²)``, zero
    biases, unit norms), drawn on the generator's device (the values are
    not JAX's: the two generators differ)."""
    device = generator.device
    model = PyanNet(cfg, dtype=dtype, device=device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    for name, p in model.named_parameters():
        if name.endswith(".g"):
            p.fill_(1.0)
        elif name.endswith(".b") or ".bias_" in name or name.startswith("lstm.bias"):
            p.zero_()
        elif name.endswith("weight"):  # a conv: drawn in the JAX layout [K, I, O]
            p.copy_(normal(p.shape[::-1], 0.02).permute(2, 1, 0))
        elif name.startswith("lstm."):  # drawn as wx [in, 4H] / wh [H, 4H]
            p.copy_(normal(p.shape[::-1], 0.05).T)
        else:  # linears and classifier, [in, out]
            p.copy_(normal(p.shape, 0.05))
    return model.eval()


def _instance_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Each channel normalized over time, per sample: x [B, C, T]."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p.g[:, None] + p.b[:, None]


@torch.no_grad()
def forward(model: PyanNet, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, samples] → frame log-scores [B, frames, num_classes]."""
    cfg = model.cfg
    with reference_matmul(), no_tf32_cudnn():
        # pyannote's SincNet instance-norms the raw waveform first
        x = _instance_norm(model.wav_norm, audio.to(model.classifier.w.dtype)[:, None])
        for ci, (conv, stride) in enumerate(zip(model.sincnet, cfg.sincnet_strides)):
            x = F.conv1d(x, conv.weight, stride=stride)
            if ci == 0:  # pyannote applies abs to the sinc layer ONLY
                x = x.abs()
            x = F.max_pool1d(x, cfg.pool_size, cfg.pool_size)
            x = F.leaky_relu(_instance_norm(conv.norm, x), 0.01)
        x = x.transpose(1, 2)  # [B, T, C]
        if model.lstm is not None:
            x, _ = model.lstm(x.contiguous())
        for lin in model.linear:
            x = torch.tanh(x @ lin.w + lin.b)
        logits = x @ model.classifier.w + model.classifier.b
    return torch.log_softmax(logits, dim=-1)
