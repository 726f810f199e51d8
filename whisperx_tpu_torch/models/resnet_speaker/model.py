"""ResNet34 speaker-embedding network (wespeaker family) in PyTorch.

Counterpart of ``whisperx_tpu/models/resnet_speaker/model.py``: the
embedding model of pyannote/speaker-diarization-3.1
(wespeaker-voxceleb-resnet34-LM). 80-dim log-mel fbank → ResNet34 trunk →
temporal statistics pooling (mean ‖ std) → linear projection to a unit-norm
256-dim speaker embedding.

The trunk is NCHW with H = time and W = mel; the modules hold torch's conv
layout (OIHW), which ``convert.checkpoint.resnet_speaker_from_numpy`` maps
from the JAX package's NHWC/HWIO checkpoints once, at load. Three details
keep the arithmetic the JAX package's:
  - XLA's ``"SAME"`` padding is asymmetric at stride 2 on an even side (0
    before, 1 after): every convolution pads explicitly, per side, as XLA
    does, then runs with ``padding=0``;
  - batch norm is the inference form from the checkpoint's statistics,
    ``(x - mean) * rsqrt(var + 1e-5) * g + b``;
  - the pooled features flatten as ``[B, T, F·C]`` with C fastest, and the
    standard deviation is the population one.
The forward runs in full f32: no TF32 in cuDNN's convolutions nor in the
products.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperx_tpu_torch.audio.constants import HOP_LENGTH, N_FFT
from whisperx_tpu_torch.audio.mel import _mel_filters_tensor, _stft_power, reflect_pad
from whisperx_tpu_torch.models.pyannote.model import Dense, _param
from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetSpeakerConfig:
    channels: Tuple[int, ...] = (32, 64, 128, 256)
    blocks: Tuple[int, ...] = (3, 4, 6, 3)
    n_mels: int = 80
    embed_dim: int = 256


TEST_CONFIG = ResNetSpeakerConfig(channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1), embed_dim=16)


def config_from_json(cfg: dict) -> ResNetSpeakerConfig:
    """A config from a checkpoint's ``config.json`` (lists for tuples)."""
    return ResNetSpeakerConfig(
        channels=tuple(cfg["channels"]),
        blocks=tuple(cfg["blocks"]),
        n_mels=cfg["n_mels"],
        embed_dim=cfg["embed_dim"],
    )


class BatchNorm(nn.Module):
    """Inference batch norm: affine ``g``, ``b`` and running ``mean``, ``var``."""

    def __init__(self, c: int, *, dtype, device):
        super().__init__()
        for name in ("g", "b", "mean", "var"):
            setattr(self, name, _param((c,), dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def ch(v):
            return v[:, None, None]

        return (x - ch(self.mean)) * ch(torch.rsqrt(self.var + BN_EPS)) * ch(self.g) + ch(self.b)


class ConvBN(nn.Module):
    """A convolution ``w`` [O, I, k, k] and its batch norm (the stem and a
    block's downsample)."""

    def __init__(self, c_in: int, c_out: int, k: int, *, dtype, device):
        super().__init__()
        self.w = _param((c_out, c_in, k, k), dtype, device)
        self.bn = BatchNorm(c_out, dtype=dtype, device=device)


class Block(nn.Module):
    """Basic residual block: ``conv1``/``bn1``, ``conv2``/``bn2``, and a 1×1
    ``down`` projection where the shape changes."""

    def __init__(self, c_in: int, c_out: int, stride: int, has_down: bool, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stride = stride
        self.conv1 = _param((c_out, c_in, 3, 3), dtype, device)
        self.bn1 = BatchNorm(c_out, **kw)
        self.conv2 = _param((c_out, c_out, 3, 3), dtype, device)
        self.bn2 = BatchNorm(c_out, **kw)
        self.down = ConvBN(c_in, c_out, 1, **kw) if has_down else None


class ResNetSpeaker(nn.Module):
    """The trunk and head. A block projects its shortcut when it strides or
    changes the width (JAX ``init_params``' rule, which the wespeaker
    converter's checkpoints follow)."""

    def __init__(
        self,
        cfg: ResNetSpeakerConfig,
        *,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.stem = ConvBN(1, cfg.channels[0], 3, **kw)
        stages, c_in = [], cfg.channels[0]
        for stage, (c_out, n) in enumerate(zip(cfg.channels, cfg.blocks)):
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Block(c_in, c_out, stride, stride != 1 or c_in != c_out, **kw))
                c_in = c_out
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        freq_out = cfg.n_mels // (2 ** (len(cfg.channels) - 1))
        self.proj = Dense(cfg.channels[-1] * freq_out * 2, cfg.embed_dim, **kw)  # mean ‖ std
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.proj.w.device


@torch.no_grad()
def init_params(
    cfg: ResNetSpeakerConfig, generator: torch.Generator, dtype: torch.dtype = torch.float32
) -> ResNetSpeaker:
    """Random weights with the JAX package's distributions (``init_params``:
    convs ``N(0, 1/(k²·c_in))``, projection ``N(0, 0.02²)``, zero bias,
    identity batch norms), drawn on the generator's device (the values are
    not JAX's: the two generators differ)."""
    device = generator.device
    model = ResNetSpeaker(cfg, dtype=dtype, device=device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 4:  # drawn in the JAX layout [k, k, I, O]
            o, i, k, _ = p.shape
            x = torch.randn((k, k, i, o), generator=generator, device=device)
            p.copy_((x / math.sqrt(k * k * i)).permute(3, 2, 0, 1).to(dtype))
        elif name == "proj.w":
            p.copy_((torch.randn(p.shape, generator=generator, device=device) * 0.02).to(dtype))
        elif leaf in ("g", "var"):
            p.fill_(1.0)
        else:  # bn b / mean, proj b
            p.zero_()
    return model.eval()


def _same_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``conv_general_dilated(..., "SAME")`` of XLA: out = ceil(in / stride)
    per side, the padding split with the odd element AFTER."""
    k = w.shape[-1]
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad's order: last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w, stride=stride)


def _block(p: Block, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(p.bn1(_same_conv(x, p.conv1, p.stride)))
    h = p.bn2(_same_conv(h, p.conv2, 1))
    if p.down is not None:
        x = p.down.bn(_same_conv(x, p.down.w, p.stride))
    return F.relu(x + h)


@reference_matmul()
def fbank(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, samples] → log-mel fbank [B, T, n_mels], mean-normalized over time
    (T = samples // HOP_LENGTH, centre reflect padding)."""
    half = N_FFT // 2
    n_frames = audio.shape[-1] // HOP_LENGTH
    padded = reflect_pad(audio, half)
    power = _stft_power(padded, n_frames)  # [B, T, F]
    mel = torch.matmul(power, _mel_filters_tensor(n_mels, audio.device).T)
    logmel = torch.log(torch.clamp(mel, min=1e-10))
    return logmel - logmel.mean(dim=1, keepdim=True)  # CMN


@torch.no_grad()
def embed(model: ResNetSpeaker, audio: torch.Tensor) -> torch.Tensor:
    """[B, samples] on the model's device → unit-norm speaker embeddings
    [B, embed_dim]."""
    with reference_matmul(), no_tf32_cudnn():
        x = fbank(audio.to(torch.float32), model.cfg.n_mels)[:, None]  # [B, 1, T, M]
        x = F.relu(model.stem.bn(_same_conv(x, model.stem.w, 1)))
        for blocks in model.stages:
            for block in blocks:
                x = _block(block, x)
        # temporal statistics pooling: [B, C, T, F] → [B, T, F·C], C fastest
        b, c, t, f = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        mean = flat.mean(dim=1)
        std = torch.sqrt(torch.clamp(flat.var(dim=1, correction=0), min=1e-7))
        emb = torch.cat([mean, std], dim=-1) @ model.proj.w + model.proj.b
        return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-9)


class ResNetSpeakerEmbedding:
    """Diarization embedding backend: ``embed([B, samples]) → [B, D]``, numpy
    in and out, one batched forward on ``device``."""

    def __init__(
        self,
        model: Optional[ResNetSpeaker] = None,
        config: ResNetSpeakerConfig = TEST_CONFIG,
        device: Union[str, torch.device] = "cuda",
    ):
        from whisperx_tpu_torch.models.whisper import resolve_device

        if model is None:
            model = init_params(config, torch.Generator(resolve_device(device)).manual_seed(0))
        self.model = model
        self.config = model.cfg
        self.dim = model.cfg.embed_dim

    @classmethod
    def from_checkpoint(
        cls, path: str, device: Union[str, torch.device] = "cuda"
    ) -> "ResNetSpeakerEmbedding":
        from whisperx_tpu_torch.convert.checkpoint import read_checkpoint, resnet_speaker_from_numpy
        from whisperx_tpu_torch.models.whisper import resolve_device

        flat, meta = read_checkpoint(path)
        model = resnet_speaker_from_numpy(
            flat, config_from_json(meta["config"]), device=resolve_device(device)
        )
        return cls(model)

    def embed(self, windows: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(windows, np.float32), device=self.model.device)
        return embed(self.model, x).cpu().numpy()
