"""wav2vec2-CTC acoustic model in PyTorch, for forced alignment.

Counterpart of ``whisperx_tpu/models/wav2vec2/model.py``: both published
variants ("base": post-layer-norm encoder and a group-norm feature
extractor; "large/xlsr": pre-layer-norm and layer-normed convolutions), the
same parameter names and layouts (conv ``w`` is ``[k, I, O]``, linear ``w``
is ``[in, out]``), and the same arithmetic step by step, so that f32
emissions agree with the JAX package's to rounding:

  - GELU is the tanh approximation (``jax.nn.gelu``'s default);
  - layer and group norms take f32 statistics with the population variance;
  - the positional grouped convolution pads k//2 on both sides and drops
    the trailing frame when k is even;
  - the self-attention is plain products and a softmax over every frame,
    padded ones included (no mask), as the JAX einsum is.

The convolutions are ``F.conv1d`` and the projections ``torch.matmul``: the
JAX package computes them outside any Pallas kernel too. The forward pass
runs in full f32 on CUDA: no TF32 in the matrix products nor in cuDNN's
convolutions (TF32 would move the feature extractor's output by ~1e-3).

``init_params`` draws random weights from a ``torch.Generator`` with the
JAX package's distributions; the values differ from JAX's ``PRNGKey(0)``
ones (the two generators differ), so parity tests carry JAX's weights over
through ``convert.checkpoint.wav2vec2_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from whisperx_tpu_torch.utils.precision import no_tf32_cudnn, reference_matmul


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False  # False: base; True: large/xlsr
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BASE_CONFIG = Wav2Vec2Config()
LARGE_XLSR_CONFIG = Wav2Vec2Config(
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
    do_stable_layer_norm=True,
    feat_extract_norm="layer",
)
# Tiny config for unit tests.
TEST_CONFIG = Wav2Vec2Config(
    hidden_size=64,
    num_layers=2,
    num_heads=2,
    intermediate_size=128,
    conv_dim=(32, 32, 32, 32, 32, 32, 32),
)


def config_from_json(cfg: dict) -> Wav2Vec2Config:
    """A config from a checkpoint's ``config.json`` (lists for tuples)."""
    return Wav2Vec2Config(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    )


# ---------------------------------------------------------------------------
# Modules: weight containers named after the JAX parameter tree
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Norm(nn.Module):
    """Affine of a layer norm or of the per-channel group norm."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.g = _param((d,), dtype, device)
        self.b = _param((d,), dtype, device)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


class ConvLayer(nn.Module):
    """One feature-extractor convolution: ``w`` [k, I, O], an optional bias
    (converted large checkpoints), and its norm: ``ln`` on every layer of a
    "layer" extractor, ``gn`` on the first layer of a "group" one."""

    def __init__(self, k, d_in, d_out, *, norm: str, bias: bool, dtype, device):
        super().__init__()
        self.w = _param((k, d_in, d_out), dtype, device)
        if bias:
            self.b = _param((d_out,), dtype, device)
        else:
            self.register_parameter("b", None)
        if norm:
            setattr(self, norm, Norm(d_out, dtype=dtype, device=device))


class Attention(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.query = Linear(d, d, **kw)
        self.key = Linear(d, d, **kw)
        self.value = Linear(d, d, **kw)
        self.out = Linear(d, d, **kw)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = Attention(d, **kw)
        self.attn_ln = Norm(d, **kw)
        self.mlp1 = Linear(d, d_ff, **kw)
        self.mlp2 = Linear(d_ff, d, **kw)
        self.mlp_ln = Norm(d, **kw)


class FeatureProjection(nn.Module):
    def __init__(self, d_in: int, d: int, *, dtype, device):
        super().__init__()
        self.ln = Norm(d_in, dtype=dtype, device=device)
        self.proj = Linear(d_in, d, dtype=dtype, device=device)


class PosConv(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, *, dtype, device):
        super().__init__()
        d = cfg.hidden_size
        k, groups = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.w = _param((k, d // groups, d), dtype, device)
        self.b = _param((d,), dtype, device)


class Wav2Vec2(nn.Module):
    """The CTC model: ``forward(audio [B, samples])`` → log-probs
    [B, frames, vocab] in f32."""

    def __init__(
        self,
        cfg: Wav2Vec2Config,
        *,
        conv_bias: bool = False,
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=dtype, device=device)
        convs, d_in = [], 1
        for i, (d_out, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            norm = "ln" if cfg.feat_extract_norm == "layer" else ("gn" if i == 0 else "")
            convs.append(ConvLayer(k, d_in, d_out, norm=norm, bias=conv_bias, **kw))
            d_in = d_out
        d = cfg.hidden_size
        self.feature_extractor = nn.ModuleList(convs)
        self.feature_projection = FeatureProjection(cfg.conv_dim[-1], d, **kw)
        self.pos_conv = PosConv(cfg, **kw)
        self.encoder_ln = Norm(d, **kw)
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.intermediate_size, **kw) for _ in range(cfg.num_layers)
        )
        self.lm_head = Linear(d, cfg.vocab_size, **kw)

    @property
    def device(self) -> torch.device:
        return self.lm_head.w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.w.dtype

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return forward(self, audio)


@torch.no_grad()
def init_params(
    cfg: Wav2Vec2Config,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> Wav2Vec2:
    """Random weights with the JAX package's distributions: convolutions
    ``N(0,1)/√(k·I)``, linears ``N(0,1)/√d_in`` with zero biases, the
    positional conv ``N(0, 0.02²)``, unit norm gains. Drawn in f32 on the
    generator's device (the model's device unless ``device`` is given)."""
    model = Wav2Vec2(cfg, dtype=dtype, device=device or generator.device)

    def normal(p: nn.Parameter, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, device=generator.device)
        p.copy_((x * scale).to(p.dtype))

    for mod in model.modules():
        if isinstance(mod, ConvLayer):
            k, d_in, _ = mod.w.shape
            normal(mod.w, 1.0 / math.sqrt(k * d_in))
        elif isinstance(mod, Linear):
            normal(mod.w, 1.0 / math.sqrt(mod.w.shape[0]))
            mod.b.zero_()
        elif isinstance(mod, Norm):
            mod.g.fill_(1.0)
            mod.b.zero_()
    normal(model.pos_conv.w, 0.02)
    model.pos_conv.b.zero_()
    return model.eval()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.g.float() + p.b.float()).to(x.dtype)


def _group_norm_per_channel(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Group norm with one group per channel (base conv 0): each channel
    normalised over time, padded frames included. x: [B, T, C]."""
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = xf.var(1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p.g.float() + p.b.float()).to(x.dtype)


def _linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), p.w.float()).to(x.dtype) + p.b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
          groups: int = 1) -> torch.Tensor:
    """[B, T, C] conv with the JAX layout's weight [k, I/groups, O]."""
    y = F.conv1d(
        x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
        stride=stride, padding=padding, groups=groups,
    )
    return y.transpose(1, 2)


def feature_extractor(model: Wav2Vec2, audio: torch.Tensor) -> torch.Tensor:
    """[B, samples] → [B, frames, conv_dim[-1]] (≈50 frames a second)."""
    x = audio[:, :, None]
    for conv, s in zip(model.feature_extractor, model.config.conv_stride):
        x = _conv(x, conv.w, stride=s)
        if conv.b is not None:
            x = x + conv.b.to(x.dtype)
        if hasattr(conv, "ln"):
            x = _layer_norm(conv.ln, x)
        elif hasattr(conv, "gn"):
            x = _group_norm_per_channel(conv.gn, x)
        x = _gelu(x)
    return x


def _encoder_layer(p: EncoderLayer, x: torch.Tensor, n_heads: int, stable_ln: bool):
    def attn(h):
        b, t, d = h.shape
        dh = d // n_heads
        q = _linear(p.attn.query, h).reshape(b, t, n_heads, dh)
        k = _linear(p.attn.key, h).reshape(b, t, n_heads, dh)
        v = _linear(p.attn.value, h).reshape(b, t, n_heads, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d)
        return _linear(p.attn.out, o)

    def mlp(h):
        return _linear(p.mlp2, _gelu(_linear(p.mlp1, h)))

    if stable_ln:  # pre-LN (large/xlsr)
        x = x + attn(_layer_norm(p.attn_ln, x))
        x = x + mlp(_layer_norm(p.mlp_ln, x))
    else:  # post-LN (base)
        x = _layer_norm(p.attn_ln, x + attn(x))
        x = _layer_norm(p.mlp_ln, x + mlp(x))
    return x


def forward(model: Wav2Vec2, audio: torch.Tensor) -> torch.Tensor:
    """[B, samples] → CTC log-prob emissions [B, frames, vocab] (f32).
    Differentiable (the CTC trainer's loss runs through it); inference
    callers wrap it in ``torch.no_grad``. A backward pass that should match
    the forward's numerics runs inside the same two precision scopes."""
    cfg = model.config
    with reference_matmul(), no_tf32_cudnn():
        feats = feature_extractor(model, audio.to(model.dtype))
        h = _layer_norm(model.feature_projection.ln, feats)
        h = _linear(model.feature_projection.proj, h)

        k = cfg.num_conv_pos_embeddings
        pos = _conv(
            h, model.pos_conv.w, padding=k // 2, groups=cfg.num_conv_pos_embedding_groups
        )
        if k % 2 == 0:  # drop the trailing frame of an even kernel
            pos = pos[:, :-1]
        h = h + _gelu(pos + model.pos_conv.b)
        if not cfg.do_stable_layer_norm:
            h = _layer_norm(model.encoder_ln, h)
        for layer in model.layers:
            h = _encoder_layer(layer, h, cfg.num_heads, cfg.do_stable_layer_norm)
        if cfg.do_stable_layer_norm:
            h = _layer_norm(model.encoder_ln, h)
        logits = _linear(model.lm_head, h).float()
        return torch.log_softmax(logits, dim=-1)


def output_lengths(cfg: Wav2Vec2Config, input_length: int) -> int:
    length = input_length
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
    return length
