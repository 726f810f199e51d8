"""Whisper encoder-decoder in PyTorch: ``nn.Module`` containers holding the
weights, and plain functions for the forward passes.

Counterpart of ``whisperx_tpu/models/whisper/model.py``; the numerics follow
it step by step so that f32 runs agree with the JAX package to rounding:

  - parameter names and layouts are the JAX ones (linear ``w`` is
    ``[in, out]``, conv ``w`` is ``[3, I, O]``), so a checkpoint's flat key
    ``encoder/blocks/0/attn/query/w`` is the state-dict key
    ``encoder.blocks.0.attn.query.w``;
  - every matrix product accumulates in f32 (JAX's
    ``preferred_element_type=f32``); layer-norm statistics are f32 with the
    population variance; the logits are f32; the forward passes run
    under ``reference_matmul`` (no TF32, bf16 GEMMs reduced in f32);
  - GELU is the tanh approximation (``jax.nn.gelu``'s default);
  - the encoder's self-attention goes through the K1 kernel
    (``ops/flash_attention.py``); the decoder's attention is plain matrix
    products, as it is in the JAX package, except that on CUDA a bf16
    one-token step's cross-attention over the int8 cache goes through K3
    (``ops/cross_attention_decode.py::cross_decode_route``), which reads
    the cache in place (JAX keeps K3 behind an opt-in that is off by
    default); the tracker counts these passes by route
    (``cross_decode.kernel_passes``, ``cross_decode.plain_passes``);
  - a weight-only quantized linear (``quant.QuantizedLinear``) goes through
    ``quant_linear_apply``: K4 for int8 on CUDA (``ops/quant_matmul.py``);
  - every forward also runs on a tensor-parallel model
    (``parallel.shard_params_tp``): a block placed over several devices
    carries a ``TPLayout``, its split linears are ``SplitLinear``s, and its
    caches ``HeadShards``; an unplaced block is the one-shard case of the
    same code.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperx_tpu_torch.models.whisper.config import ModelDimensions
from whisperx_tpu_torch.ops.cross_attention_decode import (
    cross_attention_decode,
    cross_decode_route,
)
from whisperx_tpu_torch.ops import count_pass, refuse_xla_route
from whisperx_tpu_torch.ops.flash_attention import flash_attention
from whisperx_tpu_torch.quant.core import QuantizedLinear, quant_linear_apply
from whisperx_tpu_torch.utils.precision import reference_matmul

# ---------------------------------------------------------------------------
# Modules: weight containers named after the JAX parameter tree
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = True, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        if bias:
            self.b = _param((d_out,), dtype, device)
        else:
            self.register_parameter("b", None)


class SplitLinear(nn.Module):
    """A linear split over the devices of one model-parallel row
    (``parallel.shard_params_tp``). Column-split (``rows=False``): each
    part is a ``Linear`` of a slice of the output columns and their bias,
    on its shard's device. Row-split (``rows=True``): each part holds a
    slice of the input rows, without bias; ``b`` is added once, on the lead
    device, after the partial products are summed."""

    def __init__(self, parts: Sequence[Linear], b: Optional[torch.Tensor], *, rows: bool):
        super().__init__()
        self.parts = nn.ModuleList(parts)
        self.rows = rows
        if b is None:
            self.register_parameter("b", None)
        else:
            self.b = nn.Parameter(b, requires_grad=False)


@dataclass(frozen=True)
class TPLayout:
    """Where a tensor-parallel block's work runs: ``heads`` holds
    (device, first head, end) per shard with at least one head (whole
    heads, the first shards taking one more when they do not divide),
    ``hidden`` (device, first column, end) of the MLP's hidden width per
    shard. The lead device, shard 0's, holds the residual stream, the
    layer norms and every linear that is not split."""

    heads: Tuple[Tuple[torch.device, int, int], ...]
    hidden: Tuple[Tuple[torch.device, int, int], ...]


class HeadShards(list):
    """A cache entry of a tensor-parallel decoder: one tensor (or
    ``QuantizedKV``) per shard of ``TPLayout.heads``, each [B, T, H_s, Dh]
    on its shard's device. ``index_select`` reorders every shard's rows, as
    the beam search does to a plain tensor."""

    def index_select(self, dim: int, index: torch.Tensor) -> "HeadShards":
        return HeadShards(x.index_select(dim, index.to(x.device)) for x in self)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.g = _param((d,), dtype, device)
        self.b = _param((d,), dtype, device)


class Conv1d(nn.Module):
    """Width-3 conv weights in the JAX layout ``[3, I, O]``."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device):
        super().__init__()
        self.w = _param((3, d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


class MultiHeadAttention(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.query = Linear(d, d, **kw)
        self.key = Linear(d, d, bias=False, **kw)
        self.value = Linear(d, d, **kw)
        self.out = Linear(d, d, **kw)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, *, cross: bool, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = MultiHeadAttention(d, **kw)
        self.attn_ln = LayerNorm(d, **kw)
        self.mlp1 = Linear(d, 4 * d, **kw)
        self.mlp2 = Linear(4 * d, d, **kw)
        self.mlp_ln = LayerNorm(d, **kw)
        if cross:
            self.cross_attn = MultiHeadAttention(d, **kw)
            self.cross_attn_ln = LayerNorm(d, **kw)
        self.tp: Optional[TPLayout] = None  # set by parallel.shard_params_tp


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = dims.n_audio_state
        self.n_head = dims.n_audio_head
        self.conv1 = Conv1d(dims.n_mels, d, **kw)
        self.conv2 = Conv1d(d, d, **kw)
        self.pos_emb = _param((dims.n_audio_ctx, d), dtype, device)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cross=False, **kw)
            for _ in range(dims.n_audio_layer)
        )
        self.ln_post = LayerNorm(d, **kw)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self, mel, self.n_head)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d = dims.n_text_state
        self.n_head = dims.n_text_head
        self.tok_emb = _param((dims.n_vocab, d), dtype, device)
        self.pos_emb = _param((dims.n_text_ctx, d), dtype, device)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, cross=True, **kw)
            for _ in range(dims.n_text_layer)
        )
        self.ln = LayerNorm(d, **kw)


class Whisper(nn.Module):
    """Dims + encoder + decoder + the metadata the pipeline reads
    (``is_multilingual``, ``num_languages``, ``vocab_path``, and the
    ``alignment_heads`` word timing reads: a checkpoint's published mask, or
    JAX's default of every head of the upper half of the decoder)."""

    def __init__(
        self,
        dims: ModelDimensions,
        *,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        name: str = "custom",
        vocab_path: Optional[str] = None,
        alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
    ):
        super().__init__()
        self.dims = dims
        self.name = name
        self.vocab_path = vocab_path
        if alignment_heads is None:
            alignment_heads = [
                (layer, head)
                for layer in range(dims.n_text_layer // 2, dims.n_text_layer)
                for head in range(dims.n_text_head)
            ]
        self.alignment_heads = [tuple(x) for x in alignment_heads]
        self.encoder = AudioEncoder(dims, dtype=dtype, device=device)
        self.decoder = TextDecoder(dims, dtype=dtype, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.tok_emb.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.tok_emb.device

    @property
    def is_multilingual(self) -> bool:
        return self.dims.is_multilingual

    @property
    def num_languages(self) -> int:
        return self.dims.num_languages

    def embed_audio(self, mel: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self.encoder, mel, self.dims.n_audio_head)


# ---------------------------------------------------------------------------
# Initialization (hermetic random weights)
# ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embedding (encoder)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


@torch.no_grad()
def init_weights(model: Whisper, generator: torch.Generator) -> Whisper:
    """Random weights with the JAX package's distributions (``init_params``):
    linear ``N(0,1)/√d_in``, conv ``N(0,1)/√(3·d_in)``, zero biases, unit
    layer-norm gains, sinusoidal encoder positions, token embedding
    ``N(0, 0.02²)`` and decoder positions ``N(0, 0.01²)``. Drawn in f32 on
    the generator's device and cast; the values are not the JAX package's
    (the two RNGs differ), so parity tests hand weights over instead."""

    def normal(p: nn.Parameter, scale: float) -> None:
        x = torch.randn(
            p.shape, generator=generator, device=generator.device,
            dtype=torch.float32,
        )
        p.copy_((x * scale).to(p.dtype))

    for mod in model.modules():
        if isinstance(mod, Linear):
            normal(mod.w, 1.0 / math.sqrt(mod.w.shape[0]))
            if mod.b is not None:
                mod.b.zero_()
        elif isinstance(mod, LayerNorm):
            mod.g.fill_(1.0)
            mod.b.zero_()
        elif isinstance(mod, Conv1d):
            normal(mod.w, 1.0 / math.sqrt(mod.w.shape[1] * 3))
            mod.b.zero_()
    enc, dec = model.encoder, model.decoder
    enc.pos_emb.copy_(torch.from_numpy(sinusoids(*enc.pos_emb.shape)))
    normal(dec.tok_emb, 0.02)
    normal(dec.pos_emb, 0.01)
    return model


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 with an f32 result (JAX's
    ``preferred_element_type=f32``)."""
    return torch.matmul(a.float(), b.float())


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)  # jnp.var: population
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p.g.float() + p.b.float()).to(x.dtype)


def linear(p: Union[Linear, QuantizedLinear], x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32, cast to x's dtype, then the bias added
    in that dtype. A bf16 product on the card is one cuBLAS bf16 GEMM, which
    accumulates in f32 and rounds once at the output — the same rounding as
    JAX's ``dot(preferred_element_type=f32).astype(bf16)`` — so only the
    CPU and f32 products widen their operands first. A quantized layer goes
    to ``quant_linear_apply`` (the bias after the product, as in JAX)."""
    if isinstance(p, QuantizedLinear):
        return quant_linear_apply(p, x)
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.matmul(x, p.w)
    else:
        y = _dot_f32(x, p.w).to(x.dtype)
    if p.b is not None:
        y = y + p.b
    return y


def _column(p, h: torch.Tensor, shards, unit: int) -> List[torch.Tensor]:
    """A column-split or whole linear's output, one tensor per shard
    (device, a, b) of ``shards``: columns [a·unit, b·unit) on that device.
    A whole linear (an unplaced block's, or a ``QuantizedLinear``, which is
    never split) runs once on the lead device and its output is sliced."""
    if isinstance(p, SplitLinear):
        return [linear(part, h.to(dev)) for part, (dev, _, _) in zip(p.parts, shards)]
    y = linear(p, h)
    if len(shards) == 1:
        return [y]
    return [y[..., a * unit : b * unit].to(dev) for dev, a, b in shards]


def _row(p, xs: List[torch.Tensor]) -> torch.Tensor:
    """A row-split or whole linear over the shards' inputs ``xs``, on the
    lead device (``xs[0]``'s). A split one is the in-process all-reduce:
    the shards' partial products in f32, summed on the lead device, rounded
    once to x's dtype, then the bias — ``linear``'s rounding. A whole one
    takes the shards' inputs concatenated."""
    lead = xs[0].device
    if isinstance(p, SplitLinear):
        acc = None
        for x, part in zip(xs, p.parts):
            y = _dot_f32(x, part.w).to(lead)
            acc = y if acc is None else acc + y
        y = acc.to(xs[0].dtype)
        return y if p.b is None else y + p.b
    x = xs[0] if len(xs) == 1 else torch.cat([x.to(lead) for x in xs], dim=-1)
    return linear(p, x)


def _layout(blk: "ResidualAttentionBlock", n_head: int, x: torch.Tensor) -> TPLayout:
    """The block's ``TPLayout``, or the single shard of an unplaced block
    (every head and the whole hidden width on x's device)."""
    if blk.tp is not None:
        return blk.tp
    return TPLayout(((x.device, 0, n_head),), ((x.device, 0, 4 * x.shape[-1]),))


def _part(entry, s: int):
    """Shard ``s`` of a cache entry (a plain tensor is the one shard)."""
    return entry[s] if isinstance(entry, HeadShards) else entry


def _mlp(p: "ResidualAttentionBlock", h: torch.Tensor, lay: TPLayout) -> torch.Tensor:
    hs = _column(p.mlp1, h, lay.hidden, 1)
    return _row(p.mlp2, [_gelu(y) for y in hs])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to exact erf
    return F.gelu(x, approximate="tanh")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def qkv_attention(
    q: torch.Tensor,  # [B, Tq, H, Dh]
    k: torch.Tensor,  # [B, Tk, H, Dh]
    v: torch.Tensor,  # [B, Tk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk]
    return_weights: bool = False,
):
    """The attention output [B, Tq, H, Dh]; with ``return_weights`` the pair
    (output, the PRE-softmax scaled scores [B, H, Tq, Tk] in f32), as JAX's
    ``qkv_attention(return_weights=True)``: word timing re-normalises the
    raw scores over a truncated frame range."""
    dh = q.shape[-1]
    scale = dh**-0.25
    qf = q * scale
    kf = k * scale
    scores = torch.einsum("bqhd,bkhd->bhqk", qf.float(), kf.float())
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    out = out.to(v.dtype)
    return (out, scores) if return_weights else out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv1d(p: Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Width-3, pad-1 conv as three shifted GEMMs:
    ``y[o] = Σ_w x[o·stride − 1 + w] @ W[w]``, summed in f32, cast once,
    bias added in x's dtype. x: [B, T, C]; w: [3, I, O]."""
    w = p.w.to(x.dtype)
    t = x.shape[1]
    t_out = (t + 2 - 3) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1))
    y = None
    for i in range(3):
        xs = xp[:, i : i + t]
        if stride != 1:
            xs = xs[:, ::stride]
        yi = _dot_f32(xs[:, :t_out], w[i])
        y = yi if y is None else y + yi
    return y.to(x.dtype) + p.b


@reference_matmul()
def encoder_forward(
    enc: AudioEncoder, mel: torch.Tensor, n_head: int
) -> torch.Tensor:
    """mel: [B, T=3000, n_mels] in the model dtype → features [B, 1500, d].
    ``WHISPERX_TPU_FLASH`` other than 1 (JAX: the XLA attention) raises on
    CUDA (``ops.refuse_xla_route``)."""
    refuse_xla_route(
        "WHISPERX_TPU_FLASH", os.environ.get("WHISPERX_TPU_FLASH", "1") != "1", mel
    )
    x = _gelu(_conv1d(enc.conv1, mel, stride=1))
    x = _gelu(_conv1d(enc.conv2, x, stride=2))
    x = x + enc.pos_emb[None, : x.shape[1]]
    for blk in enc.blocks:
        x = _encoder_block(blk, x, n_head)
    return layer_norm(enc.ln_post, x)


def _encoder_block(
    p: ResidualAttentionBlock, x: torch.Tensor, n_head: int
) -> torch.Tensor:
    """One encoder block; a tensor-parallel one runs K1 once per shard, on
    its heads."""
    lay = _layout(p, n_head, x)
    dh = x.shape[-1] // n_head
    h = layer_norm(p.attn_ln, x)
    qs, ks, vs = (_column(lin, h, lay.heads, dh) for lin in (p.attn.query, p.attn.key, p.attn.value))
    attn = [
        _merge_heads(flash_attention(*(_split_heads(t[s], h1 - h0) for t in (qs, ks, vs))))
        for s, (_, h0, h1) in enumerate(lay.heads)
    ]
    x = x + _row(p.attn.out, attn)
    return x + _mlp(p, layer_norm(p.mlp_ln, x), lay)


# ---------------------------------------------------------------------------
# Decoder with a static KV cache
# ---------------------------------------------------------------------------


class QuantizedKV(NamedTuple):
    """int8 cross-KV with per-(batch, head, channel) scales. The scales fold
    into the query and the attention output; no dequantized copy is kept:
      scores = (q · s_k) @ k8ᵀ,   out = (p @ v8) · s_v
    """

    q8: torch.Tensor  # [B, T, H, D] int8
    scale: torch.Tensor  # [B, 1, H, D] f32


def quantize_kv(x: Union[torch.Tensor, HeadShards]) -> Union[QuantizedKV, HeadShards]:
    """[B, T, H, D] → per-(b, h, d)-channel int8 over the T axis; each
    shard of a ``HeadShards`` on its own (the scales are per head)."""
    if isinstance(x, HeadShards):
        return HeadShards(quantize_kv(part) for part in x)
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-10)
    q8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedKV(q8, scale)


CrossKV = Union[torch.Tensor, QuantizedKV]


@dataclass
class KVCache:
    """Decoder cache, one tensor per layer.

    self_k/self_v: [B, cache_len, H, Dh], written IN PLACE at the decode
    offset — a deliberate change from the JAX package, whose immutable
    arrays return an updated copy (XLA then reuses the buffer); here the
    cache is one allocation for the whole decode.
    cross_k/cross_v: [B, n_audio_ctx, H, Dh] (or ``QuantizedKV``), computed
    once per segment and read-only thereafter.
    A tensor-parallel layer's entries are ``HeadShards``: each shard's
    heads on its own device.
    """

    self_k: List[Union[torch.Tensor, HeadShards]]
    self_v: List[Union[torch.Tensor, HeadShards]]
    cross_k: List[Union[CrossKV, HeadShards]]
    cross_v: List[Union[CrossKV, HeadShards]]


def new_self_cache(dec: TextDecoder, batch: int, cache_len: int, n_head: int):
    """Zeroed self-attention K and V caches, one entry per layer:
    [B, cache_len, H, Dh] in the decoder's dtype on its device, or, for a
    tensor-parallel block, a ``HeadShards`` of its shards' heads."""
    d = dec.tok_emb.shape[1]
    kw = dict(dtype=dec.tok_emb.dtype)

    def entry(blk):
        if blk.tp is None:
            return torch.zeros((batch, cache_len, n_head, d // n_head), device=dec.tok_emb.device, **kw)
        return HeadShards(
            torch.zeros((batch, cache_len, h1 - h0, d // n_head), device=dev, **kw)
            for dev, h0, h1 in blk.tp.heads
        )

    return [entry(blk) for blk in dec.blocks], [entry(blk) for blk in dec.blocks]


@reference_matmul()
def precompute_cross_kv(
    dec: TextDecoder, audio_features: torch.Tensor, n_head: int
) -> Tuple[list, list]:
    """Per-layer cross-attention K/V lists of [B, 1500, H, Dh] (a
    tensor-parallel layer's: ``HeadShards``)."""
    dh = audio_features.shape[-1] // n_head
    ks, vs = [], []
    for blk in dec.blocks:
        lay = _layout(blk, n_head, audio_features)
        for lin, out in ((blk.cross_attn.key, ks), (blk.cross_attn.value, vs)):
            ys = _column(lin, audio_features, lay.heads, dh)
            parts = [_split_heads(y, h1 - h0) for y, (_, h0, h1) in zip(ys, lay.heads)]
            out.append(parts[0] if blk.tp is None else HeadShards(parts))
    return ks, vs


def _cross_attention(
    cq: torch.Tensor, ck: CrossKV, cv: CrossKV, use_kernel: bool = False
) -> torch.Tensor:
    """``use_kernel`` (``cross_decode_route``'s answer): a one-token step
    whose int8 cache goes through K3, read in place (its query rounded to
    bf16, as in JAX); otherwise the einsum over the cache widened to f32."""
    if not isinstance(ck, QuantizedKV):
        return qkv_attention(cq, ck, cv)
    dh = cq.shape[-1]
    # the K channel scales and 1/√dh fold into q (rounded to q's dtype, as
    # in JAX); the int8 values are exact in any float type
    q_eff = (cq.float() * ck.scale * (dh**-0.5)).to(cq.dtype)
    if use_kernel:
        return (cross_attention_decode(q_eff, ck.q8, cv.q8) * cv.scale).to(cq.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q_eff.float(), ck.q8.float())
    weights = torch.softmax(scores, dim=-1)
    cattn = torch.einsum(
        "bhqk,bkhd->bqhd", weights.to(cq.dtype).float(), cv.q8.float()
    )
    # [B, 1, H, D] V scales broadcast over the query axis
    return (cattn * cv.scale).to(cq.dtype)


@reference_matmul()
def decoder_forward(
    dec: TextDecoder,
    tokens: torch.Tensor,  # [B, T_new] int64
    cache: KVCache,
    offset: Union[int, torch.Tensor],  # tokens already in the cache: int or [B]
    n_head: int,
    beam_groups: int = 1,
    capture_cross_qk: bool = False,
    capture_heads: Optional[Sequence[Tuple[int, int]]] = None,
):
    """One decoder pass over T_new tokens starting at ``offset``; writes the
    new self-attention K/V into ``cache`` and returns the logits
    [B, T_new, vocab] in f32.

    ``beam_groups`` = K > 1: the token batch is B·K beam rows, each group of
    K rows sharing one audio, and ``cache.cross_k/v`` hold the untiled
    [B, 1500, H, Dh] K/V. Cross-attention is independent per query, so the K
    beams fold into the query axis ([B·K, T, H, D] → [B, K·T, H, D]) and
    attend against one copy; the self-attention cache stays per beam.

    ``capture_cross_qk`` (word timing, with a cross-KV in the model's dtype):
    returns ``(logits, qk)``, ``qk`` the pre-softmax cross-attention scores
    of every layer, [n_layer, B, H, T_new, 1500] f32, as JAX's
    ``decoder_forward(capture_cross_qk=True)``; with ``capture_heads``, a
    list of (layer, head), only those planes, [A, B, T_new, 1500], taken
    layer by layer so the other heads' scores are never held together.

    ``offset`` as a LongTensor [B]: each row starts at its own offset (the
    speculative decode, whose rows accept their own number of tokens; JAX
    gets this from ``jax.vmap`` of a B=1 loop). The position embedding is
    gathered per row, the new K/V are index-written per row, and the causal
    mask is [B, 1, T_new, cache_len]. As JAX's gather and
    ``dynamic_update_slice`` do, a position past the table reads its last
    row and a write that would overhang the cache starts earlier."""
    assert not (capture_cross_qk and beam_groups > 1), "the capture is per row"
    b, t_new = tokens.shape
    cache_len = _part(cache.self_k[0], 0).shape[1]
    device = tokens.device
    dh = dec.tok_emb.shape[1] // n_head
    k_pos = torch.arange(cache_len, device=device)

    if torch.is_tensor(offset):
        steps = torch.arange(t_new, device=device)
        positions = offset[:, None] + steps  # [B, T_new]
        x = dec.tok_emb[tokens] + dec.pos_emb[positions.clamp(max=dec.pos_emb.shape[0] - 1)]
        write_at = (
            torch.arange(b, device=device)[:, None],
            offset.clamp(max=cache_len - t_new)[:, None] + steps,
        )
        self_mask = torch.zeros((b, 1, t_new, cache_len), dtype=torch.float32, device=device)
        self_mask.masked_fill_(k_pos > positions[:, None, :, None], float("-inf"))
    else:
        positions = torch.arange(offset, offset + t_new, device=device)
        x = dec.tok_emb[tokens] + dec.pos_emb[positions][None]
        write_at = (slice(None), slice(offset, offset + t_new))
        # additive causal mask over the static cache: query i (global
        # position offset+i) attends to cache slots 0..offset+i
        self_mask = torch.zeros((t_new, cache_len), dtype=torch.float32, device=device)
        self_mask.masked_fill_(k_pos[None, :] > positions[:, None], float("-inf"))
        self_mask = self_mask[None, None]
    # (layer, head) → [B, T_new, 1500], or layer → per-shard [B, H_s, T_new, 1500]
    captured = {}

    for i, blk in enumerate(dec.blocks):
        lay = _layout(blk, n_head, x)
        h = layer_norm(blk.attn_ln, x)
        qs, ks, vs = (
            _column(lin, h, lay.heads, dh) for lin in (blk.attn.query, blk.attn.key, blk.attn.value)
        )
        attn = []
        for s, (dev, h0, h1) in enumerate(lay.heads):
            sk, sv = _part(cache.self_k[i], s), _part(cache.self_v[i], s)
            at = tuple(w.to(dev) if torch.is_tensor(w) else w for w in write_at)
            # in the cache's dtype: a quantized linear with an f32 bias (a
            # converted int8 checkpoint's) returns f32, which a per-row
            # index write would refuse and a slice write casts
            sk[at] = _split_heads(ks[s], h1 - h0).to(sk.dtype)
            sv[at] = _split_heads(vs[s], h1 - h0).to(sv.dtype)
            a = qkv_attention(_split_heads(qs[s], h1 - h0), sk, sv, mask=self_mask.to(dev))
            attn.append(_merge_heads(a))
        x = x + _row(blk.attn.out, attn)

        h = layer_norm(blk.cross_attn_ln, x)
        cqs = _column(blk.cross_attn.query, h, lay.heads, dh)
        use_k3 = cross_decode_route(
            cqs[0].device, cqs[0].dtype, dh, isinstance(_part(cache.cross_k[i], 0), QuantizedKV),
            t_new, beam_groups, capture_cross_qk,
        )
        if t_new == 1:  # one per layer of a one-token pass, by route
            count_pass("cross_decode.kernel_passes" if use_k3 else "cross_decode.plain_passes")
        cattn = []
        for s, (dev, h0, h1) in enumerate(lay.heads):
            cq = _split_heads(cqs[s], h1 - h0)
            ck, cv = _part(cache.cross_k[i], s), _part(cache.cross_v[i], s)
            if capture_cross_qk:
                a, qk = qkv_attention(cq, ck, cv, return_weights=True)
                if capture_heads is None:
                    captured.setdefault(i, []).append(qk)
                else:
                    captured.update(
                        ((i, hd), qk[:, hd - h0])
                        for layer, hd in capture_heads
                        if layer == i and h0 <= hd < h1
                    )
            else:
                if beam_groups > 1:  # fold the beams into the query axis
                    cq = cq.reshape(b // beam_groups, beam_groups * t_new, h1 - h0, -1)
                a = _cross_attention(cq, ck, cv, use_k3)
                if beam_groups > 1:  # unfold back to per-beam rows
                    a = a.reshape(b, t_new, h1 - h0, -1)
            cattn.append(_merge_heads(a))
        x = x + _row(blk.cross_attn.out, cattn)

        h = layer_norm(blk.mlp_ln, x)
        x = x + _mlp(blk, h, lay)

    x = layer_norm(dec.ln, x)
    logits = _dot_f32(x, dec.tok_emb.T)
    if not capture_cross_qk:
        return logits
    if capture_heads is None:  # every head, in head order across the shards
        planes = [
            qks[0] if len(qks) == 1 else torch.cat([q.to(device) for q in qks], dim=1)
            for qks in (captured[i] for i in range(len(dec.blocks)))
        ]
    else:
        planes = [captured[tuple(k)].to(device) for k in capture_heads]
    return logits, torch.stack(planes)
