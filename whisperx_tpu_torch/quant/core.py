"""Weight-only int8 / int4 quantization with group-wise scales.

Counterpart of ``whisperx_tpu/quant/core.py``. The quantized weights stay
int8 (or int4 packed two per byte) in device memory and are dequantized
inside the product:

  - int8 on CUDA: the K4 kernel (``ops/quant_matmul.py``,
    ``ops/csrc/quant_matmul.cu``) widens each weight tile to bf16 in shared
    memory and applies the group scales to f32 partial sums;
  - int8 on the CPU: K4's plain version, the same arithmetic in torch;
  - int4: ``dequantize`` + one matrix product on either device, which is the
    JAX package's own int4 route (it has no int4 kernel).

Quantization itself runs on the host in numpy, exactly as the JAX package
does, so ``qw`` and ``scale`` are bit-identical to its for the same weights.

Policy (as the JAX package's): conv stems, embeddings and the encoder stay
full precision; at decoder depth ≥ 4 the first and last decoder blocks do
too; matrices under ``min_size`` elements or whose input width
``group_size`` does not divide are skipped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "int8"  # "int8" | "int4"
    group_size: int = 64  # scales per `group_size` input channels
    # decoder-only: the decode step reads every decoder weight per token,
    # while the encoder is one large product per chunk
    skip_patterns: tuple = ("conv1", "conv2", "pos_emb", "tok_emb", "/encoder")
    # the first and last decoder blocks carry the largest per-layer accuracy
    # sensitivity and stay full precision (at depth ≥ 4 only: shallow test
    # models would otherwise quantize nothing)
    skip_first_last_blocks: bool = True
    min_size: int = 4096  # don't quantize tiny matrices


class QuantizedLinear(nn.Module):
    """A quantized linear layer: ``qw`` int8 ``[d_in, d_out]`` (int4:
    ``[d_in/2, d_out]``, two nibbles per byte), ``scale`` f32
    ``[d_in/group_size, d_out]`` and the optional bias ``b``. The tensors are
    buffers, not parameters: ``model.parameters()`` lists only the
    full-precision weights."""

    def __init__(self, qw, scale, b=None, *, bits: int, group_size: int):
        super().__init__()
        self.register_buffer("qw", qw)
        self.register_buffer("scale", scale)
        self.register_buffer("b", b)
        self.bits = bits
        self.group_size = group_size

    def extra_repr(self) -> str:
        return f"bits={self.bits}, group_size={self.group_size}"


def quantize_weight(w: np.ndarray, mode: str, group_size: int) -> dict:
    """Quantize a ``[in, out]`` matrix group-wise along the input dim, in
    numpy f32 (round half to even, as ``np.round``).

    Returns {"qw": int8 CPU tensor [in(/2), out], "scale": f32 CPU tensor
    [in/g, out], "bits": 4|8, "group_size"}. int4 packs two nibbles per byte
    along dim 0: the low nibble holds the first half of each group's rows,
    the high nibble the second half.
    """
    d_in, d_out = w.shape
    if d_in % group_size != 0:
        raise ValueError(f"group_size {group_size} does not divide d_in {d_in}")
    if mode == "int4" and group_size % 2 != 0:
        raise ValueError(
            f"int4 packs two nibbles per byte: group_size must be even, got {group_size}"
        )
    g = d_in // group_size
    wg = np.asarray(w, np.float32).reshape(g, group_size, d_out)
    max_abs = np.abs(wg).max(axis=1, keepdims=True)  # [g, 1, out]
    qmax = 127.0 if mode == "int8" else 7.0
    scale = np.maximum(max_abs / qmax, 1e-10)
    q = np.clip(np.round(wg / scale), -qmax, qmax).astype(np.int8)
    if mode == "int4":
        half = group_size // 2
        lo = q[:, :half] & 0x0F
        hi = (q[:, half:] & 0x0F) << 4
        q = (lo | hi).astype(np.int8).reshape(d_in // 2, d_out)
    else:
        q = q.reshape(d_in, d_out)
    return {
        "qw": torch.from_numpy(np.ascontiguousarray(q)),
        "scale": torch.from_numpy(scale.reshape(g, d_out).astype(np.float32)),
        "bits": 8 if mode == "int8" else 4,
        "group_size": group_size,
    }


def make_quantized_linear(
    w: np.ndarray, mode: str, group_size: int, b=None, device=None
) -> QuantizedLinear:
    qp = quantize_weight(w, mode, group_size)
    return QuantizedLinear(
        qp["qw"].to(device), qp["scale"].to(device), b,
        bits=qp["bits"], group_size=group_size,
    )


def _unpack_int4(qw: torch.Tensor, group_size: int) -> torch.Tensor:
    """[in/2, out] packed int8 → [in, out] int8 nibbles (group-half layout)."""
    d_half, d_out = qw.shape
    g = (d_half * 2) // group_size
    half = group_size // 2
    as_u8 = qw.contiguous().view(torch.uint8).reshape(g, half, d_out)
    lo = (as_u8 & 0x0F).to(torch.int8)
    hi = (as_u8 >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=1).reshape(g * group_size, d_out)


def dequantize(qp: QuantizedLinear, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    qw = qp.qw
    group = qp.group_size
    if qp.bits == 4:
        qw = _unpack_int4(qw, group)
    d_in, d_out = qw.shape
    g = qp.scale.shape[0]
    w = qw.float().reshape(g, group, d_out) * qp.scale[:, None, :]
    return w.reshape(d_in, d_out).to(dtype)


def quant_linear_apply(qp: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(qw) (+ b). The bias is added after the product, in
    the dtype torch's promotion gives (as JAX's ``y + qp.b``): a bf16 output
    stays bf16 with a bf16 bias and becomes f32 with an f32 one."""
    from whisperx_tpu_torch.ops.quant_matmul import quant_matmul

    y = quant_matmul(x, qp)
    if qp.b is not None:
        y = y + qp.b
    return y


def _skip_patterns(root: nn.Module, config: QuantConfig) -> List[str]:
    skip = list(config.skip_patterns)
    if config.skip_first_last_blocks:
        blocks = getattr(getattr(root, "decoder", None), "blocks", None)
        nb = len(blocks) if blocks is not None else 0
        if nb >= 4:
            skip += ["/decoder/blocks/0/", f"/decoder/blocks/{nb - 1}/"]
    return skip


@torch.no_grad()
def quantize_tree(root: nn.Module, config: QuantConfig) -> nn.Module:
    """Replace every eligible ``Linear`` under ``root`` by a
    ``QuantizedLinear``, IN PLACE (the JAX package returns a new tree).
    Paths are the JAX ones (``/decoder/blocks/1/attn/query``). Each weight
    goes to the host as f32, is quantized in numpy, and its int8 codes come
    back to the weight's device; the full-precision module is dropped before
    the next one is read, so device memory never holds both copies of the
    decoder."""
    from whisperx_tpu_torch.models.whisper.model import Linear

    skip = _skip_patterns(root, config)
    names = [n for n, m in root.named_modules() if isinstance(m, Linear)]
    for name in names:
        path = "/" + name.replace(".", "/")
        lin = root.get_submodule(name)
        w = lin.w
        if any(pat in path for pat in skip):
            continue
        if w.dim() != 2 or w.numel() < config.min_size:
            continue
        if w.shape[0] % config.group_size != 0:
            continue
        qlin = make_quantized_linear(
            w.float().cpu().numpy(), config.mode, config.group_size,
            b=None if lin.b is None else lin.b.detach(), device=w.device,
        )
        parent, _, leaf = name.rpartition(".")
        setattr(root.get_submodule(parent), leaf, qlin)
        del lin, w, qlin
    return root


def quantize_model(
    model,
    mode: str = "int8",
    group_size: Optional[int] = None,
    config: Optional[QuantConfig] = None,
):
    """Quantize a ``Whisper``'s weights (weight-only) in place and return
    it, renamed ``<name>-<mode>``. In place, unlike the JAX package's new
    model: the full-precision decoder weights are freed as they go."""
    gs = group_size or 64
    if config is None:
        config = QuantConfig(mode=mode, group_size=gs)
    quantize_tree(model, config)
    model.name = f"{model.name}-{config.mode}"
    return model
