"""Encoder self-attention: the K1 kernel (``csrc/flash_attention.cu``), its
plain PyTorch version, and the multi-head wrapper the encoder calls.

Counterpart of ``whisperx_tpu/ops/flash_attention.py``. A CUDA tensor always
goes to the hand-written kernel; a CPU tensor goes to ``_attention_reference``,
the same arithmetic in plain torch (used by the CPU tests and, on the card,
as the yardstick the kernel is held against). Nothing on the CUDA path calls
the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

LOG2_E = math.log2(math.e)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def _attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    skip_max: bool = False,
    causal: bool = False,
) -> torch.Tensor:
    """The JAX ``_wholek_kernel``'s arithmetic: q: [BH, Tq, D], k/v:
    [BH, Tk, D] → [BH, Tq, D]. The scale × log2(e) is folded into q (rounded
    back to q's dtype), scores are f32 in log2 space, exp2, the weights are
    rounded to v's dtype for the P·V product while the denominator sums them
    unrounded, and the [Tq, D] output is normalised. ``causal`` masks keys
    after the query (aligned at the end, as ``_xla_attention``)."""
    d = q.shape[-1]
    kscale = LOG2_E / math.sqrt(d)
    qs = (q.float() * kscale).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))  # [BH, Tq, Tk]
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(tk - tq)
        s = s.masked_fill(~keep, float("-inf"))
    if skip_max:
        p = torch.exp2(s)
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("wholek_attention: q, k and v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"wholek_attention takes float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"wholek_attention wants q [BH,Tq,D], k/v [BH,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, tq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"wholek_attention supports D in {_HEAD_DIMS}, got {d}")
    if not (1 <= bh <= 65535 and tq >= 1 and k.shape[1] >= 1):
        raise ValueError(f"wholek_attention: unsupported sizes {tuple(q.shape)}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError("wholek_attention wants contiguous, 16-byte aligned q, k and v")


def _kernel_library() -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.wholek_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def wholek_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, skip_max: bool = False
) -> torch.Tensor:
    """Non-causal attention over the whole key axis: q [BH, Tq, D], k/v
    [BH, Tk, D] → [BH, Tq, D]. CUDA tensors launch K1; CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, skip_max=skip_max)
    _check_operands(q, k, v)
    lib = _kernel_library()
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    kscale = LOG2_E / math.sqrt(d)  # double here, f32 in the kernel (as JAX)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.wholek_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, tq, k.shape[1], d, _DTYPE_CODES[q.dtype], int(skip_max),
            kscale, stream,
        )
    if err != 0:
        raise RuntimeError(f"wholek_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention in the JAX layout [B, T, H, D] → [B, Tq, H, D].

    On CUDA every call launches K1 (``flash_attention.launches`` counts the
    launches); there is no size gate and no library attention. Causal
    attention is the tiled K2 kernel, not yet ported to CUDA.
    """
    b, tq, h, d = q.shape

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, -1, d)

    qb, kb, vb = to_bh(q), to_bh(k), to_bh(v)
    if q.device.type == "cpu":
        out = _attention_reference(qb, kb, vb, causal=causal)
    elif causal:
        raise NotImplementedError(
            "causal flash_attention on CUDA is kernel K2 (ROADMAP.md, "
            "Queue 2, K2: the causal flag of K1's CUDA kernel)"
        )
    else:
        out = wholek_attention(qb, kb, vb)
    return out.reshape(b, h, tq, d).transpose(1, 2)


flash_attention.launches = 0
