"""Softmax attention: the K1, K1b and K2 kernels (one CUDA source,
``csrc/flash_attention.cu``, with modes), their plain PyTorch versions, and
the multi-head wrapper the encoder calls.

Counterpart of ``whisperx_tpu/ops/flash_attention.py``:

  - ``wholek_attention`` ↔ ``_flash_attention_wholek``: K1, the whole-key
    softmax; with ``mxu_sum=True`` K1b, whose denominator sums the weights
    after their rounding to v's dtype (the TPU kernel's ones column);
  - ``flash_attention_tiled`` ↔ ``_flash_attention_pallas``: K2, the online
    softmax over key tiles, optionally causal;
  - ``flash_attention`` dispatches as the JAX package does on its device:
    non-causal with Tk ≤ 2048 → K1, otherwise K2.

A CUDA tensor always goes to the hand-written kernel (each kernel counts its
launches: ``flash_attention.launches`` for K1, ``wholek_attention.
mxu_sum_launches`` for K1b, ``flash_attention_tiled.launches`` for K2); a
CPU tensor goes to the same kernel's plain version, the same arithmetic in
plain torch (used by the CPU tests and, on the card, as the yardstick the
kernel is held against). Nothing on the CUDA path calls a plain version.

The kernel runs on the tensor cores in both dtypes: bf16 as it is, f32 as
error-compensated TF32 (each operand split into a TF32 high and low part,
three products, the low·low one dropped), which keeps the plain f32
version's accuracy where plain TF32 would lose three decimal digits.
``tests/test_torch_flash_attention.py`` emulates that arithmetic on the
CPU against the JAX kernels and an f64 evaluation; ``chip_smoke.py`` holds
the kernel's own error against f64 on the card, with plain TF32 as the
control that must fail the same limit.

Every launch goes through one ``torch.autograd.Function``, so a CUDA output
carries a gradient rule: the forward is the kernel, the backward
``attention_backward`` (dQ, dK, dV in plain torch from the saved q, k and v,
P recomputed in f32). The JAX package has no backward kernel either: its
trainers run XLA's attention both ways. The plain versions, which CPU
tensors take, are differentiable as they stand.

The causal mask is aligned at the end of the keys (query i sees keys
j ≤ i + Tk − Tq), as the JAX package's XLA route and the decoder's own mask
align it. The Pallas kernel aligns it at the start (j ≤ i): the two agree
when Tq = Tk and differ when Tq < Tk, a divergence of the reference
(``tests/test_torch_flash_attention.py`` names it).
"""

from __future__ import annotations

import ctypes
import math

import torch

from whisperx_tpu_torch.ops import count_launch
from whisperx_tpu_torch.utils.precision import reference_matmul

LOG2_E = math.log2(math.e)
WHOLEK_MAX_KEYS = 2048  # the JAX dispatch: longer key axes take K2
K2_BLOCK_KEYS = 1536  # the key tile ``flash_attention`` gives K2 in JAX

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
# the CUDA source's modes
_K1, _K1_SKIP_MAX, _K1B, _K2, _K2_CAUSAL = range(5)


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """The softmax scale × log2(e) folded into q, rounded back to q's dtype."""
    kscale = LOG2_E / math.sqrt(q.shape[-1])
    return (q.float() * kscale).to(q.dtype)


def _causal_keep(tq: int, tk: int, device) -> torch.Tensor:
    """[Tq, Tk] mask, True where query i may see key j ≤ i + Tk − Tq."""
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril(tk - tq)


def _attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    skip_max: bool = False,
    mxu_sum: bool = False,
) -> torch.Tensor:
    """The JAX ``_wholek_kernel``'s arithmetic: q: [BH, Tq, D], k/v:
    [BH, Tk, D] → [BH, Tq, D]. The scale × log2(e) is folded into q (rounded
    back to q's dtype), scores are f32 in log2 space, exp2, the weights are
    rounded to v's dtype for the P·V product while the denominator sums them
    unrounded (``mxu_sum``, K1b's ``_wholek_mxusum_kernel``: rounded), and
    the [Tq, D] output is normalised."""
    s = torch.matmul(_scaled_q(q).float(), k.float().transpose(-1, -2))  # [BH, Tq, Tk]
    if skip_max:
        p = torch.exp2(s)
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    pr = p.to(v.dtype).float()
    l = (pr if mxu_sum else p).sum(dim=-1, keepdim=True)
    o = torch.matmul(pr, v.float())
    return (o / l).to(q.dtype)


def _flash_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    bk: int = 512,
) -> torch.Tensor:
    """The JAX ``_flash_kernel``'s arithmetic (K2): q: [BH, Tq, D], k/v:
    [BH, Tk, D] → [BH, Tq, D]. The online softmax over key tiles of ``bk``:
    q scaled as in K1, a running row max, exp2, l summing the unrounded
    weights, acc += round(p) · v, then acc / max(l, 1e-20). Query tiles do
    not change any value (rows are independent), nor does skipping a key
    tile that is masked for every row of a query tile: its weights are 0
    and its rescale 1."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    bk = min(bk, tk)
    qs = _scaled_q(q).float()
    keep = _causal_keep(tq, tk, q.device) if causal else None
    m = torch.full((bh, tq, 1), float("-inf"), device=q.device)
    l = torch.zeros((bh, tq, 1), device=q.device)
    acc = torch.zeros((bh, tq, q.shape[-1]), device=q.device)
    for k0 in range(0, tk, bk):
        s = torch.matmul(qs, k[:, k0 : k0 + bk].float().transpose(-1, -2))
        if keep is not None:
            s = s.masked_fill(~keep[:, k0 : k0 + bk], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[:, k0 : k0 + bk].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention kernel: q, k and v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"attention kernel takes float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"attention kernel wants q [BH,Tq,D], k/v [BH,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, tq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attention kernel supports D in {_HEAD_DIMS}, got {d}")
    if not (1 <= bh <= 65535 and tq >= 1 and k.shape[1] >= 1):
        raise ValueError(f"attention kernel: unsupported sizes {tuple(q.shape)}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError("attention kernel wants contiguous, 16-byte aligned q, k and v")


def _kernel_library() -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = False,
):
    """(dQ, dK, dV) of ``softmax(q kᵀ / √D) v`` for q [BH, Tq, D], k/v
    [BH, Tk, D] and the output's gradient ``dout`` [BH, Tq, D]: P is
    recomputed in f32 from the saved operands (TF32 off), causal masked at
    the end of the keys as K2 masks it; each gradient in its operand's
    dtype."""
    with reference_matmul():
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [BH, Tq, Tk]
        if causal:
            s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device), float("-inf"))
        p = torch.softmax(s, dim=-1)
        dv = torch.matmul(p.transpose(-1, -2), df)
        dp = torch.matmul(df, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
        dq = torch.matmul(ds, kf)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _KernelAttention(torch.autograd.Function):
    """One kernel launch (``mode``) with ``attention_backward`` as its
    gradient rule."""

    @staticmethod
    def forward(ctx, q, k, v, mode):
        ctx.save_for_backward(q, k, v)
        ctx.causal = mode == _K2_CAUSAL
        return _launch(q, k, v, mode)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, dout, ctx.causal), None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: int) -> torch.Tensor:
    _check_operands(q, k, v)
    if mode == _K2_CAUSAL and q.shape[1] > k.shape[1]:
        raise ValueError("causal attention needs Tq <= Tk (a query with no key)")
    lib = _kernel_library()
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    kscale = LOG2_E / math.sqrt(d)  # double here, f32 in the kernel (as JAX)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, tq, k.shape[1], d, _DTYPE_CODES[q.dtype], mode, kscale, stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    return out


def wholek_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    skip_max: bool = False,
    mxu_sum: bool = False,
) -> torch.Tensor:
    """Non-causal attention over the whole key axis: q [BH, Tq, D], k/v
    [BH, Tk, D] → [BH, Tq, D]. CUDA tensors launch K1 (K1b with
    ``mxu_sum``, which, as in JAX, takes no ``skip_max``); CPU tensors take
    the plain version."""
    if mxu_sum and skip_max:
        raise ValueError("mxu_sum has no skip_max variant")
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, skip_max=skip_max, mxu_sum=mxu_sum)
    if mxu_sum:
        out = _KernelAttention.apply(q, k, v, _K1B)
        count_launch(wholek_attention, "mxu_sum_launches")
    else:
        out = _KernelAttention.apply(q, k, v, _K1_SKIP_MAX if skip_max else _K1)
        count_launch(flash_attention)
    return out


def flash_attention_tiled(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    bk: int = 512,
) -> torch.Tensor:
    """K2: attention by the online softmax over key tiles, q [BH, Tq, D],
    k/v [BH, Tk, D] → [BH, Tq, D], causal aligned at the end of the keys.
    CUDA tensors launch K2 (its key tile is the kernel's own, 64; ``bk`` is
    the plain version's, as in ``_flash_attention_pallas``); CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return _flash_reference(q, k, v, causal=causal, bk=bk)
    out = _KernelAttention.apply(q, k, v, _K2_CAUSAL if causal else _K2)
    count_launch(flash_attention_tiled)
    return out


def flash_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head attention in the JAX layout [B, T, H, D] → [B, Tq, H, D].

    The JAX package's dispatch on its device, with no size gate and no
    library attention: non-causal attention over at most 2048 keys is K1,
    anything else K2 with key tiles of 1536 (on the CPU, each kernel's plain
    version)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]

    def to_bh(x):  # at b == 1 the reshape is a strided view: copy it
        return x.transpose(1, 2).reshape(b * h, -1, d).contiguous()

    qb, kb, vb = to_bh(q), to_bh(k), to_bh(v)
    if not causal and tk <= WHOLEK_MAX_KEYS:
        out = wholek_attention(qb, kb, vb)
    else:
        out = flash_attention_tiled(qb, kb, vb, causal=causal, bk=K2_BLOCK_KEYS)
    return out.reshape(b, h, tq, d).transpose(1, 2)


flash_attention.launches = 0
wholek_attention.mxu_sum_launches = 0
flash_attention_tiled.launches = 0
