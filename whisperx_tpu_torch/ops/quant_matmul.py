"""Weight-only quantized matrix product: the K4 kernel
(``csrc/quant_matmul.cu``), its plain PyTorch version, and the dispatch the
quantized linears call.

Counterpart of ``whisperx_tpu/ops/quant_matmul.py``. K4 computes what the
TPU kernel ``_int8_matmul_kernel`` computes:

    y = cast_to_x_dtype( Σ_g (x[:, g] @ widen(qw[g, :])) · scale[g, :] )

with each group's partial product accumulated in f32, multiplied by that
group's scale row, and the partials summed over groups in f32. It is not
the XLA path's arithmetic (``_quant_matmul_xla`` dequantizes the weight and
rounds it to x's dtype first): in bf16 the two differ by that weight
rounding.

A CUDA tensor with int8 weights always launches K4 (``quant_matmul.launches``
counts the launches) or raises; a CPU tensor takes
``_quant_matmul_reference``. Nothing on the CUDA path calls the plain
version. int4 has no kernel in the JAX package either: both packages
dequantize and take one matrix product (``_quant_matmul_xla``), on any
device — that is int4's route, not a fallback.
"""

from __future__ import annotations

import ctypes

import torch

from whisperx_tpu_torch.utils.precision import reference_matmul

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M_TILES = 65535  # gridDim.y of the launch, 64 rows each
_TILE_M = 64


@reference_matmul()
def _quant_matmul_reference(
    x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, group_size: int
) -> torch.Tensor:
    """K4's arithmetic in plain torch: x [M, K] f32/bf16, qw [K, N] int8,
    scale [K/group_size, N] f32 → [M, N] in x's dtype. The int8 codes widen
    exactly; each group's product is f32, scaled, and added to an f32
    accumulator group by group (two roundings, as the kernel's)."""
    m, k = x.shape
    n = qw.shape[1]
    xf = x.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(k // group_size):
        rows = slice(g * group_size, (g + 1) * group_size)
        acc = acc + torch.matmul(xf[:, rows], qw[rows].float()) * scale[g]
    return acc.to(x.dtype)


def _check_operands(x, qw, scale, group_size) -> None:
    if not (x.is_cuda and qw.device == x.device and scale.device == x.device):
        raise ValueError("int8_matmul: x, qw and scale must be on one CUDA device")
    if x.dtype not in _DTYPE_CODES or qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(
            f"int8_matmul takes x float32/bfloat16, qw int8, scale float32; got "
            f"{x.dtype}/{qw.dtype}/{scale.dtype}"
        )
    if x.dim() != 2 or qw.dim() != 2 or scale.dim() != 2:
        raise ValueError("int8_matmul wants x [M, K], qw [K, N], scale [K/g, N]")
    m, k = x.shape
    n = qw.shape[1]
    if group_size <= 0 or group_size % 16 != 0:
        raise ValueError(f"int8_matmul: group_size must be a multiple of 16, got {group_size}")
    if qw.shape[0] != k or k % group_size != 0:
        raise ValueError(
            f"int8_matmul: K={k} must equal qw's rows ({qw.shape[0]}) and be a "
            f"multiple of group_size {group_size}"
        )
    if tuple(scale.shape) != (k // group_size, n):
        raise ValueError(f"int8_matmul: scale {tuple(scale.shape)} != {(k // group_size, n)}")
    if not (1 <= m <= _MAX_M_TILES * _TILE_M and n >= 1):
        raise ValueError(f"int8_matmul: unsupported sizes M={m}, N={n}")
    if not all(t.is_contiguous() for t in (x, qw, scale)) or x.data_ptr() % 16 != 0:
        raise ValueError("int8_matmul wants contiguous operands and a 16-byte aligned x")


def _kernel_library() -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    lib = _build.load("quant_matmul")
    fn = lib.int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def int8_matmul(
    x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, group_size: int
) -> torch.Tensor:
    """x [M, K] @ int8 qw [K, N] with group scales → [M, N] in x's dtype.
    CUDA tensors launch K4; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return _quant_matmul_reference(x, qw, scale, group_size)
    _check_operands(x, qw, scale, group_size)
    lib = _kernel_library()
    m, k = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # 16-byte weight loads when every row of a 64-column tile is whole
    vec = int(n % 16 == 0 and qw.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, group_size, _DTYPE_CODES[x.dtype], vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    quant_matmul.launches += 1
    return out


def quant_matmul(x: torch.Tensor, qp) -> torch.Tensor:
    """``x`` [..., K] @ the quantized weight of ``qp`` (a ``QuantizedLinear``)
    → [..., N] in x's dtype, bias not added."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if qp.bits == 4:
        from whisperx_tpu_torch.quant.core import dequantize

        w = dequantize(qp, dtype=x.dtype)
        with reference_matmul():
            if x2.is_cuda and x2.dtype != torch.float32:
                y = torch.matmul(x2, w)  # cuBLAS: f32 accumulation, one rounding
            else:
                y = torch.matmul(x2.float(), w.float()).to(x.dtype)
    else:
        y = int8_matmul(x2.contiguous(), qp.qw, qp.scale, qp.group_size)
    return y.reshape(*lead, -1)


quant_matmul.launches = 0
