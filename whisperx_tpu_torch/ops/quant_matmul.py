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

``launch_plan`` picks K4's regime from the shapes: split K for the decode's
skinny products, wgmma tiles for large M (the cross-KV product), a plain
tiled path for other group sizes. A CUDA tensor with int8 weights always
launches K4 (``quant_matmul.launches`` counts the calls) or raises; a CPU tensor takes
``_quant_matmul_reference``. Nothing on the CUDA path calls the plain
version. int4 has no kernel in the JAX package either: both packages
dequantize and take one matrix product (``_quant_matmul_xla``), on any
device — that is int4's route, not a fallback.
"""

from __future__ import annotations

import ctypes
import os

import torch

from whisperx_tpu_torch.ops import count_launch, refuse_xla_route
from whisperx_tpu_torch.utils.precision import reference_matmul

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M_TILES = 65535  # gridDim.y of the launch, 64 rows each
_TILE_M = 64

SM_COUNT = 132  # H100 SXM: split K until the grid covers every SM twice
SPLITK_MAX_M = 128  # larger M takes the wgmma tiles
_SPLITK_TILE_N = 64
_WGMMA_TILE = 128  # wgmma regime: 128 x 128 outputs per block
_REGIMES = {"tiled": 0, "split_k": 1, "wgmma": 2, "f32": 0}  # the C entry's codes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(m: int, k: int, n: int, group_size: int, dtype=torch.bfloat16,
                aligned: bool = True) -> dict:
    """K4's launch for x [m, k] @ qw [k, n] (``csrc/quant_matmul.cu``): the
    regime, the grid and, for split K, the slices as group ranges.

    bf16 with groups of a multiple of 64, n a multiple of 16 and a 16-byte
    aligned weight (``aligned``) takes split K when m <= 128 (the decode
    and prefill: bytes bound it, so the grid needs 2 blocks per SM) and the
    wgmma tiles above (the cross-KV product: operations bound it); any
    other bf16 shape the plain tiled path, f32 its CUDA-core kernel."""
    if dtype == torch.float32:
        return {"regime": "f32", "grid": (_cdiv(n, 64), _cdiv(m, 64)), "slices": 1}
    if not (group_size % 64 == 0 and n % 16 == 0 and aligned):
        return {"regime": "tiled", "grid": (_cdiv(n, _TILE_M), _cdiv(m, _TILE_M)), "slices": 1}
    if m > SPLITK_MAX_M:
        return {"regime": "wgmma", "grid": (_cdiv(n, _WGMMA_TILE), _cdiv(m, _WGMMA_TILE)), "slices": 1}
    tiles = _cdiv(n, _SPLITK_TILE_N)
    groups = k // group_size
    slices = min(groups, _cdiv(2 * SM_COUNT, tiles))
    # the kernel's own split: slice s takes groups [s·G/S, (s+1)·G/S)
    ranges = [(s * groups // slices, (s + 1) * groups // slices) for s in range(slices)]
    return {"regime": "split_k", "grid": (tiles, slices), "slices": slices, "group_ranges": ranges}


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


def _launch(
    x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, group_size: int
) -> torch.Tensor:
    _check_operands(x, qw, scale, group_size)
    lib = _kernel_library()
    m, k = x.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # 16-byte weight loads when every row of a 64-column tile is whole
    vec = n % 16 == 0 and qw.data_ptr() % 16 == 0
    plan = launch_plan(m, k, n, group_size, x.dtype, aligned=vec)
    slices = plan["slices"]
    # split K: each slice's f32 sum, added in slice order by the kernel
    ws = torch.empty((slices, m, n), dtype=torch.float32, device=x.device) if slices > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, group_size, _DTYPE_CODES[x.dtype], int(vec),
            _REGIMES[plan["regime"]], slices,
            None if ws is None else ws.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    return out


def int8_matmul(
    x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, group_size: int
) -> torch.Tensor:
    """x [M, K] @ int8 qw [K, N] with group scales → [M, N] in x's dtype.
    CUDA tensors launch K4; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return _quant_matmul_reference(x, qw, scale, group_size)
    out = _launch(x, qw, scale, group_size)
    count_launch(quant_matmul)
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
        # JAX: the XLA dequant-dot instead of the kernel; here it raises on CUDA
        refuse_xla_route(
            "WHISPERX_TPU_NO_PALLAS_QUANT",
            bool(os.environ.get("WHISPERX_TPU_NO_PALLAS_QUANT")), x2,
        )
        y = int8_matmul(x2.contiguous(), qp.qw, qp.scale, qp.group_size)
    return y.reshape(*lead, -1)


quant_matmul.launches = 0
