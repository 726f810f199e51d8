"""Cross-attention of one decode step over the int8 cross K/V cache: the K3
kernels (``csrc/cross_attention_decode.cu``), their plain PyTorch versions,
the op the decoder calls, and the route that picks it.

Counterpart of ``whisperx_tpu/ops/cross_attention_decode.py``. Its three
Pallas functions keep their argument layouts here:

  - ``cross_decode`` ↔ ``_cross_decode_pallas`` (K3): spread bf16 queries
    ``qs`` [B, H, D], packed k8/v8 [B, T, D] int8 → [B, 1, D] f32;
  - ``cross_decode_kt`` ↔ ``_cross_decode_pallas_kt`` (K3kt): K transposed,
    kt8 [B, D, T];
  - ``cross_decode_i8`` ↔ ``_cross_decode_pallas_i8`` (K3i8): int8 queries
    qs8 [B, H, D] with per-head f32 scales sq [B, H, 1], int8×int8 scores
    summed exactly.

"Spread" queries are the TPU kernels' block-diagonal layout: row h of ``qs``
is the packed query masked to head h's columns. The plain versions compute
the Pallas arithmetic on that layout as it is; the CUDA kernel reads each
head's own slice, which for spread queries is the same dot product (the
other columns add exact zeros).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``cross_attention_decode`` (the decoder's op) passes the packed
query to the kernel directly, without building the [B, H, D] spread.

``cross_decode_route`` decides from a pass's own operands: on CUDA every
one-token, unfolded, uncaptured pass of a bf16 query over an int8 cache
goes to K3, which reads the cache in place; the JAX package keeps the same
kernel behind its opt-in (``WHISPERX_TPU_CROSS_DECODE``), off by default on
the TPU. The opt-in keeps its meaning here only for CPU tensors.

``launch_plan`` splits T across a thread-block cluster per (b, h): it picks
the keys of each block's sub-split and the cluster size, which the kernel
takes at run time.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from whisperx_tpu_torch.ops import count_launch
from whisperx_tpu_torch.utils.precision import reference_matmul

TILE = 512  # the TPU kernels' T tile (``bt``); the CUDA kernel walks the same
_HEAD_DIMS = (32, 64)
MAX_CLUSTER = 8  # blocks of a cluster: the portable size
SPLITS = (64, 128, 256, TILE)  # keys of a block's sub-split: each divides the tile
PIECE = 64  # keys of a shared-memory slot: K's, then the same keys' V
KT_ROW = 80  # K3kt: bytes of each of a slot's Dh rows of K (64 keys and alignment)
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may use (H100)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(b: int, t: int, h: int, dh: int, k_transposed: bool = False) -> dict:
    """The CUDA kernel's split of T for B rows, T keys, H heads of Dh.

    One cluster of ``cluster`` blocks per (b, h), grid (cluster · H, B). Each
    block owns a sub-split of ``split`` keys: the smallest of ``SPLITS``
    that needs at most ``MAX_CLUSTER`` blocks, so that the grid spreads
    over as many SMs as T allows (B 8, T 1500, H 20: 256 keys, 6 blocks a
    cluster, 960 blocks; B 1: 120). A split divides the 512-key tile, so no
    sub-split straddles a tile boundary. Past 8 · 512 keys each block walks
    ``tiles_per_block`` whole tiles in order. ``smem_bytes``: the block's
    dynamic shared memory (a slot of 64 keys for each piece of the
    sub-split, which holds K and then V, the scores, a max per tile)."""
    for split in SPLITS:
        if _cdiv(t, split) <= MAX_CLUSTER:
            tiles_per_block, cluster = 1, _cdiv(t, split)
            break
    else:
        tiles = _cdiv(t, TILE)
        tiles_per_block = _cdiv(tiles, MAX_CLUSTER)
        cluster = _cdiv(tiles, tiles_per_block)
    slot = dh * KT_ROW if k_transposed else PIECE * dh
    return {
        "split": split,
        "splits_per_tile": TILE // split,
        "tiles_per_block": tiles_per_block,
        "cluster": cluster,
        "grid": (cluster * h, b),
        "smem_bytes": split // PIECE * slot + 4 * split + 4 * tiles_per_block,
    }


def use_cross_decode_kernel(device: torch.device) -> bool:
    """The JAX package's opt-in, with its variable and values:
    ``WHISPERX_TPU_CROSS_DECODE=1`` sends CUDA tensors to the kernel (CPU
    tensors stay on the einsum), ``=force`` sends CPU tensors to the plain
    version too; anything else, the default, is off. ``cross_decode_route``
    asks it for CPU tensors only."""
    flag = os.environ.get("WHISPERX_TPU_CROSS_DECODE", "0")
    if flag == "force":
        return True
    return flag == "1" and torch.device(device).type == "cuda"


def cross_decode_route(
    device: torch.device, q_dtype: torch.dtype, head_dim: int, quantized: bool,
    t_new: int, beam_groups: int = 1, capture: bool = False,
) -> bool:
    """Whether a decoder pass's cross-attention goes through
    ``cross_attention_decode``. Only a one-token pass (``t_new`` 1) with no
    beams folded into its queries and no scores captured, over an int8
    cache (``quantized``), can: on CUDA when its query is bf16 and the
    kernel takes its head size (an f32 or f16 query keeps the einsum: the
    kernel rounds the query to bf16, below the precision such a model
    states); on the CPU only under the opt-in's ``force`` (the plain
    version)."""
    if t_new != 1 or beam_groups != 1 or capture or not quantized:
        return False
    if torch.device(device).type == "cuda":
        return q_dtype == torch.bfloat16 and head_dim in _HEAD_DIMS
    return use_cross_decode_kernel(device)


@reference_matmul()
def _cross_decode_reference(
    qs: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sq: Optional[torch.Tensor] = None,
    k_transposed: bool = False,
    bt: int = TILE,
) -> torch.Tensor:
    """The Pallas kernels' arithmetic in plain torch → [B, 1, D] f32.

    Per T tile of ``bt`` (the last one cut to the keys that exist, which is
    what the TPU kernel's mask of the overhanging tile leaves): scores
    s[h, t] = qs[h] · k[t] in f32 (with ``sq``: the exact integer dot, in
    f64, times the head's scale), a running max, natural exp, l summing the
    unrounded p, acc += bf16(p) · v; then acc / max(l, 1e-20) and each
    column taken from the head that owns it."""
    b, h, d = qs.shape
    t = k.shape[2] if k_transposed else k.shape[1]
    bt = min(bt, t)
    dh = d // h
    device = qs.device
    m = torch.full((b, h, 1), float("-inf"), device=device)
    l = torch.zeros((b, h, 1), device=device)
    acc = torch.zeros((b, h, d), device=device)
    for t0 in range(0, t, bt):
        kb = k[:, :, t0 : t0 + bt] if k_transposed else k[:, t0 : t0 + bt].transpose(1, 2)
        if sq is None:
            s = torch.matmul(qs.float(), kb.float())  # [B, H, n]
        else:
            # int8 × int8 sums are integers below 2^53: exact in f64, then
            # rounded to f32 as the TPU's int32 → f32 conversion rounds
            s = torch.matmul(qs.double(), kb.double()).float() * sq
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(torch.bfloat16).float(), v[:, t0 : t0 + bt].float())
        acc = acc * alpha + pv
        m = m_new
    out_all = acc / torch.clamp(l, min=1e-20)  # [B, H, D]
    owner = torch.arange(d, device=device) // dh
    sel = owner[None, :] == torch.arange(h, device=device)[:, None]  # [H, D]
    return torch.where(sel, out_all, 0.0).sum(dim=1, keepdim=True)


def _check_operands(q, k, v, *, n_head, k_transposed, q_int8, bt) -> None:
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v)):
        raise ValueError("cross_attention_decode: q, k and v must be on one CUDA device")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"cross_attention_decode takes int8 k/v, got {k.dtype}/{v.dtype}")
    want_q = torch.int8 if q_int8 else torch.bfloat16
    if q.dtype != want_q:
        raise TypeError(f"cross_attention_decode wants {want_q} queries, got {q.dtype}")
    if k.dim() != 3 or v.dim() != 3:
        raise ValueError("cross_attention_decode wants k/v of rank 3")
    b, t, d = v.shape
    want_k = (b, d, t) if k_transposed else (b, t, d)
    if tuple(k.shape) != want_k:
        raise ValueError(f"cross_attention_decode: k {tuple(k.shape)} != {want_k}")
    if d % n_head or d // n_head not in _HEAD_DIMS:
        raise ValueError(
            f"cross_attention_decode supports head sizes {_HEAD_DIMS}, got D={d}, H={n_head}"
        )
    if bt != TILE:
        raise ValueError(f"the CUDA kernel walks T in tiles of {TILE}, not {bt}")
    if not (1 <= b <= 65535 and t >= 1):
        raise ValueError(f"cross_attention_decode: unsupported sizes B={b}, T={t}")
    if not all(x.is_contiguous() for x in (q, k, v)) or any(
        x.data_ptr() % 16 for x in (k, v)
    ):
        raise ValueError("cross_attention_decode wants contiguous operands, k/v 16-byte aligned")


def _kernel_library() -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    lib = _build.load("cross_attention_decode")
    fn = lib.cross_attention_decode
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, *, n_head, q_strides, sq=None, k_transposed=False, bt=TILE):
    """One launch of the CUDA kernel → [B, 1, D] f32."""
    q_int8 = sq is not None
    _check_operands(q, k, v, n_head=n_head, k_transposed=k_transposed, q_int8=q_int8, bt=bt)
    b, t, d = v.shape
    plan = launch_plan(b, t, n_head, d // n_head, k_transposed)
    if plan["smem_bytes"] > MAX_SMEM:
        raise ValueError(f"cross_attention_decode: T={t} needs more shared memory than a block has")
    if q_int8:
        sq = sq.reshape(b, n_head).to(torch.float32).contiguous()
    lib = _kernel_library()
    out = torch.empty((b, 1, d), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.cross_attention_decode(
            q.data_ptr(), sq.data_ptr() if q_int8 else None, k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, t, n_head, d // n_head,
            q_strides[0], q_strides[1], int(k_transposed), int(q_int8),
            plan["split"], plan["tiles_per_block"], plan["cluster"], stream,
        )
    if err != 0:
        raise RuntimeError(f"cross_attention_decode launch failed: cudaError {err}")
    return out


def cross_decode(qs, k8, v8, bt: int = TILE) -> torch.Tensor:
    """K3 (``_cross_decode_pallas``): qs [B, H, D] bf16 spread queries,
    k8/v8 [B, T, D] int8 → [B, 1, D] f32."""
    if qs.device.type == "cpu":
        return _cross_decode_reference(qs, k8, v8, bt=bt)
    b, h, d = qs.shape
    out = _launch(qs, k8, v8, n_head=h, q_strides=(h * d, d), bt=bt)
    count_launch(cross_attention_decode)
    return out


def cross_decode_kt(qs, kt8, v8, bt: int = TILE) -> torch.Tensor:
    """K3kt (``_cross_decode_pallas_kt``): K transposed, kt8 [B, D, T]."""
    if qs.device.type == "cpu":
        return _cross_decode_reference(qs, kt8, v8, k_transposed=True, bt=bt)
    b, h, d = qs.shape
    out = _launch(qs, kt8, v8, n_head=h, q_strides=(h * d, d), k_transposed=True, bt=bt)
    count_launch(cross_decode_kt)
    return out


def cross_decode_i8(qs8, sq, k8, v8, bt: int = TILE) -> torch.Tensor:
    """K3i8 (``_cross_decode_pallas_i8``): qs8 [B, H, D] int8 spread queries,
    sq [B, H, 1] f32 per-head query scales, k8/v8 [B, T, D] int8."""
    if qs8.device.type == "cpu":
        return _cross_decode_reference(qs8, k8, v8, sq=sq, bt=bt)
    b, h, d = qs8.shape
    out = _launch(qs8, k8, v8, n_head=h, q_strides=(h * d, d), sq=sq, bt=bt)
    count_launch(cross_decode_i8)
    return out


def spread_queries(q_pack: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, D] → [B, H, D]: row h keeps head h's columns, zeros elsewhere."""
    b, d = q_pack.shape
    owner = torch.arange(d, device=q_pack.device) // (d // n_head)
    sel = owner[None, :] == torch.arange(n_head, device=q_pack.device)[:, None]
    return q_pack[:, None, :] * sel.to(q_pack.dtype)


def cross_attention_decode(
    q_eff: torch.Tensor,  # [B, 1, H, Dh]: K scales and 1/√dh folded in
    k8: torch.Tensor,  # [B, T, H, Dh] int8
    v8: torch.Tensor,  # [B, T, H, Dh] int8
) -> torch.Tensor:
    """softmax(q_eff · k8ᵀ) · v8 for one decode step → [B, 1, H, Dh] f32; the
    caller applies the V channel scales. The query is rounded to bf16 (as in
    JAX, whatever the model's dtype). CUDA tensors launch K3
    (``cross_attention_decode.launches`` counts the launches): the decoder's
    route for every bf16 one-token step over an int8 cache on CUDA
    (``cross_decode_route``); CPU tensors take the plain version."""
    b, one, h, dh = q_eff.shape
    if one != 1:
        raise ValueError("cross_attention_decode handles one query per row")
    t, d = k8.shape[1], h * dh
    q_pack = q_eff.reshape(b, d).to(torch.bfloat16)
    if q_eff.device.type == "cpu":
        out = _cross_decode_reference(
            spread_queries(q_pack, h), k8.reshape(b, t, d), v8.reshape(b, t, d)
        )
    else:
        out = _launch(
            q_pack.contiguous(), k8.reshape(b, t, d), v8.reshape(b, t, d),
            n_head=h, q_strides=(d, 0),
        )
        count_launch(cross_attention_decode)
    return out.reshape(b, 1, h, dh)


cross_attention_decode.launches = 0
cross_decode_kt.launches = 0
cross_decode_i8.launches = 0
