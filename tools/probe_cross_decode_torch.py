#!/usr/bin/env python3
"""Where K3's time goes on the card (the port's cross-attention decode
kernel, ``whisperx_tpu_torch/ops/csrc/cross_attention_decode.cu``).

    python3 tools/probe_cross_decode_torch.py

needs one CUDA GPU and nvcc. Two measurements at the large-v3 decode step
(T 1500, H 20, Dh 64, B 8 and B 1, K/V cycled past the L2):

  1. timeline: a copy of the kernel source with a ``%globaltimer`` stamp by
     thread 0 of every block at each phase boundary (entry, first K piece
     landed, scores done, exchange barrier, V landed, P·V done, partials
     barrier, rank 0's output), built beside the real one; per phase the
     median and 90th percentile over blocks, the spread of block start
     times (a second wave shows as late starts) and the span of the launch;
  2. read floor: a kernel that only copies the same K/V bytes into shared
     memory with 16-byte ``cp.async``, as one head's 64-byte row slices (the
     kernel's pattern), as two heads' 128-byte rows, and contiguously,
     timed like ``chip_smoke.py`` times kernels; and the time of a trivial
     launch, the fixed cost in each.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ["entry", "K0 landed", "scores", "barrier 1", "V landed", "P·V done", "barrier 2", "rank-0 out"]
# (text in the kernel source, stamp, put it before or after the text)
MARKS = [
    ("  qv.load(qh);\n", "PROF(0)", "after"),
    ("        cp_async_wait_all_but(pieces - 1);\n        __syncthreads();\n", "if (i == 0) { PROF(1) }", "after"),
    ("    if (tid == 0) own_max_sh = own_max;\n    cluster.sync();", "PROF(2)", "before"),
    ("    cluster.sync();  // every block has started, and published its max\n", "PROF(3)", "after"),
    ("    __syncthreads();  // V and bf16(p) are visible\n", "PROF(4)", "after"),
    ("  // the block's (l, acc): rows of a warp", "PROF(5)", "before"),
    ("  cluster.sync();  // the partials have landed; rank 0 reads only its own memory\n", "PROF(6)", "after"),
    ("  out[static_cast<long long>(b) * d_model + head_col + tid] = a / fmaxf(l, 1e-20f);", "PROF(7)", "before"),
]
STAMPS = r'''
__device__ unsigned long long g_stamp[16384][8];
#define PROF(i) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_stamp[blockIdx.y * gridDim.x + blockIdx.x][i] = t_; }
'''
READ_FLOOR = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void cp16(void* s, const void* g) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
}
// one block per (256-key split, head or head pair, batch row), K then V
template <int ROW>
__global__ void __launch_bounds__(128) read_kv(const int8_t* k, const int8_t* v, int* out,
                                               int t, int d, int contiguous) {
  extern __shared__ __align__(16) int8_t sm[];
  const int col = blockIdx.x / 6, t0 = blockIdx.x % 6 * 256, b = blockIdx.y;
  const int rows = min(256, t - t0);
  for (int a = 0; a < 2; ++a) {
    const int8_t* base = a ? v : k;
    int8_t* dst = sm + a * 256 * ROW;
    const long long blk = static_cast<long long>(b) * gridDim.x + blockIdx.x;
    for (int i = threadIdx.x; i < rows * ROW / 16; i += 128) {
      const int8_t* src = contiguous
          ? base + blk * 256 * ROW + i * 16
          : base + (static_cast<long long>(b) * t + t0 + i / (ROW / 16)) * d + col * ROW + i % (ROW / 16) * 16;
      cp16(dst + i * 16, src);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (reinterpret_cast<int*>(sm)[threadIdx.x] == 0x7fffffff) out[0] = 1;
}
extern "C" int read_floor(const void* k, const void* v, void* out, int b, int t, int d,
                          int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  if (mode == 1) {
    cudaFuncSetAttribute(read_kv<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
    read_kv<128><<<dim3(d / 128 * 6, b), 128, 2 * 256 * 128, s>>>(kp, vp, static_cast<int*>(out), t, d, 0);
  } else {
    read_kv<64><<<dim3(d / 64 * 6, b), 128, 2 * 256 * 64, s>>>(kp, vp, static_cast<int*>(out), t, d, mode == 2);
  }
  return static_cast<int>(cudaGetLastError());
}
'''


def build(name: str, source: str) -> ctypes.CDLL:
    from whisperx_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(path[:-3] + ".so")


def instrumented_source() -> str:
    from whisperx_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "cross_attention_decode.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n", "namespace {\n" + STAMPS, 1)
    for text, stamp, where in MARKS:
        if text not in src:
            raise RuntimeError(f"phase mark not found in the kernel source: {text!r}")
        src = src.replace(text, text + stamp + "\n" if where == "after" else stamp + "\n" + text, 1)
    return src + '''
extern "C" int read_stamps(void* dst, size_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp, n));
}
'''


def timeline(cs, cad) -> None:
    import torch

    lib = build("k3_timeline", instrumented_source())
    real = cad._kernel_library()
    lib.cross_attention_decode.argtypes = real.cross_attention_decode.argtypes
    lib.cross_attention_decode.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    cad._kernel_library = lambda: lib
    try:
        for b in (8, 1):
            qs, k8, v8 = cs.cross_decode_case(b, 1500, 20, 64, seed=11)[:3]
            sets = [(qs, k8.clone(), v8.clone())
                    for _ in range(math.ceil(2 * cs.L2_BYTES / (2 * k8.numel())))]
            cyc = itertools.cycle(sets)
            ms = cs.cuda_ms(lambda: cad.cross_decode(*next(cyc)))
            plan = cad.launch_plan(b, 1500, 20, 64)
            blocks = plan["grid"][0] * plan["grid"][1]
            for _ in sets:  # the next set is cold in the L2
                cad.cross_decode(*next(cyc))
            torch.cuda.synchronize()
            cad.cross_decode(*next(cyc))
            torch.cuda.synchronize()
            buf = np.zeros((16384, 8), np.uint64)
            assert lib.read_stamps(buf.ctypes.data, buf.nbytes) == 0
            t = (buf[:blocks].astype(np.int64) - int(buf[:blocks, 0].min())) / 1e3  # µs
            rank0 = np.arange(blocks) % plan["cluster"] == 0
            print(f"[timeline] B={b}: {blocks} blocks, kernel {ms:.4f} ms (CUDA events), one launch "
                  f"spans {t[rank0, 7].max():.2f} us from the first block's entry")
            print("[timeline]   block starts, quantiles 0/50/90/100%: "
                  + " ".join(f"{x:.2f}" for x in np.quantile(t[:, 0], [0, .5, .9, 1])) + " us")
            for i in range(1, len(PHASES)):
                d = t[rank0, i] - t[rank0, i - 1] if i == 7 else t[:, i] - t[:, i - 1]
                print(f"[timeline]   {PHASES[i - 1]:>10} -> {PHASES[i]:<10} median "
                      f"{np.median(d):.2f} us, p90 {np.quantile(d, .9):.2f} us")
    finally:
        cad._kernel_library = lambda: real


def read_floor(cs) -> None:
    import torch

    lib = build("read_floor", READ_FLOOR)
    lib.read_floor.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    b, t, d = 8, 1500, 1280
    n = b * t * d  # the bytes each mode reads of K, and of V
    alloc = b * d // 64 * 6 * 256 * 64  # the contiguous mode's blocks at 256 rows each
    sets = [tuple(torch.randint(-127, 128, (alloc,), dtype=torch.int8, device="cuda") for _ in range(2))
            for _ in range(math.ceil(2 * cs.L2_BYTES / (2 * n)))]
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for mode, label in ((0, "one head's 64-byte rows (K3's pattern)"),
                        (1, "two heads' 128-byte rows"), (2, "contiguous 16 KB a block")):
        cyc = itertools.cycle(sets)
        ms = [cs.cuda_ms(lambda: lib.read_floor(*(x.data_ptr() for x in next(cyc)), out.data_ptr(),
                                                b, t, d, mode, stream)) for _ in range(3)]
        print(f"[read floor] {2 * n / 1e6:.2f} MB of K/V as {label}: "
              f"{' '.join(f'{x:.4f}' for x in ms)} ms")
    print(f"[read floor] a trivial launch: {cs.cuda_ms(lambda: out.add_(0), iters=50):.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_cross_decode_torch: no CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from whisperx_tpu_torch.ops import cross_attention_decode as cad

    cs.phase_card()
    timeline(cs, cad)
    read_floor(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
