// K4: weight-only int8 matrix product with group scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel whisperx_tpu/ops/quant_matmul.py::_int8_matmul_kernel
// (reached through _quant_matmul_pallas_int8). Computes
//     y[m, n] = cast( Σ_g ( Σ_{k in g} x[m, k] · qw[k, n] ) · scale[g, n] )
// for x [M, K] (bf16 or f32, row-major), qw [K, N] int8, scale [K/G, N] f32
// and G = group_size: the int8 codes are widened exactly, each group's
// partial product is accumulated in f32 and multiplied by the group's scale
// row, the scaled partials are summed over groups in f32 (multiply, then
// add: two roundings, as the plain version), and the sum is cast once to
// x's dtype.
//
// What bounds it on this card. In the decode step (M = rows: 8 greedy, 40
// with beam 5; K, N in {1280, 5120} for large-v3) the weight read dominates:
// at M = 40, K = 1280, N = 5120 the kernel must move K·N + 4·(K/64)·N +
// 2·M·K + 2·M·N ≈ 7.5 MB (2.2 µs at 3.35 TB/s) for 2·M·N·K = 0.52 GFLOP
// (0.53 µs at 989 TFLOP/s): bytes bound it. In precompute_cross_kv (M =
// B·1500 = 12000 at batch 8, K = N = 1280) it is 39 GFLOP against 63 MB:
// operations bound it (40 µs vs 19 µs).
//
// What the design does about it (simple and right first; speed is later):
//   - bf16: one block of 4 warps computes a 64 x 64 output tile, each warp a
//     32 x 32 quarter, and walks K in chunks of KC = 64, 32 or 16 columns
//     (the largest that divides G). Each chunk stages the x tile [64, KC]
//     bf16 and the qw tile [KC, 64] in shared memory, the int8 codes widened
//     to bf16 on the way in (exact), rows padded by 16 B so ldmatrix is free
//     of bank conflicts. The products run on the tensor cores as mma.sync
//     m16n8k16 (bf16 in, f32 accumulate) into a per-group partial; when a
//     chunk closes a group, acc += partial · scale[g, n] and the partial
//     restarts at zero. Int8 stays int8 in device memory: the weight read,
//     which bounds the decode step, is half the bf16 one.
//   - f32: tensor cores would round x to TF32 and break the f32 token
//     identity with the CPU, so a CUDA-core kernel keeps full f32: 256
//     threads per 64 x 64 tile, 4 x 4 outputs each, 16-column chunks staged
//     as f32 in shared memory.
//   - Ragged M and N are masked: padded rows and columns load as zero and
//     are never stored.
// Known costs, fixed later: a skinny M (8 or 40 decode rows) wastes most of
// each 64-row tile and each m16 fragment; the K loop is not pipelined
// (no cp.async/TMA double buffering); N = 1280 gives only 20 blocks per
// row tile, too few to stream the weights at the memory's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kThreads = 128; // 4 warps, 2 x 2 over the tile
constexpr int kPad = 8;       // bf16 elements of row padding

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d = a · b + d, a: 16x16 bf16 (row), b: 16x8 bf16 (col), d: 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rows m0.. of the chunk [k0, k0 + KC) into xs; rows past m are zero.
// K is a multiple of 16 and k0 of KC, so every 16-byte load is aligned.
template <int KC>
__device__ __forceinline__ void load_x_bf16(__nv_bfloat16 (*xs)[KC + kPad],
                                            const __nv_bfloat16* x, int m0, int m,
                                            int k, int k0) {
  constexpr int kVec = KC / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBM * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < m)
      val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * k + k0 + c);
    *reinterpret_cast<uint4*>(&xs[r][c]) = val;
  }
}

// qw rows [k0, k0 + KC), columns n0.. into ws, widened to bf16 (exact for
// int8); columns past n are zero. VEC: N is a multiple of 16, so a
// 16-column vector is either wholly inside or wholly outside.
template <int KC, bool VEC>
__device__ __forceinline__ void load_w_bf16(__nv_bfloat16 (*ws)[kBN + kPad],
                                            const int8_t* qw, int n0, int n, int k0) {
  if (VEC) {
    constexpr int kVec = kBN / 16;
    for (int i = threadIdx.x; i < KC * kVec; i += kThreads) {
      const int r = i / kVec;
      const int c = (i % kVec) * 16;
      int4 raw = make_int4(0, 0, 0, 0);
      if (n0 + c < n)
        raw = *reinterpret_cast<const int4*>(qw + static_cast<size_t>(k0 + r) * n + n0 + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint4 wide[2];  // 16 bf16 values, 16-byte aligned for the stores
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(wide);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]),
                                     static_cast<float>(b[2 * j + 1]));
      *reinterpret_cast<uint4*>(&ws[r][c]) = wide[0];
      *reinterpret_cast<uint4*>(&ws[r][c + 8]) = wide[1];
    }
  } else {
    for (int i = threadIdx.x; i < KC * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const int8_t v = n0 + c < n ? qw[static_cast<size_t>(k0 + r) * n + n0 + c] : 0;
      ws[r][c] = __float2bfloat16_rn(static_cast<float>(v));
    }
  }
}

template <int KC, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ qw,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ out, int m, int n, int k,
                        int group_size) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][KC + kPad];
  __shared__ __align__(16) __nv_bfloat16 ws[KC][kBN + kPad];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;  // this warp's 32 x 32 quarter
  const int wn = (warp % 2) * 32;

  // [m16 tile][n8 tile][fragment]: rows lane/4 (+8), columns (lane%4)*2 (+1)
  float acc[2][4][4];
  float part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = part[mi][j][e] = 0.f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    __syncthreads();  // every warp is done with the previous chunk
    load_x_bf16<KC>(xs, x, m0, m, k, k0);
    load_w_bf16<KC, VEC>(ws, qw, n0, n, k0);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &xs[wm + mi * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];  // b0/b1 of n8 tiles j and j+1, qw read transposed
        ldmatrix_x4_trans(b, &ws[kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                                [wn + (j + lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(part[mi][j], a[mi], b[0], b[1]);
          mma_bf16(part[mi][j + 1], a[mi], b[2], b[3]);
        }
      }
    }

    if ((k0 + KC) % group_size == 0) {  // this chunk closes group g
      const int g = (k0 + KC) / group_size - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + (lane % 4) * 2 + e;
          const float s = col < n ? scale[static_cast<size_t>(g) * n + col] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& p = part[mi][j][2 * r + e];
              acc[mi][j][2 * r + e] = __fadd_rn(acc[mi][j][2 * r + e], __fmul_rn(p, s));
              p = 0.f;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + mi * 16 + lane / 4 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + (lane % 4) * 2 + e;
          if (col < n)
            out[static_cast<size_t>(row) * n + col] = __float2bfloat16_rn(acc[mi][j][2 * r + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32 precision
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 64;  // 64 x 64 outputs per block
constexpr int kF32Side = 16;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kF32KC = 16;    // K columns per chunk (G is a multiple of 16)

__global__ void __launch_bounds__(kF32Side * kF32Side)
int8_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ qw,
                       const float* __restrict__ scale, float* __restrict__ out,
                       int m, int n, int k, int group_size) {
  __shared__ float xs[kF32Tile][kF32KC];
  __shared__ float ws[kF32KC][kF32Tile];

  const int n0 = blockIdx.x * kF32Tile;
  const int m0 = blockIdx.y * kF32Tile;
  const int tx = threadIdx.x % kF32Side;  // columns tx + 16·j
  const int ty = threadIdx.x / kF32Side;  // rows ty + 16·i
  float acc[4][4];
  float part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kF32KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * kF32KC; i += kF32Side * kF32Side) {
      const int r = i / kF32KC;
      const int c = i % kF32KC;
      xs[r][c] = m0 + r < m ? x[static_cast<size_t>(m0 + r) * k + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32KC * kF32Tile; i += kF32Side * kF32Side) {
      const int r = i / kF32Tile;
      const int c = i % kF32Tile;
      ws[r][c] = n0 + c < n
                     ? static_cast<float>(qw[static_cast<size_t>(k0 + r) * n + n0 + c])
                     : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kF32KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + kF32Side * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + kF32Side * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }

    if ((k0 + kF32KC) % group_size == 0) {
      const int g = (k0 + kF32KC) / group_size - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + kF32Side * j;
        const float s = col < n ? scale[static_cast<size_t>(g) * n + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(part[i][j], s));
          part[i][j] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + kF32Side * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + kF32Side * j;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

template <int KC>
void launch_bf16(const void* x, const void* qw, const void* scale, void* out, int m,
                 int n, int k, int group_size, bool vec, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const int8_t*>(qw);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec)
    int8_matmul_bf16_kernel<KC, true><<<grid, kThreads, 0, stream>>>(xb, q, s, o, m, n, k, group_size);
  else
    int8_matmul_bf16_kernel<KC, false><<<grid, kThreads, 0, stream>>>(xb, q, s, o, m, n, k, group_size);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [m, k] and qw [k, n] row-major and
// contiguous, x 16-byte aligned; vec: n % 16 == 0 and qw 16-byte aligned.
// group_size is a multiple of 16 that divides k. Returns the launch's
// cudaError_t.
extern "C" int int8_matmul(const void* x, const void* qw, const void* scale, void* out,
                           int m, int n, int k, int group_size, int dtype, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || group_size <= 0 || group_size % 16 != 0 ||
      k % group_size != 0 || (dtype != 0 && dtype != 1) ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (group_size % 64 == 0) launch_bf16<64>(x, qw, scale, out, m, n, k, group_size, vec, s);
    else if (group_size % 32 == 0) launch_bf16<32>(x, qw, scale, out, m, n, k, group_size, vec, s);
    else launch_bf16<16>(x, qw, scale, out, m, n, k, group_size, vec, s);
  } else {
    const dim3 grid((n + kF32Tile - 1) / kF32Tile, (m + kF32Tile - 1) / kF32Tile);
    int8_matmul_f32_kernel<<<grid, kF32Side * kF32Side, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const float*>(scale), static_cast<float*>(out), m, n, k, group_size);
  }
  return static_cast<int>(cudaGetLastError());
}
