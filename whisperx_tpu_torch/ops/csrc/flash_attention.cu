// K1, K1b, K2: softmax attention for Hopper (sm_90a), one kernel with modes.
//
// Replaces the TPU kernels of whisperx_tpu/ops/flash_attention.py:
//   K1   _wholek_kernel         (:125, through _flash_attention_wholek, :190)
//   K1b  _wholek_mxusum_kernel  (:163, the same function with mxu_sum=True)
//   K2   _flash_kernel          (:33,  through _flash_attention_pallas, :85)
// Computes
//     out = softmax(q kᵀ / √D) v
// for q, k, v laid out [BH, T, D] (row-major, contiguous), accumulating in
// f32 and writing the input dtype. As in the TPU kernel, the softmax scale
// times log2(e) is folded into q (rounded back to the input dtype), scores
// live in log2 space and are exponentiated with exp2, the probabilities are
// rounded to the input dtype before the P·V product, the denominator sums
// the unrounded probabilities, and the [BQ, D] output is normalised once.
//
// What bounds it on this card. At the encoder's shape (BH = B·20, T = 1500,
// D = 64, bf16) the work is 4·BH·T²·D operations against 4·BH·T·D·2 bytes of
// input and output: ~375 operations per byte, above the H100's ridge (~295),
// so it is bound by tensor-core operations (0.093 ms at 989 TFLOP/s for
// B = 8), not by memory (0.037 ms at 3.35 TB/s).
//
// What the design does about it. The TPU kernel kept a head's whole K and V
// in VMEM (2·1500·64·2 B = 384 KB in bf16); a Hopper block has at most
// 227 KB of shared memory, so that layout does not carry over. Instead:
//   - bf16 (the main path): one block of 4 warps takes a 64-row query tile
//     (16 rows per warp) and streams K/V through shared memory in 64-key
//     tiles (8 KB each, rows padded by 16 B so ldmatrix is conflict-free).
//     Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//     f32 accumulate): S = Q·Kᵀ with Q's fragments held in registers for the
//     whole loop, then O += P·V with P taken straight from S's accumulator
//     registers (the C layout of two n8 tiles is the A layout of one k16
//     step). The softmax is the online recurrence: a running row max and
//     sum, and the accumulator rescaled once per key tile.
//   - f32 (test-sized models): tensor cores would round to TF32, so a CUDA-
//     core kernel keeps full f32: one thread per query row, its scaled q row
//     and accumulator in registers, 32-key tiles staged as f32 in shared
//     memory and read as warp broadcasts.
// Still to do for speed (a later optimisation): cp.async/TMA double
// buffering of the K/V tiles, and wgmma on 64-row warpgroup tiles.
//
// skip_max drops the running-max rescale (the TPU kernel's skip_max): the
// scores are exponentiated as they are, which stays finite in f32 while the
// scaled logits are below ~128.
//
// The modes (the `mode` argument):
//   0  K1: as above.
//   1  K1 with skip_max.
//   2  K1b: the denominator sums P after its rounding to the input dtype,
//      l = Σ bf16(p), which is what the TPU kernel's ones column appended
//      to V computes on the MXU; the P·V tiles do not change. In f32 the
//      rounding is the identity, so mode 2 is mode 0.
//   3  K2: the tiled online-softmax kernel, for keys past the whole-K
//      kernel's 2048: the same streaming loop, with the TPU kernel's
//      out = acc / max(l, 1e-20).
//   4  K2 causal: query i attends keys j ≤ i + (Tk − Tq), the mask aligned
//      at the end of the keys, as the JAX package's XLA route and the
//      decoder's own mask align it (the Pallas kernel aligns it at the
//      start, j ≤ i; the two agree when Tq = Tk). A query tile stops at the
//      last key tile any of its rows can see, so fully masked tiles are
//      skipped as on the TPU. Needs Tq ≤ Tk.
// K2's bound is operations too: 2·BH·T²·D for the causal case at Tq = Tk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBK = 64;                     // keys per shared-memory tile
constexpr int kPad = 8;                     // bf16 elements of row padding

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy a [rows, D] bf16 tile (rows past `valid` zero) into padded shared
// memory, 16 bytes per thread per step; optionally scale by `scale` with a
// round back to bf16 (q's fold of the softmax scale).
template <int D, bool SCALE>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src, int rows,
                                          int valid, float scale) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVec; i += kWarps * 32) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
      if (SCALE) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

enum Mode { kK1 = 0, kK1SkipMax = 1, kK1b = 2, kK2 = 3, kK2Causal = 4 };

// the last key (exclusive) that rows [r0, r1) can attend: all of them, or
// under the causal mask j ≤ i + (tk − tq)
template <int MODE>
__device__ __forceinline__ int key_end(int r1, int tq, int tk) {
  return MODE == kK2Causal ? min(tk, r1 - 1 + (tk - tq) + 1) : tk;
}

template <int D, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
wholek_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int tq, int tk,
                             float kscale) {
  constexpr bool SKIP_MAX = MODE == kK1SkipMax;
  constexpr int kS = kBK / 8;  // n8 score tiles per key tile
  constexpr int kO = D / 8;    // n8 output tiles
  constexpr int kK = D / 16;   // k16 steps over the head dimension
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][D + kPad];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * tk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * tk * D;

  load_tile<D, true>(qs, q + (static_cast<size_t>(bh) * tq + q0) * D, kBQ,
                     tq - q0, kscale);
  __syncthreads();
  // this warp's 16 query rows as A fragments, for the whole key loop
  uint32_t qa[kK][4];
  const int wr = warp * kRowsPerWarp;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    ldmatrix_x4(qa[kk], &qs[wr + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  float acc[kO][4];
#pragma unroll
  for (int j = 0; j < kO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this thread's two rows: g = lane / 4 and g + 8 of the warp's 16
  float m[2] = {SKIP_MAX ? 0.f : -CUDART_INF_F, SKIP_MAX ? 0.f : -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  const int k_end = key_end<MODE>(min(q0 + kBQ, tq), tq, tk);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int n = min(kBK, tk - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, false>(ks, kb + static_cast<size_t>(k0) * D, kBK, n, 1.f);
    load_tile<D, false>(vs, vb + static_cast<size_t>(k0) * D, kBK, n, 1.f);
    __syncthreads();

    // S = Q Kᵀ: [16, 64] per warp as kS n8 tiles
    float s[kS][4];
#pragma unroll
    for (int j = 0; j < kS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int j = 0; j < kS; j += 2) {
        uint32_t b[4];  // b0/b1 of key tiles j and j+1
        ldmatrix_x4(b, &ks[j * 8 + (lane % 8) + (lane / 16) * 8]
                          [kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax over this tile; padded keys weigh exp2(-inf) = 0
    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + (lane % 4) * 2 + (e % 2);
        if (key >= n) s[j][e] = -CUDART_INF_F;
        if (MODE == kK2Causal && k0 + key > q0 + wr + lane / 4 + 8 * (e / 2) + (tk - tq))
          s[j][e] = -CUDART_INF_F;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], s[j][e]);
      }
    }
    float m_new[2] = {m[0], m[1]};
    if (!SKIP_MAX) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        m_new[r] = fmaxf(m[r], tile_max[r]);
        const float alpha = exp2f(m[r] - m_new[r]);  // 0 on the first tile
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kO; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
        m[r] = m_new[r];
      }
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_new[e / 2]);
        // K1b: the denominator of the rounded weights, as P·V sees them
        l[e / 2] += MODE == kK1b ? __bfloat162float(__float2bfloat16_rn(s[j][e])) : s[j][e];
      }
    }

    // O += P V: P's A fragments come from S's accumulators (rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kO; j += 2) {
        uint32_t b[4];  // b0/b1 of output tiles j and j+1, V read transposed
        ldmatrix_x4_trans(b, &vs[kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                                [(j + lane / 16) * 8]);
        mma_bf16(acc[j], pa, b[0], b[1]);
        mma_bf16(acc[j + 1], pa, b[2], b[3]);
      }
    }
  }

  // normalise and store this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (MODE >= kK2) l[r] = fmaxf(l[r], 1e-20f);
    const int row = q0 + wr + lane / 4 + 8 * r;
    if (row < tq) {
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * tq + row) * D;
#pragma unroll
      for (int j = 0; j < kO; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(&orow[j * 8 + (lane % 4) * 2]) =
            __floats2bfloat162_rn(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32 precision
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;  // query rows per block, one thread each
constexpr int kF32BK = 32;  // keys per shared-memory tile

template <int D, int MODE>
__global__ void __launch_bounds__(kF32BQ)
wholek_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            int tq, int tk, float kscale) {
  constexpr bool SKIP_MAX = MODE == kK1SkipMax;
  __shared__ float ks[kF32BK][D];
  __shared__ float vs[kF32BK][D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kF32BQ + threadIdx.x;
  const bool active = row < tq;
  // rows past the ragged end read row 0 and store nothing; they still take
  // part in the cooperative tile loads and the barriers
  const float* qrow = q + (static_cast<size_t>(bh) * tq + (active ? row : 0)) * D;
  const float* kb = k + static_cast<size_t>(bh) * tk * D;
  const float* vb = v + static_cast<size_t>(bh) * tk * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qrow[d] * kscale;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = SKIP_MAX ? 0.f : -CUDART_INF_F;
  float l = 0.f;

  const int k_end = key_end<MODE>(min(static_cast<int>(blockIdx.x) * kF32BQ + kF32BQ, tq), tq, tk);
  for (int k0 = 0; k0 < k_end; k0 += kF32BK) {
    const int n = min(kF32BK, tk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BK * D; i += kF32BQ) {
      const int j = i / D;
      const int d = i % D;
      const size_t off = static_cast<size_t>(k0 + j) * D + d;
      ks[j][d] = j < n ? kb[off] : 0.f;
      vs[j][d] = j < n ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[kF32BK];
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int j = 0; j < kF32BK; ++j) s[j] = fmaf(qr[d], ks[j][d], s[j]);
    }
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      if (j >= n || (MODE == kK2Causal && k0 + j > row + (tk - tq))) s[j] = -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    float m_new = m;
    if (!SKIP_MAX) {
      m_new = fmaxf(m, tile_max);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (MODE >= kK2) l = fmaxf(l, 1e-20f);
  if (active) {
    float* orow = o + (static_cast<size_t>(bh) * tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l;
  }
}

template <int D, int MODE>
void launch(const void* q, const void* k, const void* v, void* o, int bh,
            int tq, int tk, int dtype, float kscale, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((tq + kBQ - 1) / kBQ, bh);
    wholek_attention_bf16_kernel<D, MODE><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq,
        tk, kscale);
  } else {
    const dim3 grid((tq + kF32BQ - 1) / kF32BQ, bh);
    // K1b's rounding is the identity in f32
    constexpr int kMode = MODE == kK1b ? kK1 : MODE;
    wholek_attention_f32_kernel<D, kMode><<<grid, kF32BQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), tq, tk, kscale);
  }
}

template <int D>
void launch_mode(const void* q, const void* k, const void* v, void* o, int bh,
                 int tq, int tk, int dtype, int mode, float kscale, cudaStream_t s) {
  switch (mode) {
    case kK1: launch<D, kK1>(q, k, v, o, bh, tq, tk, dtype, kscale, s); break;
    case kK1SkipMax: launch<D, kK1SkipMax>(q, k, v, o, bh, tq, tk, dtype, kscale, s); break;
    case kK1b: launch<D, kK1b>(q, k, v, o, bh, tq, tk, dtype, kscale, s); break;
    case kK2: launch<D, kK2>(q, k, v, o, bh, tq, tk, dtype, kscale, s); break;
    default: launch<D, kK2Causal>(q, k, v, o, bh, tq, tk, dtype, kscale, s); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d: 32 or 64; mode: see the top of the
// file (mode 4 needs tq <= tk). Pointers are 16-byte aligned, contiguous
// [BH, T, D]. Returns the launch's cudaError_t.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int tq, int tk, int d,
                                int dtype, int mode, float kscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || (dtype != 0 && dtype != 1) ||
      mode < kK1 || mode > kK2Causal || (mode == kK2Causal && tq > tk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) launch_mode<64>(q, k, v, o, bh, tq, tk, dtype, mode, kscale, s);
  else if (d == 32) launch_mode<32>(q, k, v, o, bh, tq, tk, dtype, mode, kscale, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
