// K4: weight-only int8 matrix product with group scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel whisperx_tpu/ops/quant_matmul.py::_int8_matmul_kernel
// (reached through _quant_matmul_pallas_int8). Computes
//     y[m, n] = cast( Σ_g ( Σ_{k in g} x[m, k] · qw[k, n] ) · scale[g, n] )
// for x [M, K] (bf16 or f32, row-major), qw [K, N] int8, scale [K/G, N] f32
// and G = group_size: the int8 codes are widened exactly, each group's
// partial product is accumulated in f32 and multiplied by the group's scale
// row, the scaled partials are summed in f32 (multiply, then add: two
// roundings, as the plain version), and the sum is cast once to x's dtype.
//
// The host picks one of four regimes from the shapes
// (ops/quant_matmul.py::launch_plan):
//
// 1. Split K (bf16, M <= 128: the decode steps at M = 8 and 40, the prefill
//    at 120). Bytes bound it: at M = 40, K = N = 1280 the kernel must move
//    1.95 MB (0.58 µs at 3.35 TB/s) for 0.13 GFLOP (0.13 µs at 989 TFLOP/s);
//    at (1280, 5120) and (5120, 1280) 7.47 MB (2.2 µs). Streaming at the
//    memory's rate needs ~3 MB in flight over the card, so the grid must
//    cover every SM at least twice: 64-column tiles alone give only 20
//    blocks at N = 1280. So K is split into slices of whole groups
//    (blockIdx.y), as many as bring the grid to 2 × 132 blocks, and each
//    block streams its int8 weight slab [K/S, 64] through a ring of four
//    shared-memory stages with 16-byte cp.async.cg copies (x's chunk rides
//    in the same stage). The codes stay int8 in shared memory and are
//    widened to bf16 in registers right before an mma.sync m16n8k16 (M is
//    padded to 16-row fragments; the tensor-core rate does not matter
//    here). Each slice writes its f32 sum to a workspace [S, M, N]; a second
//    small kernel adds the slices in slice order and casts: deterministic,
//    no float atomics. A single slice writes the output directly.
// 2. wgmma tiles (bf16, M > 128: precompute_cross_kv at M = B·1500).
//    Operations bound it: 39 GFLOP against 63 MB at M = 12000, K = N = 1280
//    (40 µs vs 19 µs). One block of two consumer warpgroups computes a
//    128 x 128 output tile, each warpgroup 64 rows with two wgmma m64n64k16
//    per k16 step (both operands from shared memory, in the 128-byte
//    swizzle). x tiles (coalesced rows, stored in
//    wgmma's 128-byte swizzle) and raw int8 weight tiles arrive through a
//    four-stage cp.async ring; the weight tile of the next
//    64-row chunk is widened into a second bf16 buffer (the wgmma B operand,
//    read N-major) while the current chunk's wgmma runs, then
//    fence.proxy.async makes it visible to the tensor cores. The group's
//    partial stays in registers beside the accumulator (a group of 64 is
//    four k16 steps) and is scaled into it when the group closes.
// 3. The plain tiled path (bf16, groups of 32 or 16, N not a multiple of
//    16, or an unaligned weight: no caller on the main paths): the first
//    design, kept for these shapes. A 64 x 64 output tile per block of 4
//    warps, K in synchronous chunks of 64, 32 or 16 (the largest that
//    divides G) with the codes widened into shared memory, mma.sync.
// 4. f32 (test-sized models): tensor cores would round x to TF32 and break
//    the f32 token identity with the CPU, so a CUDA-core kernel keeps full
//    f32: 256 threads per 64 x 64 tile, 4 x 4 outputs each.
// Ragged M and N are masked everywhere: padded rows and columns load as zero
// and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // plain tiled path: output rows per block
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

// 16 bytes global -> shared, bypassing L1; `valid` false zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two int8 codes, widened exactly, as a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Four int8 codes (a 32-bit word, code 0 in the low byte) widened exactly to
// two bf16 pairs without the conversion units: byte permutes build the f32
// 2^23 + 128 + v, less 2^23 + 128 that is v, and a small integer's f32 has a
// zero low half, so its high half is its bf16.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // v + 128, unsigned
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// ---------------------------------------------------------------------------
// Regime 1: split K for skinny M (mma.sync, cp.async ring)
// ---------------------------------------------------------------------------

constexpr int kSkKC = 64;              // K rows per stage: one group of 64
constexpr int kSkStages = 4;
constexpr int kSkWRow = kBN + 16;      // int8 row stride: 80 B, conflict-free byte reads
constexpr int kSkXRow = kSkKC + kPad;  // bf16 row stride: 144 B, conflict-free ldmatrix

template <int MT>  // 16-row fragments: M <= 16·MT
struct SkinnySmem {
  __nv_bfloat16 x[kSkStages][MT * 16][kSkXRow];
  int8_t w[kSkStages][kSkKC][kSkWRow];
};

// grid (N tiles of 64, slices). Slice s takes groups
// [s·G_all/S, (s+1)·G_all/S): whole groups, covering K exactly.
template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_splitk_kernel(const __nv_bfloat16* __restrict__ x,
                          const int8_t* __restrict__ qw,
                          const float* __restrict__ scale,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                          int m, int n, int k, int group_size) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<SkinnySmem<MT>*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int s = blockIdx.y;
  const int slices = gridDim.y;
  const int groups = k / group_size;
  const int kb = static_cast<int>(static_cast<long long>(s) * groups / slices) * group_size;
  const int ke = static_cast<int>(static_cast<long long>(s + 1) * groups / slices) * group_size;
  const int chunks = (ke - kb) / kSkKC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wn = warp * 16;  // this warp's 16 columns: two n8 tiles

  auto load = [&](int c, int st) {
    const int k0 = kb + c * kSkKC;
    constexpr int kXVec = kSkKC / 8;  // 16-byte vectors per x row
    for (int i = threadIdx.x; i < MT * 16 * kXVec; i += kThreads) {
      const int r = i / kXVec;
      const int cc = (i % kXVec) * 8;
      const bool ok = r < m;
      cp_async16(&sm.x[st][r][cc], ok ? x + static_cast<size_t>(r) * k + k0 + cc : x, ok);
    }
    constexpr int kWVec = kBN / 16;  // 16-byte vectors per weight row
    for (int i = threadIdx.x; i < kSkKC * kWVec; i += kThreads) {
      const int r = i / kWVec;
      const int cc = (i % kWVec) * 16;
      const bool ok = n0 + cc < n;
      cp_async16(&sm.w[st][r][cc], ok ? qw + static_cast<size_t>(k0 + r) * n + n0 + cc : qw, ok);
    }
  };

#pragma unroll
  for (int c = 0; c < kSkStages - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();  // an empty group past the end keeps the count
  }

  // [m16 tile][n8 tile][fragment]: rows lane/4 (+8), columns (lane%4)*2 (+1)
  float acc[MT][2][4];
  float part[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = part[mi][j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kSkStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();  // ... everyone's; and every warp is done with chunk c - 1
    if (c + kSkStages - 1 < chunks) load(c + kSkStages - 1, (c + kSkStages - 1) % kSkStages);
    cp_async_commit();
    const int st = c % kSkStages;

#pragma unroll
    for (int kk = 0; kk < kSkKC / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], &sm.x[st][mi * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
      const int kr = kk * 16 + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn + j * 8 + lane / 4;  // B fragment: column lane/4
        const uint32_t b0 = widen2(sm.w[st][kr][col], sm.w[st][kr + 1][col]);
        const uint32_t b1 = widen2(sm.w[st][kr + 8][col], sm.w[st][kr + 9][col]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_bf16(part[mi][j], a[mi], b0, b1);
      }
    }

    const int k1 = kb + (c + 1) * kSkKC;
    if (k1 % group_size == 0) {  // this chunk closes group g
      const int g = k1 / group_size - 1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + (lane % 4) * 2 + e;
          const float sc = col < n ? scale[static_cast<size_t>(g) * n + col] : 0.f;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& p = part[mi][j][2 * r + e];
              acc[mi][j][2 * r + e] = __fadd_rn(acc[mi][j][2 * r + e], __fmul_rn(p, sc));
              p = 0.f;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mi * 16 + lane / 4 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + wn + j * 8 + (lane % 4) * 2;  // even; N is a multiple of 16
        if (col >= n) continue;
        const float v0 = acc[mi][j][2 * r], v1 = acc[mi][j][2 * r + 1];
        if (ws != nullptr)
          *reinterpret_cast<float2*>(&ws[(static_cast<size_t>(s) * m + row) * n + col]) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(&out[static_cast<size_t>(row) * n + col]) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out = cast(((ws[0] + ws[1]) + ws[2]) + ...), the slices in order
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                     int mn, int slices) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= mn) return;
  float sum = ws[i];
  for (int s = 1; s < slices; ++s) sum = __fadd_rn(sum, ws[static_cast<size_t>(s) * mn + i]);
  out[i] = __float2bfloat16_rn(sum);
}

// ---------------------------------------------------------------------------
// Regime 2: wgmma tiles for large M (cp.async ring, int8 widened in shared
// memory)
// ---------------------------------------------------------------------------

// d[8][4] += A(smem) · B(smem), m64n64k16, bf16 in, f32 accumulate
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the registers a wgmma wrote, pinned after the wait that completed it (the
// compiler sees the asm's outputs as ready when it is issued)
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[j][e]) :: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor for an operand in the 128-byte swizzle:
// rows of 128 bytes whose 16-byte chunk c sits at c ^ (row % 8), 8-row
// atoms of 1024 bytes (sbo), the atoms 1024-byte aligned. K-major (rows are
// M or N): a k16 step advances p by 32 bytes; N-major (rows are K, N = 64):
// by 16 rows.
__device__ __forceinline__ uint32_t sw128(int r, int c) {  // chunk c of row r
  return r * 128 + ((c ^ (r % 8)) << 4);
}
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

constexpr int kTlBM = 128;    // output rows per block: two warpgroups of 64
constexpr int kTlBN = 128;    // output columns per block
constexpr int kTlKC = 64;     // K rows per stage
constexpr int kTlStages = 4;
constexpr int kTlThreads = 256;
constexpr int kTlWRow = kTlBN + 16;  // raw int8 row stride: 144 B, conflict-free 16-byte reads

struct TiledSmem {
  // x chunk, K-major rows of 128 bytes in the 128-byte swizzle
  __nv_bfloat16 a[kTlStages][kTlBM][kTlKC];
  // the widened weight chunk, N-major: [64 columns][k][64] in the swizzle
  __nv_bfloat16 b[2][kTlBN / 64][kTlKC][64];
  int8_t w[kTlStages][kTlKC][kTlWRow];  // the raw int8 weight chunk
};

__global__ void __launch_bounds__(kTlThreads)
int8_matmul_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ qw,
                         const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ out, int m, int n, int k,
                         int group_size) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<TiledSmem*>(  // the swizzle atoms: 1024-byte aligned
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n0 = blockIdx.x * kTlBN;
  const int m0 = blockIdx.y * kTlBM;
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 rows
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = k / kTlKC;

  auto load = [&](int c, int st) {
    const int k0 = c * kTlKC;
    for (int i = threadIdx.x; i < kTlBM * (kTlKC / 8); i += kTlThreads) {
      const int r = i / (kTlKC / 8);  // 8 threads read one row's 128 bytes
      const int kg = i % (kTlKC / 8);
      const bool ok = m0 + r < m;
      cp_async16(reinterpret_cast<unsigned char*>(&sm.a[st][0][0]) + sw128(r, kg),
                 ok ? x + static_cast<size_t>(m0 + r) * k + k0 + kg * 8 : x, ok);
    }
    for (int i = threadIdx.x; i < kTlKC * (kTlBN / 16); i += kTlThreads) {
      const int r = i / (kTlBN / 16);
      const int cc = (i % (kTlBN / 16)) * 16;
      const bool ok = n0 + cc < n;
      cp_async16(&sm.w[st][r][cc], ok ? qw + static_cast<size_t>(k0 + r) * n + n0 + cc : qw, ok);
    }
  };
  // raw chunk st -> bf16 buffer buf (exact), 16 codes per thread
  auto widen = [&](int st, int buf) {
    const int r = threadIdx.x % kTlKC;
    const int cc = (threadIdx.x / kTlKC) * 16;  // 4 x 16 columns per pass
#pragma unroll
    for (int pass = 0; pass < kTlBN / 64; ++pass) {
      const int col = cc + pass * 64;
      const uint4 raw = *reinterpret_cast<const uint4*>(&sm.w[st][r][col]);
      uint32_t h[8];
      widen4(raw.x, h[0], h[1]);
      widen4(raw.y, h[2], h[3]);
      widen4(raw.z, h[4], h[5]);
      widen4(raw.w, h[6], h[7]);
      unsigned char* atom = reinterpret_cast<unsigned char*>(&sm.b[buf][col / 64][0][0]);
      const int c = (col % 64) / 8;
      *reinterpret_cast<uint4*>(atom + sw128(r, c)) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(atom + sw128(r, c + 1)) = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

#pragma unroll
  for (int c = 0; c < kTlStages - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  cp_async_wait<kTlStages - 2>();
  __syncthreads();
  widen(0, 0);
  fence_proxy_async();
  __syncthreads();

  float acc[kTlBN / 8][4];
  float part[kTlBN / 8][4];
#pragma unroll
  for (int j = 0; j < kTlBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int st = c % kTlStages;
    const int k0 = c * kTlKC;
    // part (+)= x[rows, chunk] · w[chunk, cols]: four k16 steps, async
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTlKC / 16; ++kk) {
      const uint64_t da = smem_desc_sw128(&sm.a[st][wg * 64][16 * kk]);
#pragma unroll
      for (int na = 0; na < kTlBN / 64; ++na) {  // one 64-column atom each
        const uint64_t db = smem_desc_sw128(&sm.b[c % 2][na][16 * kk][0]);
        wgmma_m64n64k16_ss<1>(*reinterpret_cast<float(*)[8][4]>(&part[8 * na][0]), da, db,
                              (k0 % group_size != 0) || kk > 0);
      }
    }
    wgmma_commit();
    const int k1 = k0 + kTlKC;
    const bool closes = k1 % group_size == 0;  // this chunk closes group k1 / G - 1
    float sc[kTlBN / 8][2];  // its scale row at this thread's columns, read early
    if (closes) {
      const float* srow = scale + static_cast<size_t>(k1 / group_size - 1) * n;
#pragma unroll
      for (int j = 0; j < kTlBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + (lane % 4) * 2 + e;
          sc[j][e] = col < n ? __ldg(&srow[col]) : 0.f;
        }
    }
    // meanwhile: the copies of chunk c + 3 (into the stage chunk c - 1
    // used, whose wgmma has completed) and the widening of chunk c + 1
    if (c + kTlStages - 1 < chunks) load(c + kTlStages - 1, (c + kTlStages - 1) % kTlStages);
    cp_async_commit();
    cp_async_wait<kTlStages - 2>();  // chunk c + 1 has landed (this thread's copies)
    __syncthreads();                 // ... everyone's
    if (c + 1 < chunks) widen((c + 1) % kTlStages, (c + 1) % 2);
    fence_proxy_async();  // the widened tile and the copied x tile, for wgmma
    wgmma_wait<0>();
    fence_regs(part);

    if (closes) {
#pragma unroll
      for (int j = 0; j < kTlBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            acc[j][2 * r + e] = __fadd_rn(acc[j][2 * r + e], __fmul_rn(part[j][2 * r + e], sc[j][e]));
    }
    __syncthreads();  // chunk c + 1's bf16 buffer is complete before its wgmma
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTlBN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col < n)
        *reinterpret_cast<__nv_bfloat162*>(&out[static_cast<size_t>(row) * n + col]) =
            __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Regime 3: the plain tiled path (groups of 32 or 16, ragged or unaligned N)
// ---------------------------------------------------------------------------

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
void launch_tiled(const void* x, const void* qw, const void* scale, void* out, int m,
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

template <int MT>
cudaError_t launch_splitk(const void* x, const void* qw, const void* scale, void* out,
                          void* ws, int m, int n, int k, int group_size, int slices,
                          cudaStream_t stream) {
  constexpr int kSmem = sizeof(SkinnySmem<MT>);
  static bool configured = false;  // the attribute once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_splitk_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n + kBN - 1) / kBN, slices);
  auto* o = static_cast<__nv_bfloat16*>(out);
  float* w = slices > 1 ? static_cast<float*>(ws) : nullptr;
  int8_matmul_splitk_kernel<MT><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), o, w, m, n, k, group_size);
  if (slices > 1) {
    const int mn = m * n;
    splitk_reduce_kernel<<<(mn + 255) / 256, 256, 0, stream>>>(w, o, mn, slices);
  }
  return cudaSuccess;
}

cudaError_t launch_wgmma(const void* x, const void* qw, const void* scale, void* out, int m,
                         int n, int k, int group_size, cudaStream_t stream) {
  constexpr int kSmem = sizeof(TiledSmem) + 1024;  // + the 1024-byte alignment
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n + kTlBN - 1) / kTlBN, (m + kTlBM - 1) / kTlBM);
  int8_matmul_wgmma_kernel<<<grid, kTlThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, n, k, group_size);
  return cudaSuccess;
}

enum Regime { kTiled = 0, kSplitK = 1, kWgmma = 2 };

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [m, k] and qw [k, n] row-major and
// contiguous, x 16-byte aligned. bf16 regime (ops/quant_matmul.py::
// launch_plan): 0 the plain tiled path (vec: n % 16 == 0 and qw 16-byte
// aligned); 1 split K into `slices` slices of whole groups (m <= 128), with
// `ws` an f32 workspace [slices, m, n] when slices > 1; 2 wgmma tiles.
// Regimes 1 and 2 need group_size % 64 == 0, n % 16 == 0 and a 16-byte
// aligned qw. f32 ignores the regime. group_size is a multiple of 16 that
// divides k. Returns the launch's cudaError_t.
extern "C" int int8_matmul(const void* x, const void* qw, const void* scale, void* out,
                           int m, int n, int k, int group_size, int dtype, int vec,
                           int regime, int slices, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || group_size <= 0 || group_size % 16 != 0 ||
      k % group_size != 0 || (dtype != 0 && dtype != 1) ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const dim3 grid((n + kF32Tile - 1) / kF32Tile, (m + kF32Tile - 1) / kF32Tile);
    int8_matmul_f32_kernel<<<grid, kF32Side * kF32Side, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const float*>(scale), static_cast<float*>(out), m, n, k, group_size);
    return static_cast<int>(cudaGetLastError());
  }
  const bool fast = group_size % 64 == 0 && n % 16 == 0 && vec;
  cudaError_t err = cudaSuccess;
  if (regime == kSplitK) {
    if (!fast || m > 128 || slices < 1 || slices > k / group_size || slices > 65535 ||
        (slices > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (m <= 16) err = launch_splitk<1>(x, qw, scale, out, ws, m, n, k, group_size, slices, s);
    else if (m <= 32) err = launch_splitk<2>(x, qw, scale, out, ws, m, n, k, group_size, slices, s);
    else if (m <= 48) err = launch_splitk<3>(x, qw, scale, out, ws, m, n, k, group_size, slices, s);
    else if (m <= 64) err = launch_splitk<4>(x, qw, scale, out, ws, m, n, k, group_size, slices, s);
    else err = launch_splitk<8>(x, qw, scale, out, ws, m, n, k, group_size, slices, s);
  } else if (regime == kWgmma) {
    if (!fast) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_wgmma(x, qw, scale, out, m, n, k, group_size, s);
  } else if (regime == kTiled) {
    if (group_size % 64 == 0) launch_tiled<64>(x, qw, scale, out, m, n, k, group_size, vec, s);
    else if (group_size % 32 == 0) launch_tiled<32>(x, qw, scale, out, m, n, k, group_size, vec, s);
    else launch_tiled<16>(x, qw, scale, out, m, n, k, group_size, vec, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
