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
// B = 8), not by memory (0.037 ms at 3.35 TB/s). K2's causal case is bound
// by operations too: 2·BH·T²·D at Tq = Tk.
//
// What the design does about it. The TPU kernel kept a head's whole K and V
// in VMEM (2·1500·64·2 B = 384 KB in bf16); a Hopper block has at most
// 227 KB of shared memory, so K and V stream through it:
//   - bf16 (the main path): a block is one consumer warpgroup, which owns a
//     64-row query tile, and one producer warp. Q is scaled, rounded and
//     stored once into shared memory by the consumers. The producer keeps
//     64-key K and V tiles in flight through a ring of two stages with
//     TMA: a 3-D tensor map over [BH, T, D] (so the ragged end of T is
//     zero-filled, never read from the next head), one box of 64 whole rows
//     per tile, written in the swizzle of the row length (128 bytes at
//     D = 64) that wgmma reads, and a full/empty mbarrier pair per stage.
//     The consumers run S = Q·Kᵀ as wgmma m64n64k16 with both operands in
//     shared memory (K stored [keys, D] is already K-major), the online
//     softmax in registers (a row max and sum per thread, reduced over the
//     quad with shuffles), and O += P·V as wgmma with P from registers (S's
//     accumulator layout is the A fragment's) and V from shared memory,
//     read N-major. Several blocks share an SM, so one block's softmax
//     overlaps another's products. (Issuing tile t + 1's scores with tile
//     t's P·V made ptxas serialize the wgmmas, and was slower.)
//   - f32 (test-sized models): tensor cores would round to TF32, so a CUDA-
//     core kernel keeps full f32: one thread per query row, its scaled q row
//     and accumulator in registers, 32-key tiles staged as f32 in shared
//     memory and read as warp broadcasts.
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

#include <cuda.h>  // CUtensorMap; the encoder is reached through the CUDA runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows per block: one consumer warpgroup
constexpr int kBK = 64;          // keys per K/V tile
constexpr int kStages = 2;       // K/V ring depth: 4 blocks an SM (3 with 3 stages)
constexpr int kConsumers = 128;  // the warpgroup
constexpr int kBf16Threads = kConsumers + 32;  // + the producer warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// one TMA box of the 3-D map at (c0, c1, c2), innermost first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {  // named barrier 1: the warpgroup only
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
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

// Every operand tile is [rows][D] bf16 in the swizzle of its row length
// (D = 64: rows of 128 bytes, 128-byte swizzle; D = 32: 64 bytes, 64-byte
// swizzle): the 16-byte chunk c of row r sits at c ^ (r % 8) (128) or
// c ^ ((r / 2) % 4) (64), what TMA writes in that mode and wgmma reads.
// Atoms of 8 rows, 1024-byte aligned.
template <int D>
struct Swizzle {
  static constexpr uint32_t kRowBytes = D * 2;
  static constexpr uint32_t kAtomBytes = 8 * kRowBytes;  // 8 rows: the sbo
  static constexpr uint64_t kLayout = D == 64 ? 1 : 2;   // wgmma: 128B / 64B swizzle
  // the byte offset of 16-byte chunk c of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t o = r * kRowBytes + c * 16;
    return o ^ (((o >> 7) & (D == 64 ? 7 : 3)) << 4);
  }
  // the descriptor of a tile from p: K-major (rows are M or N, K along the
  // row; a k16 step advances p by 32 bytes) or N-major (rows are K; N
  // fits one row; a k16 step advances p by 16 rows)
  static __device__ __forceinline__ uint64_t desc(const void* p) {
    return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (kLayout << 62);
  }
};

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

// d[8][4] += A(registers) · B(smem), m64n64k16, bf16 in, f32 accumulate
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// d[4][4] += A(registers) · B(smem), m64n32k16, bf16 in, f32 accumulate
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

enum Mode { kK1 = 0, kK1SkipMax = 1, kK1b = 2, kK2 = 3, kK2Causal = 4 };

// the last key (exclusive) that rows [r0, r1) can attend: all of them, or
// under the causal mask j ≤ i + (tk − tq)
template <int MODE>
__device__ __forceinline__ int key_end(int r1, int tq, int tk) {
  return MODE == kK2Causal ? min(tk, r1 - 1 + (tk - tq) + 1) : tk;
}

template <int D>
struct AttnSmem {  // each tile in Swizzle<D>
  __nv_bfloat16 q[kBQ][D];
  __nv_bfloat16 k[kStages][kBK][D];
  __nv_bfloat16 v[kStages][kBK][D];
};

template <int D, int MODE>
__global__ void __launch_bounds__(kBf16Threads)
wholek_attention_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q,
                             __nv_bfloat16* __restrict__ o, int tq, int tk,
                             float kscale) {
  constexpr bool SKIP_MAX = MODE == kK1SkipMax;
  constexpr int kS = kBK / 8;  // n8 score tiles per key tile
  constexpr int kO = D / 8;    // n8 output tiles
  constexpr int kK = D / 16;   // k16 steps over the head dimension
  constexpr uint32_t kTileBytes = 2u * kBK * D * sizeof(__nv_bfloat16);  // K and V
  extern __shared__ unsigned char smem_raw[];
  using Sw = Swizzle<D>;
  auto& sm = *reinterpret_cast<AttnSmem<D>*>(  // the swizzle atoms: 1024-byte aligned
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int k_end = key_end<MODE>(min(q0 + kBQ, tq), tq, tk);
  const int tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: one lane keeps the ring full
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty_bar[st], ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full_bar[st], kTileBytes);
        tma_load_3d(&sm.k[st][0][0], &kmap, &full_bar[st], 0, t * kBK, bh);
        tma_load_3d(&sm.v[st][0][0], &vmap, &full_bar[st], 0, t * kBK, bh);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Q, scaled and rounded back to bf16, rows past tq zero
  for (int i = threadIdx.x; i < kBQ * (D / 8); i += kConsumers) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < tq) {
      val = *reinterpret_cast<const uint4*>(q + (static_cast<size_t>(bh) * tq + q0 + r) * D + c * 8);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * kscale, f.y * kscale);
      }
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(&sm.q[0][0]) + Sw::offset(r, c)) = val;
  }
  fence_proxy_async();  // the generic stores, visible to wgmma
  consumers_sync();

  float acc[kO][4];
#pragma unroll
  for (int j = 0; j < kO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // this thread's two rows: g = lane / 4 and g + 8 of its warp's 16
  const int wr = warp * 16;
  float m[2] = {SKIP_MAX ? 0.f : -CUDART_INF_F, SKIP_MAX ? 0.f : -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  for (int t = 0; t < tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kBK;
    const int n = min(kBK, tk - k0);
    mbar_wait(&full_bar[st], (t / kStages) & 1);

    // S = Q Kᵀ: [64, 64], rows wr.. per warp as kS n8 tiles
    float s[kS][4];
#pragma unroll
    for (int j = 0; j < kS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const uint64_t da = Sw::desc(&sm.q[0][16 * kk]);
      const uint64_t db = Sw::desc(&sm.k[st][0][16 * kk]);
      wgmma_m64n64k16_ss<0>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

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
        if (MODE != kK1b) l[e / 2] += s[j][e];  // K1b sums the rounded weights below
      }
    }

    // P's A fragments from S's accumulators (rounded to bf16)
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      if (MODE == kK1b) {  // the denominator of the rounded weights, as P·V sees them
#pragma unroll
        for (int i = 0; i < 4; ++i)
          l[i % 2] += __uint_as_float(pa[kk][i] << 16) + __uint_as_float(pa[kk][i] & 0xFFFF0000u);
      }
    }
    // O += P V, V [keys, D] read N-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = Sw::desc(&sm.v[st][16 * kk][0]);
      if constexpr (D == 64) wgmma_m64n64k16_rs<1>(acc, pa[kk], db);
      else wgmma_m64n32k16_rs<1>(acc, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty_bar[st]);  // this stage may be refilled
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

// cuTensorMapEncodeTiled, reached through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [bh, t, d] bf16, boxes of kBK whole rows of one head in Swizzle<d>;
// out-of-range rows read as zero
bool make_kv_map(CUtensorMap* map, const void* base, int bh, int t, int d) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d), kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                   int tk, int dtype, float kscale, cudaStream_t stream) {
  if (dtype == 1) {
    constexpr int kSmem = sizeof(AttnSmem<D>) + 1024;  // + the 1024-byte alignment
    static bool configured = false;  // the attribute once per instantiation
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          wholek_attention_bf16_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    CUtensorMap kmap, vmap;
    if (!make_kv_map(&kmap, k, bh, tk, D) || !make_kv_map(&vmap, v, bh, tk, D))
      return cudaErrorInvalidValue;
    const dim3 grid((tq + kBQ - 1) / kBQ, bh);
    wholek_attention_bf16_kernel<D, MODE><<<grid, kBf16Threads, kSmem, stream>>>(
        kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), tq,
        tk, kscale);
  } else {
    const dim3 grid((tq + kF32BQ - 1) / kF32BQ, bh);
    // K1b's rounding is the identity in f32
    constexpr int kMode = MODE == kK1b ? kK1 : MODE;
    wholek_attention_f32_kernel<D, kMode><<<grid, kF32BQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), tq, tk, kscale);
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_mode(const void* q, const void* k, const void* v, void* o, int bh,
                        int tq, int tk, int dtype, int mode, float kscale, cudaStream_t s) {
  switch (mode) {
    case kK1: return launch<D, kK1>(q, k, v, o, bh, tq, tk, dtype, kscale, s);
    case kK1SkipMax: return launch<D, kK1SkipMax>(q, k, v, o, bh, tq, tk, dtype, kscale, s);
    case kK1b: return launch<D, kK1b>(q, k, v, o, bh, tq, tk, dtype, kscale, s);
    case kK2: return launch<D, kK2>(q, k, v, o, bh, tq, tk, dtype, kscale, s);
    default: return launch<D, kK2Causal>(q, k, v, o, bh, tq, tk, dtype, kscale, s);
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
  cudaError_t err;
  if (d == 64) err = launch_mode<64>(q, k, v, o, bh, tq, tk, dtype, mode, kscale, s);
  else if (d == 32) err = launch_mode<32>(q, k, v, o, bh, tq, tk, dtype, mode, kscale, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
