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
// by operations too: 2·BH·T²·D at Tq = Tk. In f32 (the trainers, and
// `--compute_type float32`) the same 92.16 GFLOP at B = 8 take 1.376 ms on
// the CUDA cores' 67 TFLOP/s; on the tensor cores as three TF32 products
// (below), 3 × 92.16 GFLOP at 494.7 TFLOP/s = 0.559 ms.
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
//   - f32: error-compensated TF32 ("3xTF32") on wgmma. TF32 keeps 10
//     mantissa bits (2⁻¹¹ relative), too few for f32 work; so each operand
//     is split as x_hi = tf32(x), x_lo = tf32(x − x_hi) (cvt.rna), which
//     leaves x − x_hi − x_lo ≤ 2⁻²² |x|, and each product is taken as
//     a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, dropping a_lo·b_lo (~2⁻²²). The
//     tensor cores multiply TF32 exactly and sum in f32, truncating; so the
//     small terms go first, S starts from zero on every key tile, and each
//     tile's P·V is its own sum from zero, added to the rescaled output on
//     the CUDA cores (to nearest). The error against f64 then stays at the
//     plain f32 version's own (chip_smoke.py's witness holds it within 8×,
//     with plain TF32 as the control outside that limit). A block is two
//     consumer warpgroups (128 query rows, 64 each) and a producer
//     warpgroup, one lane of which keeps 32-key K and V tiles in flight
//     through a ring of three raw f32 stages by TMA; setmaxnreg moves the
//     producer's registers to the consumers (24 and 240 a thread; without
//     it ptxas caps all at 168 and spills). What each trouble of the split
//     needs, and what the kernel does:
//       1. tf32 wgmma takes no transposed operand: A and B must both be
//          K-major. Q·Kᵀ is (K is stored [keys, D]); P·V needs V as
//          [D, keys]. The consumers transpose V's tile in shared memory
//          while they split it (a chunk of 4 keys of one d a task, stored
//          as 16 bytes: no bank conflicts), no pre-pass through memory.
//       2. The 128-byte swizzle spans 32 f32: a D = 64 row is two panels,
//          so a tile is two TMA boxes per operand ({32, 32 keys}), and a
//          k8 step's descriptor starts in panel kk / 4, 32 bytes × (kk % 4)
//          into the row. Vᵀ's rows are the 32 keys: one panel.
//       3. P from registers: S's accumulator holds keys 2·t4 and 2·t4 + 1
//          of each 8 (t4 = lane % 4), the tf32 A fragment wants columns t4
//          and t4 + 4. The P·V sum runs over keys, so column c of a k8
//          step is taken to be key 2c (c < 4) or 2(c − 4) + 1, and Vᵀ's
//          keys are stored in that order (0 2 4 6 1 3 5 7 in each 8) when
//          the tile is split. P is split in registers after the exp2.
//       4. Shared memory: Q stays in registers (its hi and lo A fragments,
//          64 at D = 64); the raw ring (3 × 16 KB), and the split K (hi,
//          lo) and Vᵀ (hi, lo), double-buffered (2 × 32 KB), take 112 KB at
//          D = 64. The split is stored once per tile and read by both
//          warpgroups; tile t + 1 is split while tile t's Q·Kᵀ runs.
//       5. Mode 4 stops at the last key tile the block's rows can see and
//          masks inside the boundary tile, as the bf16 route does.
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
// f32: error-compensated TF32 on wgmma, TMA ring, split in shared memory
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 128;          // query rows per block: two consumer warpgroups
constexpr int kF32BK = 32;           // keys per K/V tile
constexpr int kF32Stages = 3;        // raw K/V ring depth
constexpr int kF32Consumers = 256;   // the two warpgroups
constexpr int kF32Threads = kF32Consumers + 128;  // + the producer warpgroup
// registers a thread: 65536 / 384 = 168 at launch (ptxas' cap), then the
// producer gives its own back (24) and the consumers take them (240):
// 128·24 + 256·240 = 384·168
constexpr int kF32ProducerRegs = 24;
constexpr int kF32ConsumerRegs = 240;

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as f32 bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2⁻²² |x|): hi = tf32(x), lo = tf32(x − hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// f32 tiles in shared memory are rows of 32 floats (128 bytes) in the
// 128-byte swizzle: the 16-byte chunk c of row r sits at c ^ (r % 8), what
// TMA writes in that mode and wgmma reads; a row of D = 64 is two such
// panels. K-major descriptor: 8-row atoms of 1024 bytes (the sbo); a k8
// step advances the start by 32 bytes within the row.
__device__ __forceinline__ uint32_t sw128(int r, int c) {  // byte offset of chunk c of row r
  return r * 128 + ((c ^ (r % 8)) << 4);
}
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[N/8][4] (+)= A(registers) · B(smem), m64nNk8, tf32 in, f32 accumulate;
// both operands K-major (tf32 takes no transpose)
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 64, "m64n32k8 or m64n64k8");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

__device__ __forceinline__ void f32_consumers_sync() {  // named barrier 1: both warpgroups
  asm volatile("bar.sync 1, %0;\n" :: "n"(kF32Consumers) : "memory");
}

template <int D>
struct F32Smem {  // every tile in 128-byte swizzled rows of 32 floats
  float kraw[kF32Stages][D / 32][kF32BK][32];  // TMA: [panel][key][d]
  float vraw[kF32Stages][D / 32][kF32BK][32];
  float khi[2][D / 32][kF32BK][32];            // K split, same layout
  float klo[2][D / 32][kF32BK][32];
  float vhi[2][D][kF32BK];                     // Vᵀ split: [d][key], keys permuted
  float vlo[2][D][kF32BK];
};

// One raw K/V tile (ring stage st) into split buffer b, by the 256
// consumer threads: K element by element at the same offsets; V transposed
// to [d][key] with the keys of each group of 8 in the order 0 2 4 6 1 3 5 7
// (the P fragment's, see the header), one 16-byte chunk of 4 keys a task.
template <int D>
__device__ __forceinline__ void split_kv_tile(F32Smem<D>& sm, int st, int b, int tid) {
  constexpr int kChunks = D / 32 * kF32BK * 8;  // 16-byte chunks of a K tile
  const float4* kr = reinterpret_cast<const float4*>(&sm.kraw[st][0][0][0]);
  uint4* kh = reinterpret_cast<uint4*>(&sm.khi[b][0][0][0]);
  uint4* kl = reinterpret_cast<uint4*>(&sm.klo[b][0][0][0]);
  static_assert(kChunks % kF32Consumers == 0 && D * 8 % kF32Consumers == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < kChunks / kF32Consumers; ++pass) {
    const int i = tid + pass * kF32Consumers;
    const float4 x = kr[i];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    kh[i] = h;
    kl[i] = l;
  }
  const unsigned char* vr = reinterpret_cast<const unsigned char*>(&sm.vraw[st][0][0][0]);
  unsigned char* vh = reinterpret_cast<unsigned char*>(&sm.vhi[b][0][0]);
  unsigned char* vl = reinterpret_cast<unsigned char*>(&sm.vlo[b][0][0]);
#pragma unroll
  for (int pass = 0; pass < D * 8 / kF32Consumers; ++pass) {
    const int task = tid + pass * kF32Consumers;
    const int d = task % D;  // a warp: 32 consecutive d of one panel
    const int m = task / D;  // the chunk of Vᵀ's row: keys 8(m/2) + (m%2) + {0, 2, 4, 6}
    const int key0 = 8 * (m / 2) + (m % 2);
    const int p = d / 32, cc = d % 32;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + 2 * i;
      const float x = *reinterpret_cast<const float*>(
          vr + p * (kF32BK * 128) + sw128(key, cc / 4) + (cc % 4) * 4);
      split_tf32(x, h[i], l[i]);
    }
    *reinterpret_cast<uint4*>(vh + sw128(d, m)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(vl + sw128(d, m)) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(kF32Threads, 1)
wholek_attention_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ q, float* __restrict__ o,
                            int tq, int tk, float kscale) {
  constexpr bool SKIP_MAX = MODE == kK1SkipMax;
  constexpr int kS = kF32BK / 8;  // n8 score tiles (and k8 steps of P·V) per key tile
  constexpr int kO = D / 8;       // n8 output tiles (and k8 steps of Q·Kᵀ)
  constexpr uint32_t kTileBytes = 2u * kF32BK * D * sizeof(float);  // K and V
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<F32Smem<D>*>(  // the swizzle atoms: 1024-byte aligned
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full_bar[kF32Stages];
  __shared__ __align__(8) uint64_t empty_bar[kF32Stages];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kF32BQ;
  const int k_end = key_end<MODE>(min(q0 + kF32BQ, tq), tq, tk);
  const int tiles = (k_end + kF32BK - 1) / kF32BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kF32Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kF32Consumers) {
    // the producer warpgroup: one lane keeps the raw ring full, a box per panel
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kF32ProducerRegs));
    if (threadIdx.x == kF32Consumers) {
      for (int t = 0; t < tiles; ++t) {
        const int st = t % kF32Stages;
        if (t >= kF32Stages) mbar_wait(&empty_bar[st], ((t / kF32Stages) - 1) & 1);
        mbar_arrive_expect_tx(&full_bar[st], kTileBytes);
#pragma unroll
        for (int p = 0; p < D / 32; ++p) {
          tma_load_3d(&sm.kraw[st][p][0][0], &kmap, &full_bar[st], 32 * p, t * kF32BK, bh);
          tma_load_3d(&sm.vraw[st][p][0][0], &vmap, &full_bar[st], 32 * p, t * kF32BK, bh);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kF32ConsumerRegs));

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this thread's two rows: g and g + 8 of its warp's 16 in its warpgroup's 64
  const int row0 = q0 + (tid / 128) * 64 + ((tid / 32) % 4) * 16 + g;

  // Q, scaled in f32 and split, as the A fragments of the k8 steps over D:
  // a0 (row g, col t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
  uint32_t qh[kO][4], ql[kO][4];
  const float* qb = q + static_cast<size_t>(bh) * tq * D;
#pragma unroll
  for (int kk = 0; kk < kO; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 8 * (i % 2);
      const float x = r < tq ? qb[static_cast<size_t>(r) * D + 8 * kk + t4 + 4 * (i / 2)] * kscale : 0.f;
      split_tf32(x, qh[kk][i], ql[kk][i]);
    }
  }

  mbar_wait(&full_bar[0], 0);
  split_kv_tile<D>(sm, 0, 0, tid);
  mbar_arrive(&empty_bar[0]);
  fence_proxy_async();  // the generic stores, visible to wgmma
  f32_consumers_sync();

  float acc[kO][4];
#pragma unroll
  for (int j = 0; j < kO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {SKIP_MAX ? 0.f : -CUDART_INF_F, SKIP_MAX ? 0.f : -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  for (int t = 0; t < tiles; ++t) {
    const int b = t % 2;
    const int k0 = t * kF32BK;
    const int n = min(kF32BK, tk - k0);

    // S = Q Kᵀ, [64, 32] per warpgroup: the small products (lo·hi, hi·lo)
    // first, then hi·hi, all into one accumulator from zero
    float s[kS][4];
#pragma unroll
    for (int j = 0; j < kS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kO; ++kk)
      wgmma_tf32_rs<kF32BK>(s, ql[kk], desc_sw128(&sm.khi[b][kk / 4][0][8 * (kk % 4)]), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kO; ++kk)
      wgmma_tf32_rs<kF32BK>(s, qh[kk], desc_sw128(&sm.klo[b][kk / 4][0][8 * (kk % 4)]), 1);
#pragma unroll
    for (int kk = 0; kk < kO; ++kk)
      wgmma_tf32_rs<kF32BK>(s, qh[kk], desc_sw128(&sm.khi[b][kk / 4][0][8 * (kk % 4)]), 1);
    wgmma_commit();

    // while the products run: split the next tile into the other buffer
    if (t + 1 < tiles) {
      const int st = (t + 1) % kF32Stages;
      mbar_wait(&full_bar[st], ((t + 1) / kF32Stages) & 1);
      split_kv_tile<D>(sm, st, b ^ 1, tid);
      mbar_arrive(&empty_bar[st]);  // this stage may be refilled
    }
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax over this tile; padded keys weigh exp2(-inf) = 0
    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t4 * 2 + (e % 2);
        if (key >= n) s[j][e] = -CUDART_INF_F;
        if (MODE == kK2Causal && k0 + key > row0 + 8 * (e / 2) + (tk - tq)) s[j][e] = -CUDART_INF_F;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], s[j][e]);
      }
    }
    float m_new[2] = {m[0], m[1]};
    float alpha[2] = {1.f, 1.f};
    if (!SKIP_MAX) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        m_new[r] = fmaxf(m[r], tile_max[r]);
        alpha[r] = exp2f(m[r] - m_new[r]);  // 0 on the first tile
        l[r] *= alpha[r];
        m[r] = m_new[r];
      }
    }
    // P, split, as the A fragments of the k8 steps over this tile's keys:
    // s[j] holds keys 8j + 2·t4 + {0, 1} of rows g, g + 8; the fragment
    // wants columns t4 and t4 + 4, so column c of a step is key 2c (c < 4)
    // or 2(c − 4) + 1, the order V's rows were written in
    uint32_t ph[kS][4], pl[kS][4];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_new[e / 2]);
        l[e / 2] += p;
        const int a = e == 1 ? 2 : e == 2 ? 1 : e;
        split_tf32(p, ph[j][a], pl[j][a]);
      }
    }

    // this tile's P·V from zero (lo·hi, hi·lo, then hi·hi), added to the
    // rescaled accumulator on the CUDA cores
    float pv[kO][4];
#pragma unroll
    for (int j = 0; j < kO; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kS; ++j) wgmma_tf32_rs<D>(pv, pl[j], desc_sw128(&sm.vhi[b][0][8 * j]), j > 0);
#pragma unroll
    for (int j = 0; j < kS; ++j) wgmma_tf32_rs<D>(pv, ph[j], desc_sw128(&sm.vlo[b][0][8 * j]), 1);
#pragma unroll
    for (int j = 0; j < kS; ++j) wgmma_tf32_rs<D>(pv, ph[j], desc_sw128(&sm.vhi[b][0][8 * j]), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int j = 0; j < kO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], alpha[e / 2], pv[j][e]);

    fence_proxy_async();  // the next tile's split, visible to wgmma
    f32_consumers_sync();  // and this tile's buffers free for the one after
  }

  // normalise and store this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (MODE >= kK2) l[r] = fmaxf(l[r], 1e-20f);
    const int row = row0 + 8 * r;
    if (row < tq) {
      float* orow = o + (static_cast<size_t>(bh) * tq + row) * D;
#pragma unroll
      for (int j = 0; j < kO; ++j)
        *reinterpret_cast<float2*>(&orow[j * 8 + t4 * 2]) =
            make_float2(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
    }
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

// [bh, t, d] of one head's keys or values; out-of-range rows read as zero.
// bf16: boxes of kBK whole rows in Swizzle<d>; f32: boxes of kF32BK rows
// of 32 floats, one per 128-byte panel, in the 128-byte swizzle
bool make_kv_map(CUtensorMap* map, const void* base, int bh, int t, int d, int dtype) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const bool f32 = dtype == 0;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * esize,
                                 static_cast<cuuint64_t>(t) * d * esize};
  const cuuint32_t box[3] = {f32 ? 32u : static_cast<cuuint32_t>(d),
                             static_cast<cuuint32_t>(f32 ? kF32BK : kBK), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 || d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory attribute, once per kernel instantiation
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

template <int D, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                   int tk, int dtype, float kscale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!make_kv_map(&kmap, k, bh, tk, D, dtype) || !make_kv_map(&vmap, v, bh, tk, D, dtype))
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    constexpr int kSmem = sizeof(AttnSmem<D>) + 1024;  // + the 1024-byte alignment
    static bool configured = false;
    const cudaError_t err = set_smem(wholek_attention_bf16_kernel<D, MODE>, kSmem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kBQ - 1) / kBQ, bh);
    wholek_attention_bf16_kernel<D, MODE><<<grid, kBf16Threads, kSmem, stream>>>(
        kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), tq,
        tk, kscale);
  } else {
    // K1b's rounding is the identity in f32
    constexpr int kMode = MODE == kK1b ? kK1 : MODE;
    constexpr int kSmem = sizeof(F32Smem<D>) + 1024;
    static bool configured = false;
    const cudaError_t err = set_smem(wholek_attention_f32_kernel<D, kMode>, kSmem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + kF32BQ - 1) / kF32BQ, bh);
    wholek_attention_f32_kernel<D, kMode><<<grid, kF32Threads, kSmem, stream>>>(
        kmap, vmap, static_cast<const float*>(q), static_cast<float*>(o), tq, tk, kscale);
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
