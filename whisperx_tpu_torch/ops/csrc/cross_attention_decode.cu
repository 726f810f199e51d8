// K3, K3kt, K3i8: cross-attention of one decode step over the int8 cross
// K/V cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels of whisperx_tpu/ops/cross_attention_decode.py:
//   K3    _kernel     (:57,  through _cross_decode_pallas,    :113)
//   K3kt  _kernel_kt  (:148, through _cross_decode_pallas_kt, :197)
//   K3i8  _kernel_i8  (:232, through _cross_decode_pallas_i8, :283)
// For one query per batch row, packed K/V [B, T, D = H·Dh] int8 (K3kt: K
// transposed to [B, D, T]) and a query whose head h owns the columns
// [h·Dh, (h+1)·Dh), it computes, per head,
//     out[b, h·Dh + d] = Σ_t softmax_t(s[b, h, t]) · v[b, t, h·Dh + d]
// with s = q·kᵀ in f32 (K3i8: an exact int32 dot of int8 q and k, times the
// head's f32 query scale). The softmax is the TPU kernel's recurrence over
// T tiles of 512: natural exp, a running max, l summing the unrounded p,
// P rounded to bf16 before P·V (f32 accumulation), the overhanging tile's
// keys masked, and out = acc / max(l, 1e-20).
//
// What bounds it on this card. Each K and V byte is read once and used in
// one multiply-add: 2·B·T·D bytes (30.72 MB at the large-v3 decode step,
// B 8, T 1500, D 1280) against 4·B·T·D operations. At under one operation
// per byte it is bound by memory: 0.0092 ms at 3.35 TB/s.
//
// What the design does about it. One thread-block cluster per (b, h) splits
// T: block rank r of the cluster owns a sub-split of `split` keys (64 to
// 512, never across a 512-key TPU tile), or, when T needs more than 8
// sub-splits, `chunks_per_block` whole tiles walked in order. Grid
// (S·H, B), S ≤ 8 blocks a cluster (launch_plan in cross_attention_decode.py
// picks the split): 960 blocks at the decode step, where one block per
// (h, b) gave 160 on 132 SMs. At entry a block issues its whole sub-split's
// K into shared memory with cp.async, as pieces of 64 keys, one slot each;
// as soon as a piece's scores are done its slot takes the same keys' V, so
// V's load lies under the scores and the exchange. K and V share the
// slots: 17 KB a block at the decode step (K and V side by side took 33 KB
// and left the last sixth of the blocks for a second wave; V issued with K
// delayed K, which gates the exchange), 128 threads, at most 64 registers,
// so that every block of the decode step is resident at once.
//
// Sharing the TPU's running max. The TPU rounds P to bf16 against the
// running max after each tile, and the result must stay within 1e-2 of
// that arithmetic; a free split (each block against its own max, merged at
// the end) falls outside it (tests/test_torch_cross_decode.py emulates
// both). So each
// block publishes its sub-split's max in its shared memory, the cluster
// synchronises, and each block reads, through distributed shared memory,
// the maxima of every rank whose tile is not after its own: that is the
// TPU's running max m_j after the block's tile j. p = exp(s - m_j) is
// summed unrounded into l, and bf16(p)·v into acc. Each block stores
// (l, acc, m_j) into rank 0's shared memory; after a second cluster barrier
// rank 0 sums each tile's sub-splits in rank order, applies the TPU's
// recurrence over tiles, acc ← acc·exp(m_{j-1} - m_j) + acc_j, and writes
// acc / max(l, 1e-20). Every access to another block's memory lies between
// the two barriers, so none outlives its block. One launch, no workspace,
// no float atomics: the result is deterministic and differs from the plain
// version only in the order of f32 sums.
//
// Inside a block: int8 values widen to f32 exactly by a byte permute into
// the mantissa of 2^23 and one subtraction (the conversion instruction
// runs at a quarter of the FMA rate). Scores: Dh/16 neighbouring threads
// read one key row's 16-byte pieces and reduce with shuffles (K3kt: each
// thread reads a word of 4 keys from a row of the transposed slice, eight
// threads split Dh and reduce with shuffles); P·V: the same row mapping
// over V, each thread keeping 16 output columns in registers, reduced
// across rows by shuffles and across warps in a fixed order.
//
// K3kt's load: K's rows along T start at any byte when T % 16 != 0 (T 1500
// at the decode step), which neither TMA nor a 16-byte copy can address.
// Each row's run is fetched as the aligned 16-byte windows that cover it,
// and the scores read it from its offset in the window (when T % 4 == 0,
// every offset is a whole word; otherwise two words and a byte permute).
//
// Dh is 32 or 64. Pointers are 16-byte aligned and D is a multiple of 16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // per SM: 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;      // the TPU kernel's T tile
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kPiece = 64;      // keys of a slot
constexpr int kKtRow = 80;      // K3kt: bytes of a key row in a slot (64 keys and their windows)
constexpr int kFull = 0xffffffff;

__host__ __device__ constexpr int slot_bytes(int dh, bool kt) { return kt ? dh * kKtRow : kPiece * dh; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  __syncthreads();  // red may still be read by the previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = fmaxf(x, red[w]);
  return x;
}

// the four int8 values of a word, exactly, as f32: each byte, biased to
// unsigned, becomes the low mantissa byte of 2^23
__device__ __forceinline__ void widen4(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// all but the newest `pending` groups of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all_but(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// m ≤ 64 key rows of a head's Dh columns (src: the first row's, rows
// d_model bytes apart) into a slot [m][DH]
template <int DH>
__device__ __forceinline__ void load_rows(int8_t* slot, const int8_t* src, int d_model, int m) {
  constexpr int kPieces = DH / 16;
  for (int i = threadIdx.x; i < m * kPieces; i += kThreads)
    cp_async16(slot + i * 16, src + static_cast<long long>(i / kPieces) * d_model + (i % kPieces) * 16);
}

// K3kt: keys [0, m) of a head's Dh rows of [.., D, T] (src: row 0's first
// key, rows t_total bytes apart), as the aligned 16-byte windows that cover
// each row, into a slot [DH][kKtRow]; a row's first key lands at the byte
// its address has past 16, the same for every piece of the row
template <int DH>
__device__ __forceinline__ void load_kt(int8_t* slot, const int8_t* src, int t_total, int m) {
  const int windows = (15 + m + 15) / 16;  // the most a row needs: 5 at 64 keys
  for (int i = threadIdx.x; i < DH * windows; i += kThreads) {
    const int d = i / windows, w = i % windows;
    const int8_t* start = src + static_cast<long long>(d) * t_total;
    const int o = static_cast<int>(reinterpret_cast<uintptr_t>(start) & 15);
    if (w < (o + m + 15) / 16) cp_async16(slot + d * kKtRow + w * 16, start - o + w * 16);
  }
}

// the query values a thread's scores use: its 16 columns of the head (K3i8:
// packed 4 to a word for __dp4a); K3kt: the rows d ≡ tid (mod 8)
template <int DH, bool KT, bool QI8>
struct Query {
  float f[KT ? DH / 8 : 16];
  int w[4];

  __device__ __forceinline__ void load(const void* q) {
    if constexpr (QI8) {
      const int8_t* qp = static_cast<const int8_t*>(q) + threadIdx.x % (DH / 16) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = (qp[4 * i] & 0xff) | ((qp[4 * i + 1] & 0xff) << 8) |
               ((qp[4 * i + 2] & 0xff) << 16) | ((qp[4 * i + 3] & 0xff) << 24);
      }
    } else if constexpr (KT) {
      const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) f[i] = __bfloat162float(qp[threadIdx.x % 8 + 8 * i]);
    } else {
      const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q) + threadIdx.x % (DH / 16) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = __bfloat162float(qp[i]);
    }
  }
};

// scores of the m ≤ 64 keys of a slot of K rows into s_out; returns this
// thread's max over the keys it wrote (-inf if none)
template <int DH, bool QI8>
__device__ __forceinline__ float scores_rows(const int8_t* slot, float* s_out, int m,
                                             const Query<DH, false, QI8>& q, float qscale) {
  constexpr int kTPK = DH / 16;  // threads per key row
  constexpr int kRows = kThreads / kTPK;
  const int part = threadIdx.x % kTPK;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int r0 = 0; r0 < kPiece; r0 += kRows) {
    const int r = r0 + static_cast<int>(threadIdx.x) / kTPK;
    int4 kr = make_int4(0, 0, 0, 0);
    if (r < m) kr = *reinterpret_cast<const int4*>(slot + r * DH + part * 16);
    const int words[4] = {kr.x, kr.y, kr.z, kr.w};
    float s;
    if constexpr (QI8) {
      int dot = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) dot = __dp4a(words[w], q.w[w], dot);
#pragma unroll
      for (int o = 1; o < kTPK; o *= 2) dot += __shfl_xor_sync(kFull, dot, o);
      s = static_cast<float>(dot) * qscale;
    } else {
      float part_sum[4];  // four independent chains, added in a fixed order
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float f[4];
        widen4(static_cast<uint32_t>(words[w]), f);
        part_sum[w] = q.f[4 * w] * f[0];
#pragma unroll
        for (int j = 1; j < 4; ++j) part_sum[w] = fmaf(q.f[4 * w + j], f[j], part_sum[w]);
      }
      s = (part_sum[0] + part_sum[1]) + (part_sum[2] + part_sum[3]);
#pragma unroll
      for (int o = 1; o < kTPK; o *= 2) s += __shfl_xor_sync(kFull, s, o);
    }
    if (r < m) {
      mx = fmaxf(mx, s);
      if (part == 0) s_out[r] = s;
    }
  }
  return mx;
}

// K3kt: scores of the m ≤ 64 keys of a slot of the transposed slice; eight
// neighbouring threads take the rows d ≡ 0..7 (mod 8) of the same 4 keys
// (a row of 80 bytes puts the eight rows of a word on distinct banks);
// off[d]: where row d's first key lies in its slot row
template <int DH>
__device__ __forceinline__ float scores_kt(const int8_t* slot, const int* off, float* s_out,
                                           int m, const Query<DH, true, false>& q, bool aligned4) {
  static_assert(kThreads == 8 * kPiece / 4, "one thread per (word of 4 keys, row residue)");
  const int dp = threadIdx.x % 8;
  const int w = threadIdx.x / 8;  // keys 4w .. 4w + 3
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
  if (4 * w < m) {
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int d = dp + 8 * i;
      const int8_t* row = slot + d * kKtRow;
      const int o = off[d] + 4 * w;
      uint32_t word = *reinterpret_cast<const uint32_t*>(row + (o & ~3));
      if (!aligned4) {
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(row + (o & ~3) + 4);
        word = __byte_perm(word, hi, 0x3210 + 0x1111 * (o & 3));
      }
      float f[4];
      widen4(word, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) s4[j] = fmaf(q.f[i], f[j], s4[j]);
    }
  }
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int o = 1; o < 8; o *= 2) s4[j] += __shfl_xor_sync(kFull, s4[j], o);
    if (dp == 0 && 4 * w + j < m) {
      s_out[4 * w + j] = s4[j];
      mx = fmaxf(mx, s4[j]);
    }
  }
  return mx;
}

// the tile of the last chunk of rank r
__device__ __forceinline__ int last_tile(int r, int cpb, int n_chunks, int split) {
  return (min((r + 1) * cpb, n_chunks) - 1) * split / kTile;
}

// KT: K laid out [B, D, T]. QI8: q int8 with a per-(b, h) f32 scale.
// MULTI: each block walks chunks_per_block > 1 whole tiles.
template <int DH, bool KT, bool QI8, bool MULTI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_decode_kernel(const void* __restrict__ q, const float* __restrict__ sq,
                    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                    float* __restrict__ out, int t_total, int n_head,
                    long long q_batch_stride, long long q_head_stride,
                    int split, int chunks_per_block, int aligned4) {
  constexpr int kTPK = DH / 16;                 // threads per key row
  constexpr int kRowsPerPass = kThreads / kTPK;  // key rows per pass
  constexpr int kSlot = slot_bytes(DH, KT);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ int kt_off[DH];
  __shared__ float own_max_sh;  // read by the other ranks
  // rank 0's: each rank's (acc, l, running max), stored by that rank
  __shared__ float recv_acc[kMaxCluster][DH];
  __shared__ float recv_l[kMaxCluster], recv_m[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / n_ranks;
  const int b = blockIdx.y;
  const int d_model = n_head * DH;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int part = tid % kTPK;  // which 16 columns of the head's slice
  const int row = tid / kTPK;   // which key row of a pass
  const int n_chunks = (t_total + split - 1) / split;
  const int c_begin = rank * chunks_per_block;
  const int c_end = min(c_begin + chunks_per_block, n_chunks);

  int8_t* slots = reinterpret_cast<int8_t*>(smem);  // split / 64 of them
  float* s_sh = reinterpret_cast<float*>(slots + split / kPiece * kSlot);  // scores, then bf16(p)
  float* cmax_sh = s_sh + split;  // MULTI: each chunk's max

  const long long head_col = static_cast<long long>(h) * DH;
  const long long k_row0 = static_cast<long long>(b) * d_model + head_col;  // K3kt: row of d = 0
  const int8_t* kb = KT ? k + k_row0 * t_total
                        : k + static_cast<long long>(b) * t_total * d_model + head_col;
  const int8_t* vb = v + static_cast<long long>(b) * t_total * d_model + head_col;
  const void* qh = static_cast<const int8_t*>(q) +
                   (b * q_batch_stride + h * q_head_stride + head_col) * (QI8 ? 1 : 2);
  const float qscale = QI8 ? sq[static_cast<long long>(b) * n_head + h] : 1.f;
  Query<DH, KT, QI8> qv;
  qv.load(qh);
  if (KT && tid < DH) kt_off[tid] = static_cast<int>(((k_row0 + tid) * t_total) & 15);

  // K of the chunk at t0 (n keys) through the slots, its scores into s_sh;
  // with_v: as each piece's scores are done, its V goes into the slot.
  // Returns this thread's max over the scores it wrote.
  auto chunk_pass = [&](int t0, int n, bool with_v) -> float {
    const int pieces = (n + kPiece - 1) / kPiece;
    for (int i = 0; i < pieces; ++i) {
      const int m = min(kPiece, n - i * kPiece);
      if constexpr (KT) load_kt<DH>(slots + i * kSlot, kb + t0 + i * kPiece, t_total, m);
      else load_rows<DH>(slots + i * kSlot, kb + static_cast<long long>(t0 + i * kPiece) * d_model, d_model, m);
      cp_async_commit();
    }
    if (!with_v) {
      cp_async_wait<0>();
      __syncthreads();
    }
    float mx = -CUDART_INF_F;
    for (int i = 0; i < pieces; ++i) {
      const int m = min(kPiece, n - i * kPiece);
      if (with_v) {  // behind K piece i: the later K pieces and the earlier V pieces
        cp_async_wait_all_but(pieces - 1);
        __syncthreads();
      }
      float pm;
      if constexpr (KT) pm = scores_kt<DH>(slots + i * kSlot, kt_off, s_sh + i * kPiece, m, qv, aligned4 != 0);
      else pm = scores_rows<DH, QI8>(slots + i * kSlot, s_sh + i * kPiece, m, qv, qscale);
      mx = fmaxf(mx, pm);
      if (with_v) {
        __syncthreads();  // the slot's K has been read
        load_rows<DH>(slots + i * kSlot, vb + static_cast<long long>(t0 + i * kPiece) * d_model, d_model, m);
        cp_async_commit();
      }
    }
    return mx;
  };

  // p = exp(s - m) against the running max m of the chunk's tile, l summing
  // it unrounded, acc += bf16(p) · V, after acc and l are scaled by alpha
  float l_part = 0.f;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  auto softmax_pv = [&](int n, float m, float alpha) {
    float psum = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      const float p = expf(s_sh[j] - m);
      psum += p;
      s_sh[j] = round_bf16(p);
    }
    l_part = l_part * alpha + psum;
    cp_async_wait<0>();
    __syncthreads();  // V and bf16(p) are visible
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int r = row; r < n; r += kRowsPerPass) {
      const float p = s_sh[r];
      const int4 vr = *reinterpret_cast<const int4*>(slots + (r / kPiece) * kSlot + (r % kPiece) * DH + part * 16);
      const int words[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float f[4];
        widen4(static_cast<uint32_t>(words[w]), f);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * w + j] = fmaf(p, f[j], acc[4 * w + j]);
      }
    }
  };

  // the TPU's running max before this block's first tile: every other rank
  // whose tiles are not after it (lane i reads rank i)
  auto running_max_of_others = [&]() -> float {
    float m = -CUDART_INF_F;
    if (lane < n_ranks && lane != rank &&
        last_tile(lane, chunks_per_block, n_chunks, split) <= c_begin * split / kTile)
      m = *cluster.map_shared_rank(&own_max_sh, lane);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    return m;
  };

  float m_last;  // the running max of the block's last tile
  if constexpr (!MULTI) {
    // one chunk: its K, then its V in the same slots, in flight through the
    // scores and the exchange of maxima
    const int t0 = c_begin * split, n = min(split, t_total - t0);
    const float own_max = block_max(chunk_pass(t0, n, true), red);  // its barriers publish s_sh
    if (tid == 0) own_max_sh = own_max;
    cluster.sync();  // every block has started, and published its max
    m_last = fmaxf(running_max_of_others(), own_max);
    softmax_pv(n, m_last, 0.f);
  } else {
    // whole tiles: each tile's max first, then each tile again, K and V
    float own_max = -CUDART_INF_F;
    for (int c = c_begin; c < c_end; ++c) {
      const int t0 = c * split, n = min(split, t_total - t0);
      const float cm = block_max(chunk_pass(t0, n, false), red);  // its barriers free the slots
      if (tid == 0) cmax_sh[c - c_begin] = cm;
      own_max = fmaxf(own_max, cm);
    }
    if (tid == 0) own_max_sh = own_max;
    cluster.sync();
    float m_run = running_max_of_others();
    float m_prev = -CUDART_INF_F;
    for (int c = c_begin; c < c_end; ++c) {
      const int t0 = c * split, n = min(split, t_total - t0);
      __syncthreads();  // the previous tile's V and p have been read
      chunk_pass(t0, n, true);  // the same scores, bit for bit
      __syncthreads();
      m_run = fmaxf(m_run, cmax_sh[c - c_begin]);
      softmax_pv(n, m_run, expf(m_prev - m_run));  // alpha 0 on the first tile
      m_prev = m_run;
    }
    m_last = m_prev;
  }

  // the block's (l, acc): rows of a warp by shuffles, warps in order (in
  // the slots, which P·V has finished reading), stored into rank 0's
  // shared memory
#pragma unroll
  for (int o = kTPK; o < 32; o *= 2) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], o);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) l_part += __shfl_xor_sync(kFull, l_part, o);
  float* acc_red = reinterpret_cast<float*>(slots);  // [kWarps][DH]
  __syncthreads();  // every warp is done with the slots and red
  if (lane < kTPK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc_red[warp * DH + lane * 16 + i] = acc[i];
  }
  if (lane == 0) red[warp] = l_part;
  __syncthreads();
  if (tid < DH) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += acc_red[w * DH + tid];
    *cluster.map_shared_rank(&recv_acc[rank][tid], 0) = a;
  }
  if (tid == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += red[w];
    *cluster.map_shared_rank(&recv_l[rank], 0) = l;
    *cluster.map_shared_rank(&recv_m[rank], 0) = m_last;
  }
  cluster.sync();  // the partials have landed; rank 0 reads only its own memory
  if (rank != 0 || tid >= DH) return;

  // rank 0: each tile's sub-splits summed in rank order, then the TPU's
  // recurrence over the tiles in order
  float l = 0.f, a = 0.f, m = -CUDART_INF_F;
  float gl = 0.f, ga = 0.f, gm = -CUDART_INF_F;
  int g_tile = -1;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r >= n_ranks) break;
    const int tile = last_tile(r, chunks_per_block, n_chunks, split);
    if (tile != g_tile) {
      if (g_tile >= 0) {
        const float alpha = expf(m - gm);
        l = l * alpha + gl;
        a = a * alpha + ga;
        m = gm;
      }
      g_tile = tile;
      gl = ga = 0.f;
      gm = recv_m[r];
    }
    gl += recv_l[r];
    ga += recv_acc[r][tid];
  }
  const float alpha = expf(m - gm);
  l = l * alpha + gl;
  a = a * alpha + ga;
  out[static_cast<long long>(b) * d_model + head_col + tid] = a / fmaxf(l, 1e-20f);
}

size_t smem_bytes(int dh, int split, int chunks_per_block, bool kt) {
  return static_cast<size_t>(split / kPiece) * slot_bytes(dh, kt) + 4 * static_cast<size_t>(split) +
         4 * static_cast<size_t>(chunks_per_block);
}

template <int DH, bool KT, bool QI8, bool MULTI>
int launch(const void* q, const float* sq, const int8_t* k, const int8_t* v, float* out,
           int b, int t, int h, long long q_sb, long long q_sh, int split, int cpb,
           int cluster, cudaStream_t stream) {
  auto kernel = cross_decode_kernel<DH, KT, QI8, MULTI>;
  const size_t smem = smem_bytes(DH, split, cpb, KT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * h), static_cast<unsigned>(b), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int aligned4 = t % 4 == 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, q, sq, k, v, out, t, h, q_sb, q_sh,
                                           split, cpb, aligned4);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool MULTI>
int launch_mode(const void* q, const float* sq, const int8_t* k, const int8_t* v, float* out,
                int b, int t, int h, long long q_sb, long long q_sh, int k_transposed,
                int q_int8, int split, int cpb, int cluster, cudaStream_t s) {
  if (q_int8 && k_transposed) return static_cast<int>(cudaErrorInvalidValue);
  if (q_int8)
    return launch<DH, false, true, MULTI>(q, sq, k, v, out, b, t, h, q_sb, q_sh, split, cpb,
                                          cluster, s);
  if (k_transposed)
    return launch<DH, true, false, MULTI>(q, sq, k, v, out, b, t, h, q_sb, q_sh, split, cpb,
                                          cluster, s);
  return launch<DH, false, false, MULTI>(q, sq, k, v, out, b, t, h, q_sb, q_sh, split, cpb,
                                         cluster, s);
}

template <int DH>
int launch_dh(const void* q, const float* sq, const int8_t* k, const int8_t* v, float* out,
              int b, int t, int h, long long q_sb, long long q_sh, int k_transposed,
              int q_int8, int split, int cpb, int cluster, cudaStream_t s) {
  if (cpb > 1)
    return launch_mode<DH, true>(q, sq, k, v, out, b, t, h, q_sb, q_sh, k_transposed, q_int8,
                                 split, cpb, cluster, s);
  return launch_mode<DH, false>(q, sq, k, v, out, b, t, h, q_sb, q_sh, k_transposed, q_int8,
                                split, cpb, cluster, s);
}

}  // namespace

// q: bf16 (q_int8 = 0) or int8 (q_int8 = 1); head h of batch row b starts at
// element b·q_batch_stride + h·q_head_stride + h·dh (a packed [B, D] query
// has strides (D, 0), a spread [B, H, D] one (H·D, D)). sq: [B, H] f32 query
// scales (q_int8 only). k: [B, T, D] int8, or [B, D, T] with k_transposed;
// v: [B, T, D] int8; out: [B, D] f32. The plan (launch_plan in
// cross_attention_decode.py): sub-splits of `split` keys (64, 128, 256 or
// 512), `chunks_per_block` of them per block (more than one only at 512),
// `cluster` blocks per (b, h), every block with at least one chunk.
// Returns the launch's cudaError_t.
extern "C" int cross_attention_decode(const void* q, const void* sq, const void* k,
                                      const void* v, void* out, int b, int t, int h,
                                      int dh, long long q_batch_stride,
                                      long long q_head_stride, int k_transposed,
                                      int q_int8, int split, int chunks_per_block,
                                      int cluster, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool split_ok = split == 64 || split == 128 || split == 256 || split == kTile;
  const long long per_block = static_cast<long long>(split) * chunks_per_block;
  if (!split_ok || chunks_per_block < 1 || (chunks_per_block > 1 && split != kTile) ||
      cluster < 1 || cluster > kMaxCluster || per_block * cluster < t ||
      per_block * (cluster - 1) >= t)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sqf = static_cast<const float*>(sq);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  float* o = static_cast<float*>(out);
  if (dh == 64)
    return launch_dh<64>(q, sqf, kp, vp, o, b, t, h, q_batch_stride, q_head_stride,
                         k_transposed, q_int8, split, chunks_per_block, cluster, s);
  if (dh == 32)
    return launch_dh<32>(q, sqf, kp, vp, o, b, t, h, q_batch_stride, q_head_stride,
                         k_transposed, q_int8, split, chunks_per_block, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
