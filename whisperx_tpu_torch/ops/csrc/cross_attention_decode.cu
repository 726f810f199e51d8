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
// What the design does about it. The TPU fed the MXU with block-diagonal
// "spread" queries (H× zeros) and selected each head's output at the end;
// on the card each head's score is the dot product of its own Dh slice, and
// each head's output is written by its own block: grid (H, B), 256 threads.
// A block walks T in the TPU's 512-key tiles in order, so every P is
// rounded against the same running max as on the TPU and the result
// differs from the plain version only in the order of f32 sums. Within a
// tile the block's threads split the keys: Dh/16 neighbouring threads read
// one key row's head slice as 16-byte loads (a warp reads 8 whole 64-byte
// row slices, coalesced), reduce their partial dots with shuffles, and the
// same mapping reads V for P·V, each thread keeping 16 output columns of
// its rows in registers until a final reduction through shared memory.
// Products of bf16 q (or bf16 p) with int8 values are exact in f32. At the
// decode step this gives B·H = 160 blocks, about one per SM. Still to do for
// speed (a later optimisation): split T across blocks when B·H is small,
// and deeper load pipelining.
//
// Dh is 32 or 64. Pointers are 16-byte aligned and D is a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // the TPU kernel's T tile
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // red may still be read by the previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) x = fmaxf(x, red[w]);
  return x;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) x += red[w];
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// KT: K laid out [B, D, T]. QI8: q int8 with a per-(b, h) f32 scale.
template <int DH, bool KT, bool QI8>
__global__ void __launch_bounds__(kThreads)
cross_decode_kernel(const void* __restrict__ q, const float* __restrict__ sq,
                    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                    float* __restrict__ out, int t_total, int n_head,
                    long long q_batch_stride, long long q_head_stride) {
  constexpr int kTPK = DH / 16;                 // threads per key row
  constexpr int kRowsPerPass = kThreads / kTPK;  // key rows per pass
  constexpr int kPasses = kTile / kRowsPerPass;
  __shared__ float p_sh[kTile];
  __shared__ float red[kWarpsPerBlock];
  __shared__ float q_sh[DH];  // K3kt: the head's query, read as broadcasts
  __shared__ float acc_sh[kRowsPerPass][DH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = n_head * DH;
  const int tid = threadIdx.x;
  const int part = tid % kTPK;  // which 16 columns of the head's slice
  const int row = tid / kTPK;   // which key row of a pass
  const long long col0 = static_cast<long long>(h) * DH + part * 16;
  const int8_t* kb = k + static_cast<long long>(b) * t_total * d_model;
  const int8_t* vb = v + static_cast<long long>(b) * t_total * d_model;
  const long long q_off = b * q_batch_stride + h * q_head_stride + static_cast<long long>(h) * DH;

  // this thread's 16 query values (QI8: packed 4 to a word for __dp4a)
  float qf[16];
  int qw[4];
  if (QI8) {
    const int8_t* qp = static_cast<const int8_t*>(q) + q_off + part * 16;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      qw[w] = (qp[4 * w] & 0xff) | ((qp[4 * w + 1] & 0xff) << 8) |
              ((qp[4 * w + 2] & 0xff) << 16) | ((qp[4 * w + 3] & 0xff) << 24);
    }
  } else {
    const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q) + q_off;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[i] = __bfloat162float(qp[part * 16 + i]);
    if (KT && tid < DH) q_sh[tid] = __bfloat162float(qp[tid]);
  }
  const float qscale = QI8 ? sq[static_cast<long long>(b) * n_head + h] : 1.f;

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < t_total; t0 += kTile) {
    const int n = min(kTile, t_total - t0);
    __syncthreads();  // p_sh of the previous tile has been read (and q_sh written)

    // scores of this tile into p_sh; keys past the end are -inf
    if (KT) {
      for (int j = tid; j < kTile; j += kThreads) {
        float s = -CUDART_INF_F;
        if (j < n) {
          const int8_t* kc = kb + static_cast<long long>(h) * DH * t_total + t0 + j;
          s = 0.f;
#pragma unroll 8
          for (int d = 0; d < DH; ++d)
            s = fmaf(q_sh[d], static_cast<float>(kc[static_cast<long long>(d) * t_total]), s);
        }
        p_sh[j] = s;
      }
    } else {
      int4 kr[kPasses];
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int r = ps * kRowsPerPass + row;
        kr[ps] = make_int4(0, 0, 0, 0);
        if (r < n)
          kr[ps] = *reinterpret_cast<const int4*>(kb + static_cast<long long>(t0 + r) * d_model + col0);
      }
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int r = ps * kRowsPerPass + row;
        float s;
        if (QI8) {
          int dot = 0;
          dot = __dp4a(kr[ps].x, qw[0], dot);
          dot = __dp4a(kr[ps].y, qw[1], dot);
          dot = __dp4a(kr[ps].z, qw[2], dot);
          dot = __dp4a(kr[ps].w, qw[3], dot);
#pragma unroll
          for (int o = 1; o < kTPK; o *= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s = static_cast<float>(dot) * qscale;
        } else {
          const int8_t* e = reinterpret_cast<const int8_t*>(&kr[ps]);
          s = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) s = fmaf(qf[i], static_cast<float>(e[i]), s);
#pragma unroll
          for (int o = 1; o < kTPK; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        }
        if (part == 0) p_sh[r] = r < n ? s : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // online softmax over the tile (every thread holds the same m and l)
    float tile_max = -CUDART_INF_F;
    for (int j = tid; j < kTile; j += kThreads) tile_max = fmaxf(tile_max, p_sh[j]);
    tile_max = block_max(tile_max, red);
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
    for (int j = tid; j < kTile; j += kThreads) {
      const float p = expf(p_sh[j] - m_new);  // 0 for masked keys
      p_sh[j] = p;
      psum += p;
    }
    l = l * alpha + block_sum(psum, red);  // block_sum's barriers publish p_sh
    m = m_new;

    // acc = acc·alpha + bf16(P) · V over this thread's rows and 16 columns
    int4 vr[kPasses];
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int r = ps * kRowsPerPass + row;
      vr[ps] = make_int4(0, 0, 0, 0);
      if (r < n)
        vr[ps] = *reinterpret_cast<const int4*>(vb + static_cast<long long>(t0 + r) * d_model + col0);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int r = ps * kRowsPerPass + row;
      const float p = round_bf16(p_sh[r]);
      const int8_t* e = reinterpret_cast<const int8_t*>(&vr[ps]);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, static_cast<float>(e[i]), acc[i]);
    }
  }

  // sum the row groups' partial outputs and normalise
#pragma unroll
  for (int i = 0; i < 16; ++i) acc_sh[row][part * 16 + i] = acc[i];
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
    for (int r = 0; r < kRowsPerPass; ++r) o += acc_sh[r][tid];
    out[static_cast<long long>(b) * d_model + static_cast<long long>(h) * DH + tid] =
        o / fmaxf(l, 1e-20f);
  }
}

template <int DH>
int launch(const void* q, const float* sq, const int8_t* k, const int8_t* v,
           float* out, int b, int t, int h, long long q_sb, long long q_sh,
           int k_transposed, int q_int8, cudaStream_t stream) {
  const dim3 grid(h, b);
  if (q_int8 && k_transposed) return static_cast<int>(cudaErrorInvalidValue);
  if (q_int8)
    cross_decode_kernel<DH, false, true><<<grid, kThreads, 0, stream>>>(q, sq, k, v, out, t, h, q_sb, q_sh);
  else if (k_transposed)
    cross_decode_kernel<DH, true, false><<<grid, kThreads, 0, stream>>>(q, sq, k, v, out, t, h, q_sb, q_sh);
  else
    cross_decode_kernel<DH, false, false><<<grid, kThreads, 0, stream>>>(q, sq, k, v, out, t, h, q_sb, q_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16 (q_int8 = 0) or int8 (q_int8 = 1); head h of batch row b starts at
// element b·q_batch_stride + h·q_head_stride + h·dh (a packed [B, D] query
// has strides (D, 0), a spread [B, H, D] one (H·D, D)). sq: [B, H] f32 query
// scales (q_int8 only). k: [B, T, D] int8, or [B, D, T] with k_transposed;
// v: [B, T, D] int8; out: [B, D] f32. Returns the launch's cudaError_t.
extern "C" int cross_attention_decode(const void* q, const void* sq, const void* k,
                                      const void* v, void* out, int b, int t, int h,
                                      int dh, long long q_batch_stride,
                                      long long q_head_stride, int k_transposed,
                                      int q_int8, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sqf = static_cast<const float*>(sq);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  float* o = static_cast<float*>(out);
  if (dh == 64)
    return launch<64>(q, sqf, kp, vp, o, b, t, h, q_batch_stride, q_head_stride, k_transposed, q_int8, s);
  if (dh == 32)
    return launch<32>(q, sqf, kp, vp, o, b, t, h, q_batch_stride, q_head_stride, k_transposed, q_int8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
