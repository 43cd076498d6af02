// Paged-attention decode for Hopper (sm_90a), head_dim 64 and 128.
//
// Replaces the TPU kernel grasp_tpu/ops/pallas_paged64.py::paged_attention_hd64
// (its Pallas body `_kernel`), and the library paged-attention kernel the JAX
// engine called for head_dim % 128 == 0 (grasp_tpu/serving/paged.py).
//
// What it computes: one query token per sequence attends to that sequence's
// KV, read in place through its page table. q [B, nh, hd] (unscaled),
// pages [nkv, P, ps, hd], lengths [B] int32, tables [B, pages_per_seq] int32,
// out [B, nh, hd] in q's dtype. Query head h reads kv head h / gqa. Slots at
// or beyond lengths[b] are masked; a sequence with no live slot yields 0.
//
// What bounds it: decode attention does 2 flops per K/V element it reads, so
// it is bound by the bytes of K/V moved from device memory, far below the
// card's compute roofline. The design therefore reads every live K/V row
// exactly once: one thread block per (sequence, kv head) walks the
// sequence's pages, and the gqa query heads that share the kv head use each
// tile of K/V while it sits in shared memory. The page loop stops at the
// sequence's length instead of reading every table slot (masked slots add
// exactly 0). The TPU kernel's sequential (batch, page) grid carried the
// online-softmax state in scratch; here that carry is a loop inside the block.
//
// Simple first: 128 threads, synchronous 16-byte loads, fp32 math, no split
// over the sequence (flash-decoding), no cp.async/TMA. With B * nkv blocks the
// card is under-filled at small batch; splitting the sequence is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerThread = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
struct Shape {
  static constexpr int kTile = 4096 / HD;                  // slots per tile: 64 or 32
  static constexpr int kRowGroups = kThreads / HD;         // PV phase: threads per column
  static constexpr int kMaxGqa = kMaxRowsPerThread * kRowGroups;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out, int nh, int nkv,
                    int num_pages, int page_size, int pages_per_seq, float scale) {
  constexpr int kTile = Shape<HD>::kTile;
  constexpr int kRowGroups = Shape<HD>::kRowGroups;
  constexpr int kMaxGqa = Shape<HD>::kMaxGqa;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  static_assert(kTile <= kThreads, "one thread per slot fills the row offsets");

  __shared__ float q_s[kMaxGqa][HD];
  __shared__ float k_s[kTile][HD + 1];  // +1: the score loop reads rows across a warp
  __shared__ float v_s[kTile][HD];
  __shared__ float p_s[kMaxGqa][kTile];  // scores, then softmax numerators
  __shared__ float m_s[kMaxGqa], l_s[kMaxGqa], alpha_s[kMaxGqa];
  __shared__ int64_t row_s[kTile];  // element offset of each slot's K/V row

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int gqa = nh / nkv;
  const int length = lengths[b];
  const int* table = tables + (int64_t)b * pages_per_seq;
  const int64_t head_pages = (int64_t)kvh * num_pages;

  const T* qb = q + ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
  for (int i = tid; i < gqa * HD; i += kThreads) q_s[i / HD][i % HD] = to_float(qb[i]);
  for (int g = tid; g < gqa; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  // PV phase layout: thread owns column d of rows rg, rg + kRowGroups, ...
  const int d = tid % HD;
  const int rg = tid / HD;
  float acc[kMaxRowsPerThread];
#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < length; s0 += kTile) {
    const int n = min(kTile, length - s0);
    if (tid < n) {
      const int slot = s0 + tid;
      int page = table[slot / page_size];
      page = min(max(page, 0), num_pages - 1);  // never read outside the pool
      row_s[tid] = ((head_pages + page) * page_size + slot % page_size) * HD;
    }
    __syncthreads();

    for (int i = tid; i < n * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const uint4 kr = *reinterpret_cast<const uint4*>(k_pages + row_s[t] + c);
      const uint4 vr = *reinterpret_cast<const uint4*>(v_pages + row_s[t] + c);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_s[t][c + j] = to_float(ke[j]);
        v_s[t][c + j] = to_float(ve[j]);
      }
    }
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale; slots past the length are -inf
    for (int i = tid; i < gqa * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      float s = -INFINITY;
      if (t < n) {
        float a = 0.f;
#pragma unroll 16
        for (int e = 0; e < HD; ++e) a += q_s[g][e] * k_s[t][e];
        s = a * scale;
      }
      p_s[g][t] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row; NaN-free when a tile is all -inf
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int g = warp; g < gqa; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, p_s[g][t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float s = p_s[g][t];
        const float p = isfinite(s) ? expf(s - m_safe) : 0.f;
        p_s[g][t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = alpha[g] * acc[g][d] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int r = 0; r < kMaxRowsPerThread; ++r) {
      const int g = rg + r * kRowGroups;
      if (g < gqa) acc[r] *= alpha_s[g];
    }
    for (int t = 0; t < n; ++t) {
      const float v = v_s[t][d];
#pragma unroll
      for (int r = 0; r < kMaxRowsPerThread; ++r) {
        const int g = rg + r * kRowGroups;
        if (g < gqa) acc[r] += p_s[g][t] * v;
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

  T* ob = out + ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) {
    const int g = rg + r * kRowGroups;
    if (g < gqa) ob[g * HD + d] = from_float<T>(acc[r] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
           const void* tables, void* out, int batch, int nh, int nkv, int num_pages,
           int page_size, int pages_per_seq, float scale, cudaStream_t stream) {
  if (nh % nkv != 0 || nh / nkv > Shape<HD>::kMaxGqa) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, nkv);
  paged_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(lengths), static_cast<const int*>(tables), static_cast<T*>(out),
      nh, nkv, num_pages, page_size, pages_per_seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t code; an
// unsupported head_dim, dtype or group size returns cudaErrorInvalidValue.
extern "C" int grasp_paged_attention_decode(const void* q, const void* k_pages,
                                            const void* v_pages, const void* lengths,
                                            const void* tables, void* out, int batch, int nh,
                                            int nkv, int num_pages, int page_size,
                                            int pages_per_seq, int head_dim, int dtype,
                                            float scale, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || nkv <= 0 || page_size <= 0 || num_pages <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRASP_LAUNCH(T, HD)                                                              \
  return launch<T, HD>(q, k_pages, v_pages, lengths, tables, out, batch, nh, nkv, num_pages, \
                       page_size, pages_per_seq, scale, s)
  if (dtype == 0 && head_dim == 64) GRASP_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) GRASP_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) GRASP_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) GRASP_LAUNCH(__nv_bfloat16, 128);
#undef GRASP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
