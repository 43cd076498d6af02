// Paged attention for Hopper (sm_90a), head_dim 64 and 128: the one-query
// decode kernel and the chunk kernel of speculative verification.
//
// The decode kernel replaces the TPU kernel
// grasp_tpu/ops/pallas_paged64.py::paged_attention_hd64 (its Pallas body
// `_kernel`), and the library paged-attention kernel the JAX engine called for
// head_dim % 128 == 0 (grasp_tpu/serving/paged.py). The chunk kernel replaces
// paged_attention_hd64_chunk (`_kernel_chunk`) of the same file.
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
//
// The chunk kernel: C query tokens per sequence (the token a speculative step
// starts from and its C - 1 draft tokens), q and out [B, C, nh, hd]; query c
// sees slots < base_lengths[b] + c. Its contract is not a tolerance: row
// (b, c) must equal, bit for bit, what the decode kernel gives at length
// base + c, because greedy speculation emits the plain engine's stream only
// if verification and decode reduce in one order. So both kernels are one
// __device__ function inlined twice, and the chunk position is a grid axis:
// each block is a decode block with its own length, its own loop bound and
// its own last-tile mask, and no sum is ever regrouped. The TPU kernel folded
// the C * gqa rows into one block per kv head; here that would be 40 rows
// where a block holds 16, and the card has 100 idle SMs to give the chunk
// positions to instead. The price is that K/V rows are asked for C times:
// once from device memory, the rest from the L2 cache.

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

// One block's work, shared by the decode kernel and the chunk kernel: the gqa
// query rows at ``qb`` (contiguous [gqa, HD]) attend to slots [0, length) of
// one kv head of one sequence, and the result goes to ``ob``. Both kernels
// inline this one function, so a chunk row at length base + c runs the very
// instructions, in the very order, of a decode row at that length: the same
// 16-byte loads, the same q.k order over HD, the same warp max and sum over a
// tile, the same accumulation over t, the same final division.
template <typename T, int HD>
__device__ __forceinline__ void attend_rows(const T* __restrict__ qb, T* __restrict__ ob,
                                            int length, const int* __restrict__ table,
                                            const T* __restrict__ k_pages,
                                            const T* __restrict__ v_pages, int64_t head_pages,
                                            int gqa, int num_pages, int page_size,
                                            int pages_per_seq, float scale) {
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

  const int tid = threadIdx.x;
  // memory safety only: a length beyond the table is the caller's error and its
  // result undefined, but no read leaves the table
  length = min(length, pages_per_seq * page_size);

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

#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) {
    const int g = rg + r * kRowGroups;
    if (g < gqa) ob[g * HD + d] = from_float<T>(acc[r] / fmaxf(l_s[g], 1e-30f));
  }
}

// Decode: one query token per sequence. Grid (B, nkv).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out, int nh, int nkv,
                    int num_pages, int page_size, int pages_per_seq, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int gqa = nh / nkv;
  const int64_t rows = ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
  attend_rows<T, HD>(q + rows, out + rows, lengths[b], tables + (int64_t)b * pages_per_seq,
                     k_pages, v_pages, (int64_t)kvh * num_pages, gqa, num_pages, page_size,
                     pages_per_seq, scale);
}

// Chunk (speculative verify): C query tokens per sequence, q and out
// [B, C, nh, HD]; query c of sequence b sees slots < base_lengths[b] + c.
// Grid (C, nkv, B): a block is the decode block of (b, kv head) at length
// base + c, so the C blocks of one (b, kv head) read the same K/V rows (the
// chunk position is the fastest grid axis, so they run side by side and all
// but the first find the rows in the L2 cache), and C times as many blocks
// fill the card as in decode.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ base_lengths,
                   const int* __restrict__ tables, T* __restrict__ out, int chunk, int nh,
                   int nkv, int num_pages, int page_size, int pages_per_seq, float scale) {
  const int c = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = (((int64_t)b * chunk + c) * nh + (int64_t)kvh * gqa) * HD;
  attend_rows<T, HD>(q + rows, out + rows, base_lengths[b] + c,
                     tables + (int64_t)b * pages_per_seq, k_pages, v_pages,
                     (int64_t)kvh * num_pages, gqa, num_pages, page_size, pages_per_seq, scale);
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

template <typename T, int HD>
int launch_chunk(const void* q, const void* k_pages, const void* v_pages, const void* base_lengths,
                 const void* tables, void* out, int batch, int chunk, int nh, int nkv,
                 int num_pages, int page_size, int pages_per_seq, float scale,
                 cudaStream_t stream) {
  if (nh % nkv != 0 || nh / nkv > Shape<HD>::kMaxGqa) return (int)cudaErrorInvalidValue;
  const dim3 grid(chunk, nkv, batch);
  paged_chunk_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(base_lengths), static_cast<const int*>(tables),
      static_cast<T*>(out), chunk, nh, nkv, num_pages, page_size, pages_per_seq, scale);
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

// The chunk form: q and out [batch, chunk, nh, head_dim], base_lengths [batch]
// (live slots seen by the chunk's first query). Same dtype codes and return
// value; batch and nkv ride grid axes z and y (at most 65535 each).
extern "C" int grasp_paged_attention_chunk(const void* q, const void* k_pages,
                                           const void* v_pages, const void* base_lengths,
                                           const void* tables, void* out, int batch, int chunk,
                                           int nh, int nkv, int num_pages, int page_size,
                                           int pages_per_seq, int head_dim, int dtype,
                                           float scale, void* stream) {
  if (batch == 0 || chunk == 0) return 0;
  if (batch < 0 || batch > 65535 || chunk < 0 || nkv <= 0 || nkv > 65535 || page_size <= 0 ||
      num_pages <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRASP_LAUNCH(T, HD)                                                                   \
  return launch_chunk<T, HD>(q, k_pages, v_pages, base_lengths, tables, out, batch, chunk, nh, \
                             nkv, num_pages, page_size, pages_per_seq, scale, s)
  if (dtype == 0 && head_dim == 64) GRASP_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) GRASP_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) GRASP_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) GRASP_LAUNCH(__nv_bfloat16, 128);
#undef GRASP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
