// Paged attention for Hopper (sm_90a), head_dim 64 and 128: the one-query
// decode kernel and the chunk kernel of speculative verification.
//
// The decode kernels replace the TPU kernel
// grasp_tpu/ops/pallas_paged64.py::paged_attention_hd64 (its Pallas body
// `_kernel`), and the library paged-attention kernel the JAX engine called for
// head_dim % 128 == 0 (grasp_tpu/serving/paged.py). The chunk kernels replace
// paged_attention_hd64_chunk (`_kernel_chunk`) of the same file.
//
// What they compute: one query token per sequence attends to that sequence's
// KV, read in place through its page table. q [B, nh, hd] (unscaled),
// pages [nkv, P, ps, hd], lengths [B] int32, tables [B, pages_per_seq] int32,
// out [B, nh, hd] in q's dtype. Query head h reads kv head h / gqa. Slots at
// or beyond lengths[b] are masked; a sequence with no live slot yields 0.
//
// What bounds them: bytes. Decode attention does 2 flops per K/V element it
// reads, so the least time is the live K/V rows over the memory rate (1.8 us
// for a TinyLlama decode step's layer at batch 8). One block walking a whole
// row alone, as the first design did, ends when the longest row's chain of
// tiles ends, each tile a full round trip to device memory. So:
//
// - Split (flash-decoding). A row's table of ps * pages_per_seq slots is cut
//   into `splits` ranges of `split_slots` slots (a whole number of 64-slot
//   tiles, at most 8 ranges), and a block owns one range of one (row, kv
//   head). The split depends on the table's shape alone, never on the batch,
//   the chunk or the lengths (ops/paged_attention.py::paged_plan), so that a
//   decode call and a verify call cut a row at the same edges. A range past
//   the row's length exits at once (its partial would be m = -inf, l = 0,
//   acc = 0, which adds exactly nothing; a cluster barrier waits only for
//   the threads that have not exited).
// - Combine in one launch. The splits of one (row, kv head) are one
//   thread-block cluster. Each live block leaves its partial (the running
//   max m, the sum l and the unnormalised output acc of its rows) in its
//   shared memory; after a cluster barrier live block r takes its share of
//   the outputs and adds the partials of the live splits 0, 1, ... in that
//   order through distributed shared memory: m = max m_s, l = sum e^(m_s -
//   m) l_s, out = sum e^(m_s - m) acc_s / max(l, 1e-30). A row with one live
//   range needs no barrier. No atomics, no scratch in device memory, the
//   same bits from run to run.
// - bf16 on the tensor cores (paged_*_mma_kernel). A block of 4 warps holds
//   the gqa query rows of its kv head as one m16 tile (rows >= gqa are zero)
//   and streams its range in 64-slot tiles through a ring of `stages`
//   cp.async stages (all tiles of a range in flight at once where they fit);
//   the page ids of the range are read once, at its start. Warp w owns slots
//   16 w .. 16 w + 15 of every tile: S = Q K^T by mma.sync m16n8k16 with K
//   fragments by ldmatrix, an online softmax on the accumulators in base 2,
//   P rounded to bf16 in registers (FlashAttention's arithmetic, as the flash
//   forward does) and O += P V with V fragments by ldmatrix.trans. The four
//   warps' states are added in warp order into the block's partial.
// - fp32 keeps the first design's CUDA-core tile loop (its 1e-4 gate is below
//   what bf16 products keep), now over one range and into the same combine.
//
// The chunk kernels: C query tokens per sequence (the token a speculative step
// starts from and its C - 1 draft tokens), q and out [B, C, nh, hd]; query c
// sees slots < base_lengths[b] + c. Their contract is not a tolerance: row
// (b, c) must equal, bit for bit, what the decode kernel gives at length
// base + c, because greedy speculation emits the plain engine's stream only
// if verification and decode reduce in one order. So decode and chunk inline
// one __device__ body per dtype and the chunk position is a grid axis: a
// chunk block is a decode block with its own length; both cut the row at the
// plan's edges (which do not depend on C or the batch), run the same tiles,
// and combine the same live splits in the same order. The price is that K/V
// rows are asked for C times: once from device memory, the rest from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRowsPerThread = 8;
constexpr int kMaxCluster = 8;      // splits of a row: one portable cluster
constexpr int kSplitAlign = 64;     // a range is a whole number of 64-slot tiles
constexpr int kMmaTile = 64;        // slots per bf16 tile: 16 per warp
constexpr int kMmaRows = 16;        // query rows of the m16 tile
constexpr int kMaxStages = 4;
constexpr size_t kMaxSharedBytes = 232448;  // what one block may ask for on sm_90

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <bool kBase2>
__device__ __forceinline__ float ex(float x) { return kBase2 ? exp2f(x) : expf(x); }

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

// wait until at most n (0 .. kMaxStages - 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    default: tc::cp_async_wait<3>(); break;
  }
}

// Where one block's range lies: slots [s_lo, s_end) of a row of `length`
// live slots (clamped to the table, for memory safety only: a longer length
// is the caller's error and its result undefined), and how many of the row's
// ranges hold a live slot.
struct Range {
  int length, s_lo, s_end, n_live;
};

__device__ __forceinline__ Range range_of(int length, int split, int split_slots, int capacity) {
  Range r;
  r.length = max(0, min(length, capacity));
  r.s_lo = split * split_slots;
  r.s_end = min(r.length, r.s_lo + split_slots);
  r.n_live = (r.length + split_slots - 1) / split_slots;
  return r;
}

// A block whose range holds no live slot is done at once: the cluster's
// barriers wait only for threads that have not exited. Split 0 of a row
// without any live slot writes its zeros. True if the block is done.
template <typename T, int HD>
__device__ __forceinline__ bool dead_range(const Range& rg, int split, T* __restrict__ ob,
                                           int gqa) {
  if (rg.s_lo < rg.s_end) return false;
  if (rg.n_live == 0 && split == 0)
    for (int e = threadIdx.x; e < gqa * HD; e += kThreads) ob[e] = from_float<T>(0.f);
  return true;
}

// The combine, shared by every kernel of this file, run by the live blocks
// of a row (splits 0 .. n_live - 1). pm, pl [rows], pacc [rows][HD] are this
// block's partial in its shared memory (the same offsets in every block of
// the cluster); block `split` writes its share of the gqa * HD outputs from
// the partials of splits 0 .. n_live - 1, added in that order. One live block
// writes its own partial: the same bits as the sums below, whose one weight
// is then e^0 = 1, without a cluster barrier.
template <typename T, int HD, bool kBase2>
__device__ __forceinline__ void combine_splits(const float* pm, const float* pl, const float* pacc,
                                               T* __restrict__ ob, int gqa, int n_live,
                                               int split) {
  if (n_live == 1) {
    __syncthreads();  // the block's partial is in place
    for (int e = threadIdx.x; e < gqa * HD; e += kThreads)
      ob[e] = from_float<T>(pacc[e] / fmaxf(pl[e / HD], 1e-30f));
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in place
  const int total = gqa * HD;
  const int lo = split * total / n_live, hi = (split + 1) * total / n_live;
  for (int e = lo + (int)threadIdx.x; e < hi; e += kThreads) {
    const int g = e / HD;
    float ms[kMaxCluster], ls[kMaxCluster], as[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {  // every load in flight before the first add
      if (s < n_live) {
        ms[s] = cluster.map_shared_rank(pm, s)[g];
        ls[s] = cluster.map_shared_rank(pl, s)[g];
        as[s] = cluster.map_shared_rank(pacc, s)[e];
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < n_live) m = fmaxf(m, ms[s]);
    const float m_use = m == -INFINITY ? 0.f : m;
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < n_live) {
        const float w = ex<kBase2>(ms[s] - m_use);
        l += w * ls[s];
        a += w * as[s];
      }
    }
    ob[e] = from_float<T>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// fp32 body (CUDA cores)
// ---------------------------------------------------------------------------

template <int HD>
struct Shape {
  static constexpr int kTile = 4096 / HD;                  // slots per tile: 64 or 32
  static constexpr int kRowGroups = kThreads / HD;         // PV phase: threads per column
  static constexpr int kMaxGqa = kMaxRowsPerThread * kRowGroups;
};

// One block's range, shared by the fp32 decode and chunk kernels: the gqa
// query rows at ``qb`` (contiguous [gqa, HD]) attend to the live slots of
// range `split` of one kv head of one sequence, then the cluster combines the
// ranges into ``ob``. Within the range, the first design's loop: 16-byte
// loads converted to fp32 in shared memory, scalar q.k over HD, one warp per
// row for the online softmax, a scalar P V loop.
template <int HD>
__device__ __forceinline__ void attend_split_f32(const float* __restrict__ qb,
                                                 float* __restrict__ ob, int length,
                                                 const int* __restrict__ table,
                                                 const float* __restrict__ k_pages,
                                                 const float* __restrict__ v_pages,
                                                 int64_t head_pages, int gqa, int num_pages,
                                                 int page_size, int pages_per_seq, float scale,
                                                 int split, int split_slots) {
  constexpr int kTile = Shape<HD>::kTile;
  constexpr int kRowGroups = Shape<HD>::kRowGroups;
  constexpr int kMaxGqa = Shape<HD>::kMaxGqa;
  constexpr int kVec = 4;  // floats per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  static_assert(kTile <= kThreads, "one thread per slot fills the row offsets");
  static_assert(kSplitAlign % kTile == 0, "a range is a whole number of tiles");

  __shared__ float q_s[kMaxGqa][HD];
  __shared__ float k_s[kTile][HD + 1];  // +1: the score loop reads rows across a warp
  __shared__ float v_s[kTile][HD];
  __shared__ float p_s[kMaxGqa][kTile];  // scores, then softmax numerators
  __shared__ float m_s[kMaxGqa], l_s[kMaxGqa], alpha_s[kMaxGqa];
  __shared__ float part_s[kMaxGqa][HD];  // the range's unnormalised output
  __shared__ int64_t row_s[kTile];       // element offset of each slot's K/V row

  const int tid = threadIdx.x;
  const Range range = range_of(length, split, split_slots, pages_per_seq * page_size);
  if (dead_range<float, HD>(range, split, ob, gqa)) return;

  for (int i = tid; i < gqa * HD; i += kThreads) q_s[i / HD][i % HD] = qb[i];
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

  for (int s0 = range.s_lo; s0 < range.s_end; s0 += kTile) {
    const int n = min(kTile, range.s_end - s0);
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
      const float4 kr = *reinterpret_cast<const float4*>(k_pages + row_s[t] + c);
      const float4 vr = *reinterpret_cast<const float4*>(v_pages + row_s[t] + c);
      k_s[t][c] = kr.x, k_s[t][c + 1] = kr.y, k_s[t][c + 2] = kr.z, k_s[t][c + 3] = kr.w;
      v_s[t][c] = vr.x, v_s[t][c + 1] = vr.y, v_s[t][c + 2] = vr.z, v_s[t][c + 3] = vr.w;
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
    if (g < gqa) part_s[g][d] = acc[r];
  }
  combine_splits<float, HD, false>(m_s, l_s, &part_s[0][0], ob, gqa, range.n_live, split);
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr int mma_stage_bytes() { return 2 * kMmaTile * HD * 2; }  // K and V tiles

// the q tile and the block's partial (m, l, acc of 16 rows)
template <int HD>
__host__ __device__ constexpr int mma_fixed_bytes() {
  return kMmaRows * (HD + 8) * 2 + (2 * kMmaRows + kMmaRows * HD) * 4;
}

// page ids a range of split_slots slots can touch, whatever its first slot
__host__ __device__ inline int range_pages(int split_slots, int page_size) {
  return (split_slots - 1) / page_size + 2;
}

template <int HD>
int mma_smem_bytes(int stages, int split_slots, int page_size) {
  return stages * mma_stage_bytes<HD>() + mma_fixed_bytes<HD>() +
         (range_pages(split_slots, page_size) * 4 + 15) / 16 * 16;
}

// One block's range, shared by the bf16 decode and chunk kernels (see the note
// at the top). Dynamic shared memory: the ring of `stages` K/V tiles (once
// drained, its first stage holds the warps' partial outputs), the q tile (once
// in registers, it holds the warps' m and l), the block's partial, the range's
// page ids. A ring row is HD elements with its 16-byte chunks permuted
// (chunk ^ row % 8), so that the 8 rows an ldmatrix reads meet in no bank.
template <int HD>
__device__ __forceinline__ void attend_split_mma(
    const __nv_bfloat16* __restrict__ qb, __nv_bfloat16* __restrict__ ob, int length,
    const int* __restrict__ table, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, int64_t head_pages, int gqa, int num_pages,
    int page_size, int pages_per_seq, float scale_log2, int split, int split_slots, int stages) {
  constexpr int LD = HD + 8;  // q tile row stride: its ldmatrix is free of bank conflicts
  constexpr int kChunks = HD / 8;  // 16-byte pieces a row
  constexpr int kStage = 2 * kMmaTile * HD;  // elements of a stage: K tile, then V tile
  static_assert(kWarps * kMmaRows * HD * 4 <= mma_stage_bytes<HD>(),
                "the warps' partial outputs fit in the drained ring's first stage");
  static_assert(kWarps * 2 * kMmaRows * 4 <= kMmaRows * LD * 2,
                "the warps' m and l fit in the q tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* q_s = ring + stages * kStage;
  float* pm = reinterpret_cast<float*>(q_s + kMmaRows * LD);
  float* pl = pm + kMmaRows;
  float* pacc = pl + kMmaRows;
  int* pid_s = reinterpret_cast<int*>(pacc + kMmaRows * HD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Range rg = range_of(length, split, split_slots, pages_per_seq * page_size);
  // the page ids of the whole range, asked for while the length arrives
  const int p_lo = rg.s_lo / page_size;
  const int n_pages = min(pages_per_seq, (rg.s_lo + split_slots - 1) / page_size + 1) - p_lo;
  for (int i = tid; i < n_pages; i += kThreads)
    pid_s[i] = min(max(table[p_lo + i], 0), num_pages - 1);  // never read outside the pool
  if (dead_range<__nv_bfloat16, HD>(rg, split, ob, gqa)) return;

  for (int i = tid; i < kMmaRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    tc::cp_async16(q_s + r * LD + c, qb + (r < gqa ? r * HD + c : 0), r < gqa);
  }
  __syncthreads();  // the page ids, before the tile loads read them

  // tile j of the range into stage st; slots at or past the end are zero
  // (a stale V row could hold a NaN that p = 0 would not cancel)
  auto load_tile = [&](int j, int st) {
    __nv_bfloat16* ks = ring + st * kStage;
    __nv_bfloat16* vs = ks + kMmaTile * HD;
    const int t0 = rg.s_lo + j * kMmaTile;
#pragma unroll
    for (int i = tid; i < kMmaTile * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const int slot = t0 + r;
      const bool ok = slot < rg.s_end;
      int64_t off = 0;
      if (ok)
        off = ((head_pages + pid_s[slot / page_size - p_lo]) * page_size + slot % page_size) *
                  HD + ch * 8;
      const int dst = r * HD + ((ch ^ (r & 7)) << 3);
      tc::cp_async16(ks + dst, k_pages + off, ok);
      tc::cp_async16(vs + dst, v_pages + off, ok);
    }
  };
  const int n_tiles = (rg.s_end - rg.s_lo + kMmaTile - 1) / kMmaTile;
  for (int st = 0; st < stages; ++st) {  // one group a stage, the q tile in the first
    if (st < n_tiles) load_tile(st, st);
    tc::cp_async_commit();
  }

  uint32_t qf[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (base 2)
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % stages;
    cp_async_wait_upto(stages - 1);  // tile j (and, at j = 0, the q tile) has landed
    __syncthreads();                 // ... for every thread
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], q_s + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const int key0 = rg.s_lo + j * kMmaTile + warp * 16;  // the warp's 16 slots
    if (key0 < rg.s_end) {
      const __nv_bfloat16* ks = ring + st * kStage + warp * 16 * HD;
      const __nv_bfloat16* vs = ks + kMmaTile * HD;
      const int r8 = lane % 8;  // the row of its matrix a lane addresses, and its swizzle
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, ks + ((lane / 16) * 8 + r8) * HD +
                                (((kk * 2 + (lane / 8) % 2) ^ r8) << 3));
        tc::mma_bf16(s[0], qf[kk], kb[0], kb[1]);
        tc::mma_bf16(s[1], qf[kk], kb[2], kb[3]);
      }

      // online softmax over the warp's slots, NaN-free for a row with no
      // live slot yet; a row's state lives in the 4 lanes of a quad
      const bool masked = key0 + 16 > rg.s_end;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * scale_log2;
          if (masked && key0 + i * 8 + (lane % 4) * 2 + (e & 1) >= rg.s_end) x = -INFINITY;
          s[i][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - m_use[h]);  // 0 while the row has seen no slot
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = exp2f(s[i][e] - m_use[e >> 1]);
          sum[e >> 1] += s[i][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = alpha[h] * l[h] + sum[h];
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // O += P V, P rounded to bf16 in registers (the accumulators of the
      // two n-tiles are the A fragment)
      const uint32_t pa[4] = {tc::pack_bf16(s[0][0], s[0][1]), tc::pack_bf16(s[0][2], s[0][3]),
                              tc::pack_bf16(s[1][0], s[1][1]), tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, vs + (((lane / 8) % 2) * 8 + r8) * HD +
                                      (((d2 * 2 + lane / 16) ^ r8) << 3));
        tc::mma_bf16(acc[2 * d2], pa, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
    if (j + stages < n_tiles) {
      __syncthreads();  // every warp is done with stage st
      load_tile(j + stages, st);
    }
    tc::cp_async_commit();  // one group an iteration, empty or not
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is drained and q is in registers: the warps' partials move in

  float* wm = reinterpret_cast<float*>(q_s);   // [warp][16]
  float* wl = wm + kWarps * kMmaRows;          // [warp][16]
  float* wacc = reinterpret_cast<float*>(ring);  // [warp][16][HD]
  const int g = lane / 4;                      // the lane's rows: g and g + 8
  if (lane % 4 == 0) {
    wm[warp * kMmaRows + g] = m[0];
    wm[warp * kMmaRows + g + 8] = m[1];
    wl[warp * kMmaRows + g] = l[0];
    wl[warp * kMmaRows + g + 8] = l[1];
  }
  float* wa = wacc + warp * kMmaRows * HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(wa + g * HD + col) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(wa + (g + 8) * HD + col) = make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();

  // the block's partial: the warps' states added in warp order
  for (int e = tid; e < gqa * HD; e += kThreads) {
    const int row = e / HD;
    float mw[kWarps], mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wm[w * kMmaRows + row];
      mb = fmaxf(mb, mw[w]);
    }
    const float m_use = mb == -INFINITY ? 0.f : mb;
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp2f(mw[w] - m_use);
      lb += x * wl[w * kMmaRows + row];
      ab += x * wacc[w * kMmaRows * HD + e];
    }
    pacc[e] = ab;
    if (e % HD == 0) {
      pm[row] = mb;
      pl[row] = lb;
    }
  }
  combine_splits<__nv_bfloat16, HD, true>(pm, pl, pacc, ob, gqa, rg.n_live, split);
}

// ---------------------------------------------------------------------------
// kernels: grid (splits [x C], nkv, B); the splits of one row are one cluster
// ---------------------------------------------------------------------------

// Decode: one query token per sequence.
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ tables, float* __restrict__ out, int nh, int nkv,
                    int num_pages, int page_size, int pages_per_seq, float scale, int splits,
                    int split_slots) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
  attend_split_f32<HD>(q + rows, out + rows, lengths[b], tables + (int64_t)b * pages_per_seq,
                       k_pages, v_pages, (int64_t)kvh * num_pages, gqa, num_pages, page_size,
                       pages_per_seq, scale, split, split_slots);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ lengths,
                        const int* __restrict__ tables, __nv_bfloat16* __restrict__ out, int nh,
                        int nkv, int num_pages, int page_size, int pages_per_seq,
                        float scale_log2, int splits, int split_slots, int stages) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
  attend_split_mma<HD>(q + rows, out + rows, lengths[b], tables + (int64_t)b * pages_per_seq,
                       k_pages, v_pages, (int64_t)kvh * num_pages, gqa, num_pages, page_size,
                       pages_per_seq, scale_log2, split, split_slots, stages);
}

// Chunk (speculative verify): C query tokens per sequence, q and out
// [B, C, nh, HD]; query c of sequence b sees slots < base_lengths[b] + c.
// blockIdx.x = c * splits + split: the cluster of a chunk position is a
// decode cluster at length base + c.
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                   const float* __restrict__ v_pages, const int* __restrict__ base_lengths,
                   const int* __restrict__ tables, float* __restrict__ out, int chunk, int nh,
                   int nkv, int num_pages, int page_size, int pages_per_seq, float scale,
                   int splits, int split_slots) {
  const int c = blockIdx.x / splits, split = blockIdx.x % splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = (((int64_t)b * chunk + c) * nh + (int64_t)kvh * gqa) * HD;
  attend_split_f32<HD>(q + rows, out + rows, base_lengths[b] + c,
                       tables + (int64_t)b * pages_per_seq, k_pages, v_pages,
                       (int64_t)kvh * num_pages, gqa, num_pages, page_size, pages_per_seq, scale,
                       split, split_slots);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ base_lengths, const int* __restrict__ tables,
                       __nv_bfloat16* __restrict__ out, int chunk, int nh, int nkv, int num_pages,
                       int page_size, int pages_per_seq, float scale_log2, int splits,
                       int split_slots, int stages) {
  const int c = blockIdx.x / splits, split = blockIdx.x % splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = (((int64_t)b * chunk + c) * nh + (int64_t)kvh * gqa) * HD;
  attend_split_mma<HD>(q + rows, out + rows, base_lengths[b] + c,
                       tables + (int64_t)b * pages_per_seq, k_pages, v_pages,
                       (int64_t)kvh * num_pages, gqa, num_pages, page_size, pages_per_seq,
                       scale_log2, split, split_slots, stages);
}

// Launch on a grid (x_blocks, nkv, batch) with the splits of a row as one
// cluster along x.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int splits, int x_blocks, int nkv, int batch, int smem_bytes,
                    cudaStream_t stream, Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x_blocks, nkv, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan's checks (ops/paged_attention.py::paged_plan makes the plan):
// ranges of whole 64-slot tiles that cover the table in at most a cluster;
// fp32 takes no stages and no dynamic shared memory, bf16 1 to kMaxStages
// stages and exactly this file's shared bytes for them.
template <int HD>
bool plan_ok(int dtype, int gqa, int page_size, int pages_per_seq, int split_slots, int splits,
             int stages, int smem_bytes) {
  const int64_t capacity = (int64_t)page_size * pages_per_seq;
  if (split_slots <= 0 || split_slots % kSplitAlign != 0 || splits < 1 || splits > kMaxCluster ||
      splits != (capacity + split_slots - 1) / split_slots)
    return false;
  if (dtype == 0) return gqa <= Shape<HD>::kMaxGqa && stages == 0 && smem_bytes == 0;
  return gqa <= kMmaRows && stages >= 1 && stages <= kMaxStages &&
         smem_bytes == mma_smem_bytes<HD>(stages, split_slots, page_size) &&
         (size_t)smem_bytes <= kMaxSharedBytes;
}

template <int HD>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
             const void* tables, void* out, int batch, int chunk, int nh, int nkv, int num_pages,
             int page_size, int pages_per_seq, int dtype, int split_slots, int splits, int stages,
             int smem_bytes, float scale, cudaStream_t s) {
  if (nh % nkv != 0 ||
      !plan_ok<HD>(dtype, nh / nkv, page_size, pages_per_seq, split_slots, splits, stages,
                   smem_bytes))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int x = chunk == 0 ? splits : splits * chunk;
  if (dtype == 0 && chunk == 0)
    return launch_clusters(paged_decode_kernel<HD>, splits, x, nkv, batch, 0, s,
                           static_cast<const float*>(q), static_cast<const float*>(k_pages),
                           static_cast<const float*>(v_pages), static_cast<const int*>(lengths),
                           static_cast<const int*>(tables), static_cast<float*>(out), nh, nkv,
                           num_pages, page_size, pages_per_seq, scale, splits, split_slots);
  if (dtype == 0)
    return launch_clusters(paged_chunk_kernel<HD>, splits, x, nkv, batch, 0, s,
                           static_cast<const float*>(q), static_cast<const float*>(k_pages),
                           static_cast<const float*>(v_pages), static_cast<const int*>(lengths),
                           static_cast<const int*>(tables), static_cast<float*>(out), chunk, nh,
                           nkv, num_pages, page_size, pages_per_seq, scale, splits, split_slots);
  if (chunk == 0)
    return launch_clusters(paged_decode_mma_kernel<HD>, splits, x, nkv, batch, smem_bytes, s,
                           static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
                           static_cast<const bf16*>(v_pages), static_cast<const int*>(lengths),
                           static_cast<const int*>(tables), static_cast<bf16*>(out), nh, nkv,
                           num_pages, page_size, pages_per_seq, scale_log2, splits, split_slots,
                           stages);
  return launch_clusters(paged_chunk_mma_kernel<HD>, splits, x, nkv, batch, smem_bytes, s,
                         static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
                         static_cast<const bf16*>(v_pages), static_cast<const int*>(lengths),
                         static_cast<const int*>(tables), static_cast<bf16*>(out), chunk, nh, nkv,
                         num_pages, page_size, pages_per_seq, scale_log2, splits, split_slots,
                         stages);
}

int dispatch_hd(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
                const void* tables, void* out, int batch, int chunk, int nh, int nkv,
                int num_pages, int page_size, int pages_per_seq, int head_dim, int dtype,
                int split_slots, int splits, int stages, int smem_bytes, float scale,
                void* stream) {
  if (batch < 0 || batch > 65535 || chunk < 0 || nkv <= 0 || nkv > 65535 || page_size <= 0 ||
      num_pages <= 0 || pages_per_seq <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return dispatch<64>(q, k_pages, v_pages, lengths, tables, out, batch, chunk, nh, nkv,
                        num_pages, page_size, pages_per_seq, dtype, split_slots, splits, stages,
                        smem_bytes, scale, s);
  if (head_dim == 128)
    return dispatch<128>(q, k_pages, v_pages, lengths, tables, out, batch, chunk, nh, nkv,
                         num_pages, page_size, pages_per_seq, dtype, split_slots, splits, stages,
                         smem_bytes, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The plan (split_slots, splits, stages,
// smem_bytes) is ops/paged_attention.py::paged_plan's for the table's page
// size, pages per row, head_dim, group size and dtype; a plan of another
// layout is refused. Returns 0 or a cudaError_t code; an unsupported
// head_dim, dtype, group size or plan returns cudaErrorInvalidValue.
extern "C" int grasp_paged_attention_decode(const void* q, const void* k_pages,
                                            const void* v_pages, const void* lengths,
                                            const void* tables, void* out, int batch, int nh,
                                            int nkv, int num_pages, int page_size,
                                            int pages_per_seq, int head_dim, int dtype,
                                            int split_slots, int splits, int stages,
                                            int smem_bytes, float scale, void* stream) {
  if (batch == 0) return 0;
  return dispatch_hd(q, k_pages, v_pages, lengths, tables, out, batch, 0, nh, nkv, num_pages,
                     page_size, pages_per_seq, head_dim, dtype, split_slots, splits, stages,
                     smem_bytes, scale, stream);
}

// The chunk form: q and out [batch, chunk, nh, head_dim], base_lengths [batch]
// (live slots seen by the chunk's first query). Same dtype codes, plan and
// return value; batch and nkv ride grid axes z and y (at most 65535 each).
extern "C" int grasp_paged_attention_chunk(const void* q, const void* k_pages,
                                           const void* v_pages, const void* base_lengths,
                                           const void* tables, void* out, int batch, int chunk,
                                           int nh, int nkv, int num_pages, int page_size,
                                           int pages_per_seq, int head_dim, int dtype,
                                           int split_slots, int splits, int stages,
                                           int smem_bytes, float scale, void* stream) {
  if (batch == 0 || chunk == 0) return 0;
  if (chunk < 0) return (int)cudaErrorInvalidValue;
  return dispatch_hd(q, k_pages, v_pages, base_lengths, tables, out, batch, chunk, nh, nkv,
                     num_pages, page_size, pages_per_seq, head_dim, dtype, split_slots, splits,
                     stages, smem_bytes, scale, stream);
}
