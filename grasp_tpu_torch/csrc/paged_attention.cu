// Paged attention for Hopper (sm_90a): the one-query decode kernel and the
// chunk kernel of speculative verification, over fp pages at head_dim 64,
// 96, 128 and 256 and over int8 pages (fp32 scale per slot) at 128 and 256.
//
// The decode kernels replace the TPU kernel
// grasp_tpu/ops/pallas_paged64.py::paged_attention_hd64 (its Pallas body
// `_kernel`), and jax's own TPU kernel
// jax.experimental.pallas.ops.tpu.paged_attention, which the JAX engine calls
// at grasp_tpu/serving/paged.py:306 for head_dim % 128 == 0 over fp pages and
// over int8 pages (wrapped in its QuantizedTensor and read in place). The
// chunk kernels replace paged_attention_hd64_chunk (`_kernel_chunk`) of
// pallas_paged64.py, and take the decode kernels' layouts.
//
// What they compute: one query token per sequence attends to that sequence's
// KV, read in place through its page table. q [B, nh, hd] (unscaled),
// pages [nkv, P, ps, hd], lengths [B] int32, tables [B, pages_per_seq] int32,
// out [B, nh, hd] in q's dtype. Query head h reads kv head h / gqa. Slots at
// or beyond lengths[b] are masked; a sequence with no live slot yields 0.
//
// What bounds them: bytes. Decode attention does 2 flops per K/V element it
// reads, so the least time is the live K/V rows over the memory rate (1.8 us
// for a TinyLlama decode step's layer at batch 8, 28 us at Gemma-7B's 16 MHA
// heads of 256). A kernel that only streams the same tiles with cp.async
// comes near that rate; what held the first designs back was the work around
// the copies, serial within a block: a chain of tiles each a round trip,
// the page table's arithmetic on every copy, products with nothing in flight
// under them, and the epilogue. So:
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
// - bf16 on the tensor cores (paged_*_mma_kernel, attend_rows_mma). A block
//   of 4 warps holds up to 16 query rows as one m16 tile (rows past them are
//   zero): in decode the group of its kv head, in verify 16 of the chunk's C
//   x gqa rows (below). Each row carries its own length. At its start the
//   block reads the range's page ids and turns every slot into its row in
//   the pool once (a multiply for the division by the page size), so a copy
//   costs a shared-memory read and an add. It streams the range in 64-slot
//   tiles through a cp.async ring of `ring_tiles` entries, each a K tile or
//   a V tile: tile j's scores wait for its K tile alone, and while they and
//   its products run, its V tile and the next tiles land. Warp w owns slots
//   16 w .. 16 w + 15 of every tile: S = Q K^T by mma.sync m16n8k16 with K
//   fragments by ldmatrix, an online softmax on the accumulators in base 2
//   with each row masked at its own end, P rounded to bf16 in registers
//   (FlashAttention's arithmetic, as the flash forward does) and O += P V
//   with V fragments by ldmatrix.trans; a warp whose rows' maxima did not
//   move skips the rescale (alpha = 1). The four warps' states are added in
//   warp order into the block's partial, rows past the block's rows never
//   stored. A ring row of 8 or 16 16-byte chunks permutes them by chunk ^
//   (row % 8); at head_dim 96 a row has 12, which that XOR would carry into
//   the next row, so there rows are padded to HD + 8 elements (13 chunks: 8
//   rows at one chunk fall in 8 distinct bank groups, as in the q tile) and
//   not permuted.
// - head_dim 256: a 64-slot K tile is 32 KB and the drained ring holds the
//   warps' 64 KB of partials, so the plan gives a block two blocks' share of
//   an SM: three ring entries over bf16 pages (two in flight under every
//   product), six over int8 pages; and a warp reads its q fragments again
//   for every tile instead of holding 64 more registers beside the 128 of
//   its output.
// - int8 pages: the ring holds the tiles as they lie in the pool (half the
//   bytes of bf16) and their scales; fragments become bf16 in registers,
//   exactly, by a byte permute and one fp32 add (no int-to-float converts,
//   which run at a quarter of the ALU's rate). The key scale multiplies the
//   scores after q.k, the value scale the rounded softmax numerators before
//   P V, as the gather route orders them.
// - fp32 keeps the first design's CUDA-core tile loop (its 1e-4 gate is below
//   what bf16 products keep), now over one range and into the same combine;
//   at head_dim 256 its tiles take dynamic shared memory (F32Smem).
//   Its PV phase gives thread (warp w, lane) columns lane + 32 i of query
//   rows w + 4 j, so all 128 threads work at every head_dim and a group of
//   up to 16 rows fits in registers.
//
// The chunk kernels: C query tokens per sequence (the token a speculative step
// starts from and its C - 1 draft tokens), q and out [B, C, nh, hd]; query c
// sees slots < base_lengths[b] + c. Their contract is not a tolerance: row
// (b, c) must equal, bit for bit, what the decode kernel gives at length
// base + c, because greedy speculation emits the plain engine's stream only
// if verification and decode reduce in one order. bf16: the C x gqa query
// rows of a (sequence, kv head), ordered (position c, head h), are cut into
// groups of 16, and a group's cluster reads each K/V tile of the row once
// for all its rows (once for Gemma-7B's heads at C 5, twice for Mistral-7B's
// 4 a kv head, three times for Gemma-2B's 8, C times for 16). Decode and
// verify inline one __device__ body and take one plan (which does not depend
// on C or the batch): a row's scores, softmax steps and products are those of
// the decode block at its length, whatever rows share its tile. A tile, or
// a warp's 16 slots, past a row's end leaves its m, l and acc bit for bit as
// they were (its numerators are 0 and its rescale e^0 = 1), and a range live
// only for later rows adds nothing to it: the combine adds row r's own live
// ranges only, in the decode kernel's order. fp32 keeps a cluster a chunk
// position (a decode cluster at length base + c): K/V rows asked for C times,
// once from device memory, the rest from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGqa = 16;         // query rows of a kv head (both bodies)
constexpr int kMaxCluster = 8;      // splits of a row: one portable cluster
constexpr int kSplitAlign = 64;     // a range is a whole number of 64-slot tiles
constexpr int kMmaTile = 64;        // slots per bf16 tile: 16 per warp
constexpr int kMmaRows = 16;        // query rows of the m16 tile
constexpr int kMaxRingTiles = 8;  // K and V tiles of the bf16 ring
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

// wait until at most n (0 .. kMaxRingTiles - 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    case 3: tc::cp_async_wait<3>(); break;
    case 4: tc::cp_async_wait<4>(); break;
    case 5: tc::cp_async_wait<5>(); break;
    case 6: tc::cp_async_wait<6>(); break;
    default: tc::cp_async_wait<7>(); break;
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

// The fp32 bodies' combine (the bf16 body's is combine_rows), run by the
// live blocks of a row (splits 0 .. n_live - 1). pm, pl [rows], pacc [rows][HD] are this
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
  static_assert(HD % 32 == 0, "a thread owns whole columns lane + 32 i");
  static constexpr int kTile = HD <= 64 ? 64 : 32;  // slots per tile
  static constexpr int kCols = HD / 32;             // PV phase: columns lane + 32 i of a thread
  static constexpr int kRows = kMaxGqa / kWarps;    // ... of rows warp + kWarps j
};

// The fp32 body's shared memory. Up to head_dim 128 it is static (43,600
// bytes at 128 as ptxas reports it, 43,840 over int8 pages); at 256 it
// outgrows the 48 KB of static shared memory (84,552 bytes, 84,800 over int8
// pages) and is the launch's dynamic shared memory, which the plan states.
template <int HD, bool kQ8>
struct F32Smem {
  static constexpr int kTile = Shape<HD>::kTile;
  int64_t row[kTile];             // element offset of each slot's K/V row
  float q[kMaxGqa][HD];
  float k[kTile][HD + 1];         // +1: the score loop reads rows across a warp
  float v[kTile][HD];
  float p[kMaxGqa][kTile];        // scores, then softmax numerators (times the value scale)
  float m[kMaxGqa], l[kMaxGqa], alpha[kMaxGqa];
  float ksc[kQ8 ? kTile : 1], vsc[kQ8 ? kTile : 1];  // int8 pages: the slots' scales
};

template <int HD, bool kQ8>
__host__ __device__ constexpr int f32_smem_bytes() {  // the launch's dynamic shared memory
  return sizeof(F32Smem<HD, kQ8>) > 48 * 1024 ? (int)sizeof(F32Smem<HD, kQ8>) : 0;
}

template <int HD, bool kQ8>
__device__ __forceinline__ F32Smem<HD, kQ8>& f32_smem() {
  if constexpr (f32_smem_bytes<HD, kQ8>() > 0) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return *reinterpret_cast<F32Smem<HD, kQ8>*>(smem_raw);
  } else {
    __shared__ F32Smem<HD, kQ8> smem;
    return smem;
  }
}

// One block's range, shared by the fp32 decode and chunk kernels: the gqa
// query rows at ``qb`` (contiguous [gqa, HD]) attend to the live slots of
// range `split` of one kv head of one sequence, then the cluster combines the
// ranges into ``ob``. Within the range, the first design's loop: 16-byte
// loads converted to fp32 in shared memory, scalar q.k over HD, one warp per
// row for the online softmax, a scalar P V loop. Over int8 pages (kQ8) a
// 16-byte load brings 16 values, the key scale multiplies a slot's score
// after the contraction and the value scale its softmax numerator before the
// P V loop (the gather route's order); l sums the numerators unscaled.
template <int HD, bool kQ8>
__device__ __forceinline__ void attend_split_f32(
    const float* __restrict__ qb, float* __restrict__ ob, int length,
    const int* __restrict__ table,
    const std::conditional_t<kQ8, int8_t, float>* __restrict__ k_pages,
    const std::conditional_t<kQ8, int8_t, float>* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales, int64_t head_pages,
    int gqa, int num_pages, int page_size, int pages_per_seq, float scale, int split,
    int split_slots) {
  constexpr int kTile = Shape<HD>::kTile;
  constexpr int kCols = Shape<HD>::kCols;
  constexpr int kRows = Shape<HD>::kRows;
  constexpr int kVec = kQ8 ? 16 : 4;  // values per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  static_assert(kTile <= kThreads, "one thread per slot fills the row offsets");
  static_assert(kSplitAlign % kTile == 0, "a range is a whole number of tiles");
  static_assert(kMaxGqa * HD <= kTile * (HD + 1), "the range's output fits in the drained k_s");

  F32Smem<HD, kQ8>& sm = f32_smem<HD, kQ8>();
  float* part_s = &sm.k[0][0];  // after the loop: the range's unnormalised output [gqa][HD]

  const int tid = threadIdx.x;
  const Range range = range_of(length, split, split_slots, pages_per_seq * page_size);
  if (dead_range<float, HD>(range, split, ob, gqa)) return;

  for (int i = tid; i < gqa * HD; i += kThreads) sm.q[i / HD][i % HD] = qb[i];
  for (int g = tid; g < gqa; g += kThreads) {
    sm.m[g] = -INFINITY;
    sm.l[g] = 0.f;
  }

  // PV phase layout: acc[j][i] is column lane + 32 i of query row warp + kWarps j
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[kRows][kCols];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[j][i] = 0.f;
  __syncthreads();

  for (int s0 = range.s_lo; s0 < range.s_end; s0 += kTile) {
    const int n = min(kTile, range.s_end - s0);
    if (tid < n) {
      const int slot = s0 + tid;
      int page = table[slot / page_size];
      page = min(max(page, 0), num_pages - 1);  // never read outside the pool
      const int64_t row = (head_pages + page) * page_size + slot % page_size;
      sm.row[tid] = row * HD;
      if constexpr (kQ8) {
        sm.ksc[tid] = k_scales[row];
        sm.vsc[tid] = v_scales[row];
      }
    }
    __syncthreads();

    for (int i = tid; i < n * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      if constexpr (kQ8) {  // int8 -> fp32 is exact
        const int4 kr = *reinterpret_cast<const int4*>(k_pages + sm.row[t] + c);
        const int4 vr = *reinterpret_cast<const int4*>(v_pages + sm.row[t] + c);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sm.k[t][c + e] = (float)kb[e];
          sm.v[t][c + e] = (float)vb[e];
        }
      } else {
        const float4 kr = *reinterpret_cast<const float4*>(k_pages + sm.row[t] + c);
        const float4 vr = *reinterpret_cast<const float4*>(v_pages + sm.row[t] + c);
        sm.k[t][c] = kr.x, sm.k[t][c + 1] = kr.y, sm.k[t][c + 2] = kr.z, sm.k[t][c + 3] = kr.w;
        sm.v[t][c] = vr.x, sm.v[t][c + 1] = vr.y, sm.v[t][c + 2] = vr.z, sm.v[t][c + 3] = vr.w;
      }
    }
    __syncthreads();

    // scores s[g][t] = (q_g . k_t) * scale [* key scale]; slots past the length are -inf
    for (int i = tid; i < gqa * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i % kTile;
      float s = -INFINITY;
      if (t < n) {
        float a = 0.f;
#pragma unroll 16
        for (int e = 0; e < HD; ++e) a += sm.q[g][e] * sm.k[t][e];
        s = a * scale;
        if constexpr (kQ8) s *= sm.ksc[t];
      }
      sm.p[g][t] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row; NaN-free when a tile is all -inf
    for (int g = warp; g < gqa; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sm.p[g][t]);
      mx = warp_max(mx);
      const float m_prev = sm.m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float s = sm.p[g][t];
        const float p = isfinite(s) ? expf(s - m_safe) : 0.f;
        if constexpr (kQ8)
          sm.p[g][t] = t < n ? p * sm.vsc[t] : 0.f;
        else
          sm.p[g][t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        sm.alpha[g] = alpha;
        sm.l[g] = alpha * sm.l[g] + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = alpha[g] * acc[g][d] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int g = warp + j * kWarps;
      if (g < gqa) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[j][i] *= sm.alpha[g];
      }
    }
    for (int t = 0; t < n; ++t) {
      float v[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) v[i] = sm.v[t][lane + 32 * i];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int g = warp + j * kWarps;
        if (g < gqa) {
          const float p = sm.p[g][t];
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[j][i] += p * v[i];
        }
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int g = warp + j * kWarps;
    if (g < gqa) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) part_s[g * HD + lane + 32 * i] = acc[j][i];
    }
  }
  combine_splits<float, HD, false>(sm.m, sm.l, part_s, ob, gqa, range.n_live, split);
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

// A ring row of the bf16 body: HD elements whose 16-byte chunks are permuted
// by chunk ^ (row % 8) where a row holds a multiple of 8 chunks (hd 64, 128,
// 256), else HD + 8 elements in order (hd 96: 13 chunks, so the 8 rows an
// ldmatrix reads at one chunk meet 8 distinct bank groups). Element offset of
// chunk ch of row r: at(r, ch).
template <int HD>
struct Ring {
  static constexpr bool kSwizzle = HD % 64 == 0;
  static constexpr int kLd = kSwizzle ? HD : HD + 8;
  __device__ static __forceinline__ int at(int r, int ch) {
    return r * kLd + ((kSwizzle ? ch ^ (r & 7) : ch) << 3);
  }
};

// A ring tile: the K tile or the V tile of 64 slots and, over int8 pages
// (kQ8), its 64 scales. An int8 row is HD + 16 bytes: the 8 rows a fragment
// load reads meet in 8 distinct bank groups.
template <int HD, bool kQ8>
struct RingTile {
  static constexpr int kRowBytes = kQ8 ? HD + 16 : Ring<HD>::kLd * 2;
  static constexpr int kRowsBytes = kMmaTile * kRowBytes;
  static constexpr int kBytes = kRowsBytes + (kQ8 ? kMmaTile * 4 : 0);
};

// What the drained ring holds: the warps' partial outputs [warp][16][HD] and
// the block's partial (m, l and the output of 16 rows)
template <int HD>
__host__ __device__ constexpr int mma_epilogue_bytes() {
  return kWarps * kMmaRows * HD * 4 + (2 * kMmaRows + kMmaRows * HD) * 4;
}

template <int HD, bool kQ8>
__host__ __device__ constexpr int mma_ring_bytes(int ring_tiles) {
  return ring_tiles * RingTile<HD, kQ8>::kBytes > mma_epilogue_bytes<HD>()
             ? ring_tiles * RingTile<HD, kQ8>::kBytes
             : mma_epilogue_bytes<HD>();
}

// the q tile, and each query row's output offset and live ranges
template <int HD>
__host__ __device__ constexpr int mma_fixed_bytes() {
  return kMmaRows * (HD + 8) * 2 + kMmaRows * (8 + 4);
}

// page ids a range of split_slots slots can touch, whatever its first slot
__host__ __device__ inline int range_pages(int split_slots, int page_size) {
  return (split_slots - 1) / page_size + 2;
}

// ... and each slot's row in its head's pool: split_slots ints (a whole
// number of 64-slot tiles: 16-byte aligned)
template <int HD, bool kQ8>
int mma_smem_bytes(int ring_tiles, int split_slots, int page_size) {
  return mma_ring_bytes<HD, kQ8>(ring_tiles) + mma_fixed_bytes<HD>() + split_slots * 4 +
         (range_pages(split_slots, page_size) * 4 + 15) / 16 * 16;
}

// two int8 values, lo in bits 0-7 and hi in bits 8-15 of w -> a bf16x2
// register, lo in the low half, exactly and without int-to-float converts
// (a quarter of the ALU's rate): a byte u = x + 128 becomes the low byte of
// the fp32 2^23 + u, which less 2^23 + 128 is x; an integer of magnitude at
// most 128 has zeros in its fp32's low 16 bits, so its bf16 is the upper half
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// slot / page_size as a multiply by magic = ceil(2^32 / page_size): exact
// while slot * page_size < 2^32, which the plan checks for the whole table
__host__ __device__ inline uint64_t page_magic(int page_size) {
  return (0x100000000ull + (uint64_t)page_size - 1) / (uint64_t)page_size;
}

__device__ __forceinline__ int page_of(int slot, uint64_t magic) {
  return (int)(((uint64_t)slot * magic) >> 32);
}

// The combine of a bf16 block's query rows, run by the live blocks of the
// group (splits 0 .. n_live_max - 1): pm, pl [16] and pacc [16][HD] are this
// block's partial (the same offsets in every block of the cluster); row r's
// output lies at out + row_off[r] and adds the partials of its own live
// splits 0 .. row_live[r] - 1 in that order, as the decode kernel at that
// row's length adds them (a later split, live only for later rows, adds
// nothing). Block `split` writes its share of the n_rows * HD outputs,
// combine_splits' arithmetic element by element. One live block writes its
// own partial: the same bits as the sums, whose one weight is then e^0 = 1,
// without a cluster barrier.
template <int HD>
__device__ __forceinline__ void combine_rows(const float* pm, const float* pl, const float* pacc,
                                             __nv_bfloat16* __restrict__ out,
                                             const int64_t* row_off, const int* row_live,
                                             int n_rows, int n_live_max, int split) {
  if (n_live_max == 1) {
    __syncthreads();  // the block's partial is in place
    for (int e = threadIdx.x; e < n_rows * HD; e += kThreads)
      out[row_off[e / HD] + e % HD] = __float2bfloat16(pacc[e] / fmaxf(pl[e / HD], 1e-30f));
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in place
  const int total = n_rows * HD;
  const int lo = split * total / n_live_max, hi = (split + 1) * total / n_live_max;
  for (int e = lo + (int)threadIdx.x; e < hi; e += kThreads) {
    const int r = e / HD, n_live = row_live[r];
    float ms[kMaxCluster], ls[kMaxCluster], as[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {  // every load in flight before the first add
      if (s < n_live) {
        ms[s] = cluster.map_shared_rank(pm, s)[r];
        ls[s] = cluster.map_shared_rank(pl, s)[r];
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
        const float w = exp2f(ms[s] - m_use);
        l += w * ls[s];
        a += w * as[s];
      }
    }
    out[row_off[r] + e % HD] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// One block's range for up to 16 query rows, shared by the bf16 decode and
// chunk kernels (see the note at the top). The rows are rows row_lo ..
// row_lo + n_rows - 1 of the C x gqa query rows of one (sequence, kv head),
// ordered (chunk position c, head h): row R is position R / gqa, head R %
// gqa, at element offset row0 + (c nh + h) HD of q and out, and sees the
// slots below base_length + c (the decode kernel: C = 1). Their lengths do
// not decrease with R, so the last row's bounds the range's tiles.
//
// Dynamic shared memory: the ring of `ring_tiles` K or V tiles (once drained,
// the warps' partial outputs and the block's partial), the q tile (once read,
// the warps' m and l), each row's output offset and
// live ranges, the range's page ids. Ring rows are laid out by Ring<HD> (bf16
// pages) or RingTile<HD, true> (int8 pages), so that the 8 rows a fragment
// load reads meet in no bank. Ring tile n is the K (n even) or the V (n odd)
// tile of the range's tile n / 2, in ring place n % ring_tiles: tile j's
// scores wait for its K tile alone, and while they and its products run, its
// V tile and the next tiles land.
//
// Up to head_dim 128 a warp keeps its q fragments in registers from the
// first tile on; at 256 they would take 64 registers beside the 128 of its
// output, so it reads them from the q tile again for every tile.
//
// Over int8 pages (kQ8) the K and V tiles are copied into the ring as they
// lie in the pool, half the bytes of bf16, with their scales; each fragment
// is read from the ring as int8 and converted to bf16 in registers, exactly.
// The key scale multiplies the scores after the contraction; P is rounded to
// bf16, multiplied by the bf16 value scale and rounded again before P V: the
// gather route's order (ops/paged_attention.py::paged_attention_gather).
template <int HD, bool kQ8>
__device__ __forceinline__ void attend_rows_mma(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int64_t row0, int nh,
    int gqa, int row_lo, int n_rows, int base_length, const int* __restrict__ table,
    const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ k_pages,
    const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales, int64_t head_pages,
    int num_pages, int page_size, uint64_t magic, int pages_per_seq, float scale_log2, int split,
    int split_slots, int ring_tiles) {
  using RT = RingTile<HD, kQ8>;
  constexpr int LD = HD + 8;  // q tile row stride: its ldmatrix is free of bank conflicts
  constexpr int kChunks = kQ8 ? HD / 16 : HD / 8;  // 16-byte pieces a row
  constexpr int RB = RT::kRowBytes;
  constexpr bool kQRegs = HD <= 128;  // q fragments kept in registers
  static_assert(2 * kWarps * kMmaRows * 4 <= kMmaRows * LD * 2,
                "the warps' m and l fit in the q tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(ring + mma_ring_bytes<HD, kQ8>(ring_tiles));
  int64_t* row_off = reinterpret_cast<int64_t*>(q_s + kMmaRows * LD);
  int* row_live = reinterpret_cast<int*>(row_off + kMmaRows);
  int* slot_row = row_live + kMmaRows;  // [split_slots]: a slot's row in its head's pool
  int* pid_s = slot_row + split_slots;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int capacity = pages_per_seq * page_size;
  const int s_lo = split * split_slots, s_hi = s_lo + split_slots;
  // the page ids of the whole range, asked for while the length arrives
  const int p_lo = s_lo / page_size;
  const int n_pages = min(pages_per_seq, (s_hi - 1) / page_size + 1) - p_lo;
  for (int i = tid; i < n_pages; i += kThreads)
    pid_s[i] = min(max(table[p_lo + i], 0), num_pages - 1);  // never read outside the pool
  // row r: its live slots (clamped to the table, for memory safety only: a
  // longer length is the caller's error and its result undefined) and offset
  auto row_length = [&](int r) {
    return max(0, min(base_length + (row_lo + r) / gqa, capacity));
  };
  auto row_offset = [&](int r) {
    const int R = row_lo + r;
    return row0 + ((int64_t)(R / gqa) * nh + R % gqa) * HD;
  };
  const int len_max = row_length(n_rows - 1);
  const int end_max = min(len_max, s_hi);
  const int n_live_max = (len_max + split_slots - 1) / split_slots;
  if (s_lo >= end_max) {  // no row has a live slot here; split 0 of rows without any writes zeros
    if (n_live_max == 0 && split == 0)
      for (int e = tid; e < n_rows * HD; e += kThreads)
        out[row_offset(e / HD) + e % HD] = __float2bfloat16(0.f);
    return;
  }
  if (tid < n_rows) {
    row_off[tid] = row_offset(tid);
    row_live[tid] = (row_length(tid) + split_slots - 1) / split_slots;
  }
  for (int i = tid; i < kMmaRows * (HD / 8); i += kThreads) {  // rows >= n_rows are zero
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    tc::cp_async16(q_s + r * LD + c, q + (r < n_rows ? row_offset(r) + c : 0), r < n_rows);
  }
  __syncthreads();  // the page ids
  // each live slot's row in its head's pool, once for both of its tiles
  for (int i = tid; i < end_max - s_lo; i += kThreads) {
    const int slot = s_lo + i, p = page_of(slot, magic);
    slot_row[i] = pid_s[p - p_lo] * page_size + (slot - p * page_size);
  }
  __syncthreads();  // ... before the tile loads read them

  // ring tile n into its place; slots at or past the rows' end are zero (a
  // stale V row could hold a NaN that p = 0 would not cancel)
  const int64_t head_row = head_pages * page_size;
  auto load_tile = [&](int n) {
    unsigned char* dst = ring + (n % ring_tiles) * RT::kBytes;
    const auto* pages = (n & 1) ? v_pages : k_pages;
    const int r0 = (n >> 1) * kMmaTile, live = end_max - s_lo - r0;  // rows r < live are live
    static_assert(kMmaTile * kChunks % kThreads == 0, "a tile is whole 16-byte pieces a thread");
#pragma unroll
    for (int k = 0; k < kMmaTile * kChunks / kThreads; ++k) {
      const int i = tid + k * kThreads, r = i / kChunks, ch = i % kChunks;
      const bool ok = r < live;
      const int64_t row = head_row + (ok ? slot_row[r0 + r] : 0);
      if constexpr (kQ8)
        tc::cp_async16(dst + r * RB + ch * 16, pages + row * HD + ch * 16, ok);
      else
        tc::cp_async16(dst + Ring<HD>::at(r, ch) * 2, pages + row * HD + ch * 8, ok);
    }
    if constexpr (kQ8) {  // the slots' scales; zero past the end
      if (tid < kMmaTile) {
        const bool ok = tid < live;
        tc::cp_async4(reinterpret_cast<float*>(dst + RT::kRowsBytes) + tid,
                      ((n & 1) ? v_scales : k_scales) + head_row + (ok ? slot_row[r0 + tid] : 0),
                      ok);
      }
    }
  };
  const int n_tiles = (end_max - s_lo + kMmaTile - 1) / kMmaTile;
  const int n_ring = 2 * n_tiles;  // ring tiles of the range: K, V of each tile
  for (int n = 0; n < ring_tiles; ++n) {  // one group a ring tile, the q tile in the first
    if (n < n_ring) load_tile(n);
    tc::cp_async_commit();
  }

  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (base 2)
  float l[2] = {0.f, 0.f};
  const int g = lane / 4, t = lane % 4;  // the lane's rows g and g + 8, its pair 2 t, 2 t + 1
  // the end of the lane's rows within the range (at or below s_lo: no slot)
  const int end[2] = {g < n_rows ? min(row_length(g), s_hi) : s_lo,
                      g + 8 < n_rows ? min(row_length(g + 8), s_hi) : s_lo};
  const int r8 = lane % 8;  // the row of its matrix a lane addresses

  for (int j = 0; j < n_tiles; ++j) {
    // groups committed: ring_tiles, one at j = 0's middle, two an iteration since
    cp_async_wait_upto(j == 0 ? ring_tiles - 1 : ring_tiles - 2);  // K of tile j has landed
    __syncthreads();  // ... for every thread, and every warp is done with V of tile j - 1
    if (j > 0) {
      if (2 * j - 1 + ring_tiles < n_ring) load_tile(2 * j - 1 + ring_tiles);
      tc::cp_async_commit();
    }
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          tc::ldmatrix_x4(qf[kk], q_s + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
    }
    const int key0 = s_lo + j * kMmaTile + warp * 16;  // the warp's 16 slots
    const bool live = key0 < end_max;
    float s[2][4];
    if (live) {
      const unsigned char* kt =
          ring + ((2 * j) % ring_tiles) * RT::kBytes + warp * 16 * RB;  // the warp's K rows
      const float* ksc = reinterpret_cast<const float*>(ring + ((2 * j) % ring_tiles) * RT::kBytes +
                                                        RT::kRowsBytes) + warp * 16;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          tc::ldmatrix_x4(qa, q_s + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        }
        if constexpr (kQ8) {  // b0: dims 2t, 2t+1 of slot g (of n-tile i); b1: dims + 8
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const unsigned char* kr = kt + (i * 8 + g) * RB + kk * 16 + 2 * t;
            tc::mma_bf16(s[i], qa, int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(kr)),
                         int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(kr + 8)));
          }
        } else {
          uint32_t kb[4];
          tc::ldmatrix_x4(kb, reinterpret_cast<const __nv_bfloat16*>(kt) +
                                  Ring<HD>::at((lane / 16) * 8 + r8, kk * 2 + (lane / 8) % 2));
          tc::mma_bf16(s[0], qa, kb[0], kb[1]);
          tc::mma_bf16(s[1], qa, kb[2], kb[3]);
        }
      }

      // online softmax over the warp's slots, each row masked at its own
      // end, NaN-free for a row with no live slot yet; a row's state lives in
      // the 4 lanes of a quad. A row with no live slot among the 16 keeps its
      // m, l and acc bit for bit (alpha = e^0 = 1, or 0 on a state of zeros)
      const bool masked = key0 + 16 > min(end[0], end[1]);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * scale_log2;
          if constexpr (kQ8) x *= ksc[i * 8 + 2 * t + (e & 1)];
          if (masked && key0 + i * 8 + 2 * t + (e & 1) >= end[e >> 1]) x = -INFINITY;
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
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // else acc * 1 = acc
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[i][0] *= alpha[0];
          acc[i][1] *= alpha[0];
          acc[i][2] *= alpha[1];
          acc[i][3] *= alpha[1];
        }
      }
    }
    cp_async_wait_upto(ring_tiles - 2);  // V of tile j has landed
    __syncthreads();                     // ... for every thread, and every warp is done with K of tile j
    if (2 * j + ring_tiles < n_ring) load_tile(2 * j + ring_tiles);
    tc::cp_async_commit();
    if (live) {
      const unsigned char* vt =
          ring + ((2 * j + 1) % ring_tiles) * RT::kBytes + warp * 16 * RB;  // the warp's V rows
      // O += P V, P rounded to bf16 in registers (the accumulators of the
      // two n-tiles are the A fragment)
      if constexpr (kQ8) {  // P rounded, times the bf16 value scale, rounded again
        const float* vsc = reinterpret_cast<const float*>(
                               ring + ((2 * j + 1) % ring_tiles) * RT::kBytes + RT::kRowsBytes) +
                           warp * 16;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][e] = __bfloat162float(__float2bfloat16(s[i][e])) *
                      __bfloat162float(__float2bfloat16(vsc[i * 8 + 2 * t + (e & 1)]));
      }
      const uint32_t pa[4] = {tc::pack_bf16(s[0][0], s[0][1]), tc::pack_bf16(s[0][2], s[0][3]),
                              tc::pack_bf16(s[1][0], s[1][1]), tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        if constexpr (kQ8) {  // b0: slots 2t, 2t+1 of dim g (of n-tile nt); b1: slots + 8
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const unsigned char* vc = vt + 2 * t * RB + d2 * 16 + nt * 8 + g;
            tc::mma_bf16(acc[2 * d2 + nt], pa, int8x2_to_bf16x2(vc[0] | vc[RB] << 8),
                         int8x2_to_bf16x2(vc[8 * RB] | vc[9 * RB] << 8));
          }
        } else {
          uint32_t vb[4];
          tc::ldmatrix_x4_trans(
              vb, reinterpret_cast<const __nv_bfloat16*>(vt) +
                      Ring<HD>::at(((lane / 8) % 2) * 8 + r8, d2 * 2 + lane / 16));
          tc::mma_bf16(acc[2 * d2], pa, vb[0], vb[1]);
          tc::mma_bf16(acc[2 * d2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is drained and q is read: the warps' partials move in

  float* wm = reinterpret_cast<float*>(q_s);     // [warp][16]
  float* wl = wm + kWarps * kMmaRows;            // [warp][16]
  float* wacc = reinterpret_cast<float*>(ring);  // [warp][16][HD]
  float* pm = wacc + kWarps * kMmaRows * HD;     // the block's partial: m [16], l [16],
  float* pl = pm + kMmaRows;                     // acc [16][HD]
  float* pacc = pl + kMmaRows;
  if (t == 0) {
    wm[warp * kMmaRows + g] = m[0];
    wm[warp * kMmaRows + g + 8] = m[1];
    wl[warp * kMmaRows + g] = l[0];
    wl[warp * kMmaRows + g + 8] = l[1];
  }
  float* wa = wacc + warp * kMmaRows * HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (g < n_rows)
      *reinterpret_cast<float2*>(wa + g * HD + col) = make_float2(acc[i][0], acc[i][1]);
    if (g + 8 < n_rows)
      *reinterpret_cast<float2*>(wa + (g + 8) * HD + col) = make_float2(acc[i][2], acc[i][3]);
  }
  __syncthreads();

  // the block's partial: the warps' states added in warp order
  for (int e = tid; e < n_rows * HD; e += kThreads) {
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
  combine_rows<HD>(pm, pl, pacc, out, row_off, row_live, n_rows, n_live_max, split);
}

// ---------------------------------------------------------------------------
// kernels: grid (splits [x C], nkv, B); the splits of one row are one cluster
// ---------------------------------------------------------------------------

// Decode: one query token per sequence. kQ8: int8 pages and their scales
// (k_scales, v_scales [nkv, P, ps] fp32); otherwise both are null.
template <int HD, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const std::conditional_t<kQ8, int8_t, float>* __restrict__ k_pages,
                    const std::conditional_t<kQ8, int8_t, float>* __restrict__ v_pages,
                    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                    const int* __restrict__ lengths, const int* __restrict__ tables,
                    float* __restrict__ out, int nh, int nkv, int num_pages, int page_size,
                    int pages_per_seq, float scale, int splits, int split_slots) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = ((int64_t)b * nh + (int64_t)kvh * gqa) * HD;
  attend_split_f32<HD, kQ8>(q + rows, out + rows, lengths[b], tables + (int64_t)b * pages_per_seq,
                            k_pages, v_pages, k_scales, v_scales, (int64_t)kvh * num_pages, gqa,
                            num_pages, page_size, pages_per_seq, scale, split, split_slots);
}

template <int HD, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ k_pages,
                        const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ v_pages,
                        const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                        const int* __restrict__ lengths, const int* __restrict__ tables,
                        __nv_bfloat16* __restrict__ out, int nh, int nkv, int num_pages,
                        int page_size, uint64_t magic, int pages_per_seq, float scale_log2,
                        int splits, int split_slots, int ring_tiles) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  attend_rows_mma<HD, kQ8>(q, out, ((int64_t)b * nh + (int64_t)kvh * gqa) * HD, nh, gqa, 0, gqa,
                           lengths[b], tables + (int64_t)b * pages_per_seq, k_pages, v_pages,
                           k_scales, v_scales, (int64_t)kvh * num_pages, num_pages, page_size,
                           magic, pages_per_seq, scale_log2, split, split_slots, ring_tiles);
}

// Chunk (speculative verify): C query tokens per sequence, q and out
// [B, C, nh, HD]; query c of sequence b sees slots < base_lengths[b] + c.
// fp32: blockIdx.x = c * splits + split, the cluster of a chunk position is a
// decode cluster at length base + c. bf16: blockIdx.x = group * splits +
// split, the C x gqa query rows of a (sequence, kv head), ordered (c, h), cut
// into groups of 16: a group's cluster reads each K/V tile of the row once
// for all its rows, each row masked at its own length.
template <int HD, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const float* __restrict__ q,
                   const std::conditional_t<kQ8, int8_t, float>* __restrict__ k_pages,
                   const std::conditional_t<kQ8, int8_t, float>* __restrict__ v_pages,
                   const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                   const int* __restrict__ base_lengths, const int* __restrict__ tables,
                   float* __restrict__ out, int chunk, int nh, int nkv, int num_pages,
                   int page_size, int pages_per_seq, float scale, int splits, int split_slots) {
  const int c = blockIdx.x / splits, split = blockIdx.x % splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int64_t rows = (((int64_t)b * chunk + c) * nh + (int64_t)kvh * gqa) * HD;
  attend_split_f32<HD, kQ8>(q + rows, out + rows, base_lengths[b] + c,
                            tables + (int64_t)b * pages_per_seq, k_pages, v_pages, k_scales,
                            v_scales, (int64_t)kvh * num_pages, gqa, num_pages, page_size,
                            pages_per_seq, scale, split, split_slots);
}

template <int HD, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ k_pages,
                       const std::conditional_t<kQ8, int8_t, __nv_bfloat16>* __restrict__ v_pages,
                       const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                       const int* __restrict__ base_lengths, const int* __restrict__ tables,
                       __nv_bfloat16* __restrict__ out, int chunk, int nh, int nkv, int num_pages,
                       int page_size, uint64_t magic, int pages_per_seq, float scale_log2,
                       int splits, int split_slots, int ring_tiles) {
  const int group = blockIdx.x / splits, split = blockIdx.x % splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int gqa = nh / nkv;
  const int row_lo = group * kMmaRows;
  attend_rows_mma<HD, kQ8>(q, out, ((int64_t)b * chunk * nh + (int64_t)kvh * gqa) * HD, nh, gqa,
                           row_lo, min(kMmaRows, chunk * gqa - row_lo), base_lengths[b],
                           tables + (int64_t)b * pages_per_seq, k_pages, v_pages, k_scales,
                           v_scales, (int64_t)kvh * num_pages, num_pages, page_size, magic,
                           pages_per_seq, scale_log2, split, split_slots, ring_tiles);
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
// fp32 takes no ring and the fp32 body's own dynamic shared memory (0 up to
// head_dim 128), bf16 a ring of 2 to kMaxRingTiles K and V tiles, exactly
// this file's shared bytes for them, and a table whose slots times its page
// size stay below 2^32 (page_of's exact range).
template <int HD, bool kQ8>
bool plan_ok(int dtype, int gqa, int page_size, int pages_per_seq, int split_slots, int splits,
             int ring_tiles, int smem_bytes) {
  const int64_t capacity = (int64_t)page_size * pages_per_seq;
  if (split_slots <= 0 || split_slots % kSplitAlign != 0 || splits < 1 || splits > kMaxCluster ||
      splits != (capacity + split_slots - 1) / split_slots)
    return false;
  if (dtype == 0)
    return gqa <= kMaxGqa && ring_tiles == 0 && smem_bytes == f32_smem_bytes<HD, kQ8>();
  return gqa <= kMaxGqa && ring_tiles >= 2 && ring_tiles <= kMaxRingTiles &&
         smem_bytes == mma_smem_bytes<HD, kQ8>(ring_tiles, split_slots, page_size) &&
         (size_t)smem_bytes <= kMaxSharedBytes && capacity * page_size < (int64_t{1} << 32);
}

template <int HD, bool kQ8>
int dispatch(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
             const void* v_scales, const void* lengths, const void* tables, void* out, int batch,
             int chunk, int nh, int nkv, int num_pages, int page_size, int pages_per_seq,
             int dtype, int split_slots, int splits, int ring_tiles, int smem_bytes, float scale,
             cudaStream_t s) {
  if (nh % nkv != 0 ||
      !plan_ok<HD, kQ8>(dtype, nh / nkv, page_size, pages_per_seq, split_slots, splits,
                        ring_tiles, smem_bytes) ||
      (int64_t)num_pages * page_size >= (int64_t{1} << 31))  // a slot's row is an int
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  using F32Page = std::conditional_t<kQ8, int8_t, float>;
  using Bf16Page = std::conditional_t<kQ8, int8_t, bf16>;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* lens = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(tables);
  const float scale_log2 = scale * 1.4426950408889634f;
  const uint64_t magic = page_magic(page_size);
  // fp32: a cluster a chunk position; bf16: a cluster a group of 16 query rows
  const int x = chunk == 0 ? splits
                           : splits * (dtype == 0 ? chunk : (chunk * (nh / nkv) + kMmaRows - 1) / kMmaRows);
  if (dtype == 0 && chunk == 0)
    return launch_clusters(paged_decode_kernel<HD, kQ8>, splits, x, nkv, batch, smem_bytes, s,
                           static_cast<const float*>(q), static_cast<const F32Page*>(k_pages),
                           static_cast<const F32Page*>(v_pages), ks, vs, lens, tab,
                           static_cast<float*>(out), nh, nkv, num_pages, page_size,
                           pages_per_seq, scale, splits, split_slots);
  if (dtype == 0)
    return launch_clusters(paged_chunk_kernel<HD, kQ8>, splits, x, nkv, batch, smem_bytes, s,
                           static_cast<const float*>(q), static_cast<const F32Page*>(k_pages),
                           static_cast<const F32Page*>(v_pages), ks, vs, lens, tab,
                           static_cast<float*>(out), chunk, nh, nkv, num_pages, page_size,
                           pages_per_seq, scale, splits, split_slots);
  if (chunk == 0)
    return launch_clusters(paged_decode_mma_kernel<HD, kQ8>, splits, x, nkv, batch, smem_bytes,
                           s, static_cast<const bf16*>(q), static_cast<const Bf16Page*>(k_pages),
                           static_cast<const Bf16Page*>(v_pages), ks, vs, lens, tab,
                           static_cast<bf16*>(out), nh, nkv, num_pages, page_size, magic,
                           pages_per_seq, scale_log2, splits, split_slots, ring_tiles);
  return launch_clusters(paged_chunk_mma_kernel<HD, kQ8>, splits, x, nkv, batch, smem_bytes, s,
                         static_cast<const bf16*>(q), static_cast<const Bf16Page*>(k_pages),
                         static_cast<const Bf16Page*>(v_pages), ks, vs, lens, tab,
                         static_cast<bf16*>(out), chunk, nh, nkv, num_pages, page_size, magic,
                         pages_per_seq, scale_log2, splits, split_slots, ring_tiles);
}

// fp pages at head_dim 64, 96, 128 and 256; int8 pages (k_scales non-null)
// at 128 and 256, the layouts where the JAX package's TPU route reads pages
// in place
int dispatch_hd(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                const void* v_scales, const void* lengths, const void* tables, void* out,
                int batch, int chunk, int nh, int nkv, int num_pages, int page_size,
                int pages_per_seq, int head_dim, int dtype, int split_slots, int splits,
                int ring_tiles, int smem_bytes, float scale, void* stream) {
  if (batch < 0 || batch > 65535 || chunk < 0 || nkv <= 0 || nkv > 65535 || page_size <= 0 ||
      num_pages <= 0 || pages_per_seq <= 0 || (dtype != 0 && dtype != 1) ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRASP_PAGED_DISPATCH(HD, Q8)                                                          \
  return dispatch<HD, Q8>(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, out,     \
                          batch, chunk, nh, nkv, num_pages, page_size, pages_per_seq, dtype, \
                          split_slots, splits, ring_tiles, smem_bytes, scale, s)
  if (k_scales != nullptr) {
    if (head_dim == 128) GRASP_PAGED_DISPATCH(128, true);
    if (head_dim == 256) GRASP_PAGED_DISPATCH(256, true);
    return (int)cudaErrorInvalidValue;
  }
  if (head_dim == 64) GRASP_PAGED_DISPATCH(64, false);
  if (head_dim == 96) GRASP_PAGED_DISPATCH(96, false);
  if (head_dim == 128) GRASP_PAGED_DISPATCH(128, false);
  if (head_dim == 256) GRASP_PAGED_DISPATCH(256, false);
#undef GRASP_PAGED_DISPATCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and, for fp pages, of the pages): 0 = float32, 1 = bfloat16.
// The plan (split_slots, splits, ring_tiles, smem_bytes) is
// ops/paged_attention.py::paged_plan's for the table's page size, pages per
// row, head_dim, group size and dtypes; a plan of another layout is refused.
// Returns 0 or a cudaError_t code; an unsupported head_dim, dtype, group size
// or plan returns cudaErrorInvalidValue.
extern "C" int grasp_paged_attention_decode(const void* q, const void* k_pages,
                                            const void* v_pages, const void* lengths,
                                            const void* tables, void* out, int batch, int nh,
                                            int nkv, int num_pages, int page_size,
                                            int pages_per_seq, int head_dim, int dtype,
                                            int split_slots, int splits, int ring_tiles,
                                            int smem_bytes, float scale, void* stream) {
  if (batch == 0) return 0;
  return dispatch_hd(q, k_pages, v_pages, nullptr, nullptr, lengths, tables, out, batch, 0, nh,
                     nkv, num_pages, page_size, pages_per_seq, head_dim, dtype, split_slots,
                     splits, ring_tiles, smem_bytes, scale, stream);
}

// The chunk form: q and out [batch, chunk, nh, head_dim], base_lengths [batch]
// (live slots seen by the chunk's first query). Same dtype codes, plan and
// return value; batch and nkv ride grid axes z and y (at most 65535 each).
extern "C" int grasp_paged_attention_chunk(const void* q, const void* k_pages,
                                           const void* v_pages, const void* base_lengths,
                                           const void* tables, void* out, int batch, int chunk,
                                           int nh, int nkv, int num_pages, int page_size,
                                           int pages_per_seq, int head_dim, int dtype,
                                           int split_slots, int splits, int ring_tiles,
                                           int smem_bytes, float scale, void* stream) {
  if (batch == 0 || chunk == 0) return 0;
  if (chunk < 0) return (int)cudaErrorInvalidValue;
  return dispatch_hd(q, k_pages, v_pages, nullptr, nullptr, base_lengths, tables, out, batch,
                     chunk, nh, nkv, num_pages, page_size, pages_per_seq, head_dim, dtype,
                     split_slots, splits, ring_tiles, smem_bytes, scale, stream);
}

// Both forms over int8 pages: k_pages, v_pages int8 [nkv, P, ps, hd] and
// their scales k_scales, v_scales fp32 [nkv, P, ps, 1]; q and out in dtype.
// chunk 0 is the decode form (q [batch, nh, hd]). head_dim 128 or 256.
extern "C" int grasp_paged_attention_int8(const void* q, const void* k_pages,
                                          const void* v_pages, const void* k_scales,
                                          const void* v_scales, const void* lengths,
                                          const void* tables, void* out, int batch, int chunk,
                                          int nh, int nkv, int num_pages, int page_size,
                                          int pages_per_seq, int head_dim, int dtype,
                                          int split_slots, int splits, int ring_tiles,
                                          int smem_bytes, float scale, void* stream) {
  if (batch == 0) return 0;
  if (chunk < 0 || k_scales == nullptr || v_scales == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_hd(q, k_pages, v_pages, k_scales, v_scales, lengths, tables, out, batch, chunk,
                     nh, nkv, num_pages, page_size, pages_per_seq, head_dim, dtype, split_slots,
                     splits, ring_tiles, smem_bytes, scale, stream);
}
