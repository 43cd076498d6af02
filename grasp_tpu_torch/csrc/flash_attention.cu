// Causal flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels,
// head_dim 64, 96, 128 and 256, float32 and bfloat16.
//
// Replaces the three TPU kernels of grasp_tpu/ops/pallas_attention.py (fp32
// body, bf16 body):
//   flash_fwd_kernel, flash_fwd_mma_kernel <- _flash_fwd_impl (Pallas body
//     `_kernel`)
//   flash_dkv_kernel, flash_dkv_mma_kernel + flash_dkv_reduce_kernel <-
//     _flash_bwd_impl, first pallas_call (`_dkv_kernel`)
//   flash_dq_kernel, flash_dq_mma_kernel <- _flash_bwd_impl, second
//     pallas_call (`_dq_kernel`)
//
// What they compute: q [B, nh, S, hd], k/v [B, nkv, S, hd], query head h reads
// kv head h / (nh / nkv). Scores s = (q . k) * scale, keys after the query's
// own position are masked, softmax over the keys, o = p . v. The forward keeps
// one log-sum-exp per query row (lse = m + log l) in place of the TPU kernel's
// separate m and l. The backward recomputes p = exp(s - lse) with the same
// scale and mask, ds = p * (dO . v - di) * scale with di = sum(o * dO) given by
// the caller, and dV = p^T dO, dK = ds^T q (summed over the q heads of a kv
// group), dQ = ds k. Neither pass writes an [S, S] matrix to device memory.
//
// What bounds them: at the calibration shape (S = 2047, hd = 64) attention
// does about S / 2 multiply-adds per byte it has to move, far above the card's
// balance point, so all three are bound by operations, not bytes.
//
// Design. The TPU kernels walk a sequential last grid axis and carry the
// softmax state (or the dK/dV, dQ sums) in scratch from step to step; CUDA
// blocks run in no order, so that axis is a loop inside the block. S is not
// padded: rows and columns >= S are masked in the kernel. Two sets of bodies,
// chosen by dtype:
// - bf16 takes the tensor-core kernels (mma.sync on bf16 tiles staged by
//   cp.async), described above each: flash_fwd_mma_kernel, and for the
//   backward flash_dq_mma_kernel and flash_dkv_mma_kernel, whose fp32 partials
//   of every q head flash_dkv_reduce_kernel adds up per kv group.
// - fp32 keeps the simple first design: 256 threads, every product is fp32
//   FMAs on CUDA cores from fp32 tiles in shared memory, each thread owning a
//   4 x 4 piece of the 64 x 64 score tile and a 4 x (hd / 16) piece of the
//   output tile (ColMap: 4 adjacent columns in each 64-column group at hd 64
//   and 128, 2 in each 32-column group at hd 96); p and ds stay fp32; no
//   pipelining. Forward and dQ: one block
//   per (batch * head, 64 query rows) loops over the 64-key tiles at or below
//   the diagonal. dK/dV: one block per (batch * kv head, 64 keys) loops over
//   the q heads of its group and the query tiles at or above the diagonal, so
//   the group sum needs no atomics and is the same from run to run. fp32
//   stays off the tensor cores because its gate (1e-4) is below what TF32
//   keeps.
// - head_dim 256 (Gemma). bf16: the accumulators of 256 output columns (128
//   fp32 registers a thread for O or dQ, 256 for dK and dV) do not fit beside
//   the score tiles, so a block owns one half of the output columns
//   (out_cols<256> = 128, a third grid axis of 2) and recomputes the scores of
//   its tile over the whole head_dim: the forward does 1.5x the products, dQ
//   5/3 and dK/dV 1.5x, with hd 128's registers. Q (and dO) fragments are read
//   from the resident tile each step instead of kept in registers. fp32: the
//   streamed tiles of the backward hold 32 rows (fp32_step<256>), so that
//   fp32 tiles of 256 columns fit in shared memory; dK/dV computes its tile
//   transposed (keys as rows) at every head_dim, which gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows (keys in dK/dV) of a block's resident tile

// rows of the streamed tiles of the fp32 backward (keys in dQ, queries in
// dK/dV): 64, and 32 at head_dim 256, where four fp32 tiles of 64 rows would
// take 266 KB of shared memory
template <int HD>
__host__ __device__ constexpr int fp32_step() { return HD > 128 ? 32 : 64; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// The columns of a [64, HD] output tile that thread tx (0..15) owns in the
// fp32 bodies: W adjacent columns in each of G groups of 16 * W columns, at
// tx * W + 16 * W * g; W * G = HD / 16. hd 64 and 128 take 4 columns a group
// (float4), hd 96 2 (float2) in 3 groups of 32.
template <int HD>
struct ColMap {
  static_assert(HD % 32 == 0, "the fp32 bodies take head dims that are multiples of 32");
  static constexpr int W = HD % 64 == 0 ? 4 : 2;
  static constexpr int G = HD / (16 * W);
};

// x[0 .. W) = src[0 .. W), one 16- or 8-byte shared-memory load
template <int W>
__device__ __forceinline__ void load_cols(float (&x)[W], const float* src) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x; x[1] = t.y;
  }
}

// max / sum over the 16 lanes that share a tile row (lane = ty * 16 + tx)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + R) of a [S, HD] matrix -> fp32 shared tile with row
// stride HD + 4; rows >= S are zero. 16-byte global loads.
template <typename T, int HD, int R = kTile>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int row0, int S, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  constexpr int kLd = HD + 4;
  for (int i = tid; i < R * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.f;
    }
    float* d = dst + r * kLd + c;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  }
}

// acc[i][j] += sum_d a[(ty*4+i)][d] * b[(tx+16j)][d]: the thread's 4 x NB/16
// piece of A B^T for a [64, HD] shared tile a and an [NB, HD] tile b (row
// stride HD + 4).
template <int HD, int NB>
__device__ __forceinline__ void tile_abt(float (&acc)[4][NB / 16], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = HD + 4;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[NB / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB / 16; ++j)
        acc[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_j p[(ty*4+i)][j] * b[j][cols(c)]: the thread's 4 x (HD/16)
// piece of P B for a [64, NB] shared p (stride NB + 4) and an [NB, HD] tile b,
// columns by ColMap<HD>; j runs in order.
template <int HD, int NB>
__device__ __forceinline__ void tile_pb(float (&acc)[4][HD / 16], const float* __restrict__ p,
                                        const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = HD + 4;
  constexpr int W = ColMap<HD>::W;
  for (int j0 = 0; j0 < NB; j0 += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * (NB + 4) + j0);
      pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int cc = 0; cc < ColMap<HD>::G; ++cc) {
        float bv[W];
        load_cols<W>(bv, b + (j0 + jj) * kLd + tx * W + 16 * W * cc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[i][cc * W + w] += pv[i][jj] * bv[w];
      }
    }
  }
}

// Write the thread's 4 x (HD/16) piece, scaled per row, to rows < S of a
// [S, HD] matrix.
template <typename T, int HD>
__device__ __forceinline__ void store_piece(T* __restrict__ dst, const float (&acc)[4][HD / 16],
                                            const float (&row_scale)[4], int row0, int S, int ty,
                                            int tx) {
  constexpr int W = ColMap<HD>::W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int cc = 0; cc < ColMap<HD>::G; ++cc) {
      T* d = dst + (int64_t)row * HD + tx * W + 16 * W * cc;
      const float* a = acc[i] + cc * W;
      if constexpr (W == 4)
        store4(d, a[0] * row_scale[i], a[1] * row_scale[i], a[2] * row_scale[i],
               a[3] * row_scale[i]);
      else
        store2(d, a[0] * row_scale[i], a[1] * row_scale[i]);
    }
  }
}

// fp32 layouts: Q, K, V and P (forward); two resident tiles of 64 rows, two
// streamed of fp32_step rows and one (dQ: ds) or two (dK/dV: p and ds) tiles
// of 64 x fp32_step
template <int HD>
constexpr int fwd_smem_bytes() { return (3 * kTile * (HD + 4) + kTile * (kTile + 4)) * (int)sizeof(float); }
template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * (kTile + fp32_step<HD>()) * (HD + 4) + kTile * (fp32_step<HD>() + 4)) * (int)sizeof(float);
}
template <int HD>
constexpr int dkv_smem_bytes() {
  return (2 * (kTile + fp32_step<HD>()) * (HD + 4) + 2 * kTile * (fp32_step<HD>() + 4)) *
         (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int nh, int nkv, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + 4;
  float* q_s = smem;
  float* k_s = q_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* p_s = v_s + kTile * kLd;

  const int qi = gridDim.x - 1 - blockIdx.x;  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* qh = q + (int64_t)bh * S * HD;
  const T* kh = k + ((int64_t)b * nkv + kvh) * S * HD;
  const T* vh = v + ((int64_t)b * nkv + kvh) * S * HD;

  load_tile<T, HD>(q_s, qh, qi * kTile, S, tid);

  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();  // the previous tile's reads of k_s, v_s, p_s are done
    load_tile<T, HD>(k_s, kh, kj * kTile, S, tid);
    load_tile<T, HD>(v_s, vh, kj * kTile, S, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt<HD, kTile>(s, q_s, k_s, ty, tx);

    // online softmax; NaN-free when a row of the tile is fully masked
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qi * kTile + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kj * kTile + tx + 16 * j;
        s[i][j] = (col <= row && col < S) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_safe);
        p_s[(ty * 4 + i) * (kTile + 4) + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pb<HD, kTile>(acc, p_s, v_s, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const int row = qi * kTile + ty * 4 + i;
    // a row that saw no key keeps lse = +inf, so the backward's p is 0
    if (tx == 0 && row < S) lse[(int64_t)bh * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
  store_piece<T, HD>(o + (int64_t)bh * S * HD, acc, inv, qi * kTile, S, ty, tx);
}

// ---------------------------------------------------------------------------
// forward, bf16, on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces grasp_tpu/ops/pallas_attention.py::_flash_fwd_impl (Pallas body
// `_kernel`) for bf16 inputs.
//
// What bounds it: operations (17.2 GFLOP at the calibration shape, B 1, 32
// over 4 heads, S 2047, hd 64, against 17 MB moved). The fp32-FMA body above
// cannot pass the card's 67 TFLOP/s fp32 rate; this one runs every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).
//
// Design (FlashAttention-2's shape on mma.sync):
// - a block holds 64 query rows in 4 warps; each warp owns 16 rows and keeps
//   their Q fragments in registers for the whole key loop (128 rows in 8
//   warps were slower on an H100: at about 146 registers a thread one such
//   block fills an SM's registers, where three of these fit);
// - K and V come in 64-key tiles by 16-byte cp.async into two shared-memory
//   stages, so tile j + 1 arrives while tile j is computed; rows are padded
//   by 16 bytes, which makes every ldmatrix free of bank conflicts;
// - S = Q K^T with K fragments by ldmatrix; the online softmax runs on the
//   accumulator fragments (a row lives in the 4 lanes of a quad: two
//   shuffles), in base 2 with scale * log2(e) folded in; only tiles that cross
//   the diagonal or the end of the sequence are masked;
// - P is rounded to bf16 in registers, as the TPU kernel rounds
//   p.astype(v.dtype), and is the A operand of P V directly (the accumulator
//   layout of two n-tiles is the A layout); V fragments by ldmatrix.trans;
// - a warp skips the products of a tile whose keys all lie after its rows;
// - the output goes through the warp's own rows of the Q tile and leaves in
//   16-byte stores; lse is written in natural-log units (m ln 2 + ln l), +inf
//   for a row that saw no key, as K1k and K1q read it.
// Blocks run the longest query tiles first. Stopping at mma.sync: wgmma with
// TMA and a producer warp (FlashAttention-3) is the next step.

constexpr int kMmaWarps = 4;
constexpr int kMmaTileM = kMmaWarps * 16;  // query rows a block
constexpr int kMmaTileN = 64;              // keys per tile

// output columns a bf16 block owns: all of them up to head_dim 128; at 256 a
// half, blockIdx.z picking which (the scores are recomputed by each half)
template <int HD>
__host__ __device__ constexpr int out_cols() { return HD > 128 ? 128 : HD; }

template <int HD>
constexpr int fwd_mma_smem_bytes() {
  return (kMmaTileM + 4 * kMmaTileN) * (HD + 8) * 2;
}

// rows [row0, row0 + R) of a [S, HD] bf16 matrix -> shared (row stride HD + 8);
// rows >= S are zero-filled
template <int R, int HD, int THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                        int S, int tid) {
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int i = tid; i < R * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < S;
    tc::cp_async16(dst + r * (HD + 8) + c, src + (int64_t)(ok ? row0 + r : 0) * HD + c, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int nh, int nkv, int S, float scale_log2) {
  constexpr int kThreadsM = kMmaWarps * 32;
  constexpr int BM = kMmaTileM;
  constexpr int BN = kMmaTileN;
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LD]
  __nv_bfloat16* k_s = q_s + BM * LD;                                // [2][BN][LD]
  __nv_bfloat16* v_s = k_s + 2 * BN * LD;                            // [2][BN][LD]

  constexpr int OC = out_cols<HD>();
  constexpr bool kQInRegisters = HD <= 128;  // else read from q_s each tile
  const int qi = gridDim.x - 1 - blockIdx.x;  // long rows first
  const int bh = blockIdx.y;
  const int c0 = OC == HD ? 0 : blockIdx.z * OC;  // the block's output columns [c0, c0 + OC)
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qi * BM;
  const int wrow0 = q0 + warp * 16;
  const __nv_bfloat16* qh = q + (int64_t)bh * S * HD;
  const __nv_bfloat16* kh = k + ((int64_t)b * nkv + kvh) * S * HD;
  const __nv_bfloat16* vh = v + ((int64_t)b * nkv + kvh) * S * HD;
  // key tiles holding a key at or before the block's last row
  const int n_tiles = (min(q0 + BM, S) - 1) / BN + 1;

  cp_rows<BM, HD, kThreadsM>(q_s, qh, q0, S, tid);
  cp_rows<BN, HD, kThreadsM>(k_s, kh, 0, S, tid);
  cp_rows<BN, HD, kThreadsM>(v_s, vh, 0, S, tid);
  tc::cp_async_commit();

  uint32_t qf[kQInRegisters ? HD / 16 : 1][4];
  const int qf_at = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // + kk * 16
  float acc[OC / 8][4];
#pragma unroll
  for (int i = 0; i < OC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (base 2)
  float l[2] = {0.f, 0.f};
  const int row_a = wrow0 + lane / 4;  // the lane's two rows: row_a, row_a + 8

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();  // tile j (and, at j = 0, Q) has landed
    __syncthreads();         // ... for every thread; stage (j + 1) & 1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      cp_rows<BN, HD, kThreadsM>(k_s + st * BN * LD, kh, (j + 1) * BN, S, tid);
      cp_rows<BN, HD, kThreadsM>(v_s + st * BN * LD, vh, (j + 1) * BN, S, tid);
    }
    tc::cp_async_commit();
    if constexpr (kQInRegisters) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          tc::ldmatrix_x4(qf[kk], q_s + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
    }
    const int kv0 = j * BN;
    if (kv0 > wrow0 + 15) continue;  // every key of the tile is after the warp's rows
    const __nv_bfloat16* ks = k_s + (j & 1) * BN * LD;
    const __nv_bfloat16* vs = v_s + (j & 1) * BN * LD;

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t q_frag[4];  // hd 256: this step's fragment, from shared
      if constexpr (!kQInRegisters) tc::ldmatrix_x4(q_frag, q_s + qf_at + kk * 16);
      const uint32_t(&qa)[4] = kQInRegisters ? qf[kQInRegisters ? kk : 0] : q_frag;
#pragma unroll
      for (int n2 = 0; n2 < BN / 16; ++n2) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, ks + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                                ((lane / 8) % 2) * 8);
        tc::mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax over the tile, NaN-free for a row with no live key
    const bool masked = kv0 + BN - 1 > wrow0 || kv0 + BN > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale_log2;
        if (masked) {
          const int col = kv0 + i * 8 + (lane % 4) * 2 + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col > row || col >= S) x = -INFINITY;
        }
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
      alpha[h] = exp2f(m[h] - m_use[h]);  // 0 while the row has seen no key
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
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
    for (int i = 0; i < OC / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < OC / 16; ++d2) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + c0 +
                                      d2 * 16 + (lane / 16) * 8);
        tc::mma_bf16(acc[2 * d2], pa, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    const int row = row_a + h * 8;
    // natural-log units; a row that saw no key keeps lse = +inf (p = 0 in the backward)
    if (lane % 4 == 0 && row < S && (OC == HD || blockIdx.z == 0))
      lse[(int64_t)bh * S + row] = l[h] > 0.f ? m[h] * 0.69314718055994531f + logf(l[h]) : INFINITY;
  }
  // the warp's own 16 rows of the Q tile (which only it reads) hold its
  // output rows, then 16-byte stores
  __nv_bfloat16* stage = q_s + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < OC / 8; ++i) {
    const int c = i * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(stage + (lane / 4) * LD + c) =
        tc::pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (lane / 4 + 8) * LD + c) =
        tc::pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* oh = o + (int64_t)bh * S * HD + c0;
#pragma unroll
  for (int i = lane; i < 16 * (OC / 8); i += 32) {
    const int r = i / (OC / 8);
    const int c = (i % (OC / 8)) * 8;
    if (wrow0 + r < S)
      *reinterpret_cast<uint4*>(oh + (int64_t)(wrow0 + r) * HD + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// backward, fp32
// ---------------------------------------------------------------------------

// dQ: one block per (64 query rows, batch * head) loops over the key tiles of
// NB = fp32_step keys at or below its last row: ds = p (dp - di) scale with
// p = exp(s - lse) under the forward's mask, then dQ += ds K.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, T* __restrict__ dq, int nh, int nkv, int S,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + 4;
  constexpr int NB = fp32_step<HD>();
  float* q_s = smem;
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + NB * kLd;
  float* ds_s = v_s + NB * kLd;  // [64][NB + 4]

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* kh = k + ((int64_t)b * nkv + kvh) * S * HD;
  const T* vh = v + ((int64_t)b * nkv + kvh) * S * HD;
  const int row0 = qi * kTile;
  const int n_tiles = (min(row0 + kTile, S) - 1) / NB + 1;  // key tiles at or below the last row

  load_tile<T, HD>(q_s, q + (int64_t)bh * S * HD, row0, S, tid);
  load_tile<T, HD>(do_s, dout + (int64_t)bh * S * HD, row0, S, tid);

  float lse_r[4], di_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    lse_r[i] = row < S ? lse[(int64_t)bh * S + row] : INFINITY;
    di_r[i] = row < S ? di[(int64_t)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  for (int kj = 0; kj < n_tiles; ++kj) {
    __syncthreads();
    load_tile<T, HD, NB>(k_s, kh, kj * NB, S, tid);
    load_tile<T, HD, NB>(v_s, vh, kj * NB, S, tid);
    __syncthreads();
    float s[4][NB / 16], dp[4][NB / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<HD, NB>(s, q_s, k_s, ty, tx);
    tile_abt<HD, NB>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const int col = kj * NB + tx + 16 * j;
        const bool live = col <= row && col < S && row < S;
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * 4 + i) * (NB + 4) + tx + 16 * j] = p * (dp[i][j] - di_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_pb<HD, NB>(acc, ds_s, k_s, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_piece<T, HD>(dq + (int64_t)bh * S * HD, acc, one, row0, S, ty, tx);
}

// dK/dV: one block per (64 keys, batch * kv head) loops over the q heads of
// its group and the query tiles of NB = fp32_step rows at or after its first
// key, so the group sum needs no atomics and is the same from run to run. The
// tile is computed transposed, keys as rows: s^T = K Q^T, dp^T = V dO^T,
// p^T = exp(s^T - lse), ds^T = p^T (dp^T - di) scale, then dV += p^T dO and
// dK += ds^T Q.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int nh,
                 int nkv, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + 4;
  constexpr int NB = fp32_step<HD>();
  float* k_s = smem;
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;
  float* do_s = q_s + NB * kLd;
  float* p_s = do_s + NB * kLd;         // [64][NB + 4]
  float* ds_s = p_s + kTile * (NB + 4);  // [64][NB + 4]

  const int kj = blockIdx.x;
  const int bkv = blockIdx.y;  // batch * nkv + kv head
  const int b = bkv / nkv;
  const int kvh = bkv % nkv;
  const int groups = nh / nkv;
  const int q_tiles = (S + NB - 1) / NB;
  const int first = kj * kTile / NB;  // query tiles before it end before the block's keys
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile<T, HD>(k_s, k + (int64_t)bkv * S * HD, kj * kTile, S, tid);
  load_tile<T, HD>(v_s, v + (int64_t)bkv * S * HD, kj * kTile, S, tid);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // fixed order: q heads of the group, then query tiles from the diagonal down
  for (int g = 0; g < groups; ++g) {
    const int64_t bh = (int64_t)b * nh + kvh * groups + g;
    const T* qh = q + bh * S * HD;
    const T* doh = dout + bh * S * HD;
    for (int qt = first; qt < q_tiles; ++qt) {
      __syncthreads();  // the previous step's reads of q_s, do_s, p_s, ds_s are done
      load_tile<T, HD, NB>(q_s, qh, qt * NB, S, tid);
      load_tile<T, HD, NB>(do_s, doh, qt * NB, S, tid);
      float lse_c[NB / 16], di_c[NB / 16];
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const int col = qt * NB + tx + 16 * j;
        lse_c[j] = col < S ? lse[bh * S + col] : INFINITY;
        di_c[j] = col < S ? di[bh * S + col] : 0.f;
      }
      __syncthreads();
      float sT[4][NB / 16], dpT[4][NB / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NB / 16; ++j) sT[i][j] = dpT[i][j] = 0.f;
      tile_abt<HD, NB>(sT, k_s, q_s, ty, tx);
      tile_abt<HD, NB>(dpT, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kj * kTile + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < NB / 16; ++j) {
          const int col = qt * NB + tx + 16 * j;  // the query
          const bool live = key <= col && col < S && key < S;
          const float p = live ? expf(sT[i][j] * scale - lse_c[j]) : 0.f;
          const int at = (ty * 4 + i) * (NB + 4) + tx + 16 * j;
          p_s[at] = p;
          ds_s[at] = p * (dpT[i][j] - di_c[j]) * scale;
        }
      }
      __syncthreads();
      tile_pb<HD, NB>(dv_acc, p_s, do_s, ty, tx);
      tile_pb<HD, NB>(dk_acc, ds_s, q_s, ty, tx);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_piece<T, HD>(dk + (int64_t)bkv * S * HD, dk_acc, one, kj * kTile, S, ty, tx);
  store_piece<T, HD>(dv + (int64_t)bkv * S * HD, dv_acc, one, kj * kTile, S, ty, tx);
}

// ---------------------------------------------------------------------------
// backward, bf16, on the tensor cores
// ---------------------------------------------------------------------------
//
// Replace grasp_tpu/ops/pallas_attention.py::_flash_bwd_impl (its two
// pallas_calls, `_dq_kernel` and `_dkv_kernel`) for bf16 inputs.
//
// What bounds them: operations. At the calibration shape (B 1, 32 over 4
// heads, S 2047, hd 64) dQ runs three products over the causal half (S, dP,
// dQ: 25.8 GFLOP) and dK/dV four (S, dP, dV, dK: 34.3 GFLOP) against about
// 20 MB moved. The CUDA-core bodies above stay under the card's 67 TFLOP/s
// fp32 rate; these run every product on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate) with K1f's skeleton: 4 warps of 16 rows, operand
// tiles by 16-byte cp.async into two shared-memory stages with rows padded by
// 16 bytes, only diagonal and ragged tiles masked, a warp skipping tiles that
// its rows do not reach. p = exp2(s * scale * log2(e) - lse * log2(e)) from
// the forward's natural-log lse.
//
// dQ (flash_dq_mma_kernel): one block per (64 query rows, batch * q head),
// longest rows first. Each warp keeps its Q and dO fragments in registers for
// the whole key loop; K and V arrive in tiles of 64 keys at hd 64 (32 at hd
// 96 and 128, where the accumulators of 96 or 128 columns leave no registers
// for a wider tile). S = Q K^T and dP = dO V^T on the tensor cores; ds = p
// (dp - di) scale is rounded to bf16 in registers, as the TPU kernel rounds
// ds.astype(k.dtype), and is the A operand of dQ += dS K directly (the
// accumulator layout of two n-tiles is the A layout); K fragments by
// ldmatrix.trans.
//
// dK/dV (flash_dkv_mma_kernel): the transposed tile, keys as rows. One block
// per (64 keys, batch * q head): 1024 blocks at the calibration shape where
// one block per kv head gave 128 blocks for 132 SMs, each running up to 8 q
// heads x 32 query tiles (the diagonal alone cost 2x). Each warp owns 16 keys
// and keeps their K and V fragments in registers at hd 64 (at hd 96 and 128
// it reads them from the resident tile each step, for registers). Q and dO
// tiles, with their lse and di rows, come through the two stages, 64 queries
// a step (32 at hd 96 and 128). S^T = K Q^T and dP^T = V dO^T run on the
// tensor cores; P^T and dS^T are rounded to bf16 in registers and are the A
// operands of dV += P^T dO and dK += dS^T Q. The TPU kernel multiplies fp32 p and ds there (an fp32
// operand promotes its products); rounding them to bf16 is FlashAttention-2's
// arithmetic, a difference from the TPU kernel held to the gradient gate of
// 2e-2 of the plain gradient's max. Blocks start with the longest key tiles
// (those nearest the sequence start see the most queries). Each block writes
// its q head's fp32 partial dK and dV to a workspace ([2][B * nh][S][hd], from
// the wrapper); flash_dkv_reduce_kernel then adds each group's partials in q
// head order and rounds once to bf16. No atomics: dK and dV are the same bits
// from run to run, as with the group sum inside one block before.

constexpr float kLog2e = 1.4426950408889634f;

// query rows (dQ) or keys (dK/dV) a block: 4 warps of 16
constexpr int kBwdBlock = kMmaWarps * 16;
// keys a dQ step, queries a dK/dV step. hd 96 takes hd 128's branch (a step
// of 32, K and V read from shared memory in dK/dV): at a step of 64 its live
// fp32 values (dQ: 48 accumulators + 64 of S and dP; dK/dV: 96 + 64) would
// equal hd 128's at 32, which already takes 238 to 244 registers, and K/V
// fragments in registers would add 48 more; at 32 dQ takes 171 and dK/dV 178
// (no spills).
template <int HD>
__host__ __device__ constexpr int bwd_step() { return HD == 64 ? 64 : 32; }

template <int HD>
constexpr int dq_mma_smem_bytes() {
  return (2 * kBwdBlock + 4 * bwd_step<HD>()) * (HD + 8) * 2;
}
template <int HD>
constexpr int dkv_mma_smem_bytes() {
  return (2 * kBwdBlock + 4 * bwd_step<HD>()) * (HD + 8) * 2 + 4 * bwd_step<HD>() * 4;
}

template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dq, int nh, int nkv, int S, float scale) {
  constexpr int kThreadsM = kMmaWarps * 32;
  constexpr int BM = kBwdBlock;
  constexpr int BN = bwd_step<HD>();
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LD]
  __nv_bfloat16* do_s = q_s + BM * LD;                               // [BM][LD]
  __nv_bfloat16* k_s = do_s + BM * LD;                               // [2][BN][LD]
  __nv_bfloat16* v_s = k_s + 2 * BN * LD;                            // [2][BN][LD]

  constexpr int OC = out_cols<HD>();
  constexpr bool kQInRegisters = HD <= 128;  // Q and dO fragments; else read from shared
  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // long rows first
  const int c0 = OC == HD ? 0 : blockIdx.z * OC;  // the block's dQ columns [c0, c0 + OC)
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qi * BM;
  const int wrow0 = q0 + warp * 16;
  const __nv_bfloat16* kh = k + ((int64_t)b * nkv + kvh) * S * HD;
  const __nv_bfloat16* vh = v + ((int64_t)b * nkv + kvh) * S * HD;
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (min(q0 + BM, S) - 1) / BN + 1;

  cp_rows<BM, HD, kThreadsM>(q_s, q + (int64_t)bh * S * HD, q0, S, tid);
  cp_rows<BM, HD, kThreadsM>(do_s, dout + (int64_t)bh * S * HD, q0, S, tid);
  cp_rows<BN, HD, kThreadsM>(k_s, kh, 0, S, tid);
  cp_rows<BN, HD, kThreadsM>(v_s, vh, 0, S, tid);
  tc::cp_async_commit();

  const int row_a = wrow0 + lane / 4;  // the lane's two rows: row_a, row_a + 8
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    // a row past the end gets p = 0 (its dO is zero-filled too)
    lse2[h] = row < S ? lse[(int64_t)bh * S + row] * kLog2e : INFINITY;
    di_r[h] = row < S ? di[(int64_t)bh * S + row] : 0.f;
  }
  uint32_t qf[kQInRegisters ? HD / 16 : 1][4], df[kQInRegisters ? HD / 16 : 1][4];
  const int qf_at = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // + kk * 16
  float acc[OC / 8][4];
#pragma unroll
  for (int i = 0; i < OC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();  // tile j (and, at j = 0, Q and dO) has landed
    __syncthreads();         // ... for every thread; stage (j + 1) & 1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      cp_rows<BN, HD, kThreadsM>(k_s + st * BN * LD, kh, (j + 1) * BN, S, tid);
      cp_rows<BN, HD, kThreadsM>(v_s + st * BN * LD, vh, (j + 1) * BN, S, tid);
    }
    tc::cp_async_commit();
    if constexpr (kQInRegisters) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int at = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
          tc::ldmatrix_x4(qf[kk], q_s + at);
          tc::ldmatrix_x4(df[kk], do_s + at);
        }
      }
    }
    const int kv0 = j * BN;
    if (kv0 > wrow0 + 15) continue;  // every key of the tile is after the warp's rows
    const __nv_bfloat16* ks = k_s + (j & 1) * BN * LD;
    const __nv_bfloat16* vs = v_s + (j & 1) * BN * LD;

    // S = Q K^T and dP = dO V^T, 16 rows x BN keys a warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t q_frag[4], do_frag[4];  // hd 256: this step's fragments, from shared
      if constexpr (!kQInRegisters) {
        tc::ldmatrix_x4(q_frag, q_s + qf_at + kk * 16);
        tc::ldmatrix_x4(do_frag, do_s + qf_at + kk * 16);
      }
      const uint32_t(&qa)[4] = kQInRegisters ? qf[kQInRegisters ? kk : 0] : q_frag;
      const uint32_t(&da)[4] = kQInRegisters ? df[kQInRegisters ? kk : 0] : do_frag;
#pragma unroll
      for (int n2 = 0; n2 < BN / 16; ++n2) {
        const int at = (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, ks + at);
        tc::mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
        tc::ldmatrix_x4(vb, vs + at);
        tc::mma_bf16(dp[2 * n2], da, vb[0], vb[1]);
        tc::mma_bf16(dp[2 * n2 + 1], da, vb[2], vb[3]);
      }
    }

    // ds = p (dp - di) scale in place of s; p = 0 under the mask
    const bool masked = kv0 + BN - 1 > wrow0 || kv0 + BN > S;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[i][e] * scale_log2 - lse2[e >> 1]);
        if (masked) {
          const int col = kv0 + i * 8 + (lane % 4) * 2 + (e & 1);
          if (col > row_a + (e >> 1) * 8 || col >= S) p = 0.f;
        }
        s[i][e] = p * (dp[i][e] - di_r[e >> 1]) * scale;
      }

    // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < OC / 16; ++d2) {
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, ks + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + c0 +
                                      d2 * 16 + (lane / 16) * 8);
        tc::mma_bf16(acc[2 * d2], da, kb[0], kb[1]);
        tc::mma_bf16(acc[2 * d2 + 1], da, kb[2], kb[3]);
      }
    }
  }

  // the warp's own 16 rows of the Q tile (which only it reads) hold its dQ
  // rows, then 16-byte stores
  __nv_bfloat16* stage = q_s + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < OC / 8; ++i) {
    const int c = i * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(stage + (lane / 4) * LD + c) = tc::pack_bf16(acc[i][0], acc[i][1]);
    *reinterpret_cast<uint32_t*>(stage + (lane / 4 + 8) * LD + c) =
        tc::pack_bf16(acc[i][2], acc[i][3]);
  }
  __syncwarp();
  __nv_bfloat16* dqh = dq + (int64_t)bh * S * HD + c0;
#pragma unroll
  for (int i = lane; i < 16 * (OC / 8); i += 32) {
    const int r = i / (OC / 8);
    const int c = (i % (OC / 8)) * 8;
    if (wrow0 + r < S)
      *reinterpret_cast<uint4*>(dqh + (int64_t)(wrow0 + r) * HD + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dk_part, float* __restrict__ dv_part, int nh, int nkv,
                     int S, float scale) {
  constexpr int kThreadsM = kMmaWarps * 32;
  constexpr int BN = kBwdBlock;      // keys a block
  constexpr int BQ = bwd_step<HD>();  // queries a step
  constexpr int LD = HD + 8;
  constexpr bool kKvInRegisters = HD == 64;
  constexpr int OC = out_cols<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][LD]
  __nv_bfloat16* v_s = k_s + BN * LD;                                // [BN][LD]
  __nv_bfloat16* q_s = v_s + BN * LD;                                // [2][BQ][LD]
  __nv_bfloat16* do_s = q_s + 2 * BQ * LD;                           // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);       // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                      // [2][BQ]

  const int bh = blockIdx.x;  // batch * nh + q head
  const int kj = blockIdx.y;  // key tile; the first ones see the most queries
  const int c0 = OC == HD ? 0 : blockIdx.z * OC;  // the block's dK and dV columns [c0, c0 + OC)
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = kj * BN;
  const int wkey0 = k0 + warp * 16;
  const __nv_bfloat16* qh = q + (int64_t)bh * S * HD;
  const __nv_bfloat16* doh = dout + (int64_t)bh * S * HD;
  const float* lseh = lse + (int64_t)bh * S;
  const float* dih = di + (int64_t)bh * S;
  const float scale_log2 = scale * kLog2e;
  const int t_first = k0 / BQ;  // query tiles before this one end before the block's keys
  const int n_steps = (S + BQ - 1) / BQ - t_first;

  // query tile t into stage st: Q, dO, and their lse and di rows (4-byte copies:
  // a head's rows start at bh * S floats, which need not be 16-byte aligned)
  const auto load_q_tile = [&](int t, int st) {
    const int row0 = t * BQ;
    cp_rows<BQ, HD, kThreadsM>(q_s + st * BQ * LD, qh, row0, S, tid);
    cp_rows<BQ, HD, kThreadsM>(do_s + st * BQ * LD, doh, row0, S, tid);
    for (int i = tid; i < 2 * BQ; i += kThreadsM) {
      const int r = i % BQ;
      const bool ok = row0 + r < S;
      const float* src = (i < BQ ? lseh : dih) + (ok ? row0 + r : 0);
      tc::cp_async4((i < BQ ? lse_s : di_s) + st * BQ + r, src, ok);
    }
  };

  const __nv_bfloat16* kbase = k + ((int64_t)b * nkv + kvh) * S * HD;
  const __nv_bfloat16* vbase = v + ((int64_t)b * nkv + kvh) * S * HD;
  cp_rows<BN, HD, kThreadsM>(k_s, kbase, k0, S, tid);
  cp_rows<BN, HD, kThreadsM>(v_s, vbase, k0, S, tid);
  load_q_tile(t_first, 0);
  tc::cp_async_commit();

  uint32_t kf[kKvInRegisters ? HD / 16 : 1][4], vf[kKvInRegisters ? HD / 16 : 1][4];
  float dk_acc[OC / 8][4], dv_acc[OC / 8][4];
#pragma unroll
  for (int i = 0; i < OC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const int key_a = wkey0 + lane / 4;  // the lane's two keys: key_a, key_a + 8
  const int frag_at = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // + kk * 16

  for (int t = 0; t < n_steps; ++t) {
    tc::cp_async_wait<0>();  // step t (and, at t = 0, K and V) has landed
    __syncthreads();         // ... for every thread; stage (t + 1) & 1 is free
    if (t + 1 < n_steps) load_q_tile(t_first + t + 1, (t + 1) & 1);
    tc::cp_async_commit();
    if constexpr (kKvInRegisters) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          tc::ldmatrix_x4(kf[kk], k_s + frag_at + kk * 16);
          tc::ldmatrix_x4(vf[kk], v_s + frag_at + kk * 16);
        }
      }
    }
    const int q0 = (t_first + t) * BQ;
    if (q0 + BQ - 1 < wkey0) continue;  // every query of the tile is before the warp's keys
    const int st = t & 1;
    const __nv_bfloat16* qs = q_s + st * BQ * LD;
    const __nv_bfloat16* dos = do_s + st * BQ * LD;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ queries a warp
    float sT[BQ / 8][4], dpT[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[i][e] = dpT[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (kKvInRegisters) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kk][e];
          va[e] = vf[kk][e];
        }
      } else {
        tc::ldmatrix_x4(ka, k_s + frag_at + kk * 16);
        tc::ldmatrix_x4(va, v_s + frag_at + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        const int at = (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qb[4], db[4];
        tc::ldmatrix_x4(qb, qs + at);
        tc::mma_bf16(sT[2 * n2], ka, qb[0], qb[1]);
        tc::mma_bf16(sT[2 * n2 + 1], ka, qb[2], qb[3]);
        tc::ldmatrix_x4(db, dos + at);
        tc::mma_bf16(dpT[2 * n2], va, db[0], db[1]);
        tc::mma_bf16(dpT[2 * n2 + 1], va, db[2], db[3]);
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T; masked: a key after the
    // query, or a query past the end
    const bool masked = wkey0 + 15 > q0 || q0 + BQ > S;
    const float* lses = lse_s + st * BQ;
    const float* dis = di_s + st * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int c = i * 8 + (lane % 4) * 2;  // the lane's two queries of n-tile i: c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lses + c);
      const float2 dr = *reinterpret_cast<const float2*>(dis + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float di_q = (e & 1) ? dr.y : dr.x;
        float p = exp2f(sT[i][e] * scale_log2 - lq * kLog2e);
        if (masked) {
          const int col = q0 + c + (e & 1);
          if (key_a + (e >> 1) * 8 > col || col >= S) p = 0.f;
        }
        sT[i][e] = p;
        dpT[i][e] = p * (dpT[i][e] - di_q) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {tc::pack_bf16(sT[2 * kk][0], sT[2 * kk][1]),
                              tc::pack_bf16(sT[2 * kk][2], sT[2 * kk][3]),
                              tc::pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]),
                              tc::pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3])};
      const uint32_t da[4] = {tc::pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]),
                              tc::pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]),
                              tc::pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]),
                              tc::pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < OC / 16; ++d2) {
        const int at =
            (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + c0 + d2 * 16 + (lane / 16) * 8;
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, dos + at);
        tc::mma_bf16(dv_acc[2 * d2], pa, ob[0], ob[1]);
        tc::mma_bf16(dv_acc[2 * d2 + 1], pa, ob[2], ob[3]);
        tc::ldmatrix_x4_trans(qb, qs + at);
        tc::mma_bf16(dk_acc[2 * d2], da, qb[0], qb[1]);
        tc::mma_bf16(dk_acc[2 * d2 + 1], da, qb[2], qb[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

  // this q head's fp32 partials of the block's keys
  float* dkp = dk_part + (int64_t)bh * S * HD + c0;
  float* dvp = dv_part + (int64_t)bh * S * HD + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_a + h * 8;
    if (key >= S) continue;
#pragma unroll
    for (int i = 0; i < OC / 8; ++i) {
      const int64_t at = (int64_t)key * HD + i * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(dkp + at) = make_float2(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      *reinterpret_cast<float2*>(dvp + at) = make_float2(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

constexpr int kReduceThreads = 256;

// dK, dV [B, nkv, S, HD] = bf16 of the sum of the group's partials
// [B * nh, S, HD], added in q head order; 4 values a thread
__global__ void __launch_bounds__(kReduceThreads)
flash_dkv_reduce_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nh,
                        int nkv, int64_t head_elems, int64_t total4) {
  const int groups = nh / nkv;
  for (int64_t i = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x; i < total4;
       i += (int64_t)gridDim.x * kReduceThreads) {
    const int64_t e = i * 4;
    const int64_t bkv = e / head_elems;  // batch * nkv + kv head
    const int64_t b = bkv / nkv;
    const int64_t first = ((b * nh + (bkv % nkv) * groups) * head_elems) + e % head_elems;
    float4 sk = *reinterpret_cast<const float4*>(dk_part + first);
    float4 sv = *reinterpret_cast<const float4*>(dv_part + first);
    for (int g = 1; g < groups; ++g) {
      const float4 pk = *reinterpret_cast<const float4*>(dk_part + first + g * head_elems);
      const float4 pv = *reinterpret_cast<const float4*>(dv_part + first + g * head_elems);
      sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
      sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
    }
    *reinterpret_cast<uint2*>(dk + e) = make_uint2(tc::pack_bf16(sk.x, sk.y), tc::pack_bf16(sk.z, sk.w));
    *reinterpret_cast<uint2*>(dv + e) = make_uint2(tc::pack_bf16(sv.x, sv.y), tc::pack_bf16(sv.z, sv.w));
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool bad_shape(int batch, int nh, int nkv, int S) {
  return batch <= 0 || nh <= 0 || nkv <= 0 || S <= 0 || nh % nkv != 0 ||
         (int64_t)batch * nh > 65535;
}

// The launch plan (block rows, dynamic shared memory) comes from
// ops/flash_attention.py::flash_fwd_plan; a plan this file does not build is
// refused rather than launched with other sizes.
template <int HD>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int nh, int nkv, int S, int block_m, int smem_bytes, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<float, HD>;
  constexpr int smem = fwd_smem_bytes<HD>();
  if (block_m != kTile || smem_bytes != smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q),
                                           static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<float*>(o),
                                           static_cast<float*>(lse), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                    int nh, int nkv, int S, int block_m, int smem_bytes, float scale,
                    cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<HD>;
  constexpr int smem = fwd_mma_smem_bytes<HD>();
  if (block_m != kMmaTileM || smem_bytes != smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kMmaTileM - 1) / kMmaTileM, batch * nh, HD / out_cols<HD>());
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), nh, nkv, S, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The backward's launch plan (tile sizes, dynamic shared memory, the
// group-sum pass's blocks) comes from ops/flash_attention.py::flash_bwd_plan;
// a plan this file does not build is refused.
template <int HD>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, void* dk, void* dv, void* workspace, int batch, int nh,
                   int nkv, int S, int block_n, int block_m, int smem_bytes, int reduce_blocks,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<float, HD>;
  constexpr int smem = dkv_smem_bytes<HD>();
  if (block_n != kTile || block_m != fp32_step<HD>() || smem_bytes != smem || reduce_blocks != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), nh, nkv, S,
      scale);
  return (int)cudaGetLastError();
}

// two launches: the partials of every (key tile, q head), then the group sum
template <int HD>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* di, void* dk, void* dv, void* workspace, int batch, int nh,
                    int nkv, int S, int block_n, int block_m, int smem_bytes, int reduce_blocks,
                    float scale, cudaStream_t stream) {
  auto kernel = flash_dkv_mma_kernel<HD>;
  constexpr int smem = dkv_mma_smem_bytes<HD>();
  if (block_n != kBwdBlock || block_m != bwd_step<HD>() || smem_bytes != smem ||
      reduce_blocks <= 0 || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t head_elems = (int64_t)S * HD;
  float* dk_part = static_cast<float*>(workspace);
  float* dv_part = dk_part + (int64_t)batch * nh * head_elems;
  const dim3 grid(batch * nh, (S + kBwdBlock - 1) / kBwdBlock, HD / out_cols<HD>());
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), dk_part, dv_part, nh, nkv, S,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dkv_reduce_kernel<<<reduce_blocks, kReduceThreads, 0, stream>>>(
      dk_part, dv_part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), nh, nkv,
      head_elems, (int64_t)batch * nkv * head_elems / 4);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* di, void* dq, int batch, int nh, int nkv, int S, int block_m,
                  int block_n, int smem_bytes, float scale, cudaStream_t stream) {
  auto kernel = flash_dq_kernel<float, HD>;
  constexpr int smem = dq_smem_bytes<HD>();
  if (block_m != kTile || block_n != fp32_step<HD>() || smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dq), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* di, void* dq, int batch, int nh, int nkv, int S, int block_m,
                   int block_n, int smem_bytes, float scale, cudaStream_t stream) {
  auto kernel = flash_dq_mma_kernel<HD>;
  constexpr int smem = dq_mma_smem_bytes<HD>();
  if (block_m != kBwdBlock || block_n != bwd_step<HD>() || smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * nh, (S + kBwdBlock - 1) / kBwdBlock, HD / out_cols<HD>());
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dq), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0 or a cudaError_t code; an
// unsupported head_dim, dtype, head layout or launch plan returns
// cudaErrorInvalidValue. All tensors are contiguous: q, o, dout, dq [B, nh, S,
// hd]; k, v, dk, dv [B, nkv, S, hd]; lse, di [B, nh, S] float32.
#define GRASP_DISPATCH(F32, BF16, ...)                              \
  if (dtype == 0 && head_dim == 64) return F32<64>(__VA_ARGS__);    \
  if (dtype == 0 && head_dim == 96) return F32<96>(__VA_ARGS__);    \
  if (dtype == 0 && head_dim == 128) return F32<128>(__VA_ARGS__);  \
  if (dtype == 0 && head_dim == 256) return F32<256>(__VA_ARGS__);  \
  if (dtype == 1 && head_dim == 64) return BF16<64>(__VA_ARGS__);   \
  if (dtype == 1 && head_dim == 96) return BF16<96>(__VA_ARGS__);   \
  if (dtype == 1 && head_dim == 128) return BF16<128>(__VA_ARGS__); \
  if (dtype == 1 && head_dim == 256) return BF16<256>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue

// The forward's body by dtype: fp32 flash_fwd_kernel (CUDA cores), bf16
// flash_fwd_mma_kernel (tensor cores); block_m and smem_bytes are the launch
// plan of ops/flash_attention.py.
extern "C" int grasp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int batch, int nh, int nkv, int S,
                                         int head_dim, int dtype, int block_m, int smem_bytes,
                                         float scale, void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_fwd_f32, launch_fwd_bf16, q, k, v, o, lse, batch, nh, nkv, S, block_m,
                 smem_bytes, scale, s);
}

// dK/dV by dtype: fp32 flash_dkv_kernel (one launch, the group summed inside
// a block; workspace unused, reduce_blocks 0), bf16 flash_dkv_mma_kernel into
// the fp32 workspace [2][B * nh][S][hd] and flash_dkv_reduce_kernel over
// reduce_blocks blocks. block_n keys a block, block_m queries a step.
extern "C" int grasp_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* di,
                                             void* dk, void* dv, void* workspace, int batch,
                                             int nh, int nkv, int S, int head_dim, int dtype,
                                             int block_n, int block_m, int smem_bytes,
                                             int reduce_blocks, float scale, void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_dkv_f32, launch_dkv_bf16, q, k, v, dout, lse, di, dk, dv, workspace,
                 batch, nh, nkv, S, block_n, block_m, smem_bytes, reduce_blocks, scale, s);
}

// dQ by dtype: fp32 flash_dq_kernel, bf16 flash_dq_mma_kernel. block_m
// query rows a block, block_n keys a step.
extern "C" int grasp_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* di,
                                            void* dq, int batch, int nh, int nkv, int S,
                                            int head_dim, int dtype, int block_m, int block_n,
                                            int smem_bytes, float scale, void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_dq_f32, launch_dq_bf16, q, k, v, dout, lse, di, dq, batch, nh, nkv, S,
                 block_m, block_n, smem_bytes, scale, s);
}
