// Causal flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels,
// head_dim 64 and 128, float32 and bfloat16.
//
// Replaces the three TPU kernels of grasp_tpu/ops/pallas_attention.py:
//   flash_fwd_kernel  <- _flash_fwd_impl (Pallas body `_kernel`)
//   flash_dkv_kernel  <- _flash_bwd_impl, first pallas_call (`_dkv_kernel`)
//   flash_dq_kernel   <- _flash_bwd_impl, second pallas_call (`_dq_kernel`)
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
// blocks run in no order, so that axis is a loop inside the block. Forward and
// dQ: one block per (batch * head, 64 query rows) loops over the 64-key tiles
// at or below the diagonal. dK/dV: one block per (batch * kv head, 64 keys)
// loops over the q heads of its group and over the query tiles at or above
// the diagonal, so the group sum needs no atomics and is the same from run to
// run. S is not padded: rows and columns >= S are masked in the kernel.
//
// Simple first: 256 threads, every product is fp32 FMAs on CUDA cores from
// fp32 tiles in shared memory (bf16 inputs are widened on load), each thread
// owning a 4 x 4 piece of the 64 x 64 score tile and a 4 x (hd / 16) piece of
// the output tile. p and ds stay fp32 (the TPU kernel rounds p to the input
// type before p . v). No tensor cores, no cp.async/TMA, no pipelining: the
// kernels are far from the card's bf16 tensor-core rate, which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kLdP = kTile + 4;  // row stride of the p / ds tiles (floats)

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

// Rows [row0, row0 + 64) of a [S, HD] matrix -> fp32 shared tile with row
// stride HD + 4; rows >= S are zero. 16-byte global loads.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int row0, int S, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  constexpr int kLd = HD + 4;
  for (int i = tid; i < kTile * kVecPerRow; i += kThreads) {
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

// acc[i][j] += sum_d a[(ty*4+i)][d] * b[(tx+16j)][d]: the thread's 4 x 4 piece
// of A B^T for two [64, HD] shared tiles (row stride HD + 4).
template <int HD>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = HD + 4;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_j p[(ty*4+i)][j] * b[j][cols(c)]: the thread's 4 x (HD/16)
// piece of P B for a [64, 64] shared p (stride kLdP) and a [64, HD] tile b.
// Thread columns are tx*4 .. tx*4+3 of every 64-wide column block.
template <int HD>
__device__ __forceinline__ void tile_pb(float (&acc)[4][HD / 16], const float* __restrict__ p,
                                        const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = HD + 4;
  for (int j0 = 0; j0 < kTile; j0 += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * kLdP + j0);
      pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int cc = 0; cc < HD / 64; ++cc) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (j0 + jj) * kLd + tx * 4 + 64 * cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][cc * 4 + 0] += pv[i][jj] * bv.x;
          acc[i][cc * 4 + 1] += pv[i][jj] * bv.y;
          acc[i][cc * 4 + 2] += pv[i][jj] * bv.z;
          acc[i][cc * 4 + 3] += pv[i][jj] * bv.w;
        }
      }
    }
  }
}

// acc[i][c] += sum_r p[r][(ty*4+i)] * b[r][cols(c)]: the thread's piece of
// P^T B (the dK/dV products), same tiles as tile_pb.
template <int HD>
__device__ __forceinline__ void tile_ptb(float (&acc)[4][HD / 16], const float* __restrict__ p,
                                         const float* __restrict__ b, int ty, int tx) {
  constexpr int kLd = HD + 4;
#pragma unroll 2
  for (int r = 0; r < kTile; ++r) {
    const float4 t = *reinterpret_cast<const float4*>(p + r * kLdP + ty * 4);
    const float pv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int cc = 0; cc < HD / 64; ++cc) {
      const float4 bv = *reinterpret_cast<const float4*>(b + r * kLd + tx * 4 + 64 * cc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][cc * 4 + 0] += pv[i] * bv.x;
        acc[i][cc * 4 + 1] += pv[i] * bv.y;
        acc[i][cc * 4 + 2] += pv[i] * bv.z;
        acc[i][cc * 4 + 3] += pv[i] * bv.w;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int cc = 0; cc < HD / 64; ++cc) {
      store4(dst + (int64_t)row * HD + tx * 4 + 64 * cc, acc[i][cc * 4 + 0] * row_scale[i],
             acc[i][cc * 4 + 1] * row_scale[i], acc[i][cc * 4 + 2] * row_scale[i],
             acc[i][cc * 4 + 3] * row_scale[i]);
    }
  }
}

template <int HD>
constexpr int fwd_smem_bytes() { return (3 * kTile * (HD + 4) + kTile * kLdP) * (int)sizeof(float); }
template <int HD>
constexpr int dq_smem_bytes() { return (4 * kTile * (HD + 4) + kTile * kLdP) * (int)sizeof(float); }
template <int HD>
constexpr int dkv_smem_bytes() { return (4 * kTile * (HD + 4) + 2 * kTile * kLdP) * (int)sizeof(float); }

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
    tile_abt<HD>(s, q_s, k_s, ty, tx);

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
        p_s[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pb<HD>(acc, p_s, v_s, ty, tx);
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
// backward: shared recomputation of p and ds for one (query tile, key tile)
// ---------------------------------------------------------------------------

// p[i][j] = exp(s - lse) under the forward's mask, ds = p * (dp - di) * scale,
// for the thread's 4 x 4 piece; written to p_out (may be null) and ds_out.
template <int HD>
__device__ __forceinline__ void recompute_p_ds(const float* q_s, const float* do_s,
                                               const float* k_s, const float* v_s,
                                               const float (&lse_r)[4], const float (&di_r)[4],
                                               int row0, int col0, int S, float scale, int ty,
                                               int tx, float* p_out, float* ds_out) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  tile_abt<HD>(s, q_s, k_s, ty, tx);
  tile_abt<HD>(dp, do_s, v_s, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const bool live = col <= row && col < S && row < S;
      const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
      const int at = (ty * 4 + i) * kLdP + tx + 16 * j;
      if (p_out != nullptr) p_out[at] = p;
      ds_out[at] = p * (dp[i][j] - di_r[i]) * scale;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, T* __restrict__ dq, int nh, int nkv, int S,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + 4;
  float* q_s = smem;
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* ds_s = v_s + kTile * kLd;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int kvh = (bh % nh) / (nh / nkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* kh = k + ((int64_t)b * nkv + kvh) * S * HD;
  const T* vh = v + ((int64_t)b * nkv + kvh) * S * HD;

  load_tile<T, HD>(q_s, q + (int64_t)bh * S * HD, qi * kTile, S, tid);
  load_tile<T, HD>(do_s, dout + (int64_t)bh * S * HD, qi * kTile, S, tid);

  float lse_r[4], di_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * kTile + ty * 4 + i;
    lse_r[i] = row < S ? lse[(int64_t)bh * S + row] : INFINITY;
    di_r[i] = row < S ? di[(int64_t)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  for (int kj = 0; kj <= qi; ++kj) {
    __syncthreads();
    load_tile<T, HD>(k_s, kh, kj * kTile, S, tid);
    load_tile<T, HD>(v_s, vh, kj * kTile, S, tid);
    __syncthreads();
    recompute_p_ds<HD>(q_s, do_s, k_s, v_s, lse_r, di_r, qi * kTile, kj * kTile, S, scale, ty, tx,
                       nullptr, ds_s);
    __syncthreads();
    tile_pb<HD>(acc, ds_s, k_s, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_piece<T, HD>(dq + (int64_t)bh * S * HD, acc, one, qi * kTile, S, ty, tx);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int nh,
                 int nkv, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = HD + 4;
  float* k_s = smem;
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;
  float* do_s = q_s + kTile * kLd;
  float* p_s = do_s + kTile * kLd;
  float* ds_s = p_s + kTile * kLdP;

  const int kj = blockIdx.x;
  const int bkv = blockIdx.y;  // batch * nkv + kv head
  const int b = bkv / nkv;
  const int kvh = bkv % nkv;
  const int groups = nh / nkv;
  const int q_tiles = (S + kTile - 1) / kTile;
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
    for (int qi = kj; qi < q_tiles; ++qi) {
      __syncthreads();  // the previous step's reads of q_s, do_s, p_s, ds_s are done
      load_tile<T, HD>(q_s, qh, qi * kTile, S, tid);
      load_tile<T, HD>(do_s, doh, qi * kTile, S, tid);
      float lse_r[4], di_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = qi * kTile + ty * 4 + i;
        lse_r[i] = row < S ? lse[bh * S + row] : INFINITY;
        di_r[i] = row < S ? di[bh * S + row] : 0.f;
      }
      __syncthreads();
      recompute_p_ds<HD>(q_s, do_s, k_s, v_s, lse_r, di_r, qi * kTile, kj * kTile, S, scale, ty,
                         tx, p_s, ds_s);
      __syncthreads();
      tile_ptb<HD>(dv_acc, p_s, do_s, ty, tx);
      tile_ptb<HD>(dk_acc, ds_s, q_s, ty, tx);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_piece<T, HD>(dk + (int64_t)bkv * S * HD, dk_acc, one, kj * kTile, S, ty, tx);
  store_piece<T, HD>(dv + (int64_t)bkv * S * HD, dv_acc, one, kj * kTile, S, ty, tx);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool bad_shape(int batch, int nh, int nkv, int S) {
  return batch <= 0 || nh <= 0 || nkv <= 0 || S <= 0 || nh % nkv != 0 ||
         (int64_t)batch * nh > 65535;
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int nh,
               int nkv, int S, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  constexpr int smem = fwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o),
                                           static_cast<float*>(lse), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dk, void* dv, int batch, int nh, int nkv, int S, float scale,
               cudaStream_t stream) {
  auto kernel = flash_dkv_kernel<T, HD>;
  constexpr int smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* di, void* dq, int batch, int nh, int nkv, int S, float scale,
              cudaStream_t stream) {
  auto kernel = flash_dq_kernel<T, HD>;
  constexpr int smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, batch * nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), nh, nkv, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0 or a cudaError_t code; an
// unsupported head_dim, dtype or head layout returns cudaErrorInvalidValue.
// All tensors are contiguous: q, o, dout, dq [B, nh, S, hd]; k, v, dk, dv
// [B, nkv, S, hd]; lse, di [B, nh, S] float32.
#define GRASP_DISPATCH(FN, ...)                                             \
  if (dtype == 0 && head_dim == 64) return FN<float, 64>(__VA_ARGS__);      \
  if (dtype == 0 && head_dim == 128) return FN<float, 128>(__VA_ARGS__);    \
  if (dtype == 1 && head_dim == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);   \
  if (dtype == 1 && head_dim == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue

extern "C" int grasp_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int batch, int nh, int nkv, int S,
                                         int head_dim, int dtype, float scale, void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_fwd, q, k, v, o, lse, batch, nh, nkv, S, scale, s);
}

extern "C" int grasp_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* di,
                                             void* dk, void* dv, int batch, int nh, int nkv,
                                             int S, int head_dim, int dtype, float scale,
                                             void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_dkv, q, k, v, dout, lse, di, dk, dv, batch, nh, nkv, S, scale, s);
}

extern "C" int grasp_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* di,
                                            void* dq, int batch, int nh, int nkv, int S,
                                            int head_dim, int dtype, float scale, void* stream) {
  if (bad_shape(batch, nh, nkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GRASP_DISPATCH(launch_dq, q, k, v, dout, lse, di, dq, batch, nh, nkv, S, scale, s);
}
