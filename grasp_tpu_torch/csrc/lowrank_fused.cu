// Fused low-rank projection y = (x @ A) @ B for Hopper (sm_90a).
//
// Replaces the TPU kernel grasp_tpu/ops/pallas_lowrank.py::_fused_fwd (its
// Pallas body `_kernel`).
//
// What it computes: x [m, k], A [k, r], B [r, n], all fp32 or all bf16;
// h = x @ A accumulated in fp32 and rounded to x's dtype (as the TPU kernel
// casts its scratch before the second product), y = h @ B accumulated in
// fp32 and written in x's dtype. h never reaches device memory. m, k, r, n
// are arbitrary (ragged edges are masked, nothing is padded in memory); the
// rank is at most 256.
//
// What bounds it: operations. x, A, B and y are each moved once (a few
// megabytes) for 2 m r (k + n) flops. The TPU grid ran the output tiles of one
// row tile in order and computed h at the first; CUDA blocks run in no order,
// so a block owns 64 rows, computes their h once into shared memory (in x's
// dtype precision, stored as fp32), and then loops over a run of 128-column
// output tiles. With few row tiles (8 at 512 rows) one block per row tile
// would leave most of the card idle, so the output tiles of a row tile are
// dealt to several blocks, each of which recomputes h: the launcher picks the
// number of splits that minimises waves x (k + columns per block), trading
// repeated work on otherwise idle SMs against a shorter critical path.
//
// Inside a block (256 threads as 16 x 16): thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 and columns tx, tx + 16, ... (interleaved, so that shared
// reads of A and B rows hit distinct banks and x / h reads are broadcasts).
// The contraction runs over 32-deep tiles staged through shared memory.
//
// Simple first: every product is an fp32 FMA on a CUDA core (no mma/wgmma,
// although bf16 inputs would allow it), loads are synchronous, and the rank
// is rounded up to 32, 64, 128, 192 or 256 columns of accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;    // rows per block
constexpr int kBK = 32;    // contraction depth per staged tile
constexpr int kBN = 128;   // output columns per tile
constexpr int kMaxRank = 256;
// row strides in shared memory: a warp holds two values of ty, whose rows lie
// 4 apart; these strides put the two on different banks
constexpr int kXS = kBK + 1;
constexpr int kHPad = 4;

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

template <int RC>
constexpr size_t shared_bytes() {
  constexpr size_t rp = RC * 16;
  constexpr size_t phase1 = (size_t)kBM * kXS + (size_t)kBK * rp;  // x tile + A tile
  constexpr size_t phase2 = (size_t)kBK * kBN;                     // B tile
  return sizeof(float) * ((size_t)kBM * (rp + kHPad) + (phase1 > phase2 ? phase1 : phase2));
}

// RC: accumulator columns per thread in the first product; RC * 16 >= r.
template <typename T, int RC>
__global__ void __launch_bounds__(kThreads)
lowrank_fused_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ y, int m, int k, int r, int n, int tiles_per_split) {
  constexpr int RP = RC * 16;
  constexpr int HS = RP + kHPad;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                 // [kBM][HS]
  float* xs = smem + kBM * HS;      // [kBM][kXS]   (first product)
  float* as = xs + kBM * kXS;       // [kBK][RP]    (first product)
  float* bs = xs;                   // [kBK][kBN]   (second product)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;

  // ---- h = x_tile @ A, fp32 accumulation ----
  float acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
      const int row = row0 + idx / kBK, kk = k0 + idx % kBK;
      xs[(idx / kBK) * kXS + idx % kBK] =
          row < m && kk < k ? to_float(x[(int64_t)row * k + kk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * RP; idx += kThreads) {
      const int kk = k0 + idx / RP, c = idx % RP;
      as[idx] = kk < k && c < r ? to_float(a[(int64_t)kk * r + c]) : 0.f;
    }
    __syncthreads();
    const int depth = min(kBK, k - k0);
    for (int kk = 0; kk < depth; ++kk) {
      float xv[4], av[RC];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(ty * 4 + i) * kXS + kk];
#pragma unroll
      for (int j = 0; j < RC; ++j) av[j] = as[kk * RP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(xv[i], av[j], acc[i][j]);
    }
  }
  // h in x's dtype, as the second product reads it (columns >= r are 0)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j)
      hs[(ty * 4 + i) * HS + tx + 16 * j] = to_float(from_float<T>(acc[i][j]));

  // ---- y tiles = h @ B_tile ----
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * kBN;
    float out[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
    for (int r0 = 0; r0 < r; r0 += kBK) {
      __syncthreads();  // the staged tile (and, first time round, hs) is settled
      for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
        const int rr = r0 + idx / kBN, c = n0 + idx % kBN;
        bs[idx] = rr < r && c < n ? to_float(b[(int64_t)rr * n + c]) : 0.f;
      }
      __syncthreads();
      const int depth = min(kBK, r - r0);
      for (int kk = 0; kk < depth; ++kk) {
        float hv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = hs[(ty * 4 + i) * HS + r0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[kk * kBN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) out[i][j] = fmaf(hv[i], bv[j], out[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < n) y[(int64_t)row * n + c] = from_float<T>(out[i][j]);
      }
    }
  }
}

// The number of blocks that share one row tile's output tiles: the count that
// minimises waves * (k + columns per block), fewest splits on a tie.
int pick_splits(int row_tiles, int n_tiles, int k, int sms) {
  int best = 1;
  double best_cost = -1.0;
  for (int s = 1; s <= n_tiles; ++s) {
    const int per = (n_tiles + s - 1) / s;
    if ((n_tiles + per - 1) / per != s) continue;  // the same split as a smaller s
    const int64_t blocks = (int64_t)row_tiles * s;
    const double waves = (double)((blocks + sms - 1) / sms);
    const double cost = waves * ((double)k + (double)per * kBN);
    if (best_cost < 0.0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

template <typename T, int RC>
int launch(const void* x, const void* a, const void* b, void* y, int m, int k, int r, int n,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = shared_bytes<RC>();
  err = cudaFuncSetAttribute(lowrank_fused_kernel<T, RC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (m + kBM - 1) / kBM;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int splits = pick_splits(row_tiles, n_tiles, k, sms > 0 ? sms : 1);
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid(row_tiles, splits);
  lowrank_fused_kernel<T, RC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(y), m, k, r, n, per);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* a, const void* b, void* y, int m, int k, int r, int n,
             cudaStream_t stream) {
  if (r <= 32) return launch<T, 2>(x, a, b, y, m, k, r, n, stream);
  if (r <= 64) return launch<T, 4>(x, a, b, y, m, k, r, n, stream);
  if (r <= 128) return launch<T, 8>(x, a, b, y, m, k, r, n, stream);
  if (r <= 192) return launch<T, 12>(x, a, b, y, m, k, r, n, stream);
  return launch<T, 16>(x, a, b, y, m, k, r, n, stream);
}

}  // namespace

// x [m, k], a [k, r], b [r, n] -> y [m, n], contiguous, dtype 0 = float32,
// 1 = bfloat16. Returns 0 or a cudaError_t code; r > 256 is invalid.
extern "C" int grasp_lowrank_fused(const void* x, const void* a, const void* b, void* y, int m,
                                   int k, int r, int n, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || r <= 0 || n <= 0 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, a, b, y, m, k, r, n, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, a, b, y, m, k, r, n, s);
  return (int)cudaErrorInvalidValue;
}
