// Fused nibble-packed int4 matmul (W4A16) for Hopper (sm_90a), decode shapes.
//
// Replaces the TPU kernels of grasp_tpu/ops/pallas_int4.py: the grid kernel
// (pallas_int4_matmul, Pallas body `_kernel`) and its manual-DMA variant
// (_int4_matmul_dma, body `_dma_kernel`).
//
// What they compute: y = x @ dequant(packed, scale), with
//   x      [m, in]          fp32 or bf16, m <= 64, in <= in_pad
//   packed [in_pad / 2, out] int8: byte i holds contraction row 2i in its low
//                            nibble and row 2i+1 in its high nibble (signed)
//   scale  [g, out]          fp32, one per (group of gs = in_pad / g rows,
//                            column); gs is a multiple of 128
//   y      [m, out]          in x's dtype
// in the order y[:, c] = sum_g (x_g . nibbles_g[:, c]) * scale[g, c]: the dot
// of one group in fp32, then the group's scale, then the sum over groups.
// Rows in..in_pad of the weight were zero-padded at quantize time, so x
// beyond `in` reads as zero.
//
// What bounds it: bytes. The packed weight is the only large operand and each
// of its bytes is used for 2 * m multiply-adds, so every design choice is
// about streaming `packed` once, in wide coalesced loads, with enough blocks
// in flight. One block owns 128 columns and a run of whole groups; with 8 to
// 250 column tiles the contraction is also split across blocks (grid.y) until
// about two blocks per SM exist. Partial sums go to an fp32 scratch
// [splits, m, out] and a second kernel adds them in split order and casts, so
// results are bit-equal from run to run (no atomics).
//
// Inside a block (256 threads): a tile of 64 packed rows x 128 columns (128
// contraction rows, 8 KB) and the matching slice of x (as fp32) sit in shared
// memory. Thread (tm, tc) owns columns 4 * tc .. 4 * tc + 3 and rows tm,
// tm + 8, ...: it reads one 32-bit word (4 columns of one packed row),
// sign-extends the 8 nibbles with arithmetic shifts and feeds them to its
// rows; a warp shares one x row, so x reads are broadcasts.
//
// Two variants, the same function:
//   grid: loads each tile with plain 16-byte loads, synchronises, computes.
//   dma:  the counterpart of the TPU's manual double buffering. The packed
//         rows of a chunk of whole groups are copied with cp.async into one of
//         two shared-memory buffers while the previous chunk is expanded and
//         multiplied; the fp32 accumulator carries across chunks. Shared
//         memory, not the TPU's megabyte of VMEM, bounds the chunk: the caller
//         picks it (ops/int4_matmul.py: 16 KB per buffer and block, two groups
//         of 128 rows at 128 columns). Needs out % 128 == 0, as the TPU
//         variant did.
// The two sum the groups in the same order within a block but may split the
// contraction differently across blocks, so they agree to fp32 rounding, not
// bit for bit.
//
// Simple first: the products are fp32 FMAs on CUDA cores (at m = 64 that, not
// the byte stream, is the limit), only the warps that own a row compute (one
// of eight at m = 1), no tensor cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;          // columns per block
constexpr int kRowGroups = 8;       // kThreads / 32: x rows are dealt round-robin to warps
constexpr int kSub = 128;           // contraction rows per shared-memory tile
constexpr int kSubBytes = kSub / 2 * kCols;  // 8192 bytes of packed weight per tile
constexpr int kMaxRows = 64;
constexpr size_t kMaxSharedBytes = 232448;   // what one block may ask for on sm_90

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

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x[0:rows, k0:k0+128] -> xs[rows][128] as fp32, zero beyond m and beyond in_f.
template <typename T>
__device__ __forceinline__ void load_x_tile(const T* __restrict__ x, float* xs, int rows, int m,
                                            int in_f, int k0) {
  for (int idx = threadIdx.x; idx < rows * kSub; idx += kThreads) {
    const int row = idx / kSub, k = k0 + idx % kSub;
    xs[idx] = row < m && k < in_f ? to_float(x[(int64_t)row * in_f + k]) : 0.f;
  }
}

// packed[p0:p0+64, col0:col0+128] -> ps[64][128] bytes, zero beyond out_f.
// `vec`: out_f % 16 == 0 and the base is 16-byte aligned, so 16-byte loads work
// and a 16-byte piece lies wholly inside or outside the matrix.
__device__ __forceinline__ void load_packed_tile(const int8_t* __restrict__ packed, int8_t* ps,
                                                 int p0, int col0, int out_f, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kSubBytes / 16; idx += kThreads) {
      const int p = idx / (kCols / 16), c = (idx % (kCols / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col0 + c < out_f)
        v = *reinterpret_cast<const uint4*>(packed + (int64_t)(p0 + p) * out_f + col0 + c);
      *reinterpret_cast<uint4*>(ps + p * kCols + c) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < kSubBytes; idx += kThreads) {
      const int p = idx / kCols, c = idx % kCols;
      ps[idx] = col0 + c < out_f ? packed[(int64_t)(p0 + p) * out_f + col0 + c] : (int8_t)0;
    }
  }
}

// acc[j][c] += sum over the tile's 128 contraction rows of x[row_j, k] * w[k, col_c].
template <int MT>
__device__ __forceinline__ void tile_dot(const float* xs, const int8_t* ps, int tm, int tc,
                                         float (&acc)[MT][4]) {
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(ps) + tc;
#pragma unroll 4
  for (int p = 0; p < kSub / 2; ++p) {
    const uint32_t word = pw[p * (kCols / 4)];
    float lo[4], hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t byte = (word >> (8 * c)) & 0xffu;
      lo[c] = (float)((int)(int8_t)(uint8_t)(byte << 4) >> 4);  // arithmetic shifts sign-extend
      hi[c] = (float)((int)(int8_t)(uint8_t)byte >> 4);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const float2 xv =
          *reinterpret_cast<const float2*>(xs + (tm + kRowGroups * j) * kSub + 2 * p);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(xv.x, lo[c], fmaf(xv.y, hi[c], acc[j][c]));
    }
  }
}

// Writes the block's sums: to y (cast) when the contraction is not split,
// else to its slice of the fp32 scratch.
template <typename T, int MT>
__device__ __forceinline__ void store_totals(const float (&tot)[MT][4], T* __restrict__ y,
                                             float* __restrict__ partial, int m, int out_f,
                                             int col, int tm) {
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int row = tm + kRowGroups * j;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col + c >= out_f) continue;
      const int64_t at = (int64_t)row * out_f + col + c;
      if (partial != nullptr)
        partial[(int64_t)blockIdx.y * m * out_f + at] = tot[j][c];
      else
        y[at] = from_float<T>(tot[j][c]);
    }
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
int4_grid_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ partial,
                 int m, int in_f, int out_f, int groups, int gs, int groups_per_split, int vec) {
  __shared__ __align__(16) float xs[MT * kRowGroups * kSub];
  __shared__ __align__(16) int8_t ps[kSubBytes];
  const int tc = threadIdx.x & 31, tm = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols, col = col0 + 4 * tc;
  const int g0 = blockIdx.y * groups_per_split;
  const int g1 = min(g0 + groups_per_split, groups);

  float tot[MT][4] = {};
  for (int g = g0; g < g1; ++g) {
    float acc[MT][4] = {};
    for (int k0 = g * gs; k0 < (g + 1) * gs; k0 += kSub) {
      __syncthreads();  // the previous tile has been consumed
      load_x_tile(x, xs, MT * kRowGroups, m, in_f, k0);
      load_packed_tile(packed, ps, k0 / 2, col0, out_f, vec != 0);
      __syncthreads();
      if (tm < m) tile_dot<MT>(xs, ps, tm, tc, acc);  // a warp without a row only loads
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float s = col + c < out_f ? scale[(int64_t)g * out_f + col + c] : 0.f;
#pragma unroll
      for (int j = 0; j < MT; ++j) tot[j][c] += acc[j][c] * s;
    }
  }
  store_totals<T, MT>(tot, y, partial, m, out_f, col, tm);
}

// The double-buffered variant: chunk = `gpc` whole groups, `tiles` = gpc * gs / 128
// shared-memory tiles of packed weight per buffer. Dynamic shared memory:
// xs [MT * 8][128] fp32, then two buffers of tiles * 8192 bytes.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
int4_dma_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                const float* __restrict__ scale, T* __restrict__ y, float* __restrict__ partial,
                int m, int in_f, int out_f, int gs, int gpc, int n_chunks,
                int chunks_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int tiles = gpc * gs / kSub;
  int8_t* buf[2];
  buf[0] = reinterpret_cast<int8_t*>(smem + sizeof(float) * MT * kRowGroups * kSub);
  buf[1] = buf[0] + (int64_t)tiles * kSubBytes;

  const int tc = threadIdx.x & 31, tm = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols, col = col0 + 4 * tc;
  const int c0 = blockIdx.y * chunks_per_split;
  const int c1 = min(c0 + chunks_per_split, n_chunks);
  const int chunk_prows = gpc * gs / 2;  // packed rows per chunk

  // every thread starts its share of a chunk's 16-byte copies, then commits
  auto start_copy = [&](int chunk, int slot) {
    const int8_t* src = packed + (int64_t)chunk * chunk_prows * out_f + col0;
    for (int idx = threadIdx.x; idx < chunk_prows * (kCols / 16); idx += kThreads) {
      const int p = idx / (kCols / 16), c = (idx % (kCols / 16)) * 16;
      cp_async_16(buf[slot] + p * kCols + c, src + (int64_t)p * out_f + c);
    }
    cp_async_commit();
  };

  float tot[MT][4] = {};
  if (c0 < c1) start_copy(c0, 0);
  for (int chunk = c0; chunk < c1; ++chunk) {
    const int slot = (chunk - c0) & 1;
    if (chunk + 1 < c1) {
      start_copy(chunk + 1, slot ^ 1);  // that buffer was consumed before the last barrier
      cp_async_wait<1>();               // all but the newest group: this chunk has landed
    } else {
      cp_async_wait<0>();
    }
    float chunk_sum[MT][4] = {};
    for (int gi = 0; gi < gpc; ++gi) {
      const int g = chunk * gpc + gi;
      float acc[MT][4] = {};
      for (int t = 0; t < gs / kSub; ++t) {
        __syncthreads();  // xs consumed; at t == 0 also: everyone's copies are visible below
        load_x_tile(x, xs, MT * kRowGroups, m, in_f, g * gs + t * kSub);
        __syncthreads();
        if (tm < m)
          tile_dot<MT>(xs, buf[slot] + (int64_t)(gi * (gs / kSub) + t) * kSubBytes, tm, tc, acc);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = scale[(int64_t)g * out_f + col + c];
#pragma unroll
        for (int j = 0; j < MT; ++j) chunk_sum[j][c] += acc[j][c] * s;
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[j][c] += chunk_sum[j][c];
    __syncthreads();  // the chunk's buffer may be overwritten by the next copy
  }
  store_totals<T, MT>(tot, y, partial, m, out_f, col, tm);
}

// y[i] = sum over splits of partial[s][i], in split order, cast to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_reduce_kernel(const float* __restrict__ partial, T* __restrict__ y, int n, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(int64_t)s * n + i];
  y[i] = from_float<T>(sum);
}

int rows_per_thread(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8; }

template <typename T>
int reduce(const void* partial, void* y, int m, int out_f, int splits, cudaStream_t stream) {
  const int n = m * out_f;
  int4_reduce_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(y), n, splits);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_grid(const void* x, const void* packed, const void* scale, void* y, void* partial,
                int m, int in_f, int out_f, int groups, int gs, int splits,
                cudaStream_t stream) {
  const int gps = (groups + splits - 1) / splits;
  const int vec = out_f % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const dim3 grid((out_f + kCols - 1) / kCols, splits);
  int4_grid_kernel<T, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(y),
      splits > 1 ? static_cast<float*>(partial) : nullptr, m, in_f, out_f, groups, gs, gps, vec);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return reduce<T>(partial, y, m, out_f, splits, stream);
}

template <typename T, int MT>
int launch_dma(const void* x, const void* packed, const void* scale, void* y, void* partial,
               int m, int in_f, int out_f, int gs, int gpc, int n_chunks, int splits,
               cudaStream_t stream) {
  const int cps = (n_chunks + splits - 1) / splits;
  const size_t smem = sizeof(float) * MT * kRowGroups * kSub + 2 * (size_t)gpc * gs / 2 * kCols;
  cudaError_t err = cudaFuncSetAttribute(int4_dma_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(out_f / kCols, splits);
  int4_dma_kernel<T, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(y),
      splits > 1 ? static_cast<float*>(partial) : nullptr, m, in_f, out_f, gs, gpc, n_chunks, cps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  return reduce<T>(partial, y, m, out_f, splits, stream);
}

}  // namespace

// variant 0 = grid, 1 = dma. dtype 0 = float32, 1 = bfloat16. `splits` blocks
// share each column tile's contraction (whole groups for the grid variant,
// whole chunks of `gpc` groups for the dma variant: groups must be a multiple
// of gpc and two chunks must fit shared memory); with splits > 1, `partial` is an fp32
// scratch of splits * m * out_f elements. Returns 0 or a cudaError_t code.
extern "C" int grasp_int4_matmul(const void* x, const void* packed, const void* scale, void* y,
                                 void* partial, int m, int in_f, int out_f, int groups, int gs,
                                 int dtype, int variant, int splits, int gpc, void* stream) {
  if (m <= 0 || m > kMaxRows || in_f <= 0 || out_f <= 0 || groups <= 0 || gs <= 0 ||
      gs % kSub != 0 || in_f > groups * gs || splits <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = rows_per_thread(m);
  if (variant == 0) {
    if (splits > groups) return (int)cudaErrorInvalidValue;
#define GRASP_GRID(T, MT)                                                                   \
  return launch_grid<T, MT>(x, packed, scale, y, partial, m, in_f, out_f, groups, gs, splits, s)
#define GRASP_GRID_T(T)       \
  if (mt == 1) GRASP_GRID(T, 1); \
  if (mt == 2) GRASP_GRID(T, 2); \
  if (mt == 4) GRASP_GRID(T, 4); \
  GRASP_GRID(T, 8)
    if (dtype == 0) { GRASP_GRID_T(float); }
    GRASP_GRID_T(__nv_bfloat16);
#undef GRASP_GRID_T
#undef GRASP_GRID
  }
  if (variant == 1) {
    if (out_f % kCols != 0 || gpc <= 0 || groups % gpc != 0 ||
        sizeof(float) * kMaxRows * kSub + (size_t)gpc * gs * kCols > kMaxSharedBytes ||
        reinterpret_cast<uintptr_t>(packed) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int n_chunks = groups / gpc;
    if (splits > n_chunks) return (int)cudaErrorInvalidValue;
#define GRASP_DMA(T, MT)                                                                      \
  return launch_dma<T, MT>(x, packed, scale, y, partial, m, in_f, out_f, gs, gpc, n_chunks, \
                           splits, s)
#define GRASP_DMA_T(T)       \
  if (mt == 1) GRASP_DMA(T, 1); \
  if (mt == 2) GRASP_DMA(T, 2); \
  if (mt == 4) GRASP_DMA(T, 4); \
  GRASP_DMA(T, 8)
    if (dtype == 0) { GRASP_DMA_T(float); }
    GRASP_DMA_T(__nv_bfloat16);
#undef GRASP_DMA_T
#undef GRASP_DMA
  }
  return (int)cudaErrorInvalidValue;
}
