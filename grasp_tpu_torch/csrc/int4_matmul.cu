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
// What bounds it: bytes, in principle. The packed weight is the only large
// operand and each of its bytes is used for 2 * m multiply-adds (at most 128
// at m = 64, far below the ~295 operations a byte at which an H100's bf16
// tensor cores become the limit). So the design streams `packed` once and
// makes the arithmetic on each byte cheap: an earlier design expanded every
// nibble with an I2F once per warp (eight times per byte at m <= 8) and was
// bound by those conversions. At decode's sizes (0.3 to 33 MB a call) what
// is left is mostly fixed cost a call: the launch, the first round trip to
// device memory, the cluster's split sum (scripts/int4_breakdown_torch.py
// times each).
//
// bf16 x: int4_grid_mma_kernel (K5) and int4_dma_mma_kernel (K5d).
// - A block (4 warps) owns 128 output columns and a run of whole groups. The
//   products run on the tensor cores, mma.sync m16n8k16 bf16 -> fp32, with
//   the WEIGHT as the A operand (16 output columns x 16 contraction rows) and
//   x^T as the B operand (16 contraction rows x 8 rows of x): m <= 8 is one
//   n-tile, m <= 64 at most eight (NT = 1, 2, 4, 8).
// - An A register holds contraction rows (2t, 2t + 1) of one column: exactly
//   one packed byte. A byte becomes one bf16x2 register with a byte permute,
//   one lop3 and one bf16x2 subtraction (expand_byte); every value in [-8, 7]
//   is exact in bf16, so the products are exact and only the order of the
//   fp32 sums differs from the plain version. Each byte is expanded once per
//   block: warp w owns columns 32w .. 32w + 31.
// - Column order inside a warp's two m16 tiles: one 32-bit shared load of
//   columns 4g .. 4g + 3 (lane 4g + t) feeds rows g and g + 8 of both tiles
//   (byte 0: tile 0 row g, 1: tile 0 row g + 8, 2: tile 1 row g, 3: tile 1
//   row g + 8). The epilogue writes each accumulator to its own column.
// - Shared memory is a ring of `stages` tiles of 128 contraction rows: 64
//   packed rows of 128 bytes, their 16-byte chunks permuted as the tensor
//   copy's 128-byte swizzle does (swz), so that a warp's word loads meet at
//   most two to a bank; the x slice, 8 NT rows of 128 bf16 (row stride 272
//   bytes, so ldmatrix is conflict-free), zero beyond m and beyond `in`; and,
//   with a group's first tile, its 128 scales.
// - K5 fills the ring with cp.async issued by all threads (the packed chunks
//   written to their swizzled places). K5d is the counterpart of the TPU's
//   make_async_copy + semaphores: one thread starts a 2-D tensor copy of the
//   packed tile (64 rows x 128 bytes through Hopper's Tensor Memory
//   Accelerator, the tensor map encoded on the host per call) and a bulk copy
//   of the scales, both completed on the stage's mbarrier; its x slice still
//   comes by cp.async. (One 1-D bulk copy a 128-byte row read up to 1.4x
//   slower than K5 on an H100: the engine pays per request.) Both inline one body
//   (mma_main) for expand + mma + scale + group sum and take the same plan,
//   so their outputs are bit-equal.
// - Split sum: where the plan splits a column tile's groups across blocks,
//   those blocks are one thread-block cluster (at most 8). Each leaves its
//   fp32 partial in its shared memory; after cluster.sync() block r adds, for
//   its share of the tile's outputs, the partials of splits 0, 1, ... in that
//   order (distributed shared memory) and writes y. One launch, no scratch in
//   device memory, no atomics: the same bits from run to run.
// - The plan (splits = cluster size, stages, shared bytes) is
//   ops/int4_matmul.py::int4_plan, pure Python; a plan that does not match
//   this file's layout is refused. Shared memory stays at or under 112 KB so
//   that two blocks fit an SM and every cluster is resident at once.
//
// fp32 x keeps the CUDA-core bodies (int4_grid_kernel, int4_dma_kernel,
// int4_reduce_kernel): tensor cores would round x to bf16 or TF32, and the fp32
// gate is 2e-5. There a block of 256 threads owns 128 columns; thread (tm, tc)
// expands the nibbles of its 4 columns for rows tm, tm + 8, ... with fp32
// FMAs on CUDA cores; splits write an fp32 scratch [splits, m, out] that a
// second kernel adds in split order. The fp32 dma variant double-buffers
// chunks of whole groups with cp.async and may split differently from the
// grid variant, so the two agree to fp32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;          // columns per block (both bodies)
constexpr int kRowGroups = 8;       // kThreads / 32: x rows are dealt round-robin to warps
constexpr int kSub = 128;           // contraction rows per shared-memory tile
constexpr int kSubBytes = kSub / 2 * kCols;  // 8192 bytes of packed weight per tile
constexpr int kMaxRows = 64;
constexpr size_t kMaxSharedBytes = 232448;   // what one block may ask for on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// ---------------------------------------------------------------------------
// fp32 bodies (CUDA cores)
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// bf16 bodies: tensor cores, one cluster per split column tile
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;         // 4 warps x 32 columns (one thread a column of scales)
constexpr int kTileRows = 128;           // contraction rows per ring stage
constexpr int kTilePRows = kTileRows / 2;  // packed rows per stage
constexpr int kXLd = kTileRows + 8;      // x row stride in shared memory, bf16
constexpr int kPartLd = kCols + 4;       // fp32 partial row stride
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 8;

// a ring stage: packed rows, then the x slice, then (read at a group's first
// tile) the group's 128 scales
__host__ __device__ constexpr int mma_x_offset() { return kTilePRows * kCols; }
__host__ __device__ constexpr int mma_scale_offset(int nt) {
  return mma_x_offset() + 8 * nt * kXLd * 2;
}
// rounded up to 1024 bytes: the packed rows of every stage start on 1024
// bytes, as the tensor copy's 128-byte swizzle needs
__host__ __device__ constexpr int mma_stage_bytes(int nt) {
  return (mma_scale_offset(nt) + kCols * 4 + 1023) / 1024 * 1024;
}
constexpr int kSmemAlign = 1024;  // dynamic shared memory is rounded up to this in the kernel

// Byte offset of (packed row p, column byte c) of a tile in shared memory:
// rows of 128 bytes whose 16-byte chunks are permuted by XOR with p % 8 (the
// tensor copy's 128-byte swizzle), so that a warp's word loads spread over
// the banks (two lanes a bank at most).
__device__ __forceinline__ int swz(int p, int c) {
  return p * kCols + ((((c >> 4) ^ p) & 7) << 4) + (c & 15);
}

int n_tiles_of(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8; }

// Byte B of w as bf16x2 {low nibble, high nibble}, signed (w4 = w >> 4).
// The permute puts the byte's low nibble in bits 0-3 and its high nibble in
// bits 16-19; with bit 3 of each flipped and 0x43 above, each half is the
// bf16 128 + (n ^ 8) exactly, and 128 + (n ^ 8) - 136 is the signed nibble
// n (two's complement of 4 bits: n ^ 8 - 8), exact in bf16.
template <int B>
__device__ __forceinline__ uint32_t expand_byte(uint32_t w, uint32_t w4) {
  constexpr uint32_t sel = B | (B << 4) | ((4 + B) << 8) | ((4 + B) << 12);
  uint32_t r = (__byte_perm(w, w4, sel) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;  // bf16x2 {136, 136}
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&v);
}

// four packed bytes (four columns of one packed row) -> four bf16x2 registers
__device__ __forceinline__ void expand_word(uint32_t w, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  const uint32_t w4 = w >> 4;
  r0 = expand_byte<0>(w, w4);
  r1 = expand_byte<1>(w, w4);
  r2 = expand_byte<2>(w, w4);
  r3 = expand_byte<3>(w, w4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` contiguous bytes global -> shared through the bulk-copy engine,
// completed on `bar` (both addresses 16-byte aligned, bytes a multiple of 16)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}

// a box of the 2-D tensor `map` at (column c0, row c1) -> shared memory, completed on `bar`
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(tc::smem_addr(bar))
      : "memory");
}

// orders this thread's earlier shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wait until at most n committed cp.async groups are in flight (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    case 3: tc::cp_async_wait<3>(); break;
    case 4: tc::cp_async_wait<4>(); break;
    case 5: tc::cp_async_wait<5>(); break;
    default: tc::cp_async_wait<6>(); break;
  }
}

// acc += this warp's 32 columns of the tile's weight (A) times x^T (B), 8
// k16 steps. A warp has no other work to hide latency behind (two or three
// warps a scheduler), so the tile's 16 packed words are read first and the B
// fragments of a pair of steps (one ldmatrix.x4 per n-tile) one pair ahead.
// Independent accumulator chains: at NT <= 2 a warp's products form 2 NT
// chains of dependent mma.sync; even and odd k16 steps go to two sets, added
// when the group ends (the order of the fp32 sums inside a group is free).
template <int NT>
constexpr int kChains = NT <= 2 ? 2 : 1;

template <int NT>
__device__ __forceinline__ void tile_mma(const uint8_t* ps, const __nv_bfloat16* xs, int warp,
                                         int lane, float (&acc)[kChains<NT>][2][NT][4]) {
  constexpr int kSteps = kTileRows / 16;
  // step s reads packed rows 8s + t (lo) and 8s + 4 + t (hi), columns 4g ..
  // 4g + 3 of the warp's 32: a row's place in the swizzle does not depend on s
  const int t = lane & 3, c = warp * 32 + 4 * (lane >> 2);
  const uint8_t* plo = ps + swz(t, c);
  const uint8_t* phi = ps + swz(t + 4, c);
  uint32_t words[kSteps][2];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    words[st][0] = *reinterpret_cast<const uint32_t*>(plo + 8 * st * kCols);
    words[st][1] = *reinterpret_cast<const uint32_t*>(phi + 8 * st * kCols);
  }
  const __nv_bfloat16* xl = xs + (lane & 7) * kXLd + (lane >> 3) * 8;
  uint32_t bfr[2][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) tc::ldmatrix_x4(bfr[0][j], xl + j * 8 * kXLd);
#pragma unroll
  for (int pair = 0; pair < kSteps / 2; ++pair) {
    const int cur = pair & 1;
    if (pair + 1 < kSteps / 2) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tc::ldmatrix_x4(bfr[cur ^ 1][j], xl + j * 8 * kXLd + (pair + 1) * 32);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[2][4];
      expand_word(words[2 * pair + h][0], a[0][0], a[0][1], a[1][0], a[1][1]);
      expand_word(words[2 * pair + h][1], a[0][2], a[0][3], a[1][2], a[1][3]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::mma_bf16(acc[h % kChains<NT>][mt][j], a[mt], bfr[cur][j][2 * h],
                       bfr[cur][j][2 * h + 1]);
    }
  }
}

// The body of both bf16 kernels. Block (blockIdx.x, blockIdx.y) owns columns
// col0 .. col0 + 127 and groups [g0, g1) of split blockIdx.y, which is its
// rank in the cluster of gridDim.y blocks. Dynamic shared memory: `stages`
// ring stages of mma_stage_bytes(NT); the fp32 partial takes the ring's place
// once it is drained.
template <int NT, bool kDma>
__device__ __forceinline__ void mma_main(const __nv_bfloat16* __restrict__ x,
                                         const int8_t* __restrict__ packed,
                                         const float* __restrict__ scale,
                                         __nv_bfloat16* __restrict__ y, int m, int in_f, int out_f,
                                         int groups, int gs, int gps, int stages, int vec_x,
                                         int vec_p, int vec_s, const CUtensorMap* tmap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (kSmemAlign - tc::smem_addr(smem_raw) % kSmemAlign) % kSmemAlign;
  __shared__ __align__(8) uint64_t bars[kMaxStages];  // K5d: one mbarrier a stage
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kStage = mma_stage_bytes(NT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kCols;
  const int g0 = blockIdx.y * gps, g1 = min(g0 + gps, groups);
  const int tpg = gs / kTileRows;  // ring tiles per group
  const int n = (g1 - g0) * tpg;
  const int kbase = g0 * gs;

  if (kDma) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The next tile of this block into the next stage. Stage, group and row
  // positions are counters: a division by a runtime value costs a few dozen
  // instructions, and the loop is short enough for them to show.
  int in_slot = 0, in_tile = 0, k0 = kbase;  // in_tile: the tile's place in its group
  const float* srow = scale + (int64_t)g0 * out_f + col0;
  auto issue = [&]() {
    unsigned char* st = smem + in_slot * kStage;
    uint8_t* sp = reinterpret_cast<uint8_t*>(st);
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(st + mma_x_offset());
    float* ss = reinterpret_cast<float*>(st + mma_scale_offset(NT));
    const bool first = in_tile == 0;  // the group's scales come with its first tile
    if (vec_x) {  // in % 8 == 0, 16-byte aligned: a piece is wholly inside or outside
      for (int idx = tid; idx < 8 * NT * (kTileRows / 8); idx += kMmaThreads) {
        const int r = idx / (kTileRows / 8), kk = (idx % (kTileRows / 8)) * 8;
        const bool valid = r < m && k0 + kk < in_f;
        tc::cp_async16(sx + r * kXLd + kk, valid ? x + (int64_t)r * in_f + k0 + kk : x, valid);
      }
    } else {
      for (int idx = tid; idx < 8 * NT * kTileRows; idx += kMmaThreads) {
        const int r = idx / kTileRows, kk = idx % kTileRows;
        sx[r * kXLd + kk] = r < m && k0 + kk < in_f ? x[(int64_t)r * in_f + k0 + kk]
                                                    : __float2bfloat16(0.f);
      }
    }
    const int8_t* src = packed + (int64_t)(k0 / 2) * out_f + col0;
    if (kDma) {  // out % 128 == 0, packed and scale 16-byte aligned (checked by the entry point)
      // one tensor copy of the 64 x 128-byte box (swizzled as swz() reads it)
      // and one bulk copy of the group's scales, on the stage's mbarrier
      if (tid == 0) {
        uint64_t* bar = &bars[in_slot];
        mbar_expect_tx(bar, kTilePRows * kCols + (first ? kCols * 4 : 0));
        tensor_copy(sp, tmap, col0, k0 / 2, bar);
        if (first) bulk_copy(ss, srow, kCols * 4, bar);
      }
    } else {
      if (first && vec_s) {  // out % 4 == 0, aligned: 16-byte pieces of 4 scales
        if (tid < kCols / 4) {
          const bool valid = col0 + 4 * tid < out_f;
          tc::cp_async16(ss + 4 * tid, valid ? srow + 4 * tid : scale, valid);
        }
      } else if (first) {
        ss[tid] = col0 + tid < out_f ? srow[tid] : 0.f;  // kMmaThreads == kCols
      }
      if (vec_p) {  // out % 16 == 0, aligned
        for (int idx = tid; idx < kTilePRows * (kCols / 16); idx += kMmaThreads) {
          const int p = idx / (kCols / 16), c = (idx % (kCols / 16)) * 16;
          const bool valid = col0 + c < out_f;
          tc::cp_async16(sp + swz(p, c), valid ? src + (int64_t)p * out_f + c : packed, valid);
        }
      } else {
        for (int idx = tid; idx < kTilePRows * kCols; idx += kMmaThreads) {
          const int p = idx / kCols, c = idx % kCols;
          sp[swz(p, c)] = col0 + c < out_f ? (uint8_t)src[(int64_t)p * out_f + c] : (uint8_t)0;
        }
      }
    }
    tc::cp_async_commit();
    k0 += kTileRows;
    if (++in_tile == tpg) in_tile = 0, srow += out_f;
    if (++in_slot == stages) in_slot = 0;
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < n) issue();
    else tc::cp_async_commit();  // empty groups keep the count of the waits below
  }

  float tot[2][NT][4], acc[kChains<NT>][2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[t][j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < kChains<NT>; ++c) acc[c][t][j][e] = 0.f;
      }
  // this lane's columns: tile t, accumulator row g -> 4g + 2t, row g + 8 -> 4g + 2t + 1
  const int lcol = warp * 32 + 4 * (lane >> 2);
  float sc[4];
  int slot = 0, tile = 0;  // tile i's stage and its place in its group
  uint32_t phase = 0;      // parity of the stage's mbarrier for this use
  for (int i = 0; i < n; ++i) {
    cp_async_wait_upto(stages - 2);  // tile i's cp.async group has landed
    if (kDma) mbar_wait(&bars[slot], phase);
    __syncthreads();  // tile i is visible; stage (i - 1) % stages has been consumed
    if (i + stages - 1 < n) issue();
    else tc::cp_async_commit();
    const unsigned char* st = smem + slot * kStage;
    if (tile == 0) {
      const float4 s4 = *reinterpret_cast<const float4*>(st + mma_scale_offset(NT) + 4 * lcol);
      sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
    }
    tile_mma<NT>(reinterpret_cast<const uint8_t*>(st),
                 reinterpret_cast<const __nv_bfloat16*>(st + mma_x_offset()), warp, lane, acc);
    if (++tile == tpg) {  // the group is complete: its scale, then the sum over groups
      tile = 0;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[e] = acc[0][t][j][e];
#pragma unroll
            for (int c = 1; c < kChains<NT>; ++c) d[e] += acc[c][t][j][e];
#pragma unroll
            for (int c = 0; c < kChains<NT>; ++c) acc[c][t][j][e] = 0.f;
          }
          tot[t][j][0] += d[0] * sc[2 * t];
          tot[t][j][1] += d[1] * sc[2 * t];
          tot[t][j][2] += d[2] * sc[2 * t + 1];
          tot[t][j][3] += d[3] * sc[2 * t + 1];
        }
    }
    if (kDma) fence_proxy_async();  // this thread's reads of the stage before its next refill
    if (++slot == stages) slot = 0, phase ^= 1;
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: the partial takes its place

  // Split sum: each block leaves its partial [8 NT][128] fp32 (natural column
  // order) in its shared memory; after a cluster barrier block r adds, for
  // its share of the tile's outputs, the partials of splits 0, 1, ... in that
  // order (distributed shared memory, every load in flight before the first
  // add) and writes y; a second barrier keeps every block's shared memory
  // alive until the others have read it. (Pushing each partial into its
  // owner's shared memory instead, with one barrier, read slower.) Lane
  // (g, t) holds x rows 8j + 2t (registers 0, 2) and 8j + 2t + 1 (1, 3).
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = j * 8 + 2 * (lane & 3), col = lcol + 2 * t;
      *reinterpret_cast<float2*>(part + row * kPartLd + col) =
          make_float2(tot[t][j][0], tot[t][j][2]);
      *reinterpret_cast<float2*>(part + (row + 1) * kPartLd + col) =
          make_float2(tot[t][j][1], tot[t][j][3]);
    }
  cluster.sync();  // every split's partial is in place
  const int splits = gridDim.y, rank = blockIdx.y;
  const int total = m * kCols, lo = rank * total / splits, hi = (rank + 1) * total / splits;
  for (int e = lo + tid; e < hi; e += kMmaThreads) {
    const int row = e / kCols, c = e % kCols;
    if (col0 + c >= out_f) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      v[s] = s < splits ? cluster.map_shared_rank(part, s)[row * kPartLd + c] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxCluster; ++s)
      if (s < splits) sum += v[s];
    y[(int64_t)row * out_f + col0 + c] = __float2bfloat16(sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}


template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
int4_grid_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int m,
                     int in_f, int out_f, int groups, int gs, int gps, int stages, int vec_x,
                     int vec_p, int vec_s, const __grid_constant__ CUtensorMap tmap) {
  mma_main<NT, false>(x, packed, scale, y, m, in_f, out_f, groups, gs, gps, stages, vec_x, vec_p,
                      vec_s, &tmap);
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
int4_dma_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int m,
                    int in_f, int out_f, int groups, int gs, int gps, int stages, int vec_x,
                    int vec_p, int vec_s, const __grid_constant__ CUtensorMap tmap) {
  mma_main<NT, true>(x, packed, scale, y, m, in_f, out_f, groups, gs, gps, stages, vec_x, vec_p,
                     vec_s, &tmap);
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int NT>
int launch_mma(const void* x, const void* packed, const void* scale, void* y, int m, int in_f,
               int out_f, int groups, int gs, int variant, int splits, int stages,
               int smem_bytes, cudaStream_t stream) {
  auto kernel = variant == 1 ? int4_dma_mma_kernel<NT> : int4_grid_mma_kernel<NT>;
  if (smem_bytes != stages * mma_stage_bytes(NT) + kSmemAlign) return (int)cudaErrorInvalidValue;
  CUtensorMap tmap = {};  // the dma kernel's view of `packed`: boxes of 64 rows x 128 bytes
  if (variant == 1) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)out_f, (cuuint64_t)groups * gs / 2};
    const cuuint64_t strides[1] = {(cuuint64_t)out_f};
    const cuuint32_t box[2] = {kCols, kTilePRows}, one[2] = {1, 1};
    const CUresult rc = encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed),
                               dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int gps = (groups + splits - 1) / splits;
  const int vec_x = in_f % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_p = out_f % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const int vec_s = out_f % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaLaunchAttribute cluster;  // the splits of a column tile are one cluster
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_f + kCols - 1) / kCols, splits);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const int8_t*>(packed), static_cast<const float*>(scale),
                           static_cast<__nv_bfloat16*>(y), m, in_f, out_f, groups, gs, gps, stages,
                           vec_x, vec_p, vec_s, tmap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// n bytes (n % 4 == 0) -> n bf16x2 through expand_word, four bytes a thread
__global__ void int4_expand_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                   int words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words) expand_word(in[i], out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
}

int dispatch_mma(const void* x, const void* packed, const void* scale, void* y, int m, int in_f,
                 int out_f, int groups, int gs, int variant, int splits, int stages,
                 int smem_bytes, cudaStream_t s) {
  const int gps = (groups + splits - 1) / splits;
  if (splits > kMaxCluster || (splits - 1) * gps >= groups || stages < 2 ||
      stages > kMaxStages || (size_t)smem_bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;  // a split without groups, or a plan of another layout
  if (variant == 1 && (out_f % kCols != 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(scale) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  switch (n_tiles_of(m)) {
#define GRASP_NT(NT)                                                                          \
  case NT:                                                                                    \
    return launch_mma<NT>(x, packed, scale, y, m, in_f, out_f, groups, gs, variant, splits,   \
                          stages, smem_bytes, s);
    GRASP_NT(1) GRASP_NT(2) GRASP_NT(4) GRASP_NT(8)
#undef GRASP_NT
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// variant 0 = grid, 1 = dma. dtype 0 = float32, 1 = bfloat16. The plan is
// ops/int4_matmul.py::int4_plan's.
// - bf16: `splits` blocks (one cluster, at most 8) share each column tile's
//   groups, ceil(groups / splits) each, none empty; `stages` (2 to 8) ring
//   stages of smem_bytes / stages bytes each, which must be this file's
//   stage size for m's n-tiles; gpc must be 0 and partial null (the splits
//   add up inside the kernel). dma needs out % 128 == 0 and packed 16-byte
//   aligned.
// - fp32: `splits` blocks share each column tile's contraction (whole groups
//   for the grid variant, whole chunks of `gpc` groups for the dma variant:
//   groups must be a multiple of gpc and two chunks must fit shared memory);
//   with splits > 1, `partial` is an fp32 scratch of splits * m * out_f
//   elements. stages and smem_bytes must be 0.
// Returns 0 or a cudaError_t code.
extern "C" int grasp_int4_matmul(const void* x, const void* packed, const void* scale, void* y,
                                 void* partial, int m, int in_f, int out_f, int groups, int gs,
                                 int dtype, int variant, int splits, int gpc, int stages,
                                 int smem_bytes, void* stream) {
  if (m <= 0 || m > kMaxRows || in_f <= 0 || out_f <= 0 || groups <= 0 || gs <= 0 ||
      gs % kSub != 0 || in_f > groups * gs || splits <= 0 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (partial != nullptr || gpc != 0) return (int)cudaErrorInvalidValue;
    return dispatch_mma(x, packed, scale, y, m, in_f, out_f, groups, gs, variant, splits, stages,
                        smem_bytes, s);
  }
  if (dtype != 0 || stages != 0 || smem_bytes != 0) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int mt = rows_per_thread(m);
  if (variant == 0) {
    if (splits > groups) return (int)cudaErrorInvalidValue;
    switch (mt) {
#define GRASP_GRID(MT)                                                                        \
  case MT:                                                                                    \
    return launch_grid<float, MT>(x, packed, scale, y, partial, m, in_f, out_f, groups, gs,  \
                                  splits, s);
      GRASP_GRID(1) GRASP_GRID(2) GRASP_GRID(4) GRASP_GRID(8)
#undef GRASP_GRID
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (out_f % kCols != 0 || gpc <= 0 || groups % gpc != 0 ||
      sizeof(float) * kMaxRows * kSub + (size_t)gpc * gs * kCols > kMaxSharedBytes ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = groups / gpc;
  if (splits > n_chunks) return (int)cudaErrorInvalidValue;
  switch (mt) {
#define GRASP_DMA(MT)                                                                         \
  case MT:                                                                                    \
    return launch_dma<float, MT>(x, packed, scale, y, partial, m, in_f, out_f, gs, gpc,      \
                                 n_chunks, splits, s);
    GRASP_DMA(1) GRASP_DMA(2) GRASP_DMA(4) GRASP_DMA(8)
#undef GRASP_DMA
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernels' nibble expansion alone: `in` holds 4 * words packed
// bytes, `out` receives one bf16x2 {low nibble, high nibble} per byte. For a
// check of expand_byte over every byte value at every position of a word.
extern "C" int grasp_int4_expand(const void* in, void* out, int words, void* stream) {
  if (words <= 0) return (int)cudaErrorInvalidValue;
  int4_expand_kernel<<<(words + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), words);
  return (int)cudaGetLastError();
}
