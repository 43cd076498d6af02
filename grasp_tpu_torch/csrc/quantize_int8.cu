// Stochastic-rounding int8 quantizer for Hopper (sm_90a).
//
// Replaces the TPU kernel grasp_tpu/ops/quant.py::pallas_quantize_int8 (its
// Pallas body `kernel`).
//
// What it computes: for w [in, out] (fp32 or bf16), one scale per output
// column, scale = absmax / 127 (1 where the column is all zero), and
// q = clip(floor(w / scale + u), -127, 127) as int8, with u uniform in [0, 1)
// on a 24-bit grid. Rounding down or up with probability equal to the
// fractional part makes q * scale an unbiased estimate of w.
//
// Random bits: the TPU kernel seeds the core's own generator; here the bits
// come from Philox4x32-10, written out below, keyed by the 64-bit seed with
// the counter (quad lo, quad hi, 0, 0), quad = element index / 4; element i
// takes word i % 4. The same seed gives the same bits on every run and for
// every launch geometry. The plain version
// (ops/quant.py::quantize_int8_stochastic_plain) computes the same stream in
// torch int64 arithmetic, so the two give the same q and scales bit for bit.
// u = (bits >> 8) * 2^-24 is below 1 exactly, so floor(x + u) never reaches
// x + 1 for an integer x. The scale is absmax / 127 and the quotient w / scale
// are IEEE divisions (no reciprocal products).
//
// What bounds it: bytes and integer work, close together. In bf16 an element
// moves 3 bytes (w read once, q written once); a Philox call (ten rounds of
// two 32 x 32 -> 64-bit products) yields the words of four elements. On an
// H100 the rounding pass is the larger part (about 31 instructions an
// element, a third of them Philox's and a third the IEEE division's), and the
// maxima need every row of a strip before the first element is rounded, so
// a block's loads and its rounding do not overlap (PERF.md, Findings;
// scripts/quantizer_breakdown_torch.py).
//
// Design: one launch, no memset, no atomics in device memory. The plan is
// ops/quant.py::quantize_plan, pure Python; a plan that does not match this
// file's layout is refused.
// - The columns are cut into strips of 128 bytes of a row (64 bf16 or 32
//   fp32 columns); the rows of a strip are split across the blocks of one
//   thread-block cluster (at most 8), `rows_per_block` each, with 256, 512
//   or 1024 threads (more for more rows). Thread t owns one 16-byte chunk of
//   a row (8 bf16 or 4 fp32 columns) in rows t / 8, t / 8 + threads / 8, ...,
//   so its columns and their scales are fixed.
// - keep = 1: a block copies its rows of the strip into shared memory once
//   (16-byte cp.async, every copy in flight at once), reduces its column
//   maxima from there and rounds from there: w is read from device memory
//   once. keep = 0 (the rows do not fit in 227 KB of shared memory): both
//   passes read w from device memory, which reads it twice.
// - Column maxima: per thread, across the warp by shuffles, across the warps
//   by shared-memory atomicMax on the bits (non-negative floats order as
//   their bits; a max is exact in any order). Then every block sends its
//   maxima into the shared memory of every block of its cluster (st.async,
//   distributed shared memory), where an mbarrier counts the bytes: a block
//   waits for the maxima of all blocks, computes the scales, and block 0
//   writes them. No block reads another's shared memory, so none waits for
//   the others before it exits, and no cluster barrier with a release fence
//   (a wait on every memory operation in flight) stands in the way.
// - Rounding: two Philox calls a bf16 chunk (one an fp32 chunk), the round
//   keys from the host as kernel arguments; floor and conversion in one add
//   rounding down (round_one); q stored 8 (bf16) or 4 (fp32) bytes at a time.
// - vec = 0 (the column count is not a multiple of a chunk, or a pointer is
//   not aligned): element-by-element loads, a Philox call per element and
//   byte stores, in the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kStripBytes = 128;               // bytes of each row a strip holds
constexpr int kChunks = kStripBytes / 16;      // 16-byte chunks of a strip's row
constexpr int kMaxCols = kStripBytes / 2;      // columns of a bf16 strip
constexpr int kMaxCluster = 8;
// the block's maxima [kMaxCols] (float bits), the maxima every block of the
// cluster sends [kMaxCluster][kMaxCols], the scales [kMaxCols], the mbarrier
// that counts the bytes sent (16 bytes); the tile of keep = 1 follows
constexpr int kFixedSmem = (kMaxCluster + 2) * kMaxCols * 4 + 16;
constexpr size_t kMaxSharedBytes = 232448;

// Philox4x32-10's round keys, from the seed on the host; a kernel argument,
// so the rounds read them as constant operands
struct Keys {
  uint32_t k0[10], k1[10];
};

// Philox4x32-10 at the counter (quad, 0, 0, 0): the high word of a quad is 0
// because a call takes fewer than 2^31 elements
__device__ __forceinline__ uint4 philox(uint32_t quad, const Keys& key) {
  uint32_t c0 = quad, c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ key.k0[i];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ key.k1[i];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// q of one element, clip(floor(x / s + u), -127, 127), in the low byte of the
// result. Clipping before the floor gives the same integer for every input
// (NaN included: -127 both ways). t + 1.5 * 2^23 rounded down is floor(t) +
// 1.5 * 2^23, whose ulp is 1, so its low bits are floor(t) in two's
// complement: one add instead of a rounding and a conversion.
__device__ __forceinline__ uint32_t round_one(float x, float s, uint32_t bits) {
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  const float t = fminf(fmaxf(x / s + u, -127.f), 127.f);
  return __float_as_uint(__fadd_rd(t, 12582912.f));
}

// the low bytes of a, b, c, d as one word (a lowest)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One 16-byte chunk of a row: its elements as floats, and an element-by-element
// load for the scalar path (zeros beyond `valid`)
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 gather(const float* p, int valid) {
    const uint32_t* b = reinterpret_cast<const uint32_t*>(p);
    return make_uint4(valid > 0 ? b[0] : 0u, valid > 1 ? b[1] : 0u, valid > 2 ? b[2] : 0u,
                      valid > 3 ? b[3] : 0u);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void unpack(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  __device__ static uint4 gather(const __nv_bfloat16* p, int valid) {
    const uint16_t* b = reinterpret_cast<const uint16_t*>(p);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (2 * k < valid ? (uint32_t)b[2 * k] : 0u) |
             (2 * k + 1 < valid ? (uint32_t)b[2 * k + 1] << 16 : 0u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of `p`'s counterpart in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(tc::smem_addr(p)), "r"(rank));
  return a;
}

// 4 bytes into another block's shared memory, counted on its mbarrier `bar`
__device__ __forceinline__ void send(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
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

// Grid (strips, cluster): blockIdx.x is the strip, blockIdx.y the block's
// rows [blockIdx.y * rows_per_block, ...) and its rank in the cluster. kBlock
// threads (256, 512 or 1024) at most 64 registers each.
template <typename T, bool kKeep, int kBlock>
__global__ void __launch_bounds__(kBlock, 1024 / kBlock)
quantize_int8_kernel(const T* __restrict__ w, int8_t* __restrict__ q, float* __restrict__ scale,
                     int in_f, int out_f, int rows_per_block, int vec,
                     const __grid_constant__ Keys keys) {
  constexpr int V = Chunk<T>::kElems;  // elements of a chunk
  constexpr int kCols = kChunks * V;   // columns of a strip
  constexpr int kRowStep = kBlock / kChunks;  // rows the block covers in one pass
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* blockmax = reinterpret_cast<uint32_t*>(smem);  // [kMaxCols]
  float* recv = reinterpret_cast<float*>(blockmax + kMaxCols);  // [kMaxCluster][kMaxCols]
  float* sscale = recv + kMaxCluster * kMaxCols;                 // [kMaxCols]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sscale + kMaxCols);
  uint8_t* tile = smem + kFixedSmem;  // [rows_per_block][kStripBytes], keep = 1
  const int cluster_size = gridDim.y, rank = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32;
  const int c0 = (tid % kChunks) * V;  // the thread's first column in the strip
  const int col0 = blockIdx.x * kCols;
  const int ncols = min(kCols, out_f - col0);
  const int row0 = rank * rows_per_block;
  const int nrows = max(0, min(rows_per_block, in_f - row0));
  // with vec a chunk lies wholly inside or wholly beyond the last column
  const bool live = c0 < ncols;
  const int valid = min(V, ncols - c0);
  const T* src = w + (int64_t)row0 * out_f + col0 + c0;  // the thread's chunk in the block's row 0

  auto global_chunk = [&](int r) -> uint4 {
    const T* p = src + (int64_t)r * out_f;
    return vec ? __ldg(reinterpret_cast<const uint4*>(p)) : Chunk<T>::gather(p, valid);
  };
  auto chunk_at = [&](int r) -> uint4 {
    if (kKeep) return *reinterpret_cast<const uint4*>(tile + r * kStripBytes + c0 * sizeof(T));
    return global_chunk(r);
  };

  // Every block sends its maxima to every block of the cluster (itself
  // included); the mbarrier completes when all of them have arrived. The
  // cluster barrier's wait, before the first send, makes sure that every
  // block has set up its mbarrier.
  if (tid == 0) mbar_init_expect(bar, cluster_size * kCols * 4);
  if (tid < kCols) blockmax[tid] = 0u;
  cluster_arrive_relaxed();

  if (kKeep) {  // the block's rows of the strip into shared memory
    if (live)
      for (int r = tid / kChunks; r < nrows; r += kRowStep) {
        uint8_t* dst = tile + r * kStripBytes + c0 * sizeof(T);
        if (vec)
          tc::cp_async16(dst, src + (int64_t)r * out_f, true);
        else
          *reinterpret_cast<uint4*>(dst) = global_chunk(r);
      }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }

  float m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = 0.f;
  if (live)
    for (int r = tid / kChunks; r < nrows; r += kRowStep) {
      float f[V];
      Chunk<T>::unpack(chunk_at(r), f);
#pragma unroll
      for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
    }
  // lanes l, l ^ 8, l ^ 16 and l ^ 24 of a warp hold the same columns
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xFFFFFFFFu, m[i], 8));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xFFFFFFFFu, m[i], 16));
  }
  __syncthreads();  // blockmax is zeroed
  // the bits of non-negative floats order as the floats: the max in any order
  if (lane < kChunks && live)
#pragma unroll
    for (int i = 0; i < V; ++i) atomicMax(blockmax + c0 + i, __float_as_uint(m[i]));
  __syncthreads();
  cluster_wait();  // every block's mbarrier is set up
  if (tid < kCols)
    for (int b = 0; b < cluster_size; ++b)
      send(cluster_addr(recv + rank * kMaxCols + tid, b), blockmax[tid], cluster_addr(bar, b));
  mbar_wait(bar, 0);  // every block's maxima are in
  if (tid < kCols) {
    float a = 0.f;
    for (int b = 0; b < cluster_size; ++b) a = fmaxf(a, recv[b * kMaxCols + tid]);
    const float sc = a == 0.f ? 1.f : a / 127.f;
    sscale[tid] = sc;
    if (rank == 0 && tid < ncols) scale[col0 + tid] = sc;
  }
  __syncthreads();

  float s[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sscale[c0 + i];
  if (live)
    for (int r = tid / kChunks; r < nrows; r += kRowStep) {
      float f[V];
      Chunk<T>::unpack(chunk_at(r), f);
      const uint32_t e0 = (uint32_t)(row0 + r) * (uint32_t)out_f + (uint32_t)(col0 + c0);
      if (vec) {  // e0 is a multiple of 4 (of 8 in bf16)
        uint32_t b[V];
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          const uint4 bits = philox(e0 / 4 + k, keys);
          b[4 * k] = round_one(f[4 * k], s[4 * k], bits.x);
          b[4 * k + 1] = round_one(f[4 * k + 1], s[4 * k + 1], bits.y);
          b[4 * k + 2] = round_one(f[4 * k + 2], s[4 * k + 2], bits.z);
          b[4 * k + 3] = round_one(f[4 * k + 3], s[4 * k + 3], bits.w);
        }
        if constexpr (V == 8)
          *reinterpret_cast<uint2*>(q + e0) =
              make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
        else
          *reinterpret_cast<uint32_t*>(q + e0) = pack4(b[0], b[1], b[2], b[3]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (i >= valid) break;
          const uint32_t e = e0 + i;
          const uint4 bits = philox(e / 4, keys);
          const uint32_t word = e % 4 == 0 ? bits.x : e % 4 == 1 ? bits.y
                                                  : e % 4 == 2 ? bits.z : bits.w;
          reinterpret_cast<uint8_t*>(q)[e] = (uint8_t)round_one(f[i], s[i], word);
        }
      }
    }
}

template <typename T, bool kKeep, int kBlock>
int launch(const void* w, void* q, void* scale, int in_f, int out_f, int cluster_size,
           int rows_per_block, int smem_bytes, const Keys& keys, cudaStream_t stream) {
  auto kernel = quantize_int8_kernel<T, kKeep, kBlock>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int V = Chunk<T>::kElems;
  const int vec = out_f % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % (V == 8 ? 8 : 4) == 0;
  const int cols = kChunks * V;
  cudaLaunchAttribute cluster;  // the blocks of a strip are one cluster
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = cluster_size;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_f + cols - 1) / cols, cluster_size);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(w), static_cast<int8_t*>(q),
                           static_cast<float*>(scale), in_f, out_f, rows_per_block, vec, keys);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kKeep>
int launch_threads(int threads, const void* w, void* q, void* scale, int in_f, int out_f,
                   int cluster_size, int rows_per_block, int smem_bytes, const Keys& keys,
                   cudaStream_t stream) {
  switch (threads) {
    case 256:
      return launch<T, kKeep, 256>(w, q, scale, in_f, out_f, cluster_size, rows_per_block,
                                   smem_bytes, keys, stream);
    case 512:
      return launch<T, kKeep, 512>(w, q, scale, in_f, out_f, cluster_size, rows_per_block,
                                   smem_bytes, keys, stream);
    case 1024:
      return launch<T, kKeep, 1024>(w, q, scale, in_f, out_f, cluster_size, rows_per_block,
                                    smem_bytes, keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// w [in_f, out_f] (dtype 0 = float32, 1 = bfloat16) -> q int8 [in_f, out_f],
// scale float32 [out_f]. The plan is ops/quant.py::quantize_plan's: `cluster`
// blocks (at most 8) of `rows_per_block` rows each cover a strip's rows, none
// empty, with `threads` threads (256, 512 or 1024) each; keep 1 holds the rows
// in shared memory, and smem_bytes must be this file's size for the plan.
// Returns 0 or a cudaError_t code.
extern "C" int grasp_quantize_int8_stochastic(const void* w, void* q, void* scale, int in_f,
                                              int out_f, int dtype, int cluster,
                                              int rows_per_block, int threads, int keep,
                                              int smem_bytes, unsigned long long seed,
                                              void* stream) {
  if (in_f <= 0 || out_f <= 0 || (int64_t)in_f * out_f > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || rows_per_block < 1 ||
      (int64_t)(cluster - 1) * rows_per_block >= in_f ||
      (int64_t)cluster * rows_per_block < in_f || (keep != 0 && keep != 1) ||
      (int64_t)smem_bytes != kFixedSmem + (int64_t)keep * rows_per_block * kStripBytes ||
      (size_t)smem_bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;  // a plan of another layout
  Keys keys;
  for (int i = 0; i < 10; ++i) {
    keys.k0[i] = (uint32_t)seed + (uint32_t)i * 0x9E3779B9u;
    keys.k1[i] = (uint32_t)(seed >> 32) + (uint32_t)i * 0xBB67AE85u;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return keep ? launch_threads<float, true>(threads, w, q, scale, in_f, out_f, cluster,
                                              rows_per_block, smem_bytes, keys, s)
                : launch_threads<float, false>(threads, w, q, scale, in_f, out_f, cluster,
                                               rows_per_block, smem_bytes, keys, s);
  if (dtype == 1)
    return keep ? launch_threads<bf16, true>(threads, w, q, scale, in_f, out_f, cluster,
                                             rows_per_block, smem_bytes, keys, s)
                : launch_threads<bf16, false>(threads, w, q, scale, in_f, out_f, cluster,
                                              rows_per_block, smem_bytes, keys, s);
  return (int)cudaErrorInvalidValue;
}
