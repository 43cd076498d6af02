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
// the counter set to (element index / 4); element i takes word i % 4. The same
// seed gives the same bits on every run and for every launch geometry. The
// stream is neither the TPU's nor torch.Generator's, so the plain version is
// held to this kernel by structure and distribution, not bit for bit.
// u = (bits >> 8) * 2^-24 is below 1 exactly, so floor(x + u) never reaches
// x + 1 for an integer x.
//
// What bounds it: bytes. Every element is read twice (absmax pass, rounding
// pass; the second read of a tensor under 50 MB comes from L2) and written
// once as one byte. Three launches: column absmax with the rows split over
// blocks (atomicMax on the bit pattern of a non-negative float, which orders
// like the float and gives the same result in any order), the scales, the
// rounding pass with four elements per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void philox_round(uint32_t (&c)[4], uint32_t k0, uint32_t k1) {
  const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
  const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
  c[0] = hi1 ^ c[1] ^ k0;
  c[1] = lo1;
  c[2] = hi0 ^ c[3] ^ k1;
  c[3] = lo0;
}

// Philox4x32-10: four 32-bit words from a 128-bit counter and a 64-bit key.
__device__ __forceinline__ void philox4x32_10(uint32_t (&c)[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    philox_round(c, k0, k1);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// absmax_bits[col] = max over this block's rows of |w[row, col]|, as float bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
column_absmax_kernel(const T* __restrict__ w, int* __restrict__ absmax_bits, int in_f,
                     int out_f) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= out_f) return;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int row1 = min(row0 + kRowsPerBlock, in_f);
  float m = 0.f;
  for (int row = row0; row < row1; ++row)
    m = fmaxf(m, fabsf(to_float(w[(int64_t)row * out_f + col])));
  atomicMax(absmax_bits + col, __float_as_int(m));
}

__global__ void scale_kernel(float* __restrict__ scale, int out_f) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= out_f) return;
  const float absmax = scale[col];
  scale[col] = absmax == 0.f ? 1.f : absmax / 127.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stochastic_round_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                        int8_t* __restrict__ q, int64_t n, int out_f, uint32_t seed_lo,
                        uint32_t seed_hi) {
  const int64_t quad = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t first = quad * 4;
  if (first >= n) return;
  uint32_t c[4] = {(uint32_t)quad, (uint32_t)((uint64_t)quad >> 32), 0u, 0u};
  philox4x32_10(c, seed_lo, seed_hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t e = first + j;
    if (e >= n) break;
    const float u = (float)(c[j] >> 8) * (1.0f / 16777216.0f);
    const float scaled = to_float(w[e]) / scale[e % out_f];
    const float r = fminf(fmaxf(floorf(scaled + u), -127.f), 127.f);
    q[e] = (int8_t)r;
  }
}

template <typename T>
int launch(const void* w, void* q, void* scale, int in_f, int out_f, uint64_t seed,
           cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scale, 0, sizeof(float) * out_f, stream);
  if (err != cudaSuccess) return (int)err;
  const int col_blocks = (out_f + kThreads - 1) / kThreads;
  const dim3 grid(col_blocks, (in_f + kRowsPerBlock - 1) / kRowsPerBlock);
  column_absmax_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<int*>(scale), in_f, out_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scale_kernel<<<col_blocks, kThreads, 0, stream>>>(static_cast<float*>(scale), out_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)in_f * out_f;
  const int64_t quads = (n + 3) / 4;
  stochastic_round_kernel<T><<<(unsigned)((quads + kThreads - 1) / kThreads), kThreads, 0,
                               stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(scale), static_cast<int8_t*>(q), n,
      out_f, (uint32_t)seed, (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // namespace

// w [in_f, out_f] (dtype 0 = float32, 1 = bfloat16) -> q int8 [in_f, out_f],
// scale float32 [out_f]. Returns 0 or a cudaError_t code.
extern "C" int grasp_quantize_int8_stochastic(const void* w, void* q, void* scale, int in_f,
                                              int out_f, int dtype, unsigned long long seed,
                                              void* stream) {
  if (in_f <= 0 || out_f <= 0 || (int64_t)in_f * out_f > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, q, scale, in_f, out_f, seed, s);
  if (dtype == 1) return launch<__nv_bfloat16>(w, q, scale, in_f, out_f, seed, s);
  return (int)cudaErrorInvalidValue;
}
