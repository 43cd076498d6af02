// Fused low-rank projection y = (x @ A) @ B for Hopper (sm_90a).
//
// Replaces the TPU kernel grasp_tpu/ops/pallas_lowrank.py::_fused_fwd (its
// Pallas body `_kernel`).
//
// What it computes: x [m, k], A [k, r], B [r, n], all fp32 or all bf16;
// h = x @ A accumulated in fp32 and rounded to x's dtype (as the TPU kernel
// casts its scratch before the second product), y = h @ B accumulated in
// fp32 and written in x's dtype. h never reaches device memory. m, k, r, n
// are arbitrary (ragged edges are masked, nothing is padded in memory). One
// launch takes at most 256 ranks; wider ranks run as chunks of A's columns
// and B's rows, one launch each, whose fp32 products add up in chunk order
// before y is rounded once (as the TPU kernel's one fp32 product over all
// ranks is rounded once); h is rounded per chunk, element by element, as the
// TPU kernel rounds all of h.
//
// fp32 body. x, A, B and y are each moved once (a few megabytes) for
// 2 m r (k + n) flops. The TPU grid ran the output tiles of one
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
// Two bodies, chosen by dtype. fp32 takes lowrank_fused_kernel (below, the
// simple first design): every product is an fp32 FMA on a CUDA core, loads
// are synchronous, and the rank is rounded up to 32, 64, 128, 192 or 256
// columns of accumulators; fp32 stays off the tensor cores because its gate
// (1e-4) is below what TF32 keeps. bf16 takes lowrank_fused_mma_kernel, the
// tensor-core design described above it.
//
// The launch plan (rank padding, splits, output tiles per split, dynamic
// shared memory) is computed by ops/lowrank.py::lowrank_plan from the shapes
// and the SM count and passed in; a plan this file does not build is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

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
                     T* y, const float* y_in, int m, int k, int r, int lda, int n,
                     int tiles_per_split) {
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
      as[idx] = kk < k && c < r ? to_float(a[(int64_t)kk * lda + c]) : 0.f;
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
        if (c < n) {
          const int64_t at = (int64_t)row * n + c;
          // y_in: the sum of earlier rank chunks (may be y itself)
          y[at] = from_float<T>(y_in != nullptr ? out[i][j] + y_in[at] : out[i][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces grasp_tpu/ops/pallas_lowrank.py::_fused_fwd for bf16 inputs.
//
// What bounds it: bytes. At a calibration row's up_proj, (m, k, r, n) =
// (2047, 2048, 150, 5632), it moves 33.7 MB (y alone is 23 MB) for 4.7 GFLOP,
// far below the card's balance point. The CUDA-core body above spent 63x that
// bound on fp32 FMAs from fp32-widened tiles loaded element by element.
//
// Design. A block owns 64 rows and a run of 128-column output tiles, with 8
// warps as 2 (rows) x 4 (columns), each warp 32 rows: two m16 fragments share
// every B fragment it loads. Operands come through a ring of four
// shared-memory stages filled by cp.async, so steps s + 1 to s + 3 are in
// flight while step s is computed. Shared memory stays near 110 KB a block at
// the served ranks, so two blocks fit an SM: a cluster needs all its blocks
// resident at once, and at one block an SM an H100 could not hold all 32
// clusters of 4 that the up_proj shape launches (a second wave doubled the
// time).
//
// The grid problem: at the up_proj shape there are 32 row tiles against 132
// SMs, so a row tile's output tiles are dealt to `splits` blocks. Recomputing
// h in each of them reads A once per block and x once per split from the L2
// (190 MB at the up_proj shape; 0.11 ms on an H100, bound by the L2). Here
// the splits of a row tile form one thread-block cluster (at most 8 blocks)
// that computes h once between them:
// - phase one, split k: block j of the cluster takes the j-th share of k's
//   32-deep slices, x_tile[:, share] @ A[share, :] with mma.sync m16n8k16
//   and fp32 accumulators (x by 16-byte copies, A by 4-byte copies: its rows
//   are r * 2 bytes, not a multiple of 16 at the served ranks 102, 22, 150);
// - the partial sums go to shared memory in fp32; block j adds the splits'
//   partials of its 64 / splits rows of h in rank order, reading the other
//   blocks' shared memory (distributed shared memory), rounds to bf16 (the
//   values the TPU kernel's cast gives) and writes those rows into every
//   block's h. The order of the sums is fixed, so h is the same in every
//   block and from run to run;
// - phase two, one step per (output tile, 64 ranks): the B slice by 16-byte
//   copies, products against the resident h, and after a tile's last step the
//   fp32 sums are rounded to bf16, staged in shared memory and written with
//   16-byte stores.
// The fp32 partials borrow the ring and the y staging tile between the phases
// (the ring is drained first), and the two phases are two loops, so their
// accumulators never live together. The rank is padded to a multiple of 32
// (RC = 1..8): A's padded
// columns and B's padded rows are zero-filled by the copies, so no
// uninitialised shared memory meets a product (NaN x 0 would be NaN).
// Unaligned shapes (k, n or r that break the copy widths) take
// element-by-element loads and stores. The plan (ops/lowrank.py) picks the
// cluster size that minimises waves x (k / splits + columns per block).
// Every row tile walks its slices of k and its output tiles from its own
// starting point: 32 clusters reading the same lines of A or B at the same
// moment crowd a few L2 slices. A row's h is still summed in one fixed order.

constexpr int kTcThreads = 256;
constexpr int kTcBM = 64;
constexpr int kTcBN = 128;
constexpr int kTcBK1 = 32;  // depth of a phase-one step (of k)
constexpr int kTcBK2 = 64;  // depth of a phase-two step (of the rank)
constexpr int kStages = 4;

// shared-memory layout in bf16 elements; every row padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts
template <int RC>
struct TcLayout {
  static constexpr int RP = 32 * RC;
  static constexpr int XLD = kTcBK1 + 8;
  static constexpr int ALD = RP + 8;
  static constexpr int BLD = kTcBN + 8;
  static constexpr int HLD = RP + 8;
  static constexpr int YLD = kTcBN + 8;
  static constexpr int kStage1 = kTcBM * XLD + kTcBK1 * ALD;
  static constexpr int kStage2 = kTcBK2 * BLD;
  static constexpr int kStage = kStage1 > kStage2 ? kStage1 : kStage2;
  static constexpr int kBytes = 2 * (kStages * kStage + kTcBM * YLD + kTcBM * HLD);
  static constexpr int kRankSteps = (RP + kTcBK2 - 1) / kTcBK2;  // phase-two steps a tile
  static constexpr int PLD = RP + 4;  // fp32 partials of h (over the ring and ys)
  static_assert(kTcBM * PLD * 4 <= (kStages * kStage + kTcBM * YLD) * 2,
                "the partials must fit in the ring and the staging tile");
};

constexpr int kMaxCluster = 8;  // portable thread-block cluster size

// rows [row0, row0 + R) and columns [col0, col0 + C) of a row-major [rows,
// cols] bf16 matrix with row stride ld -> shared (row stride dld), zeros
// outside the matrix. vec: 8 (16-byte copies), 2 (4-byte) or 1 (plain loads).
template <int R, int C>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int dld, const __nv_bfloat16* src,
                                           int64_t ld, int row0, int rows, int col0, int cols,
                                           int vec, int tid) {
  if (vec == 8) {
    for (int i = tid; i < R * (C / 8); i += kTcThreads) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      const bool ok = row0 + r < rows && col0 + c < cols;
      tc::cp_async16(dst + r * dld + c, ok ? src + (row0 + r) * ld + col0 + c : src, ok);
    }
  } else if (vec == 2) {
    for (int i = tid; i < R * (C / 2); i += kTcThreads) {
      const int r = i / (C / 2), c = (i % (C / 2)) * 2;
      const bool ok = row0 + r < rows && col0 + c < cols;
      tc::cp_async4(dst + r * dld + c, ok ? src + (row0 + r) * ld + col0 + c : src, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < R * C; i += kTcThreads) {
      const int r = i / C, c = i % C;
      const bool ok = row0 + r < rows && col0 + c < cols;
      dst[r * dld + c] = ok ? src[(row0 + r) * ld + col0 + c] : zero;
    }
  }
}

// the widest copy that a row-major matrix with this row length, row stride
// and base allows
__device__ __forceinline__ int copy_vec(const void* p, int cols, int ld) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (cols % 8 == 0 && ld % 8 == 0 && at % 16 == 0) return 8;
  if (cols % 2 == 0 && ld % 2 == 0 && at % 4 == 0) return 2;
  return 1;
}

// CHAIN: a rank chunk of a wider call (y_in, out_f32), taken only at RC 8; the
// other instances keep the plain epilogue and its registers
template <int RC, bool CHAIN>
__global__ void __launch_bounds__(kTcThreads, RC <= 5 ? 2 : 1)
lowrank_fused_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ b, void* y, const float* y_in,
                         int out_f32, int m, int k, int r, int lda, int n, int tiles_per_split) {
  using L = TcLayout<RC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kStage]
  __nv_bfloat16* ys = ring + kStages * L::kStage;                     // [kTcBM][YLD]
  __nv_bfloat16* hs = ys + kTcBM * L::YLD;                            // [kTcBM][HLD]
  float* part = reinterpret_cast<float*>(smem_raw);                   // [kTcBM][PLD]

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();  // the cluster is (1, splits, 1)
  const int rank = (int)cluster.block_rank();    // == blockIdx.y
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps; a warp holds 32 rows
  const int row0 = blockIdx.x * kTcBM;
  const int n_tiles = (n + kTcBN - 1) / kTcBN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const int slices = (k + kTcBK1 - 1) / kTcBK1;
  const int share = (slices + splits - 1) / splits;
  const int s0 = rank * share;  // this block's slices of k: [s0, s0 + steps1)
  const int steps1 = max(min(share, slices - s0), 0);
  const int tiles = max(t1 - t0, 0);
  const int steps2 = tiles * L::kRankSteps;
  // row tiles start their walks at different slices and tiles, so that the
  // clusters do not all ask the L2 for the same lines of A and B at once
  const int turn = blockIdx.x;
  // the output tile of phase-two step st
  const auto tile_of = [&](int st) { return t0 + (st / L::kRankSteps + turn) % tiles; };
  // A's row stride: r outside rank chunks, so that those instances keep one
  // register for both (at 128 registers a thread one more spills)
  const int a_ld = CHAIN ? lda : r;
  const int vx = copy_vec(x, k, k), va = copy_vec(a, r, a_ld), vb = copy_vec(b, n, n);
  const bool y_vec = copy_vec(y, n, n) == 8;
  __nv_bfloat16* __restrict__ yb = static_cast<__nv_bfloat16*>(y);

  // one slice into stage st % kStages: of x and A in phase one, of B in phase two
  const auto load_step = [&](int st, bool phase_one) {
    __nv_bfloat16* dst = ring + (st % kStages) * L::kStage;
    if (phase_one && st < steps1) {
      const int k0 = (s0 + (st + turn) % steps1) * kTcBK1;
      stage_tile<kTcBM, kTcBK1>(dst, L::XLD, x, k, row0, m, k0, k, vx, tid);
      stage_tile<kTcBK1, L::RP>(dst + kTcBM * L::XLD, L::ALD, a, a_ld, k0, k, 0, r, va, tid);
    } else if (!phase_one && st < steps2) {
      stage_tile<kTcBK2, kTcBN>(dst, L::BLD, b, n, (st % L::kRankSteps) * kTcBK2, r,
                               tile_of(st) * kTcBN, n, vb, tid);
    }
    tc::cp_async_commit();  // an empty group past the last slice keeps the count
  };
  // slice st has landed for every thread, and the stage slice st - 1 used is free
  const auto next = [&](int st, bool phase_one) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    load_step(st + kStages - 1, phase_one);
    return ring + (st % kStages) * L::kStage;
  };

  // ---- phase one: this block's share of k, the warp's 32 rows x RP / 4 columns ----
  {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) load_step(st, true);
    float acc[2][RC][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int st = 0; st < steps1; ++st) {
      const __nv_bfloat16* xs = next(st, true);
      const __nv_bfloat16* as = xs + kTcBM * L::XLD;
#pragma unroll
      for (int ks = 0; ks < kTcBK1 / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::ldmatrix_x4(af[mt], xs + (wm * 32 + mt * 16 + lane % 16) * L::XLD + ks * 16 +
                                      (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < RC; ++nt) {
          uint32_t bf[2];
          tc::ldmatrix_x2_trans(bf, as + (ks * 16 + lane % 16) * L::ALD + wn * 8 * RC + nt * 8);
          tc::mma_bf16(acc[0][nt], af[0], bf[0], bf[1]);
          tc::mma_bf16(acc[1][nt], af[1], bf[0], bf[1]);
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the ring is drained: the partials take its place
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < RC; ++nt) {
        const int row = wm * 32 + mt * 16 + lane / 4;
        const int col = wn * 8 * RC + nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(part + row * L::PLD + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(part + (row + 8) * L::PLD + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  cluster.sync();  // every block's partials are in place
  {
    // rows [lo, hi) of h: the splits' partials added in rank order, rounded
    // to bf16, written to every block of the cluster
    const int lo = rank * kTcBM / splits, hi = (rank + 1) * kTcBM / splits;
    for (int i = tid; i < (hi - lo) * (L::RP / 4); i += kTcThreads) {
      const int row = lo + i / (L::RP / 4), col = (i % (L::RP / 4)) * 4;
      float4 sum = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, 0) + row * L::PLD + col);
      for (int j = 1; j < splits; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, j) + row * L::PLD + col);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const uint2 h4 = make_uint2(tc::pack_bf16(sum.x, sum.y), tc::pack_bf16(sum.z, sum.w));
      for (int j = 0; j < splits; ++j)
        *reinterpret_cast<uint2*>(cluster.map_shared_rank(hs, j) + row * L::HLD + col) = h4;
    }
  }
  cluster.sync();  // h is whole in every block, and no block reads the partials any more

  // ---- phase two: y tiles = h @ B_tile, the warp's 32 rows x 32 columns ----
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_step(st, false);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int st = 0; st < steps2; ++st) {
    const __nv_bfloat16* bs = next(st, false);
    const int kc = st % L::kRankSteps;  // 64-rank slice of this output tile
    const int depth = min(kTcBK2, L::RP - kc * kTcBK2) / 16;  // the last slice may hold 32
#pragma unroll
    for (int ks = 0; ks < kTcBK2 / 16; ++ks) {
      if (ks >= depth) break;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldmatrix_x4(af[mt], hs + (wm * 32 + mt * 16 + lane % 16) * L::HLD + kc * kTcBK2 +
                                    ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, bs + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L::BLD +
                                      wn * 32 + n2 * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tc::mma_bf16(acc[mt][2 * n2], af[mt], bf[0], bf[1]);
          tc::mma_bf16(acc[mt][2 * n2 + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (kc != L::kRankSteps - 1) continue;
    if constexpr (CHAIN) {
      // rank chunks: add the fp32 sum of the earlier chunks (y_in); all but
      // the last chunk write that sum in fp32 (out_f32, y may be y_in)
      float* yf = static_cast<float*>(y);
      const int n0 = tile_of(st) * kTcBN;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + wm * 32 + mt * 16 + lane / 4 + (e >> 1) * 8;
            const int col = n0 + wn * 32 + nt * 8 + (lane % 4) * 2 + (e & 1);
            if (row >= m || col >= n) continue;
            const int64_t at = (int64_t)row * n + col;
            if (y_in != nullptr) acc[mt][nt][e] += y_in[at];
            if (out_f32) yf[at] = acc[mt][nt][e];
          }
      if (out_f32) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        continue;
      }
    }
    // the tile is done: round to bf16, stage, 16-byte stores
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = wm * 32 + mt * 16 + lane / 4;
        const int col = wn * 32 + nt * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(ys + row * L::YLD + col) =
            tc::pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint32_t*>(ys + (row + 8) * L::YLD + col) =
            tc::pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
    __syncthreads();
    const int n0 = tile_of(st) * kTcBN;
    if (y_vec) {
      for (int i = tid; i < kTcBM * (kTcBN / 8); i += kTcThreads) {
        const int rr = i / (kTcBN / 8), c = (i % (kTcBN / 8)) * 8;
        if (row0 + rr < m && n0 + c < n)
          *reinterpret_cast<uint4*>(yb + (int64_t)(row0 + rr) * n + n0 + c) =
              *reinterpret_cast<const uint4*>(ys + rr * L::YLD + c);
      }
    } else {
      for (int i = tid; i < kTcBM * kTcBN; i += kTcThreads) {
        const int rr = i / kTcBN, c = i % kTcBN;
        if (row0 + rr < m && n0 + c < n) yb[(int64_t)(row0 + rr) * n + n0 + c] = ys[rr * L::YLD + c];
      }
    }
  }
  tc::cp_async_wait<0>();
}

template <int RC>
int launch_f32(const void* x, const void* a, const void* b, void* y, const float* y_in, int m,
               int k, int r, int lda, int n, int rank_pad, int splits, int per, int smem_bytes,
               cudaStream_t stream) {
  constexpr size_t smem = shared_bytes<RC>();
  if (rank_pad != RC * 16 || smem_bytes != (int)smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lowrank_fused_kernel<float, RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kBM - 1) / kBM, splits);
  lowrank_fused_kernel<float, RC><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), y_in, m, k, r, lda, n, per);
  return (int)cudaGetLastError();
}

template <int RC, bool CHAIN>
int launch_bf16(const void* x, const void* a, const void* b, void* y, const float* y_in,
                int out_f32, int m, int k, int r, int lda, int n, int splits, int per,
                int smem_bytes, cudaStream_t stream) {
  constexpr int smem = TcLayout<RC>::kBytes;
  if (smem_bytes != smem || splits > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lowrank_fused_mma_kernel<RC, CHAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the splits of a row tile are one cluster
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + kTcBM - 1) / kTcBM, splits);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lowrank_fused_mma_kernel<RC, CHAIN>,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(a),
                           static_cast<const __nv_bfloat16*>(b), y, y_in, out_f32, m, k, r, lda,
                           n, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* x, const void* a, const void* b, void* y, const float* y_in,
                  int out_f32, int m, int k, int r, int lda, int n, int rank_pad, int splits,
                  int per, int smem_bytes, cudaStream_t s) {
  if (y_in != nullptr || out_f32) {  // a chunk of a rank above 256: padded to 256
    if (rank_pad != 32 * 8) return (int)cudaErrorInvalidValue;
    return launch_bf16<8, true>(x, a, b, y, y_in, out_f32, m, k, r, lda, n, splits, per,
                                smem_bytes, s);
  }
  if (lda != r) return (int)cudaErrorInvalidValue;  // only a chunk reads a column slice
  switch (rank_pad) {
#define GRASP_RC(RC)                                                                          \
  case 32 * RC:                                                                               \
    return launch_bf16<RC, false>(x, a, b, y, y_in, out_f32, m, k, r, lda, n, splits, per,     \
                                  smem_bytes, s);
    GRASP_RC(1) GRASP_RC(2) GRASP_RC(3) GRASP_RC(4) GRASP_RC(5) GRASP_RC(6) GRASP_RC(7) GRASP_RC(8)
#undef GRASP_RC
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_f32(const void* x, const void* a, const void* b, void* y, const float* y_in, int m,
                 int k, int r, int lda, int n, int rank_pad, int splits, int per, int smem_bytes,
                 cudaStream_t s) {
  switch (rank_pad) {
#define GRASP_RC(RC)                                                                          \
  case 16 * RC:                                                                               \
    return launch_f32<RC>(x, a, b, y, y_in, m, k, r, lda, n, rank_pad, splits, per, smem_bytes, \
                          s);
    GRASP_RC(2) GRASP_RC(4) GRASP_RC(8) GRASP_RC(12) GRASP_RC(16)
#undef GRASP_RC
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [m, k], a [k, r] with row stride lda (a column slice of a wider A), b [r,
// n] -> y [m, n], contiguous, dtype 0 = float32 (lowrank_fused_kernel), 1 =
// bfloat16 (lowrank_fused_mma_kernel). rank_pad, splits, tiles_per_split and
// smem_bytes are the plan of ops/lowrank.py::lowrank_plan. Ranks above 256
// run as chunks of at most 256, one launch each, chained through an fp32 sum:
// y_in (may be null) holds the sum of the earlier chunks and is added before
// the output is written; out_f32 (bf16 only) writes that fp32 sum to y in
// place of the bf16 output. A chained bf16 chunk takes the plan of 256 ranks;
// an unchained bf16 call needs lda == r. Returns 0 or a cudaError_t code;
// r > 256, or a plan that does not cover every output tile exactly once, is
// invalid.
extern "C" int grasp_lowrank_fused(const void* x, const void* a, const void* b, void* y,
                                   const void* y_in, int m, int k, int r, int lda, int n,
                                   int dtype, int out_f32, int rank_pad, int splits,
                                   int tiles_per_split, int smem_bytes, void* stream) {
  if (m <= 0 || k <= 0 || r <= 0 || n <= 0 || r > kMaxRank || lda < r || rank_pad < r ||
      splits <= 0 || splits > 65535 || tiles_per_split <= 0 || (out_f32 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + kBN - 1) / kBN;  // both bodies have 128-column tiles
  if ((int64_t)splits * tiles_per_split < n_tiles || (splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* acc = static_cast<const float*>(y_in);
  if (dtype == 0)
    return dispatch_f32(x, a, b, y, acc, m, k, r, lda, n, rank_pad, splits, tiles_per_split,
                        smem_bytes, s);
  if (dtype == 1)
    return dispatch_bf16(x, a, b, y, acc, out_f32, m, k, r, lda, n, rank_pad, splits,
                         tiles_per_split, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
