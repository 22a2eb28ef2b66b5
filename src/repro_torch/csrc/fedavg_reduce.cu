// Weighted FedAvg reduce over a table of client leaves, for Hopper (sm_90a):
//     out[off_j + c] = sum_g sum_k w_g[k] * leaf_gj[k, c]     (fp32 accumulate)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py
// (fedavg_reduce, body _kernel), out[p] = sum_k w[k] * msgs[k, p].  The TPU
// kernel reads one (K, P) matrix, which the caller first concatenates from
// the model's leaves; it tiles (BK, BP) through VMEM with K as a sequential
// grid axis and a scratch accumulator.  Here the function is the same, but
// the kernel reads the leaves where they lie: a by-value table names, for
// each of one or two row groups (the compacted path's k-slab and its
// N-wide old-carrier stack), leaf j's (K_g, cols_j) rows, and leaf j fills
// columns [off_j, off_j + cols_j) of the (P,) output.  Both groups go in
// one launch, each with its own fp32 accumulator walked in ascending k with
// fmaf, and out = acc_0 + acc_1: the rounding of the reference's
// fedavg_reduce(slab) + fedavg_reduce(old) (src/repro/core/simulator.py).
//
// Bound: pure bandwidth, sum_g K_g * P * elt + 4 * sum_g K_g + 4 * P bytes
// against 2 * sum_g K_g * P flops.  Design for that: every thread owns 4
// consecutive columns of one leaf and reads them with one 16-byte (fp32) or
// 8-byte (bf16) load per row, issuing kUnroll = 4 rows' loads before their
// FMAs.  Blocks are small (64 threads, one (leaf, 256-column tile) each,
// found from prefix sums in the table) and the register budget is capped at
// 32, so all of the main path's ~3,300 blocks are resident at once (32 per
// SM) and no second wave trails behind: with 256-thread blocks and 8 rows
// in flight a thread needs 40 registers, 6 blocks fit an SM, and the main
// path's blocks take a second wave; 8 bf16 columns a thread do not fit in
// 32 registers either.  Rows of a
// leaf are aligned for the wide load only when cols_j is a multiple of 4,
// so vector or scalar loads are decided per leaf: a leaf whose rows are not
// aligned (the fc bias of 10 columns) is read with coalesced scalar loads.
// Zero-weight rows are read like any other: 0 * Inf must stay NaN, as in
// the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;
constexpr int kMinBlocks = 32;  // blocks per SM the register budget must allow (2048 threads)
constexpr int kUnroll = 4;      // rows whose loads are in flight together
constexpr int kCols = 4;        // columns per thread
constexpr int kTile = kThreads * kCols;
constexpr int kMaxGroups = 2;
constexpr int kMaxLeaves = 32;

// Passed by value (about 1 KB of the 4 KB kernel-parameter space).
struct LeafTable {
  const void* leaf[kMaxGroups][kMaxLeaves];  // group g's (K_g, cols_j) rows of leaf j
  const float* w[kMaxGroups];                // group g's (K_g,) weights
  int rows[kMaxGroups];                      // K_g
  int cols[kMaxLeaves];
  int off[kMaxLeaves];                       // leaf j's first output column
  int first_tile[kMaxLeaves + 1];            // leaf j owns blocks [first_tile[j], first_tile[j + 1])
  unsigned char vec[kMaxLeaves];             // wide loads for leaf j (all groups)
  int n_groups;
};

// 4 columns of one row in one load: 16 bytes of fp32, 8 of bf16 (raw bits).
template <bool kBf16>
using Wide = std::conditional_t<kBf16, uint2, uint4>;

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }  // bf16 -> fp32 is exact
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void fma4(float w, uint4 x, float (&acc)[kCols]) {
  acc[0] = fmaf(w, __uint_as_float(x.x), acc[0]);
  acc[1] = fmaf(w, __uint_as_float(x.y), acc[1]);
  acc[2] = fmaf(w, __uint_as_float(x.z), acc[2]);
  acc[3] = fmaf(w, __uint_as_float(x.w), acc[3]);
}

__device__ __forceinline__ void fma4(float w, uint2 x, float (&acc)[kCols]) {  // element 0 in x.x's low half
  acc[0] = fmaf(w, bf16_lo(x.x), acc[0]);
  acc[1] = fmaf(w, bf16_hi(x.x), acc[1]);
  acc[2] = fmaf(w, bf16_lo(x.y), acc[2]);
  acc[3] = fmaf(w, bf16_hi(x.y), acc[3]);
}

template <bool kBf16>
__device__ __forceinline__ float load_scalar(const void* base, size_t i) {
  if constexpr (kBf16) {
    return bf16_lo(__ldg(static_cast<const unsigned short*>(base) + i));
  } else {
    return __ldg(static_cast<const float*>(base) + i);
  }
}

// acc = sum_r w[r] * rows[r, c0 .. c0 + 4), r ascending, one wide load per row.
template <bool kBf16>
__device__ __forceinline__ void reduce_wide(const void* base, int cols, int rows, const float* __restrict__ w,
                                            int c0, float (&acc)[kCols]) {
  using W = Wide<kBf16>;
  const W* p = static_cast<const W*>(base) + c0 / kCols;
  const size_t stride = static_cast<size_t>(cols / kCols);  // in W units
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  int r = 0;
  for (; r + kUnroll <= rows; r += kUnroll) {
    W x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(p + (r + u) * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fma4(__ldg(w + r + u), x[u], acc);
  }
  for (; r < rows; ++r) fma4(__ldg(w + r), __ldg(p + r * stride), acc);
}

// The same for the 4 columns c0 + i * kThreads (coalesced scalar loads), those < cols.
template <bool kBf16>
__device__ __forceinline__ void reduce_scalar(const void* base, int cols, int rows, const float* __restrict__ w,
                                              int c0, float (&acc)[kCols]) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float wr = __ldg(w + r);
    const size_t row = static_cast<size_t>(r) * cols;
    float x[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = c0 + i * kThreads;
      x[i] = c < cols ? load_scalar<kBf16>(base, row + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = fmaf(wr, x[i], acc[i]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fedavg_leaves_kernel(const __grid_constant__ LeafTable t, float* __restrict__ out) {
  int j = 0;
  while (static_cast<int>(blockIdx.x) >= t.first_tile[j + 1]) ++j;  // uniform over the block
  const int cols = t.cols[j];
  const int tile0 = (static_cast<int>(blockIdx.x) - t.first_tile[j]) * kTile;
  float* o = out + t.off[j];
  float res[kCols], acc[kCols];
  if (t.vec[j]) {
    const int c0 = tile0 + threadIdx.x * kCols;
    if (c0 >= cols) return;  // cols is a multiple of 4: a thread's columns are all in or all out
    for (int g = 0; g < t.n_groups; ++g) {
      reduce_wide<kBf16>(t.leaf[g][j], cols, t.rows[g], t.w[g], c0, acc);
#pragma unroll
      for (int i = 0; i < kCols; ++i) res[i] = g == 0 ? acc[i] : res[i] + acc[i];
    }
    if ((t.off[j] & 3) == 0) {  // 16-byte aligned output
      *reinterpret_cast<float4*>(o + c0) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) o[c0 + i] = res[i];
    }
  } else {
    const int c0 = tile0 + threadIdx.x;
    if (c0 >= cols) return;
    for (int g = 0; g < t.n_groups; ++g) {
      reduce_scalar<kBf16>(t.leaf[g][j], cols, t.rows[g], t.w[g], c0, acc);
#pragma unroll
      for (int i = 0; i < kCols; ++i) res[i] = g == 0 ? acc[i] : res[i] + acc[i];
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (c0 + i * kThreads < cols) o[c0 + i * kThreads] = res[i];
    }
  }
}

}  // namespace

// leaves[g * n_leaves + j]: group g's rows of leaf j; weights[g]: its (rows[g],)
// fp32 weights; cols[j]: leaf j's columns.  Leaf j fills out[off_j .. off_j +
// cols[j]) with off_j = cols[0] + ... + cols[j - 1].  Returns
// cudaGetLastError() after the launch (0 on success; cudaErrorInvalidValue
// for a table the kernel does not take).
extern "C" int fedavg_leaves_launch(int n_groups, int n_leaves, const void* const* leaves,
                                    const void* const* weights, const int* rows, const int* cols, int is_bf16,
                                    void* out, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = is_bf16 ? 8 : 16;  // the wide load's bytes
  LeafTable t{};
  t.n_groups = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    t.w[g] = static_cast<const float*>(weights[g]);
    t.rows[g] = rows[g];
  }
  int off = 0, tiles = 0;
  for (int j = 0; j < n_leaves; ++j) {
    t.cols[j] = cols[j];
    t.off[j] = off;
    t.first_tile[j] = tiles;
    bool aligned = cols[j] % kCols == 0;
    for (int g = 0; g < n_groups; ++g) {
      t.leaf[g][j] = leaves[g * n_leaves + j];
      aligned = aligned && reinterpret_cast<uintptr_t>(t.leaf[g][j]) % align == 0;
    }
    t.vec[j] = aligned;
    off += cols[j];
    tiles += (cols[j] + kTile - 1) / kTile;
  }
  for (int j = n_leaves; j <= kMaxLeaves; ++j) t.first_tile[j] = tiles;
  if (tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fedavg_leaves_kernel<true><<<tiles, kThreads, 0, s>>>(t, static_cast<float*>(out));
  } else {
    fedavg_leaves_kernel<false><<<tiles, kThreads, 0, s>>>(t, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
