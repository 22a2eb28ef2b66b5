// Fused fleet-wide VAoI proxy for Hopper (sm_90a):
//     m_i      = || v_i - h_i ||_2                      (Eq. 5)
//     age_i'   = (age_i + [m_i >= mu]) * (1 - q_i)      (Eq. 7)
//
// Replaces the Pallas TPU kernel src/repro/kernels/vaoi_distance.py
// (vaoi_distance, body _make_kernel).  That kernel walks F in blocks on a
// sequential grid axis with a VMEM accumulator.  Here loops inside threads
// replace that axis, and a reduction across threads (and, for a long row,
// across the blocks of one cluster) replaces the accumulator; any N and F,
// no padding.  The work is 2*N*F*elt + 16*N bytes over 3.35 TB/s, or one
// launch, whichever is longer: vaoi_empty_launch launches an empty kernel
// on the same grid and cluster shape through the same C interface, and its
// time is the launch's floor.  A row's age and q are loaded with its first
// values, not after the sum.  The route follows from F; the Python wrapper
// chooses a long row's segment count S (split_plan in
// kernels/vaoi_distance.py) and passes it in VaoiArgs, and the launcher
// derives the grid from n and S:
//   thread  (F <= 32): one thread per client row, F sequential fmaf in
//           fp32, unrolled by 8, 128 rows a block.  The launch bounds it
//           (the main path's (100, 10) moves 9.6 KB); a warp per row would
//           leave 32 - F lanes idle (measured faster than a warp a row,
//           than full unrolling and than staging rows through shared
//           memory).
//   cluster (F > 32; an LM's vocabulary-wide features): each row cut into
//           S in {1, 2, 4, 8, 16} segments, one 256-thread block a
//           segment, the S blocks of a row one thread-block cluster.  One
//           warp a row used to leave the card idle at the LM shapes: at
//           (8, 151936) its grid was one block, one SM of 132, pulling
//           9.7 MB at ~67 GB/s, with one 4-byte load of each tensor in
//           flight a lane.  Now a few rows spread over up to half the SMs
//           (split_plan: more, smaller clusters measured slower), every
//           thread keeps kUnroll 16-byte loads of v and of h in flight,
//           and a block adds its segment (warp shuffles, then shared
//           memory) and writes the partial into rank 0's shared memory
//           through distributed shared memory.  After the cluster barrier
//           rank 0 adds the S partials in rank order, so a row's sum is
//           the same bit for bit from run to run with no scratch memory
//           and no float atomics.  Many rows take S = 1: n blocks, one a
//           row, no cluster.
// A 16-byte load needs a 16-byte-aligned address: a row starts aligned only
// when its base does and F*elt % 16 == 0.  So every segment takes a scalar
// head up to v's first 16-byte boundary, a vector body and a scalar tail,
// and the segment boundaries after the first lie on v's 16-byte
// boundaries.  Where v and h sit at different offsets from 16 bytes (a view
// into one of them), the segments are read by scalar loads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kMaxRowF = 32;          // the thread route's largest F (MAX_ROW_F in the wrapper)
constexpr int kRowThreads = 128;      // thread route: 128 rows a block
constexpr int kClusterThreads = 256;  // cluster route: one block a segment (CLUSTER_THREADS in the wrapper)
constexpr int kMaxSegments = 16;      // a non-portable cluster size on sm_90
constexpr int kUnroll = 4;            // 16-byte loads of v, and of h, in flight a thread
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float update_age(float m, float mu, float a, float q) {
  return (m >= mu ? a + 1.f : a) * (1.f - q);
}

template <typename T>
__global__ void vaoi_distance_row_kernel(const T* __restrict__ v, const T* __restrict__ h,
                                         const float* __restrict__ age, const float* __restrict__ q,
                                         float mu, int n, int f,
                                         float* __restrict__ m_out, float* __restrict__ age_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float a = age[row], qr = q[row];
  const T* vr = v + static_cast<size_t>(row) * f;
  const T* hr = h + static_cast<size_t>(row) * f;
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < f; ++j) {
    const float d = to_f32(vr[j]) - to_f32(hr[j]);
    acc = fmaf(d, d, acc);
  }
  const float m = sqrtf(acc);
  m_out[row] = m;
  age_out[row] = update_age(m, mu, a, qr);
}

// Elements of T from p to the next 16-byte boundary (0 if p lies on one).
template <typename T>
__device__ __forceinline__ int head_of(const T* p) {
  return static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / sizeof(T));
}

// acc + the squared differences of the 16 bytes a of v and b of h, in element order.
__device__ __forceinline__ float add_sq16(uint4 a, uint4 b, float acc, float) {
  const float d0 = __uint_as_float(a.x) - __uint_as_float(b.x), d1 = __uint_as_float(a.y) - __uint_as_float(b.y);
  const float d2 = __uint_as_float(a.z) - __uint_as_float(b.z), d3 = __uint_as_float(a.w) - __uint_as_float(b.w);
  return fmaf(d3, d3, fmaf(d2, d2, fmaf(d1, d1, fmaf(d0, d0, acc))));
}

__device__ __forceinline__ float add_sq_pair(uint32_t a, uint32_t b, float acc) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const float d0 = x.x - y.x, d1 = x.y - y.y;
  return fmaf(d1, d1, fmaf(d0, d0, acc));
}

__device__ __forceinline__ float add_sq16(uint4 a, uint4 b, float acc, __nv_bfloat16) {
  return add_sq_pair(a.w, b.w, add_sq_pair(a.z, b.z, add_sq_pair(a.y, b.y, add_sq_pair(a.x, b.x, acc))));
}

// Thread t of nt's share of sum (v_j - h_j)^2 over j in [lo, hi) of one
// row: the scalar head up to v's first 16-byte boundary, 16-byte vectors
// kUnroll at a time, the scalar tail.  `vec` false (v and h at different
// offsets from 16 bytes): all of [lo, hi) by scalar loads.
template <typename T>
__device__ __forceinline__ float span_sum(const T* __restrict__ vr, const T* __restrict__ hr, int lo, int hi,
                                          int t, int nt, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int vlo = vec ? min(hi, lo + head_of(vr + lo)) : lo;
  const int nvec = vec ? (hi - vlo) / kVec : 0;
  const int vhi = vlo + nvec * kVec;
  float acc = 0.f;
  for (int j = lo + t; j < vlo; j += nt) {
    const float d = to_f32(vr[j]) - to_f32(hr[j]);
    acc = fmaf(d, d, acc);
  }
  const uint4* v4 = reinterpret_cast<const uint4*>(vr + vlo);
  const uint4* h4 = reinterpret_cast<const uint4*>(hr + vlo);
  int k = t;
  for (; k + (kUnroll - 1) * nt < nvec; k += kUnroll * nt) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(v4 + k + u * nt);
      b[u] = __ldg(h4 + k + u * nt);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = add_sq16(a[u], b[u], acc, T());
  }
  for (; k < nvec; k += nt) acc = add_sq16(__ldg(v4 + k), __ldg(h4 + k), acc, T());
#pragma unroll 4
  for (int j = vhi + t; j < hi; j += nt) {
    const float d = to_f32(vr[j]) - to_f32(hr[j]);
    acc = fmaf(d, d, acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

// The block's sum of acc, in thread 0: each warp's by shuffles, then the
// warps' in order.  Deterministic.
__device__ __forceinline__ float block_sum(float acc, float* warp_sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) acc = warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f);
  return acc;
}

// Grid: n * segments blocks of kClusterThreads, clusters of `segments` (one
// cluster a row).  The launch bounds cap a thread at 64 registers (four
// blocks an SM); at that cap ptxas keeps all kUnroll loads of v and of h in
// flight, without it two.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 4)
    vaoi_distance_cluster_kernel(const T* __restrict__ v, const T* __restrict__ h, const float* __restrict__ age,
                                 const float* __restrict__ q, float mu, int n, int f, int segments, bool vec,
                                 float* __restrict__ m_out, float* __restrict__ age_out) {
  __shared__ float warp_sums[32];
  __shared__ float partials[kMaxSegments];  // rank 0's: one a segment of its row
  const bool split = segments > 1;          // uniform over the grid
  // arrive now, wait before writing into rank 0: every block of the cluster
  // has then started, and the barrier's latency hides behind the sum
  if (split) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = blockIdx.x % segments;
  const int row = blockIdx.x / segments;
  const bool lead = rank == 0 && threadIdx.x == 0;
  const float a = lead ? age[row] : 0.f, qr = lead ? q[row] : 0.f;
  const size_t base = static_cast<size_t>(row) * f;
  const T* vr = v + base;
  // segment r: [head + r*seg, head + (r+1)*seg) clamped to the row, the first
  // from 0 and the last to f; seg is a whole number of 16-byte vectors
  constexpr int kVec = 16 / sizeof(T);
  const long long seg = kVec * (((f + kVec - 1LL) / kVec + segments - 1) / segments);
  const long long head = vec ? head_of(vr) : 0;
  const int lo = rank == 0 ? 0 : static_cast<int>(min(static_cast<long long>(f), head + rank * seg));
  const int hi =
      rank == segments - 1 ? f : static_cast<int>(min(static_cast<long long>(f), head + (rank + 1) * seg));
  float acc = block_sum(span_sum(vr, h + base, lo, hi, threadIdx.x, blockDim.x, vec), warp_sums);
  if (split) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) cluster.map_shared_rank(partials, 0)[rank] = acc;
    cluster.sync();  // the partials are in rank 0's shared memory
    if (!lead) return;
    acc = 0.f;
    for (int r = 0; r < segments; ++r) acc += partials[r];
  }
  if (lead) {
    const float m = sqrtf(acc);
    m_out[row] = m;
    age_out[row] = update_age(m, mu, a, qr);
  }
}

// The launch floor: the same grid and cluster shape, no work.
__global__ void vaoi_empty_kernel() {}

}  // namespace

// The launchers' one parameter block, filled by the Python wrapper with
// struct.pack("7Qf4i") (native alignment, the 76 bytes up to the padding):
// one pointer to convert per call in place of twelve arguments.  segments
// is the wrapper's split_plan.
struct VaoiArgs {
  const void* v;
  const void* h;
  const void* age;
  const void* q;
  void* m_out;
  void* age_out;
  void* stream;
  float mu;
  int n, f, is_bf16, segments;
};
static_assert(offsetof(VaoiArgs, segments) + sizeof(int) == 76, "VaoiArgs must match the wrapper's struct.pack layout");

namespace {

// Whether the kernels take the segment count: a cluster size of sm_90, 1 on
// the thread route.
bool plan_ok(const VaoiArgs* a) {
  const int s = a->segments;
  return (s == 1 || s == 2 || s == 4 || s == 8 || s == 16) && (s == 1 || a->f > kMaxRowF);
}

// Cluster sizes above 8 need the kernel's leave, once per device.
cudaError_t allow_large_clusters() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  for (const void* k : {reinterpret_cast<const void*>(vaoi_distance_cluster_kernel<float>),
                        reinterpret_cast<const void*>(vaoi_distance_cluster_kernel<__nv_bfloat16>),
                        reinterpret_cast<const void*>(vaoi_empty_kernel)}) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

// Launch `kernel` on the route's grid: thread route ceil(n / 128) blocks of
// kRowThreads; cluster route n * segments blocks of kClusterThreads, as
// clusters of `segments` where that is > 1 (cudaLaunchKernelEx), else by
// the plain launch.
template <typename... Params, typename... Args>
cudaError_t launch_on_plan(const VaoiArgs* a, void (*kernel)(Params...), Args... args) {
  const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  if (a->f <= kMaxRowF) {
    kernel<<<(a->n + kRowThreads - 1) / kRowThreads, kRowThreads, 0, stream>>>(args...);
    return cudaSuccess;
  }
  const unsigned blocks = static_cast<unsigned>(a->n) * static_cast<unsigned>(a->segments);
  if (a->segments == 1) {
    kernel<<<blocks, kClusterThreads, 0, stream>>>(args...);
    return cudaSuccess;
  }
  if (a->segments > 8) {
    const cudaError_t e = allow_large_clusters();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a->segments;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t launch(const VaoiArgs* a) {
  const T* v = static_cast<const T*>(a->v);
  const T* h = static_cast<const T*>(a->h);
  const float* age = static_cast<const float*>(a->age);
  const float* q = static_cast<const float*>(a->q);
  float* m_out = static_cast<float*>(a->m_out);
  float* age_out = static_cast<float*>(a->age_out);
  if (a->f <= kMaxRowF)
    return launch_on_plan(a, vaoi_distance_row_kernel<T>, v, h, age, q, a->mu, a->n, a->f, m_out, age_out);
  const bool vec = ((reinterpret_cast<uintptr_t>(v) ^ reinterpret_cast<uintptr_t>(h)) & 15u) == 0;
  return launch_on_plan(a, vaoi_distance_cluster_kernel<T>, v, h, age, q, a->mu, a->n, a->f, a->segments, vec,
                        m_out, age_out);
}

// A launch's own error, else cudaGetLastError(); either way the error state is cleared.
int result_of(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

// Returns the launch's error (0 on success; cudaErrorInvalidValue for a
// segment count the kernels do not take).  Nothing falls back: a refused launch is an error.
extern "C" int vaoi_distance_launch(const VaoiArgs* a) {
  if (a->n <= 0) return 0;
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  return result_of(a->is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a));
}

// vaoi_distance_launch's interface, plan, grid and cluster shape with an
// empty kernel: the least time a launch of this shape takes.
extern "C" int vaoi_empty_launch(const VaoiArgs* a) {
  if (a->n <= 0) return 0;
  if (!plan_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  return result_of(launch_on_plan(a, vaoi_empty_kernel));
}
