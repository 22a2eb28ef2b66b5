// Fused fleet-wide VAoI proxy for Hopper (sm_90a):
//     m_i      = || v_i - h_i ||_2                      (Eq. 5)
//     age_i'   = (age_i + [m_i >= mu]) * (1 - q_i)      (Eq. 7)
//
// Replaces the Pallas TPU kernel src/repro/kernels/vaoi_distance.py
// (vaoi_distance, body _make_kernel).  That kernel walks F in blocks on a
// sequential grid axis with a VMEM accumulator.  Here a loop inside the
// thread or warp replaces that axis, any N and F, no padding.  The work is
// 2*N*F*elt + 16*N bytes (at the main path's (100, 10) about 9.6 KB, 0.003
// us at 3.35 TB/s), so the launch, not memory, bounds it: vaoi_empty_launch
// launches an empty kernel on the same grid through the same C interface,
// and its time is the floor this kernel is judged against.  What a launch
// adds to that floor is memory latency, so a row's age and q are loaded
// with its first values, not after the sum:
//   F <= 32: one thread per client row, F sequential fmaf in fp32, the loop
//            unrolled by 8 (a warp per row would leave 32 - F lanes idle:
//            22 at the main path's F).  On an H100 at (100, 10) this beat
//            the warp route; unrolling all 32 loads under predicates, or
//            staging the block's rows through shared memory, was slower.
//   F >  32: one warp per client row, lanes striding over F, a warp-shuffle
//            reduce in place of the TPU's cross-block accumulator.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kThreads = 256;  // warp route: 8 warps, i.e. 8 clients, per block
constexpr int kRowThreads = 128;  // thread route: 128 clients per block
constexpr int kMaxRowF = 32;

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

template <typename T>
__global__ void vaoi_distance_kernel(const T* __restrict__ v, const T* __restrict__ h,
                                     const float* __restrict__ age, const float* __restrict__ q,
                                     float mu, int n, int f,
                                     float* __restrict__ m_out, float* __restrict__ age_out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp: all 32 lanes leave together
  const float a = lane == 0 ? age[row] : 0.f, qr = lane == 0 ? q[row] : 0.f;
  const T* vr = v + static_cast<size_t>(row) * f;
  const T* hr = h + static_cast<size_t>(row) * f;
  float acc = 0.f;
  for (int j = lane; j < f; j += 32) {
    const float d = to_f32(vr[j]) - to_f32(hr[j]);
    acc = fmaf(d, d, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float m = sqrtf(acc);
    m_out[row] = m;
    age_out[row] = update_age(m, mu, a, qr);
  }
}

// The launch floor: the same grid, no work.
__global__ void vaoi_empty_kernel() {}

// The route's grid: (blocks, threads per block).
dim3 grid_of(int n, int f, int* threads) {
  if (f <= kMaxRowF) {
    *threads = kRowThreads;
    return dim3((n + kRowThreads - 1) / kRowThreads);
  }
  *threads = kThreads;
  return dim3((n + kThreads / 32 - 1) / (kThreads / 32));
}

template <typename T>
void launch(const void* v, const void* h, const void* age, const void* q, float mu, int n, int f, void* m_out,
            void* age_out, cudaStream_t s) {
  int threads;
  const dim3 grid = grid_of(n, f, &threads);
  auto* kernel = f <= kMaxRowF ? vaoi_distance_row_kernel<T> : vaoi_distance_kernel<T>;
  kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(v), static_cast<const T*>(h),
                                  static_cast<const float*>(age), static_cast<const float*>(q), mu, n, f,
                                  static_cast<float*>(m_out), static_cast<float*>(age_out));
}

}  // namespace

// The launchers' one parameter block, filled by the Python wrapper with
// struct.pack("7Qf3i") (native alignment): one pointer to convert per call
// in place of eleven arguments.
struct VaoiArgs {
  const void* v;
  const void* h;
  const void* age;
  const void* q;
  void* m_out;
  void* age_out;
  void* stream;
  float mu;
  int n, f, is_bf16;
};
static_assert(sizeof(VaoiArgs) == 72, "VaoiArgs must match the wrapper's struct.pack layout");

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vaoi_distance_launch(const VaoiArgs* a) {
  if (a->n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  if (a->is_bf16) {
    launch<__nv_bfloat16>(a->v, a->h, a->age, a->q, a->mu, a->n, a->f, a->m_out, a->age_out, s);
  } else {
    launch<float>(a->v, a->h, a->age, a->q, a->mu, a->n, a->f, a->m_out, a->age_out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// vaoi_distance_launch's interface and grid with an empty kernel: the least
// time a launch of this shape takes.  Returns cudaGetLastError().
extern "C" int vaoi_empty_launch(const VaoiArgs* a) {
  if (a->n <= 0) return 0;
  int threads;
  const dim3 grid = grid_of(a->n, a->f, &threads);
  vaoi_empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(a->stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
