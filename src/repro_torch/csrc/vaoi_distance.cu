// Fused fleet-wide VAoI proxy for Hopper (sm_90a):
//     m_i      = || v_i - h_i ||_2                      (Eq. 5)
//     age_i'   = (age_i + [m_i >= mu]) * (1 - q_i)      (Eq. 7)
//
// Replaces the Pallas TPU kernel src/repro/kernels/vaoi_distance.py
// (vaoi_distance, body _make_kernel).  That kernel walks F in blocks on a
// sequential grid axis with a VMEM accumulator; here one warp owns one
// client row, its 32 lanes stride over F with an fp32 accumulator, and a
// warp-shuffle reduce replaces the cross-block accumulator.  Any N and F,
// no padding.  The work is 2*N*F*elt + 16*N bytes (at the main path's
// (100, 10) about 9.6 KB), so the launch, not memory, bounds it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kThreads = 256;  // 8 warps, i.e. 8 clients, per block

template <typename T>
__global__ void vaoi_distance_kernel(const T* __restrict__ v, const T* __restrict__ h,
                                     const float* __restrict__ age, const float* __restrict__ q,
                                     float mu, int n, int f,
                                     float* __restrict__ m_out, float* __restrict__ age_out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp: all 32 lanes leave together
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
    const float a = age[row];
    m_out[row] = m;
    age_out[row] = (m >= mu ? a + 1.f : a) * (1.f - q[row]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vaoi_distance_launch(const void* v, const void* h, const void* age, const void* q,
                                    float mu, int n, int f, int is_bf16,
                                    void* m_out, void* age_out, void* stream) {
  if (n <= 0) return 0;
  const int rows_per_block = kThreads / 32;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    vaoi_distance_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(h),
        static_cast<const float*>(age), static_cast<const float*>(q), mu, n, f,
        static_cast<float*>(m_out), static_cast<float*>(age_out));
  } else {
    vaoi_distance_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(v), static_cast<const float*>(h),
        static_cast<const float*>(age), static_cast<const float*>(q), mu, n, f,
        static_cast<float*>(m_out), static_cast<float*>(age_out));
  }
  return static_cast<int>(cudaGetLastError());
}
