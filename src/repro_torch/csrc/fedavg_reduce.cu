// Weighted FedAvg column reduce for Hopper (sm_90a):
//     out[p] = sum_k w[k] * msgs[k, p]     (fp32 accumulate)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py
// (fedavg_reduce, body _kernel).  That kernel tiles (BK, BP) through VMEM
// with K as a sequential grid axis and a scratch accumulator; here one
// thread owns one output column and loops over all K rows itself, so no
// sum crosses blocks.  Neighbouring threads read neighbouring columns, so
// every row's load is coalesced.  Any K and P, fp32 or bf16 messages, no
// rounding of K up to 8 (that was the TPU's sublane layout).  Pure
// bandwidth: K*P*elt + 4*K + 4*P bytes against 2*K*P flops.  Zero-weight
// rows are read like any other (0 * Inf must stay NaN, as in the reference).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kThreads = 256;

template <typename T>
__global__ void fedavg_reduce_kernel(const T* __restrict__ msgs, const float* __restrict__ w,
                                     int k, int p, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= p) return;
  float acc = 0.f;
  for (int r = 0; r < k; ++r) {
    acc = fmaf(w[r], to_f32(msgs[static_cast<size_t>(r) * p + col]), acc);
  }
  out[col] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fedavg_reduce_launch(const void* msgs, const void* w, int k, int p, int is_bf16,
                                    void* out, void* stream) {
  if (p <= 0) return 0;
  const dim3 grid((p + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    fedavg_reduce_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(msgs), static_cast<const float*>(w), k, p,
        static_cast<float*>(out));
  } else {
    fedavg_reduce_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(msgs), static_cast<const float*>(w), k, p,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
