// Mamba2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _make_kernel).  Per (batch, head), over chunks of L rows in order,
// with a = dt*A and a_cum its inclusive cumsum inside the chunk:
//     y_i  = sum_{j<=i} (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j x_j      (intra-chunk)
//          + exp(a_cum_i) C_i . S                                      (inter-chunk)
//     S'   = S exp(a_cum_last) + sum_j dt_j exp(a_cum_last - a_cum_j) x_j^T B_j
// in fp32 from a zero state; the final S is the second output.
//
// The TPU kernel walks a (B, nh, S/L) grid and carries S in VMEM across the
// sequential chunk axis.  Blocks on Hopper run in no order, so here one
// thread block owns one (batch, head) and loops over the chunks itself: the
// (hp, ds) fp32 state stays in shared memory for the whole sequence.  Inside
// a chunk the block walks 64-row tiles; each of its 256 threads (a 16 x 16
// grid) keeps a register tile of 4 rows x (hp/16 or ds/16) columns, strided
// by 16 so that shared-memory reads are conflict-free.  a_cum comes from a
// block-wide warp-shuffle scan.  B and C are read from device memory tile by
// tile; all nh heads of a batch row read the same rows, so after the first
// head they come from L2.  Rows at or past S count as dt = 0, x = B = C = 0
// and are never written, which is exactly the Pallas kernel's zero padding
// without a padded copy.  Inputs are read through their strides (x, B and C
// may be slices of one projection), so nothing is copied first.
//
// Bound: operations.  At the prefill shape (B=4, S=2048, nh=64, hp=64,
// ds=128, L=256) the chunked form needs about 26 GFLOP of fp32 multiply-adds
// (C.B^T shared by the heads, causal triangles only) against 0.22 GB of
// traffic.  This first version runs on the fp32 FMA units, recomputes C.B^T
// per head, and with ~138 KB of shared memory fits one block per SM; tensor
// cores (TF32 or bf16 mma), TMA loads, a C.B^T shared across heads and
// chunk-parallel blocks are the later redesign.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // a 16 x 16 thread grid
constexpr int kT = 64;           // rows per tile
constexpr int kRT = kT / 16;     // register rows per thread
constexpr int kTP = kT + 16;     // score tile row stride: half-warps land on disjoint banks

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* state;
  int batch, seqlen, nheads, L;
  int64_t sx_b, sx_s, sx_h, sx_p;
  int64_t sdt_b, sdt_s, sdt_h;
  int64_t sb_b, sb_s, sb_n;
  int64_t sc_b, sc_s, sc_n;
};

__device__ __forceinline__ float load(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Shared-memory floats for one block (must match the carve-up in the kernel).
__host__ __device__ constexpr int64_t smem_floats(int hp, int ds, int L) {
  return int64_t(hp) * (ds + 1) + 2 * int64_t(kT) * (ds + 1) + int64_t(kT) * hp +
         int64_t(kT) * kTP + 2 * int64_t(L);
}

// Rows r0 .. r0+kT-1 of the chunk from a (B, S, DS) operand into dst
// (row stride DS+1); rows past the chunk or past S are zero.
template <int DS>
__device__ __forceinline__ void load_rows(float* dst, const void* src, int64_t sb, int64_t ss,
                                          int64_t sn, int b, int s0, int r0, int L, int S,
                                          bool bf16) {
  for (int idx = threadIdx.x; idx < kT * DS; idx += kThreads) {
    const int r = idx / DS, n = idx % DS, l = r0 + r, s = s0 + l;
    float v = 0.f;
    if (l < L && s < S) v = load(src, b * sb + s * ss + n * sn, bf16);
    dst[r * (DS + 1) + n] = v;
  }
}

// Rows r0 .. r0+kT-1 of x*dt for head h into dst (row stride HP), times
// exp(total - a_cum) when ``to_end`` (the decay to the chunk's end).
template <int HP>
__device__ __forceinline__ void load_xdt(float* dst, const Args& a, int b, int h, int s0, int r0,
                                         const float* dts, const float* acum, float total,
                                         bool to_end, bool bf16) {
  for (int idx = threadIdx.x; idx < kT * HP; idx += kThreads) {
    const int r = idx / HP, p = idx % HP, l = r0 + r, s = s0 + l;
    float v = 0.f;
    if (l < a.L && s < a.seqlen) {
      v = load(a.x, b * a.sx_b + s * a.sx_s + h * a.sx_h + p * a.sx_p, bf16) * dts[l];
      if (to_end) v *= expf(total - acum[l]);
    }
    dst[r * HP + p] = v;
  }
}

template <int RP, int RN>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a, const bool bf16) {
  constexpr int HP = 16 * RP, DS = 16 * RN, DSP = DS + 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int L = a.L, S = a.seqlen;

  extern __shared__ float smem[];
  float* st_sh = smem;               // HP x DSP: the running state S[p][n]
  float* c_sh = st_sh + HP * DSP;    // kT x DSP: C rows of the output tile
  float* b_sh = c_sh + kT * DSP;     // kT x DSP: B rows of the source tile
  float* x_sh = b_sh + kT * DSP;     // kT x HP:  x*dt rows of the source tile
  float* sc_sh = x_sh + kT * HP;     // kT x kTP: masked, decayed scores of a tile pair
  float* acum = sc_sh + kT * kTP;    // L: inclusive cumsum of dt*A over the chunk
  float* dts = acum + L;             // L: dt over the chunk (0 past S)
  __shared__ float warp_tot[kThreads / 32];

  const float Ah = a.A[h];
  for (int i = tid; i < HP * DSP; i += kThreads) st_sh[i] = 0.f;

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * L;

    // 1) dt and a_cum, kThreads rows at a time: warp scans, then warp totals
    float carry = 0.f;
    for (int base = 0; base < L; base += kThreads) {
      const int l = base + tid;
      float v = 0.f;
      if (l < L) {
        const int s = s0 + l;
        const float d = s < S ? a.dt[b * a.sdt_b + s * a.sdt_s + h * a.sdt_h] : 0.f;
        dts[l] = d;
        v = d * Ah;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      float before = carry, round_total = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) before += warp_tot[w];
        round_total += warp_tot[w];
      }
      if (l < L) acum[l] = v + before;
      carry += round_total;
      __syncthreads();  // acum complete; warp_tot free for the next round
    }
    const float total = acum[L - 1];

    // 2) y, one tile of kT output rows at a time
    for (int i0 = 0; i0 < L; i0 += kT) {
      load_rows<DS>(c_sh, a.Cm, a.sc_b, a.sc_s, a.sc_n, b, s0, i0, L, S, bf16);
      __syncthreads();

      // inter-chunk: acc[i][p] = exp(a_cum_i) * sum_n C[i][n] S[p][n]
      float acc[kRT][RP];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[kRT], sv[RP];
#pragma unroll
        for (int r = 0; r < kRT; ++r) cv[r] = c_sh[(ty + 16 * r) * DSP + n];
#pragma unroll
        for (int q = 0; q < RP; ++q) sv[q] = st_sh[(tx + 16 * q) * DSP + n];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < L ? expf(acum[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) acc[r][q] *= e;
      }

      // intra-chunk, source tiles j0 <= i0 (the causal triangle)
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        load_rows<DS>(b_sh, a.Bm, a.sb_b, a.sb_s, a.sb_n, b, s0, j0, L, S, bf16);
        load_xdt<HP>(x_sh, a, b, h, s0, j0, dts, acum, total, false, bf16);
        __syncthreads();

        float sc[kRT][kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int q = 0; q < kRT; ++q) sc[r][q] = 0.f;
#pragma unroll 4
        for (int n = 0; n < DS; ++n) {
          float cv[kRT], bv[kRT];
#pragma unroll
          for (int r = 0; r < kRT; ++r) cv[r] = c_sh[(ty + 16 * r) * DSP + n];
#pragma unroll
          for (int q = 0; q < kRT; ++q) bv[q] = b_sh[(tx + 16 * q) * DSP + n];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int q = 0; q < kRT; ++q) sc[r][q] = fmaf(cv[r], bv[q], sc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < kRT; ++q) {
            const int j = j0 + tx + 16 * q;
            float v = 0.f;
            if (j <= i && i < L) v = sc[r][q] * expf(acum[i] - acum[j]);
            sc_sh[(ty + 16 * r) * kTP + tx + 16 * q] = v;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float sv[kRT], xv[RP];
#pragma unroll
          for (int r = 0; r < kRT; ++r) sv[r] = sc_sh[(ty + 16 * r) * kTP + j];
#pragma unroll
          for (int q = 0; q < RP; ++q) xv[q] = x_sh[j * HP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < kRT; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
        }
        __syncthreads();  // b_sh, x_sh, sc_sh (and c_sh after the last pair) free
      }

#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int l = i0 + ty + 16 * r, s = s0 + l;
        if (l < L && s < S) {
          float* yrow = a.y + ((int64_t(b) * S + s) * a.nheads + h) * HP;
#pragma unroll
          for (int q = 0; q < RP; ++q) yrow[tx + 16 * q] = acc[r][q];
        }
      }
    }

    // 3) state: S = S exp(total) + sum_j (dt_j exp(total - a_cum_j) x_j)^T B_j
    float sacc[RP][RN];
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int k = 0; k < RN; ++k) sacc[q][k] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kT) {
      load_rows<DS>(b_sh, a.Bm, a.sb_b, a.sb_s, a.sb_n, b, s0, j0, L, S, bf16);
      load_xdt<HP>(x_sh, a, b, h, s0, j0, dts, acum, total, true, bf16);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float xv[RP], bv[RN];
#pragma unroll
        for (int q = 0; q < RP; ++q) xv[q] = x_sh[j * HP + ty + 16 * q];
#pragma unroll
        for (int k = 0; k < RN; ++k) bv[k] = b_sh[j * DSP + tx + 16 * k];
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int k = 0; k < RN; ++k) sacc[q][k] = fmaf(xv[q], bv[k], sacc[q][k]);
      }
      __syncthreads();
    }
    const float decay = expf(total);
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int k = 0; k < RN; ++k) {
        const int idx = (ty + 16 * q) * DSP + tx + 16 * k;
        st_sh[idx] = st_sh[idx] * decay + sacc[q][k];
      }
    __syncthreads();  // the next chunk reads the new state
  }

  float* out = a.state + (int64_t(b) * a.nheads + h) * HP * DS;
  for (int i = tid; i < HP * DS; i += kThreads) out[i] = st_sh[(i / DS) * DSP + i % DS];
}

template <int RP, int RN>
int launch(const Args& a, bool bf16, cudaStream_t s) {
  const size_t smem = smem_floats(16 * RP, 16 * RN, a.L) * sizeof(float);
  auto kern = ssd_scan_kernel<RP, RN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(a.nheads, a.batch), kThreads, smem, s>>>(a, bf16);
  return static_cast<int>(cudaGetLastError());
}

// Instances: hp in {32, 64} and ds in {16, 128}, the widths of the
// reference's configs (mamba2-1.3b 64/128, jamba 64/16) and of reduced()
// (32/16).
template <int RP>
int launch_ds(const Args& a, int ds, bool bf16, cudaStream_t s) {
  switch (ds) {
    case 16: return launch<RP, 1>(a, bf16, s);
    case 128: return launch<RP, 8>(a, bf16, s);
    default: return -1;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs for (hp, ds, L).
extern "C" long long ssd_scan_smem_bytes(int hp, int ds, int L) {
  return smem_floats(hp, ds, L) * static_cast<long long>(sizeof(float));
}

// Returns cudaGetLastError() after the launch (0 on success), or -1 for an
// (hp, ds) without an instance (the wrapper rejects those first).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* state, int batch, int seqlen,
                               int nheads, int hp, int ds, int L, int is_bf16,
                               long long sx_b, long long sx_s, long long sx_h, long long sx_p,
                               long long sdt_b, long long sdt_s, long long sdt_h,
                               long long sb_b, long long sb_s, long long sb_n,
                               long long sc_b, long long sc_s, long long sc_n, void* stream) {
  if (batch <= 0 || nheads <= 0 || seqlen <= 0 || L <= 0) return 0;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
         static_cast<float*>(y), static_cast<float*>(state), batch, seqlen, nheads, L,
         sx_b, sx_s, sx_h, sx_p, sdt_b, sdt_s, sdt_h, sb_b, sb_s, sb_n, sc_b, sc_s, sc_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (hp) {
    case 32: return launch_ds<2>(a, ds, bf16, s);
    case 64: return launch_ds<4>(a, ds, bf16, s);
    default: return -1;
  }
}
