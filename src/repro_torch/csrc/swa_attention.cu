// Causal / sliding-window attention forward (flash attention with an online
// softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py
// (swa_attention, body _make_kernel).  For q (B, H, S, D) and k, v
// (B, Hkv, S, D), with query head h reading KV head h / (H / Hkv):
//     o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
// over the keys j < S that are live for row i: j <= i when causal, and
// j > i - window when window > 0.  Scores, probabilities and the sums are
// fp32; the output is cast to the input dtype.  This is the oracle
// (kernels/ref.py::swa_attention_ref): keys at or past S are masked, where the
// Pallas kernel pads S with zero keys that only `causal` masks.
//
// The TPU kernel walks a (B*H, S/BQ, S/BK) grid whose KV axis is sequential
// and carries m, l and the (BQ, D) accumulator in VMEM from one KV block to
// the next.  Blocks on Hopper run in no order, so here one thread block owns
// one (batch, head, 64-row query tile) and loops over the key tiles itself,
// with m and l in registers and the accumulator in per-thread register
// tiles.  The whole-block skip becomes the loop's bounds: the block visits
// only keys in [max(0, q0 - window + 1), min(q0 + 63, S - 1)] (causal), so
// the work is O(S * window), not O(S^2).  Each of the 256 threads (a 16 x 16
// grid) holds a 4 x 4 tile of the (64, 64) score tile and a 4 x D/16 tile of
// the output, strided by 16 so that shared-memory reads are conflict-free
// (float4 reads of q and k rows, whose row stride D + 4 puts eight rows of a
// quarter-warp on disjoint banks).  Masked scores are selected away, never
// multiplied, and a row with no live key yet keeps m = -1e30 and l = 0.
// Inputs are read through their strides: the model passes (B, S, H, D)
// projections as (B, H, S, D) views, and the output is written through its
// strides, so nothing is copied, transposed or padded.
//
// Bound: operations.  At StarCoder2-3B's prefill (B=1, H=24, Hkv=2, S=16384,
// D=128, window 4096) the live (q, k) pairs are 58.7 M per head, 4 D flops
// each: 721.6 GFLOP against 0.22 GB of traffic, 10.8 ms on the fp32 FMA
// units.  This first version runs on those units with ~121 KB of shared
// memory (one block per SM at D = 128); tensor cores (bf16 wgmma), TMA loads
// and a K/V tile shared by the query heads of a group are the later redesign.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kT = 64;          // rows of a query tile and of a key tile
constexpr int kRT = kT / 16;    // query rows (and key columns) per thread
constexpr int kPP = kT + 16;    // probability tile row stride: the two rows of a warp's writes on disjoint banks
constexpr float kNeg = -1e30f;  // the running max before any live key

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, heads, kv_heads, seqlen, window, causal;
  float scale;
  int64_t sq_b, sq_h, sq_s, sq_d;
  int64_t sk_b, sk_h, sk_s, sk_d;
  int64_t sv_b, sv_h, sv_s, sv_d;
  int64_t so_b, so_h, so_s, so_d;
};

template <bool BF16>
__device__ __forceinline__ float load(const void* p, int64_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void store(void* p, int64_t i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

template <int D>
__host__ __device__ constexpr int64_t smem_floats() {
  return 2 * int64_t(kT) * (D + 4) + int64_t(kT) * D + int64_t(kT) * kPP;
}

// Rows r0 .. r0+kT-1 of one head of a (B, H, S, D) operand, times mul, into
// dst (row stride ldd); rows at or past S are zero.
template <int D, bool BF16>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const void* src, int64_t base, int64_t ss,
                                          int64_t sd, int r0, int S, float mul) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = r0 + r;
    float val = 0.f;
    if (s < S) val = load<BF16>(src, base + s * ss + d * sd) * mul;
    dst[r * ldd + d] = val;
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(kThreads) swa_attention_kernel(const Args a) {
  constexpr int DP = D + 4;   // q and k row stride
  constexpr int RD = D / 16;  // output columns per thread
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.heads / a.kv_heads);
  const int S = a.seqlen, W = a.window;
  const bool causal = a.causal != 0;

  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;              // kT x DP: the query tile, times 1/sqrt(D)
  float* k_sh = q_sh + kT * DP;    // kT x DP: a key tile
  float* v_sh = k_sh + kT * DP;    // kT x D:  its value rows
  float* p_sh = v_sh + kT * D;     // kT x kPP: the tile's probabilities

  load_tile<D, BF16>(q_sh, DP, a.q, b * a.sq_b + h * a.sq_h, a.sq_s, a.sq_d, q0, S, a.scale);

  float m[kRT], l[kRT], acc[kRT][RD];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[r][c] = 0.f;
  }

  // the live key range of this query tile: the whole-block skip as loop bounds
  const int k_lo = W > 0 ? max(0, q0 - W + 1) : 0;
  const int k_hi = causal ? min(S - 1, q0 + kT - 1) : S - 1;
  const int64_t kbase = b * a.sk_b + hk * a.sk_h, vbase = b * a.sv_b + hk * a.sv_h;

  for (int j0 = k_lo; j0 <= k_hi; j0 += kT) {
    __syncthreads();  // the last tile's k_sh, v_sh and p_sh are read
    load_tile<D, BF16>(k_sh, DP, a.k, kbase, a.sk_s, a.sk_d, j0, S, 1.f);
    load_tile<D, BF16>(v_sh, D, a.v, vbase, a.sv_s, a.sv_d, j0, S, 1.f);
    __syncthreads();

    // scores: rows ty + 16 r of the query tile against keys j0 + tx + 16 c
    float s[kRT][kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int c = 0; c < kRT; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRT], kv[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) qv[r] = *reinterpret_cast<const float4*>(q_sh + (ty + 16 * r) * DP + d);
#pragma unroll
      for (int c = 0; c < kRT; ++c) kv[c] = *reinterpret_cast<const float4*>(k_sh + (tx + 16 * c) * DP + d);
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < kRT; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }

    // online softmax; a row's 64 scores live in the 16 threads of a half-warp
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int i = q0 + ty + 16 * r;
      bool live[kRT];
      float tile_max = kNeg;
#pragma unroll
      for (int c = 0; c < kRT; ++c) {
        const int j = j0 + tx + 16 * c;
        live[c] = j < S && (!causal || j <= i) && (W <= 0 || j > i - W);
        if (live[c]) tile_max = fmaxf(tile_max, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kRT; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        row_sum += p;
        p_sh[(ty + 16 * r) * kPP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[r] = l[r] * alpha + row_sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 r, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < kT; j += 4) {
      float4 pv[kRT];
      float vv[4][RD];
#pragma unroll
      for (int r = 0; r < kRT; ++r) pv[r] = *reinterpret_cast<const float4*>(p_sh + (ty + 16 * r) * kPP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < RD; ++c) vv[jj][c] = v_sh[(j + jj) * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          acc[r][c] = fmaf(pv[r].x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv[r].y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv[r].z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv[r].w, vv[3][c], acc[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i < S) {
      const float denom = fmaxf(l[r], 1e-30f);
      const int64_t row = b * a.so_b + h * a.so_h + i * a.so_s;
#pragma unroll
      for (int c = 0; c < RD; ++c) store<BF16>(a.o, row + (tx + 16 * c) * a.so_d, acc[r][c] / denom);
    }
  }
}

template <int D, bool BF16>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = swa_attention_kernel<D, BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seqlen + kT - 1) / kT, a.heads, a.batch);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(const Args& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch<D, true>(a, stream) : launch<D, false>(a, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// head dim without an instance (the wrapper rejects those first).
// Instances: D in {32, 64, 128} (the reference configs' head dims and
// tests/test_kernels.py's sweep), fp32 and bf16.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                                    int kv_heads, int seqlen, int head_dim, int window, int causal, int is_bf16,
                                    long long sq_b, long long sq_h, long long sq_s, long long sq_d,
                                    long long sk_b, long long sk_h, long long sk_s, long long sk_d,
                                    long long sv_b, long long sv_h, long long sv_s, long long sv_d,
                                    long long so_b, long long so_h, long long so_s, long long so_d, void* stream) {
  if (batch <= 0 || heads <= 0 || seqlen <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0) return -1;
  const Args a{q, k, v, o, batch, heads, kv_heads, seqlen, window, causal,
               static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim))),
               sq_b, sq_h, sq_s, sq_d, sk_b, sk_h, sk_s, sk_d,
               sv_b, sv_h, sv_s, sv_d, so_b, so_h, so_s, so_d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 32: return launch_dtype<32>(a, bf16, s);
    case 64: return launch_dtype<64>(a, bf16, s);
    case 128: return launch_dtype<128>(a, bf16, s);
    default: return -1;
  }
}
