// Mamba2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _make_kernel).  Per (batch, head), over chunks of L rows in order,
// with a = dt*A and a_cum its inclusive cumsum inside the chunk:
//     y_i  = sum_{j<=i} (C_i . B_j) exp(a_cum_i - a_cum_j) dt_j x_j      (intra-chunk)
//          + exp(a_cum_i) C_i . S                                      (inter-chunk)
//     S'   = S exp(a_cum_last) + sum_j dt_j exp(a_cum_last - a_cum_j) x_j^T B_j
// in fp32 from a zero state; the final S is the second output.  For every
// chunk length this is the same function, the recurrence
// S_t = S_{t-1} exp(dt_t A) + dt_t x_t^T B_t, y_t = S_t C_t (ref.ssd_scan_ref);
// the chunk decides only where the sums are taken.
//
// The TPU kernel walks a (B, nh, S/L) grid and carries S in VMEM across the
// sequential chunk axis.  Blocks on Hopper run in no order, so here one
// thread block owns one (batch, head) and loops over the chunks itself,
// keeping the (hp, ds) fp32 state on chip for the whole sequence.  Rows at
// or past S count as dt = 0, x = B = C = 0 and are never written, which is
// exactly the Pallas kernel's zero padding without a padded copy.  Inputs
// are read through their strides (x, B and C are slices of one projection
// in the model), so nothing is copied first.
//
// Bound: at the prefill shape (B=4, S=2048, nh=64, hp=64, ds=128, L=256)
// the chunked form needs 26.07 GFLOP against 0.216 GB of traffic (y, in
// fp32, is 62% of it): 0.389 ms on the fp32 FMA units, but on the bf16
// tensor cores 0.026 ms, below the 0.0645 ms that the bytes take.
//
// Two routes, chosen by dtype (never one as a fallback for the other):
//
// bf16, the model's route (ssd_tc_kernel): the tensor cores.  One block of
//   one warpgroup (128 threads) per (batch, head), two blocks per SM (105 KB
//   of shared memory each), so the prefill's 256 blocks run in one wave.
//   The route's chunk is its 64-row tile, whatever L is asked: shared
//   memory holds one 64-row tile set per stage (x, B, C: 40 KB at ds = 128),
//   not a 256-row chunk (160 KB), and the state is carried every 64 rows.
//   Per tile, on wgmma (bf16 in, fp32 accumulators):
//     G  = C B^T                 (C, B K-major in shared memory, K = ds)
//     Y  = C S^T                 (S^T from a bf16 copy of the fp32 state)
//     P  = G o exp(a_i - a_j) o dt_j, j <= i, in fp32 registers, rounded to
//          bf16 and packed as the A operand of
//     Y  = exp(a_i) Y + P X      (X the bf16 x tile as loaded, MN-major)
//     S  = S exp(a_last) + (X o w)^T B,  w_j = dt_j exp(a_last - a_j)
//          (X o w rounded to bf16, both operands MN-major; S stays fp32 in
//          the accumulator registers for the whole sequence)
//   So a term reaches y rounded once (P) inside its tile and twice (X o w,
//   the state's copy) from an earlier tile, and reaches the final state
//   rounded once (X o w): kernels/ssd_scan.py::ssd_bf16_limit.  x, B and C
//   arrive by TMA (4-D tensor maps over the strided views, 128-byte
//   swizzle, zero fill past S and past hp or ds, so ds = 16 runs as a
//   zero-padded 64 and hp = 32 as 64) into two stages: tile t+2 loads while
//   t+1 waits and t computes; each tile is loaded once.  dt is read with
//   plain loads one tile ahead; a_cum by a warp-shuffle scan.
//   cuTensorMapEncodeTiled is fetched at run time through
//   cudaGetDriverEntryPoint(ByVersion), so the library links no -lcuda.
//
// fp32, the correctness route (ssd_fma_kernel): fp32 FMA tiles.  256
//   threads (a 16 x 16 grid) walk the chunk's 64-row tiles; each thread keeps
//   a register tile of 4 rows x (hp/16 or ds/16) columns, strided by 16 so
//   that shared-memory reads are conflict-free; the fp32 state sits in
//   shared memory; C.B^T is formed per head and tile pair; loads are
//   synchronous.  ~138 KB of shared memory at L = 256: one block per SM.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled itself is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // fp32 route: a 16 x 16 thread grid
constexpr int kT = 64;           // rows per tile (both routes)
constexpr int kRT = kT / 16;     // fp32 route: register rows per thread
constexpr int kTP = kT + 16;     // fp32 route: score tile row stride, half-warps on disjoint banks

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* state;
  int batch, seqlen, nheads, hp, ds, L;
  int64_t sx_b, sx_s, sx_h, sx_p;
  int64_t sdt_b, sdt_s, sdt_h;
  int64_t sb_b, sb_s, sb_n;
  int64_t sc_b, sc_s, sc_n;
};

// fp32 route: shared-memory floats for one block (must match the carve-up in the kernel).
__host__ __device__ constexpr int64_t smem_floats(int hp, int ds, int L) {
  return int64_t(hp) * (ds + 1) + 2 * int64_t(kT) * (ds + 1) + int64_t(kT) * hp +
         int64_t(kT) * kTP + 2 * int64_t(L);
}

// Rows r0 .. r0+kT-1 of the chunk from a (B, S, DS) operand into dst
// (row stride DS+1); rows past the chunk or past S are zero.
template <int DS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t sb, int64_t ss,
                                          int64_t sn, int b, int s0, int r0, int L, int S) {
  for (int idx = threadIdx.x; idx < kT * DS; idx += kThreads) {
    const int r = idx / DS, n = idx % DS, l = r0 + r, s = s0 + l;
    float v = 0.f;
    if (l < L && s < S) v = src[b * sb + s * ss + n * sn];
    dst[r * (DS + 1) + n] = v;
  }
}

// Rows r0 .. r0+kT-1 of x*dt for head h into dst (row stride HP), times
// exp(total - a_cum) when ``to_end`` (the decay to the chunk's end).
template <int HP>
__device__ __forceinline__ void load_xdt(float* dst, const Args& a, int b, int h, int s0, int r0,
                                         const float* dts, const float* acum, float total,
                                         bool to_end) {
  const float* x = static_cast<const float*>(a.x);
  for (int idx = threadIdx.x; idx < kT * HP; idx += kThreads) {
    const int r = idx / HP, p = idx % HP, l = r0 + r, s = s0 + l;
    float v = 0.f;
    if (l < a.L && s < a.seqlen) {
      v = x[b * a.sx_b + s * a.sx_s + h * a.sx_h + p * a.sx_p] * dts[l];
      if (to_end) v *= expf(total - acum[l]);
    }
    dst[r * HP + p] = v;
  }
}
template <int RP, int RN>
__global__ void __launch_bounds__(kThreads) ssd_fma_kernel(const Args a) {
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
      load_rows<DS>(c_sh, static_cast<const float*>(a.Cm), a.sc_b, a.sc_s, a.sc_n, b, s0, i0, L, S);
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
        load_rows<DS>(b_sh, static_cast<const float*>(a.Bm), a.sb_b, a.sb_s, a.sb_n, b, s0, j0, L, S);
        load_xdt<HP>(x_sh, a, b, h, s0, j0, dts, acum, total, false);
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
      load_rows<DS>(b_sh, static_cast<const float*>(a.Bm), a.sb_b, a.sb_s, a.sb_n, b, s0, j0, L, S);
      load_xdt<HP>(x_sh, a, b, h, s0, j0, dts, acum, total, true);
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
int launch_fma(const Args& a, cudaStream_t s) {
  const size_t smem = smem_floats(16 * RP, 16 * RN, a.L) * sizeof(float);
  auto kern = ssd_fma_kernel<RP, RN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(a.nheads, a.batch), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores, TMA into two stages of 64-row tiles
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;        // one warpgroup
constexpr int kPanel = kT * 128;       // bytes of 64 rows x 64 bf16 columns (one 128-byte swizzle row each)

// NP: 64-column panels of B, C and the state, 2 at ds = 128 and 1 at ds = 16
// (zero-filled past ds).  x is one panel (zero-filled past hp at hp = 32).
template <int NP>
struct TcShape {
  static constexpr int X = kPanel;                      // an x tile, [row][p]
  static constexpr int BC = NP * kPanel;                // a B or C tile, [row][n], NP panels
  static constexpr int STAGE = X + 2 * BC;              // x, C, B of one tile
  static constexpr int SMEM = 1024 + 2 * STAGE + BC + X;  // 2 stages, the state's bf16 copy, x o w, 1 KB alignment slack
};

struct TcArgs {
  const float* dt;
  const float* A;
  float* y;
  float* state;
  int seqlen, nheads, hp, ds;
  int64_t sdt_b, sdt_s, sdt_h;
  int pos_x[3], pos_b[3], pos_c[3];  // each map's coordinate (1..3) of the S, H and B axes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait for phase `parity` of a barrier to complete.  A transfer that never
// lands would spin forever and hold the card: after ~2^34 cycles (seconds)
// the kernel traps instead, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// One (64 columns, 64 rows) box from column col, rows s .. s+63 of head h,
// batch b; rows past S and columns past the inner dim arrive as zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, const int* pos, uint32_t bar, int col,
                                        int s, int h, int b) {
  auto coord = [&](int axis) { return pos[0] == axis ? s : pos[1] == axis ? h : b; };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(coord(1)), "r"(coord(2)), "r"(coord(3)), "r"(bar)
      : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor (start, leading and stride byte
// offsets in 16-byte units, 128-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (uint64_t{1} << 62);
}

// K-major operand (rows contiguous along K, in 64-column panels): the 16
// columns of step kk of all 64 rows.  Within a swizzle row a step is a
// 32-byte advance of the start; the next 8 rows are 1024 bytes on.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (rows along K, the M or N axis contiguous in 64-column
// panels): the 16 rows of step kk; 8 rows are 1024 bytes (SBO), the next 64
// columns one panel on (LBO).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kPanel, 1024);
}

// Byte offset of element (row r, column n) of a [row][n] bf16 tile of
// 64-column panels under the 128-byte swizzle: the 16-byte chunk index
// within a 128-byte row is XORed with the row mod 8 (tiles are 1 KB aligned).
__device__ __forceinline__ uint32_t swz(int r, int n) {
  const uint32_t off = (n / 64) * kPanel + r * 128 + (n % 64) * 2;
  return off ^ (((off >> 7) & 7) << 4);
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// d (64 x N fp32 accumulators over the warpgroup) += A (64 x 16) B (16 x N).
// _ss: A and B from shared memory, both K-major, from 0 when scale_d is 0.
// _rs: A from registers (four bf16x2 per thread), B MN-major.
// _tt: A and B from shared memory, both MN-major (the transpose bits, which
// exist for 16-bit types only).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tt_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int NP>
__device__ __forceinline__ void wgmma_tt(float* d, uint64_t a, uint64_t b) {
  if constexpr (NP == 1) {
    wgmma_tt_n64(d, a, b, 1);
  } else {
    wgmma_tt_n128(d, a, b, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block: batch b, head h, all S rows in 64-row tiles.  Of each 64-row
// product a thread holds the rows ra = 16 (warp) + lane/4 and ra + 8 and the
// columns 8 c + 2 (lane % 4) + {0, 1}: accumulator 4 c + {0, 1} at row ra,
// 4 c + {2, 3} at ra + 8.  That is also the A-operand layout of a k16 slice,
// so the G fragment, packed pair by pair to bf16x2, feeds P X from registers.
template <int NP>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mc, const TcArgs a) {
  using T = TcShape<NP>;
  constexpr int NS = 32 * NP;  // state accumulators per thread: 64 x 64 NP over 128 threads
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float acum[kT], dts[kT], warp_tot[2];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle wants 1 KB-aligned tiles
  uint8_t* const gbase = smem_raw + (base - raw);
  auto x_off = [&](int st) { return static_cast<uint32_t>(st * T::STAGE); };
  auto c_off = [&](int st) { return static_cast<uint32_t>(st * T::STAGE + T::X); };
  auto b_off = [&](int st) { return static_cast<uint32_t>(st * T::STAGE + T::X + T::BC); };
  constexpr uint32_t s_off = 2 * T::STAGE;   // the state's bf16 copy, [p][n]: the K-major B of C S^T
  constexpr uint32_t xw_off = s_off + T::BC; // x o w, [row][p] like x: the MN-major A of the state update
  auto bar = [&](int st) { return smem_u32(&bars[st]); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = a.seqlen, nt = (S + kT - 1) / kT;
  const float Ah = a.A[h];

  auto load = [&](int t) {  // one thread: tile t into stage t % 2
    const int st = t & 1, s0 = t * kT;
    mbar_expect_tx(bar(st), T::STAGE);
    tma_box(base + x_off(st), &mx, a.pos_x, bar(st), 0, s0, h, b);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_box(base + c_off(st) + p * kPanel, &mc, a.pos_c, bar(st), 64 * p, s0, 0, b);
      tma_box(base + b_off(st) + p * kPanel, &mb, a.pos_b, bar(st), 64 * p, s0, 0, b);
    }
  };
  auto load_dt = [&](int t) {  // dt of row tid of tile t (threads 0..63), 0 past S
    const int s = t * kT + tid;
    return tid < kT && s < S ? a.dt[b * a.sdt_b + s * a.sdt_s + h * a.sdt_h] : 0.f;
  };

  // the state's bf16 copy starts at zero: C S^T of the first tile is 0
  for (int i = tid; i < T::BC / 16; i += kTcThreads) reinterpret_cast<uint4*>(gbase + s_off)[i] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  if (tid == 0) {
    mbar_init(bar(0), 1);
    mbar_init(bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < min(2, nt); ++t) load(t);
  }

  const int ra = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float sacc[NS];  // the fp32 state S[p][n] in the accumulator layout (rows p, columns n)
#pragma unroll
  for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
  float g[32], yacc[32];
  uint32_t pk[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) g[i] = yacc[i] = 0.f;
  float dt_next = load_dt(0);

  for (int t = 0; t < nt; ++t) {
    const int st = t & 1, s0 = t * kT;

    // a_cum over the tile: warps 0 and 1 scan 32 rows each
    const float d = dt_next;
    if (t + 1 < nt) dt_next = load_dt(t + 1);  // one tile ahead
    float v = d * Ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31 && warp < 2) warp_tot[warp] = v;
    __syncthreads();
    if (tid < kT) {
      acum[tid] = v + (warp == 1 ? warp_tot[0] : 0.f);
      dts[tid] = d;
    }
    __syncthreads();
    const float total = acum[kT - 1];
    const float a_a = acum[ra], a_b = acum[ra + 8];
    mbar_wait(bar(st), (t >> 1) & 1);

    // G = C B^T and Y = C S^T (S from the last tile), K = 64 NP
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(g[i]);
      fence_reg(yacc[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      wgmma_ss_n64(g, desc_kmajor(base + c_off(st), kk), desc_kmajor(base + b_off(st), kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      wgmma_ss_n64(yacc, desc_kmajor(base + c_off(st), kk), desc_kmajor(base + s_off, kk), kk > 0);
    }
    wgmma_commit();

    // meanwhile x o w, w_j = dt_j exp(a_last - a_j), rounded to bf16; a
    // 16-byte chunk keeps its row under the swizzle, so x and x o w share
    // one layout and each chunk is scaled in place of its position
    for (int c = tid; c < kT * 8; c += kTcThreads) {
      const int j = c / 8;
      const float w = dts[j] * __expf(total - acum[j]);
      uint4 chunk = *reinterpret_cast<const uint4*>(gbase + x_off(st) + 16 * c);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&chunk);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        h2[k] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      *reinterpret_cast<uint4*>(gbase + xw_off + 16 * c) = chunk;
    }
    fence_async_shared();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(g[i]);
      fence_reg(yacc[i]);
    }

    // P = G o exp(a_i - a_j) o dt_j on j <= i, packed to bf16 pairs; Y scaled by exp(a_i)
    const float e_a = __expf(a_a), e_b = __expf(a_b);
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // pair i: accumulators 2i, 2i+1, row ra + 8 when i is odd
      const int row = (i & 1) ? ra + 8 : ra, j = 8 * (i / 2) + col0;
      const float ai = (i & 1) ? a_b : a_a;
      const float p0 = j <= row ? g[2 * i] * __expf(ai - acum[j]) * dts[j] : 0.f;
      const float p1 = j + 1 <= row ? g[2 * i + 1] * __expf(ai - acum[j + 1]) * dts[j + 1] : 0.f;
      pk[i] = pack_bf16x2(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= (i & 2) ? e_b : e_a;
    const float decay = __expf(total);
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] *= decay;
    __syncthreads();  // x o w written by every thread

    // Y += P X; S += (x o w)^T B
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(yacc[i]);
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(sacc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(pk[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(yacc, &pk[4 * kk], desc_mnmajor(base + x_off(st), kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tt<NP>(sacc, desc_mnmajor(base + xw_off, kk), desc_mnmajor(base + b_off(st), kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(yacc[i]);
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(sacc[i]);

    // y rows of this tile, fp32, straight from the fragment
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = s0 + ra + 8 * half;
      if (s < S) {
        float* out = a.y + ((static_cast<int64_t>(b) * S + s) * a.nheads + h) * a.hp + col0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (8 * c < a.hp) {
            *reinterpret_cast<float2*>(out + 8 * c) = make_float2(yacc[4 * c + 2 * half], yacc[4 * c + 2 * half + 1]);
          }
        }
      }
    }

    // the state's bf16 copy for the next tile's C S^T (this tile's has been read)
    if (t + 1 < nt) {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const int row = (i & 1) ? ra + 8 : ra, n = 8 * (i / 2) + col0;
        *reinterpret_cast<uint32_t*>(gbase + s_off + swz(row, n)) = pack_bf16x2(sacc[2 * i], sacc[2 * i + 1]);
      }
      fence_async_shared();
    }
    __syncthreads();  // stage st, x o w, a_cum and the state's copy are done with
    if (tid == 0 && t + 2 < nt) load(t + 2);
  }

  // the final state, fp32
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) {
    const int p = (i & 1) ? ra + 8 : ra, n = 8 * (i / 2) + col0;
    if (p < a.hp && n < a.ds) {
      float* out = a.state + ((static_cast<int64_t>(b) * a.nheads + h) * a.hp + p) * a.ds + n;
      *reinterpret_cast<float2*>(out) = make_float2(sacc[2 * i], sacc[2 * i + 1]);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the CUDA driver API at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The tensor map of one bf16 operand with a contiguous inner dim of `inner`
// elements and three outer axes (S, H, B: sizes and element strides): dims
// (inner, then the outer axes in the order of their strides), boxes of
// (64 columns, 64 rows of S).  pos receives the map coordinate (1..3) of S,
// H and B.  A dim of size 1 is never stepped, so it gets the largest
// stride, which TMA accepts.  Box columns past `inner` and rows past S are
// zero-filled.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int inner, const int64_t size[3],
              const int64_t stride[3], int* pos) {
  struct Axis {
    uint64_t size, stride;
    int role;  // 0 = S, 1 = H, 2 = B
  };
  Axis ax[3];
  uint64_t span = static_cast<uint64_t>(inner) * 2;
  for (int k = 0; k < 3; ++k) {
    ax[k] = {static_cast<uint64_t>(size[k]), static_cast<uint64_t>(stride[k]) * 2, k};
    if (ax[k].size * ax[k].stride > span) span = ax[k].size * ax[k].stride;
  }
  for (Axis& x : ax) {
    if (x.size == 1) x.stride = span;
  }
  for (int i = 1; i < 3; ++i) {  // stable sort by stride
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) {
      const Axis tmp = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = tmp;
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), ax[0].size, ax[1].size, ax[2].size};
  const cuuint64_t strides[3] = {ax[0].stride, ax[1].stride, ax[2].stride};
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    pos[ax[k].role] = k + 1;
    if (ax[k].role == 0) box[k + 1] = kT;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

constexpr int kErrInstance = -1, kErrDriver = -2, kErrTensorMap = -3, kErrLayout = -4;

template <int NP>
cudaError_t allow_tc_smem() {
  return cudaFuncSetAttribute(ssd_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, TcShape<NP>::SMEM);
}

// Blocks of the bf16 route that one SM holds at once (the design's two).
template <int NP>
int tc_blocks_per_sm() {
  int n = 0;
  cudaError_t err = allow_tc_smem<NP>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_tc_kernel<NP>, kTcThreads, TcShape<NP>::SMEM);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int NP>
int launch_tc(const Args& a, cudaStream_t stream) {
  using T = TcShape<NP>;
  if (a.sx_p != 1 || a.sb_n != 1 || a.sc_n != 1) return kErrLayout;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrDriver;
  TcArgs t{};
  t.dt = a.dt;
  t.A = a.A;
  t.y = a.y;
  t.state = a.state;
  t.seqlen = a.seqlen;
  t.nheads = a.nheads;
  t.hp = a.hp;
  t.ds = a.ds;
  t.sdt_b = a.sdt_b;
  t.sdt_s = a.sdt_s;
  t.sdt_h = a.sdt_h;
  const int64_t x_size[3] = {a.seqlen, a.nheads, a.batch}, x_stride[3] = {a.sx_s, a.sx_h, a.sx_b};
  const int64_t bc_size[3] = {a.seqlen, 1, a.batch};
  const int64_t b_stride[3] = {a.sb_s, 0, a.sb_b}, c_stride[3] = {a.sc_s, 0, a.sc_b};
  CUtensorMap mx, mb, mc;
  if (!make_map(encode, &mx, a.x, a.hp, x_size, x_stride, t.pos_x) ||
      !make_map(encode, &mb, a.Bm, a.ds, bc_size, b_stride, t.pos_b) ||
      !make_map(encode, &mc, a.Cm, a.ds, bc_size, c_stride, t.pos_c)) {
    return kErrTensorMap;
  }
  const cudaError_t err = allow_tc_smem<NP>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_kernel<NP><<<dim3(a.nheads, a.batch), kTcThreads, T::SMEM, stream>>>(mx, mb, mc, t);
  return static_cast<int>(cudaGetLastError());
}

// Instances: hp in {32, 64} and ds in {16, 128}, the widths of the
// reference's configs (mamba2-1.3b 64/128, jamba 64/16) and of reduced()
// (32/16).  The fp32 route has one per (hp, ds); the bf16 route one per ds
// (hp 32 runs zero-padded to 64).
template <int RP>
int launch_fma_ds(const Args& a, cudaStream_t s) {
  switch (a.ds) {
    case 16: return launch_fma<RP, 1>(a, s);
    case 128: return launch_fma<RP, 8>(a, s);
    default: return kErrInstance;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block of the fp32 route needs for (hp, ds, L).
extern "C" long long ssd_scan_smem_bytes(int hp, int ds, int L) {
  return smem_floats(hp, ds, L) * static_cast<long long>(sizeof(float));
}

// Blocks of the bf16 route one SM holds at once for this ds (a negative
// CUDA error on failure).
extern "C" int ssd_scan_tc_blocks_per_sm(int ds) { return ds == 16 ? tc_blocks_per_sm<1>() : tc_blocks_per_sm<2>(); }

// Returns cudaGetLastError() after the launch (0 on success), or a negative
// code the wrapper names: -1 an (hp, ds) without an instance, -2 no
// cuTensorMapEncodeTiled in the CUDA driver, -3 a tensor map it refused,
// -4 a layout the bf16 route does not take (the wrapper rejects those first).
// bf16 runs ssd_tc_kernel (whatever L), fp32 ssd_fma_kernel.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* state, int batch, int seqlen,
                               int nheads, int hp, int ds, int L, int is_bf16,
                               long long sx_b, long long sx_s, long long sx_h, long long sx_p,
                               long long sdt_b, long long sdt_s, long long sdt_h,
                               long long sb_b, long long sb_s, long long sb_n,
                               long long sc_b, long long sc_s, long long sc_n, void* stream) {
  if (batch <= 0 || nheads <= 0 || seqlen <= 0 || L <= 0) return 0;
  if ((hp != 32 && hp != 64) || (ds != 16 && ds != 128)) return kErrInstance;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
               static_cast<float*>(y), static_cast<float*>(state), batch, seqlen, nheads, hp, ds, L,
               sx_b, sx_s, sx_h, sx_p, sdt_b, sdt_s, sdt_h, sb_b, sb_s, sb_n, sc_b, sc_s, sc_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 != 0) return ds == 16 ? launch_tc<1>(a, s) : launch_tc<2>(a, s);
  return hp == 32 ? launch_fma_ds<2>(a, s) : launch_fma_ds<4>(a, s);
}
