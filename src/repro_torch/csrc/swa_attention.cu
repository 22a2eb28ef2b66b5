// Causal / sliding-window attention forward (flash attention with an online
// softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py
// (swa_attention, body _make_kernel).  For q (B, H, S, D) and k, v
// (B, Hkv, S, D), with query head h reading KV head h / (H / Hkv):
//     o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
// over the keys j < S that are live for row i: j <= i when causal, and
// j > i - window when window > 0.  This is the oracle
// (kernels/ref.py::swa_attention_ref): keys at or past S are masked, where the
// Pallas kernel pads S with zero keys that only `causal` masks.  A row with no
// live key gives 0.
//
// The TPU kernel walks a (B*H, S/BQ, S/BK) grid whose KV axis is sequential
// and carries m, l and the (BQ, D) accumulator in VMEM from one KV block to
// the next.  Blocks on Hopper run in no order, so here one thread block owns
// one (batch, head, query tile) and loops over the key tiles itself, with m,
// l and the accumulator in registers.  The whole-block skip becomes the
// loop's bounds: the block visits only keys in [max(0, q0 - window + 1),
// min(q0 + rows - 1, S - 1)] (causal), so the work is O(S * window).
// Inputs are read through their strides (the model passes (B, S, H, D)
// projections as (B, H, S, D) views) and the output is written through a
// (B, S, H, D) buffer's, so nothing is copied, transposed or padded.
//
// Bound: operations.  At StarCoder2-3B's prefill (B=1, H=24, Hkv=2, S=16384,
// D=128, window 4096) the live (q, k) pairs need 721.6 GFLOP against 0.22 GB
// of traffic: 0.73 ms on the bf16 tensor cores, 10.8 ms on the fp32 FMA units.
//
// Two routes, chosen by dtype (never one as a fallback for the other):
//
// bf16, the model's route (swa_tc_kernel): the tensor cores.  One block of
//   two warpgroups owns a 128-row query tile; each warpgroup owns 64 rows.
//   Per 128-key tile, S = Q K^T is a chain of wgmma m64n128k16 (bf16 in, fp32
//   accumulators) with Q and K read from shared memory, K-major.  The online
//   softmax runs on the accumulator fragment in registers: scores times
//   log2(e)/sqrt(D) in fp32, 2^x on the special-function unit (ex2), row
//   max over the four threads of a quad.
//   P is rounded to bf16 (the one rounding this route adds; m, l and O stay
//   fp32, and l sums the fp32 P), and the S fragment, packed pair by pair,
//   is the A operand of O += P V (wgmma m64nDk16, A from registers, V from
//   shared memory as an MN-major B operand).  Masks are applied only on tiles
//   that need them: the window's first tile, the diagonal and the tile past S.
//   Tiles arrive by TMA: a 4-D tensor map per operand over (D, S, H, B) in
//   stride order, 128-byte swizzle (64-byte at D = 32) in boxes of 64 columns,
//   completion on an mbarrier.  Q stays resident; K and V go through a ring
//   of kStages stages, the next tile loading while this one is computed.
//   TMA zero-fills rows past S, so a masked probability never meets a NaN.
//   Shared memory: (1 + 2 kStages) tiles, 160 KB at D = 128: one block per SM.
//   The grid runs the query tiles heaviest first (the last tiles see a full
//   window), so the light tiles of the first 4096 rows fill the tail.
//   cuTensorMapEncodeTiled belongs to the CUDA driver API: it is fetched at
//   run time through cudaGetDriverEntryPoint(ByVersion), so the library
//   links no -lcuda.
//
// fp32, the correctness route (swa_fma_kernel): fp32 FMA tiles.  One block
//   of 256 threads (a 16 x 16 grid) owns a 64-row query tile; each thread
//   holds a 4 x 4 tile of the (64, 64) score tile and a 4 x D/16 tile of the
//   output, strided by 16 so that shared-memory reads are conflict-free
//   (float4 reads of q and k rows, whose row stride D + 4 puts eight rows of
//   a quarter-warp on disjoint banks).  Loads are synchronous.  Masked scores
//   are selected away, never multiplied; a row with no live key yet keeps
//   m = -1e30 and l = 0.
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 256;   // fp32 route: a 16 x 16 thread grid
constexpr int kT = 64;          // fp32 route: rows of a query tile and of a key tile
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

template <int D>
__host__ __device__ constexpr int64_t smem_floats() {
  return 2 * int64_t(kT) * (D + 4) + int64_t(kT) * D + int64_t(kT) * kPP;
}

// Rows r0 .. r0+kT-1 of one head of a (B, H, S, D) operand, times mul, into
// dst (row stride ldd); rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const void* src, int64_t base, int64_t ss,
                                          int64_t sd, int r0, int S, float mul) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = r0 + r;
    float val = 0.f;
    if (s < S) val = static_cast<const float*>(src)[base + s * ss + d * sd] * mul;
    dst[r * ldd + d] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) swa_fma_kernel(const Args a) {
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

  load_tile<D>(q_sh, DP, a.q, b * a.sq_b + h * a.sq_h, a.sq_s, a.sq_d, q0, S, a.scale);

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
    load_tile<D>(k_sh, DP, a.k, kbase, a.sk_s, a.sk_d, j0, S, 1.f);
    load_tile<D>(v_sh, D, a.v, vbase, a.sv_s, a.sv_d, j0, S, 1.f);
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
      for (int c = 0; c < RD; ++c) static_cast<float*>(a.o)[row + (tx + 16 * c) * a.so_d] = acc[r][c] / denom;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores, TMA into a ring of shared tiles
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;  // two warpgroups of 64 query rows each
constexpr int kTcRows = 128;     // rows of a query tile and of a key tile
constexpr int kStages = 2;       // K/V tiles in shared memory

struct TcArgs {
  int batch, heads, kv_heads, seqlen, window, causal, n_qtiles;
  float scale_log2;                  // log2(e) / sqrt(D)
  int pos_q[3], pos_k[3], pos_v[3];  // each map's coordinate (1..3) of the S, H and B axes
  __nv_bfloat16* o;
  int64_t so_b, so_h, so_s;
};

template <int D>
struct TcShape {
  static constexpr int PW = D < 64 ? D : 64;              // columns of a panel: one swizzle row
  static constexpr int SWB = PW * 2;                      // bytes of a swizzle row: 128, or 64 at D = 32
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;  // wgmma descriptor: 128B or 64B swizzle
  static constexpr int PANEL = kTcRows * SWB;             // bytes of a tile's panel of PW columns
  static constexpr int TILE = kTcRows * D * 2;            // bytes of a tile: D / PW panels
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * kStages);  // Q, the K/V ring, slack for 1 KB alignment
};

// Rows s0 .. s0+127 of head h, batch b, all D columns, as D / PW boxes of
// (PW, 128): panel p holds columns p*PW .. p*PW+PW-1 of every row, swizzled.
// Rows at or past S arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, const int* pos, uint32_t bar, int s0,
                                         int h, int b) {
  using T = TcShape<D>;
  auto coord = [&](int axis) { return pos[0] == axis ? s0 : pos[1] == axis ? h : b; };
  const int c1 = coord(1), c2 = coord(2), c3 = coord(3);
#pragma unroll
  for (int p = 0; p < D / T::PW; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(dst + p * T::PANEL),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(p * T::PW), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
  }
}

// K-major operand (Q or K: rows contiguous in D), the 16 columns of step kk
// for the rows from byte offset `row` of each panel.  Within a swizzle row a
// step is a 32-byte advance of the start; the next 8 rows are 8 swizzle rows on.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, uint32_t row, int kk) {
  using T = TcShape<D>;
  const uint32_t addr = tile + (kk * 16 / T::PW) * T::PANEL + row + (kk * 16 % T::PW) * 2;
  return make_desc(addr, 16, 8 * T::SWB, T::LAYOUT);
}

// MN-major operand (V as the B of P V: the N axis D is contiguous), the 16
// keys of step kk: 8 keys per 8 swizzle rows (SBO), the next PW columns one
// panel on (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using T = TcShape<D>;
  return make_desc(tile + kk * 16 * T::SWB, T::PANEL, 8 * T::SWB, T::LAYOUT);
}


// One block: batch b, head h, query rows q0 .. q0+127 (warpgroup w: rows
// q0 + 64 w ..).  A thread holds, of each 64-row product, the rows
// ra = 16 (warp in group) + lane/4 and ra + 8 and the columns
// 8 c + 2 (lane % 4) + {0, 1}: accumulator 4 c + {0, 1} at row ra, 4 c + {2, 3}
// at ra + 8.  That is also the A-operand layout of a k16 slice of P, so the
// S fragment, packed pair by pair to bf16x2, feeds P V without shared memory.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    swa_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const TcArgs a) {
  using T = TcShape<D>;
  constexpr int NS = kTcRows / 2;  // score accumulators per thread (64 x 128 over 128 threads)
  constexpr int NO = D / 2;        // output accumulators per thread
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;  // the 128B swizzle wants 1 KB-aligned tiles
  auto k_sh = [&](int st) { return q_sh + T::TILE * (1 + 2 * st); };
  auto v_sh = [&](int st) { return q_sh + T::TILE * (2 + 2 * st); };
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  // heaviest first: the last query tiles (a full window) get the low block ids
  const int n_bh = a.batch * a.heads;
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int bh = static_cast<int>(blockIdx.x % n_bh), h = bh % a.heads, b = bh / a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const int q0 = qt * kTcRows, S = a.seqlen, W = a.window;
  const bool causal = a.causal != 0;
  // the live key range of this query tile: the whole-block skip as loop bounds
  const int k_lo = W > 0 ? max(0, q0 - W + 1) : 0;
  const int k_hi = causal ? min(S - 1, q0 + kTcRows - 1) : S - 1;
  const int n_tiles = (k_hi - k_lo) / kTcRows + 1;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  auto load_kv = [&](int t) {  // one thread: key tile t into stage t % kStages
    const int st = t % kStages, j0 = k_lo + t * kTcRows;
    mbar_expect_tx(full_bar(st), 2 * T::TILE);
    tma_tile<D>(k_sh(st), &mk, a.pos_k, full_bar(st), j0, hk, b);
    tma_tile<D>(v_sh(st), &mv, a.pos_v, full_bar(st), j0, hk, b);
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full_bar(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, T::TILE);
    tma_tile<D>(q_sh, &mq, a.pos_q, q_bar, q0, h, b);
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t);
  }

  const int ra = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int i_a = q0 + 64 * wg + ra, i_b = i_a + 8;        // this thread's two query rows
  const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;         // the warpgroup's rows
  const uint32_t q_rows = 64 * wg * T::SWB;                // the warpgroup's rows in each Q panel
  const float sl2 = a.scale_log2;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;      // running max (log2 units) and fp32 sum
  float s[NS], o[NO];
  uint32_t p[NS / 2];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, j0 = k_lo + t * kTcRows;
    mbar_wait(full_bar(st), (t / kStages) & 1);

    // S = Q K^T over D / 16 steps
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n128(s, desc_kmajor<D>(q_sh, q_rows, kk), desc_kmajor<D>(k_sh(st), 0, kk), kk > 0);
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);

    // masks, only on tiles where some (row, key) pair of the warpgroup is dead
    const bool need_mask = j0 + kTcRows > S || (causal && j0 + kTcRows - 1 > r_lo) || (W > 0 && j0 <= r_hi - W);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = j0 + 8 * (i / 4) + col0 + (i & 1), row = (i & 2) ? i_b : i_a;
        const bool live = j < S && (!causal || j <= row) && (W <= 0 || j > row - W);
        if (!live) s[i] = -INFINITY;
      }
    }

    // online softmax on the fragment; a row's 128 scores live in one quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i & 2) {
        mx_b = fmaxf(mx_b, s[i]);
      } else {
        mx_a = fmaxf(mx_a, s[i]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {  // pair i: accumulators 2i, 2i+1, row b when i is odd
      const float mrow = (i & 1) ? mn_b : mn_a;
      const float p0 = ex2(fmaf(s[2 * i], sl2, -mrow)), p1 = ex2(fmaf(s[2 * i + 1], sl2, -mrow));
      if (i & 1) {
        sum_b += p0 + p1;
      } else {
        sum_a += p0 + p1;
      }
      p[i] = pack_bf16x2(p0, p1);
    }
    l_a = l_a * al_a + sum_a;  // per thread; the quad's partial sums are added at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al_b : al_a;

    // O += P V over the tile's 8 steps of 16 keys
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) fence_reg(p[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) wgmma_rs<D>(o, &p[4 * kk], desc_mnmajor<D>(v_sh(st), kk));
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);

    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && t + kStages < n_tiles) load_kv(t + kStages);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* out = a.o + b * a.so_b + h * a.so_h + col0;
  if (i_a < S) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_a * a.so_s + 8 * c) =
          __floats2bfloat162_rn(o[4 * c] * inv_a, o[4 * c + 1] * inv_a);
    }
  }
  if (i_b < S) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_b * a.so_s + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b);
    }
  }
}


// The tensor map of one (B, heads, S, D) bf16 operand with element strides
// s_b, s_h, s_s (D contiguous): dims (D, then S, H and B in the order of
// their strides), boxes of (PW, 128 rows).  pos receives the map coordinate
// (1..3) of S, H and B.  A dim of size 1 is never stepped, so it gets the
// largest stride, which TMA accepts.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int heads, int seqlen, int64_t s_b,
              int64_t s_h, int64_t s_s, int* pos) {
  using T = TcShape<D>;
  struct Axis {
    uint64_t size, stride;
    int role;  // 0 = S, 1 = H, 2 = B
  };
  Axis ax[3] = {{static_cast<uint64_t>(seqlen), static_cast<uint64_t>(s_s) * 2, 0},
                {static_cast<uint64_t>(heads), static_cast<uint64_t>(s_h) * 2, 1},
                {static_cast<uint64_t>(batch), static_cast<uint64_t>(s_b) * 2, 2}};
  uint64_t span = D * 2;
  for (const Axis& x : ax) span = x.size * x.stride > span ? x.size * x.stride : span;
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
  const cuuint64_t dims[4] = {D, ax[0].size, ax[1].size, ax[2].size};
  const cuuint64_t strides[3] = {ax[0].stride, ax[1].stride, ax[2].stride};
  cuuint32_t box[4] = {T::PW, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    pos[ax[k].role] = k + 1;
    if (ax[k].role == 0) box[k + 1] = kTcRows;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            T::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

constexpr int kErrHeadDim = -1, kErrDriver = -2, kErrTensorMap = -3, kErrLayout = -4;

template <int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  using T = TcShape<D>;
  if (a.sq_d != 1 || a.sk_d != 1 || a.sv_d != 1 || a.so_d != 1) return kErrLayout;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrDriver;
  TcArgs t{};
  t.batch = a.batch;
  t.heads = a.heads;
  t.kv_heads = a.kv_heads;
  t.seqlen = a.seqlen;
  t.window = a.window;
  t.causal = a.causal;
  t.n_qtiles = (a.seqlen + kTcRows - 1) / kTcRows;
  t.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  t.o = static_cast<__nv_bfloat16*>(a.o);
  t.so_b = a.so_b;
  t.so_h = a.so_h;
  t.so_s = a.so_s;
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(encode, &mq, a.q, a.batch, a.heads, a.seqlen, a.sq_b, a.sq_h, a.sq_s, t.pos_q) ||
      !make_map<D>(encode, &mk, a.k, a.batch, a.kv_heads, a.seqlen, a.sk_b, a.sk_h, a.sk_s, t.pos_k) ||
      !make_map<D>(encode, &mv, a.v, a.batch, a.kv_heads, a.seqlen, a.sv_b, a.sv_h, a.sv_s, t.pos_v)) {
    return kErrTensorMap;
  }
  const int64_t blocks = static_cast<int64_t>(t.n_qtiles) * a.heads * a.batch;
  if (blocks >= (int64_t{1} << 31)) return kErrLayout;
  auto kern = swa_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(blocks), kTcThreads, T::SMEM, stream>>>(mq, mk, mv, t);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fma(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = swa_fma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seqlen + kT - 1) / kT, a.heads, a.batch);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(const Args& a, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_tc<D>(a, stream) : launch_fma<D>(a, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or a negative
// code the wrapper names: -1 a head dim without an instance, -2 no
// cuTensorMapEncodeTiled in the CUDA driver, -3 a tensor map it refused,
// -4 a layout the bf16 route does not take (the wrapper rejects those first).
// Instances: D in {32, 64, 128} (the reference configs' head dims and
// tests/test_kernels.py's sweep); bf16 runs swa_tc_kernel, fp32 swa_fma_kernel.
extern "C" int swa_attention_launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                                    int kv_heads, int seqlen, int head_dim, int window, int causal, int is_bf16,
                                    long long sq_b, long long sq_h, long long sq_s, long long sq_d,
                                    long long sk_b, long long sk_h, long long sk_s, long long sk_d,
                                    long long sv_b, long long sv_h, long long sv_s, long long sv_d,
                                    long long so_b, long long so_h, long long so_s, long long so_d, void* stream) {
  if (batch <= 0 || heads <= 0 || seqlen <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0) return kErrHeadDim;
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
    default: return kErrHeadDim;
  }
}
