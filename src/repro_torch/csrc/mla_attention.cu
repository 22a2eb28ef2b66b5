// Causal multi-head latent attention core (DeepSeek-V2's MLA) for Hopper
// (sm_90a), forward and backward, flash style: the (S, S) scores and
// probabilities never reach device memory.
//
// Replaces no TPU kernel: the JAX package has no MLA (the port wrote the
// architecture, models/attention.py::mla_forward).  The plain version it
// replaces on the card is kernels/ref.py::mla_attention_ref: per head,
//     o_i = sum_{j <= i} softmax_j(scale q_i . k_j) v_j
// with q, k (B, S, H, 192) (nope 128 + rope 64), v (B, S, H, 128), bf16, and
// the softmax scale of mla_softmax_scale (1/sqrt(192) times YaRN's mscale^2).
// swa_attention takes equal q, k and v widths and has no backward, so MLA
// gets its own kernels; they share hopper_tc.cuh's building blocks with it.
//
// Bound: operations.  At the LM cell's shapes (S = 2048, H = 16) the causal
// pairs need 21.5 GFLOP a sequence forward (S^2/2 H (192 + 128) 2) against
// 31 MB of q, k, v and o: 22 us on the bf16 tensor cores, 9 us on HBM.
// The plain path moves about 2.1 GB a sequence (fp32 scores, mask,
// softmax and casts over (S, S)).  The design keeps every product on wgmma
// (bf16 in, fp32 accumulators), skips the key tiles past the diagonal and
// keeps the scores in registers.
//
// Forward (mla_fwd_kernel): one block of two warpgroups owns a 128-row
//   query tile of one (batch, head), each warpgroup 64 rows, and walks the
//   128-key tiles up to the diagonal.  S = Q K^T is 12 wgmma m64n128k16 (Q
//   and K K-major in shared memory); the online softmax runs on the
//   accumulator fragment in fp32 (m and l in registers, 2^x on the SFU); P is
//   rounded to bf16 and, packed pair by pair, is the register A operand of
//   O += P V (V MN-major).  Only the diagonal tile and the tile past S are
//   masked.  Q stays resident, K and V arrive by TMA (128-byte swizzle, boxes
//   of 64 columns) through a ring of kStages stages.  O is written in
//   (B, S, H, 128), the layout o @ wo reads, and the log-sum-exp of each row,
//   fp32 (B, H, S_pad), for the backward.  Shared memory 209 KB: one block
//   an SM.  Blocks run head by head, each head's query tiles heaviest first:
//   the tiles of a head in flight together read its K and V (1.3 MB at S
//   2048) from L2, where blocks of distinct heads side by side would each
//   read them from HBM (2.8 GB for the probe's 16 x 16 heads: bound by
//   bytes), and the light tiles fill the tail.
//
// Backward: two kernels, one launch call, no atomics (runs repeat bit for
//   bit).  Each recomputes P = exp(scale S - lse) from q, k and the saved
//   log-sum-exp, and dP = dO V^T; dS = P (dP - D) scale with
//   D = rowsum(dO o O), rounded to bf16 for the products.
//   mla_dq_kernel: a block owns 128 query rows and walks 64-key tiles up to
//     the diagonal: S and dP (wgmma m64n64k16, shared-memory operands), then
//     dQ += dS K (m64n192k16, dS from registers, K MN-major).  It first
//     computes D for its rows from o and dO and writes it for the next kernel.
//   mla_dkdv_kernel: a block owns 128 keys (64 a warpgroup, accumulators
//     dK 64 x 192 and dV 64 x 128 in registers) and walks the 64-row query
//     tiles from the diagonal on: S^T = K Q^T and dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q (P^T and dS^T from registers; dO and Q
//     MN-major).  The query tiles' lse and D arrive beside them by bulk copy.
//   dQ as a second pass (recomputing S and dP: 1.6 times the products of
//   one pass with an fp32 atomic sum) keeps the sum in registers and its
//   order fixed.  dq, dk and dv each round once, to bf16, from fp32 sums of
//   bf16 products: their distance to an fp32 reference is that of dS's and
//   P's bf16 rounding (2^-9 relative) summed over the sequence.
//
// Rows and keys at or past S arrive as zeros (TMA fills them), are masked
// out of every sum that reaches a row below S, and are never written: S
// need not be a multiple of a tile.
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

// The launch's arguments, packed by kernels/mla_attention.py (_ARGS): the
// pointers, then (b, s, h) element strides of q, k, v, o, dO, dq, dk, dv,
// then the sizes.  lse and delta are (B, H, s_pad) fp32, s_pad a multiple
// of 128; delta is scratch for the backward.
struct MlaArgs {
  const void *q, *k, *v;
  void* o;
  const void* dout;
  void *lse, *delta, *dq, *dk, *dv, *stream;
  int64_t st[8][3];
  int batch, seqlen, heads, s_pad, direction;
  float scale;
};

namespace {

constexpr int DK = 192;         // q and k head dim (nope 128 + rope 64)
constexpr int DV = 128;         // v head dim
constexpr int kThreads = 256;   // two warpgroups of 64 rows each
constexpr int kStages = 2;      // tiles in flight in a ring
constexpr int SWB = 128;        // bytes of a swizzle row: 64 bf16 columns
constexpr int PW = 64;          // columns of a panel (one TMA box)
constexpr float kNeg = -1e30f;  // the running max before any live key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A bf16 tile of R rows x C columns in shared memory, as TMA writes it:
// C / 64 panels, each R rows of 128 bytes, 128-byte swizzled.
template <int R, int C>
struct Tile {
  static constexpr int PANEL = R * SWB;
  static constexpr int BYTES = R * C * 2;
};

// K-major operand of an R-row tile: the 16 columns of step kk for the rows
// from byte offset `row` of each panel (the operand's first row).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, uint32_t row, int kk) {
  const uint32_t addr = tile + (kk * 16 / PW) * (R * SWB) + row + (kk * 16 % PW) * 2;
  return make_desc(addr, 16, 8 * SWB, 1);
}

// MN-major operand (a B whose N axis is the tile's columns): the 16 rows of
// step kk; the next 64 columns one panel on.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * SWB, R * SWB, 8 * SWB, 1);
}

// Rows s0 .. s0+R-1 of head h, batch b, all C columns of a (B, S, H, C)
// operand whose map has boxes of (64, R): C / 64 boxes, one a panel.
template <int R, int C>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, const int* pos, uint32_t bar, int s0,
                                         int h, int b) {
  auto coord = [&](int axis) { return pos[0] == axis ? s0 : pos[1] == axis ? h : b; };
  const int c1 = coord(1), c2 = coord(2), c3 = coord(3);
#pragma unroll
  for (int p = 0; p < C / PW; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
        "[%6];\n" ::"r"(dst + p * Tile<R, C>::PANEL),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(p * PW), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
  }
}

// A plain bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
               : "memory");
}

// d (64 x N fp32) += A B: _ss reads A and B from shared memory, K-major,
// and starts from 0 when scale_d is 0; _rs takes A from registers and reads
// B MN-major.  (hopper_tc.cuh has the m64n128 forms.)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


struct KArgs {
  int batch, heads, seqlen, s_pad, n_tiles;  // n_tiles: the grid's tiles of S (query or key tiles)
  float scale, scale_log2;                   // the softmax scale, and it times log2(e)
  int pos_q[3], pos_k[3], pos_v[3], pos_do[3];  // each map's coordinate (1..3) of the S, H and B axes
  const __nv_bfloat16* o;                    // dq kernel: o and dO for D
  const __nv_bfloat16* dout;
  float* lse;    // (B, H, s_pad) fp32: written forward, read backward
  float* delta;  // (B, H, s_pad) fp32: D, written by the dq kernel, read by the dkdv kernel
  __nv_bfloat16* out0;  // forward O, dq kernel dQ, dkdv kernel dK
  __nv_bfloat16* out1;  // dkdv kernel dV
  int64_t s0_b, s0_s, s0_h, s1_b, s1_s, s1_h;  // out0's and out1's element strides
  int64_t so_b, so_s, so_h, sdo_b, sdo_s, sdo_h;  // o's and dO's
};

// The thread's place in a 64-row product (as in swa_attention.cu): rows
// ra = 16 (warp in group) + lane / 4 and ra + 8, columns 8 c + 2 (lane % 4)
// + {0, 1}; accumulator 4 c + {0, 1} at row ra, 4 c + {2, 3} at ra + 8.
// A k16 slice of such a fragment, packed pair by pair, is wgmma's register
// A operand, so P and dS go from one product to the next in registers.

__global__ void __launch_bounds__(kThreads, 1)
    mla_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const KArgs a) {
  using TQ = Tile<128, DK>;
  using TK = Tile<128, DK>;
  using TV = Tile<128, DV>;
  constexpr int NS = 64;  // score accumulators a thread (64 x 128)
  constexpr int NO = 64;  // output accumulators (64 x 128)
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;  // the 128B swizzle wants 1 KB-aligned tiles
  auto k_sh = [&](int st) { return q_sh + TQ::BYTES + st * (TK::BYTES + TV::BYTES); };
  auto v_sh = [&](int st) { return k_sh(st) + TK::BYTES; };
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  // a head's query tiles in turn, heaviest first: they share its K and V in L2
  const int qt = a.n_tiles - 1 - static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles), h = bh % a.heads, b = bh / a.heads;
  const int q0 = qt * 128, S = a.seqlen;
  const int n_kt = min(S - 1, q0 + 127) / 128 + 1;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  auto load_kv = [&](int t) {  // one thread: key tile t into stage t % kStages
    const int st = t % kStages;
    mbar_expect_tx(full_bar(st), TK::BYTES + TV::BYTES);
    tma_rows<128, DK>(k_sh(st), &mk, a.pos_k, full_bar(st), 128 * t, h, b);
    tma_rows<128, DV>(v_sh(st), &mv, a.pos_v, full_bar(st), 128 * t, h, b);
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full_bar(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, TQ::BYTES);
    tma_rows<128, DK>(q_sh, &mq, a.pos_q, q_bar, q0, h, b);
    for (int t = 0; t < min(kStages, n_kt); ++t) load_kv(t);
  }

  const int ra = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int i_a = q0 + 64 * wg + ra, i_b = i_a + 8;  // this thread's two query rows
  const int r_lo = q0 + 64 * wg;                      // the warpgroup's first row
  const uint32_t q_rows = 64 * wg * SWB;              // the warpgroup's rows in each Q panel
  const float sl2 = a.scale_log2;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;  // running max (log2 units) and fp32 sum
  float s[NS], o[NO];
  uint32_t p[NS / 2];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kStages, j0 = 128 * t;
    mbar_wait(full_bar(st), (t / kStages) & 1);

#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      wgmma_ss_n128(s, desc_k<128>(q_sh, q_rows, kk), desc_k<128>(k_sh(st), 0, kk), kk > 0);
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_reg(s[i]);

    if (j0 + 128 > S || j0 + 127 > r_lo) {  // the diagonal tile, or the tile past S
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = j0 + 8 * (i / 4) + col0 + (i & 1), row = (i & 2) ? i_b : i_a;
        if (j >= S || j > row) s[i] = -INFINITY;
      }
    }

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

#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) fence_reg(p[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk) wgmma_rs_n128(o, &p[4 * kk], desc_mn<128>(v_sh(st), kk));
    wgmma_commit_and_wait();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);

    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && t + kStages < n_kt) load_kv(t + kStages);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // every row below S has key 0 live, so l >= 1; rows at or past S read 0
  if (lane % 4 == 0) {
    float* lse = a.lse + static_cast<int64_t>(bh) * a.s_pad;
    lse[i_a] = i_a < S ? (m_a + log2f(l_a)) * kLn2 : 0.f;
    lse[i_b] = i_b < S ? (m_b + log2f(l_b)) * kLn2 : 0.f;
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* out = a.out0 + b * a.s0_b + h * a.s0_h + col0;
  if (i_a < S) {
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_a * a.s0_s + 8 * c) =
          __floats2bfloat162_rn(o[4 * c] * inv_a, o[4 * c + 1] * inv_a);
    }
  }
  if (i_b < S) {
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_b * a.s0_s + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b);
    }
  }
}

// sum_c dO[i, c] o[i, c] over this thread's quarter of row i's 128 columns
// (32 of them, four 16-byte loads of each); 0 at or past S.
__device__ __forceinline__ float row_delta_part(const KArgs& a, int b, int h, int i, int quarter) {
  if (i >= a.seqlen) return 0.f;
  const uint4* o = reinterpret_cast<const uint4*>(a.o + b * a.so_b + i * a.so_s + h * a.so_h + 32 * quarter);
  const uint4* g = reinterpret_cast<const uint4*>(a.dout + b * a.sdo_b + i * a.sdo_s + h * a.sdo_h + 32 * quarter);
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 ov = o[v], gv = g[v];
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(op[e]), gf = __bfloat1622float2(gp[e]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo, const KArgs a) {
  using TQ = Tile<128, DK>;
  using TDO = Tile<128, DV>;
  using TK = Tile<64, DK>;
  using TV = Tile<64, DV>;
  constexpr int NS = 32;  // S and dP accumulators a thread (64 x 64)
  constexpr int NQ = 96;  // dQ accumulators (64 x 192)
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_sh = q_sh + TQ::BYTES;
  auto k_sh = [&](int st) { return do_sh + TDO::BYTES + st * (TK::BYTES + TV::BYTES); };
  auto v_sh = [&](int st) { return k_sh(st) + TK::BYTES; };
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  // a head's query tiles in turn, heaviest first: they share its K and V in L2
  const int qt = a.n_tiles - 1 - static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles), h = bh % a.heads, b = bh / a.heads;
  const int q0 = qt * 128, S = a.seqlen;
  const int n_kt = min(S - 1, q0 + 127) / 64 + 1;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mbar_expect_tx(full_bar(st), TK::BYTES + TV::BYTES);
    tma_rows<64, DK>(k_sh(st), &mk, a.pos_k, full_bar(st), 64 * t, h, b);
    tma_rows<64, DV>(v_sh(st), &mv, a.pos_v, full_bar(st), 64 * t, h, b);
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full_bar(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, TQ::BYTES + TDO::BYTES);
    tma_rows<128, DK>(q_sh, &mq, a.pos_q, q_bar, q0, h, b);
    tma_rows<128, DV>(do_sh, &mdo, a.pos_do, q_bar, q0, h, b);
    for (int t = 0; t < min(kStages, n_kt); ++t) load_kv(t);
  }

  const int ra = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int i_a = q0 + 64 * wg + ra, i_b = i_a + 8;
  const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;
  const uint32_t q_rows = 64 * wg * SWB;
  const float sl2 = a.scale_log2, scale = a.scale;

  // D of this thread's two rows, while the tiles load; written for the dkdv kernel
  float d_a = row_delta_part(a, b, h, i_a, lane % 4), d_b = row_delta_part(a, b, h, i_b, lane % 4);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
  }
  const int64_t row0 = static_cast<int64_t>(bh) * a.s_pad;
  if (lane % 4 == 0) {
    a.delta[row0 + i_a] = d_a;
    a.delta[row0 + i_b] = d_b;
  }
  const float lse_a = i_a < S ? a.lse[row0 + i_a] * kLog2e : 0.f;  // log2 units
  const float lse_b = i_b < S ? a.lse[row0 + i_b] * kLog2e : 0.f;

  float s[NS], dp[NS], dq[NQ];
  uint32_t ds[NS / 2];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) dq[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kStages, j0 = 64 * t;
    mbar_wait(full_bar(st), (t / kStages) & 1);
    if (j0 <= r_hi) {  // else every key of the tile lies past the warpgroup's rows
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        wgmma_ss_n64(s, desc_k<128>(q_sh, q_rows, kk), desc_k<64>(k_sh(st), 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        wgmma_ss_n64(dp, desc_k<128>(do_sh, q_rows, kk), desc_k<64>(v_sh(st), 0, kk), kk > 0);
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }

      const bool need_mask = j0 + 64 > S || j0 + 63 > r_lo;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {  // pair i: accumulators 2i, 2i+1, row b when i is odd
        const int j = j0 + 8 * (i / 2) + col0, row = (i & 1) ? i_b : i_a;
        const float lrow = (i & 1) ? lse_b : lse_a, drow = (i & 1) ? d_b : d_a;
        float p0 = ex2(fmaf(s[2 * i], sl2, -lrow)), p1 = ex2(fmaf(s[2 * i + 1], sl2, -lrow));
        if (need_mask) {
          if (j >= S || j > row) p0 = 0.f;
          if (j + 1 >= S || j + 1 > row) p1 = 0.f;
        }
        ds[i] = pack_bf16x2(p0 * (dp[2 * i] - drow) * scale, p1 * (dp[2 * i + 1] - drow) * scale);
      }

#pragma unroll
      for (int i = 0; i < NQ; ++i) fence_reg(dq[i]);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) fence_reg(ds[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) wgmma_rs_n192(dq, &ds[4 * kk], desc_mn<64>(k_sh(st), kk));
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < NQ; ++i) fence_reg(dq[i]);
    }
    __syncthreads();
    if (tid == 0 && t + kStages < n_kt) load_kv(t + kStages);
  }

  __nv_bfloat16* out = a.out0 + b * a.s0_b + h * a.s0_h + col0;
  if (i_a < S) {
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_a * a.s0_s + 8 * c) = __floats2bfloat162_rn(dq[4 * c], dq[4 * c + 1]);
    }
  }
  if (i_b < S) {
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + i_b * a.s0_s + 8 * c) =
          __floats2bfloat162_rn(dq[4 * c + 2], dq[4 * c + 3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_dkdv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo, const KArgs a) {
  using TK = Tile<128, DK>;
  using TV = Tile<128, DV>;
  using TQ = Tile<64, DK>;
  using TDO = Tile<64, DV>;
  constexpr int NS = 32;  // S^T and dP^T accumulators a thread (64 keys x 64 queries)
  constexpr int NK = 96;  // dK accumulators (64 x 192)
  constexpr int NV = 64;  // dV accumulators (64 x 128)
  constexpr int STAGE = TQ::BYTES + TDO::BYTES;
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t k_sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base = smem_raw + (k_sh - smem_u32(smem_raw));  // the same address, generic
  const uint32_t v_sh = k_sh + TK::BYTES;
  auto q_sh = [&](int st) { return v_sh + TV::BYTES + st * STAGE; };
  auto do_sh = [&](int st) { return q_sh(st) + TQ::BYTES; };
  // each stage's 64 lse and 64 D values, after the tiles
  constexpr int ROWS_OFF = TK::BYTES + TV::BYTES + kStages * STAGE;
  auto rows_sh = [&](int st) { return k_sh + ROWS_OFF + st * 512; };
  auto rows_ptr = [&](int st) { return reinterpret_cast<const float*>(base + ROWS_OFF + st * 512); };
  const uint32_t kv_bar = smem_u32(&bars[0]);
  auto full_bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  // a head's key tiles in turn, heaviest first (the first keys see every
  // query): they share its Q, dO, lse and D in L2
  const int kt = static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles), h = bh % a.heads, b = bh / a.heads;
  const int k0 = kt * 128, S = a.seqlen;
  const int n_qt = (S - 1 - k0) / 64 + 1;  // query tiles from the diagonal on
  const int64_t row0 = static_cast<int64_t>(bh) * a.s_pad;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  auto load_q = [&](int t) {
    const int st = t % kStages, i0 = k0 + 64 * t;
    mbar_expect_tx(full_bar(st), STAGE + 512);
    tma_rows<64, DK>(q_sh(st), &mq, a.pos_q, full_bar(st), i0, h, b);
    tma_rows<64, DV>(do_sh(st), &mdo, a.pos_do, full_bar(st), i0, h, b);
    bulk_copy(rows_sh(st), a.lse + row0 + i0, 256, full_bar(st));
    bulk_copy(rows_sh(st) + 256, a.delta + row0 + i0, 256, full_bar(st));
  };
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full_bar(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, TK::BYTES + TV::BYTES);
    tma_rows<128, DK>(k_sh, &mk, a.pos_k, kv_bar, k0, h, b);
    tma_rows<128, DV>(v_sh, &mv, a.pos_v, kv_bar, k0, h, b);
    for (int t = 0; t < min(kStages, n_qt); ++t) load_q(t);
  }

  const int ra = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  const int j_a = k0 + 64 * wg + ra, j_b = j_a + 8;  // this thread's two keys
  const int c_lo = k0 + 64 * wg, c_hi = c_lo + 63;   // the warpgroup's keys
  const uint32_t k_rows = 64 * wg * SWB;
  const float sl2 = a.scale_log2, scale = a.scale;

  float s[NS], dp[NS], dk[NK], dv[NV];
  uint32_t pp[NS / 2], ds[NS / 2];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NK; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) dv[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_qt; ++t) {
    const int st = t % kStages, i0 = k0 + 64 * t;
    mbar_wait(full_bar(st), (t / kStages) & 1);
    if (c_lo <= i0 + 63) {  // else every query of the tile lies before the warpgroup's keys
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        wgmma_ss_n64(s, desc_k<128>(k_sh, k_rows, kk), desc_k<64>(q_sh(st), 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        wgmma_ss_n64(dp, desc_k<128>(v_sh, k_rows, kk), desc_k<64>(do_sh(st), 0, kk), kk > 0);
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }

      const float* lse_t = rows_ptr(st);
      const float* d_t = lse_t + 64;
      const bool need_mask = i0 + 64 > S || c_hi > i0;
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {  // pair i: accumulators 2i, 2i+1 (queries c, c + 1), key b when i is odd
        const int c = 8 * (i / 2) + col0, key = (i & 1) ? j_b : j_a;
        const float l0 = lse_t[c] * kLog2e, l1 = lse_t[c + 1] * kLog2e;
        float p0 = ex2(fmaf(s[2 * i], sl2, -l0)), p1 = ex2(fmaf(s[2 * i + 1], sl2, -l1));
        if (need_mask) {
          if (i0 + c >= S || key > i0 + c) p0 = 0.f;
          if (i0 + c + 1 >= S || key > i0 + c + 1) p1 = 0.f;
        }
        pp[i] = pack_bf16x2(p0, p1);
        ds[i] = pack_bf16x2(p0 * (dp[2 * i] - d_t[c]) * scale, p1 * (dp[2 * i + 1] - d_t[c + 1]) * scale);
      }

#pragma unroll
      for (int i = 0; i < NV; ++i) fence_reg(dv[i]);
#pragma unroll
      for (int i = 0; i < NK; ++i) fence_reg(dk[i]);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        fence_reg(pp[i]);
        fence_reg(ds[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) wgmma_rs_n128(dv, &pp[4 * kk], desc_mn<64>(do_sh(st), kk));
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) wgmma_rs_n192(dk, &ds[4 * kk], desc_mn<64>(q_sh(st), kk));
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < NV; ++i) fence_reg(dv[i]);
#pragma unroll
      for (int i = 0; i < NK; ++i) fence_reg(dk[i]);
    }
    __syncthreads();
    if (tid == 0 && t + kStages < n_qt) load_q(t + kStages);
  }

  __nv_bfloat16* gk = a.out0 + b * a.s0_b + h * a.s0_h + col0;
  __nv_bfloat16* gv = a.out1 + b * a.s1_b + h * a.s1_h + col0;
  if (j_a < S) {
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(gk + j_a * a.s0_s + 8 * c) = __floats2bfloat162_rn(dk[4 * c], dk[4 * c + 1]);
    }
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(gv + j_a * a.s1_s + 8 * c) = __floats2bfloat162_rn(dv[4 * c], dv[4 * c + 1]);
    }
  }
  if (j_b < S) {
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(gk + j_b * a.s0_s + 8 * c) =
          __floats2bfloat162_rn(dk[4 * c + 2], dk[4 * c + 3]);
    }
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(gv + j_b * a.s1_s + 8 * c) =
          __floats2bfloat162_rn(dv[4 * c + 2], dv[4 * c + 3]);
    }
  }
}

// The tensor map of one (B, S, H, C) bf16 operand with element strides s_b,
// s_s, s_h (C contiguous): dims (C, then S, H and B in the order of their
// strides), boxes of (64, rows).  pos receives the map coordinate (1..3) of
// S, H and B.  A dim of size 1 is never stepped, so it gets the largest
// stride, which TMA accepts.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int cols, int rows, int batch, int heads,
              int seqlen, int64_t s_b, int64_t s_s, int64_t s_h, int* pos) {
  struct Axis {
    uint64_t size, stride;
    int role;  // 0 = S, 1 = H, 2 = B
  };
  Axis ax[3] = {{static_cast<uint64_t>(seqlen), static_cast<uint64_t>(s_s) * 2, 0},
                {static_cast<uint64_t>(heads), static_cast<uint64_t>(s_h) * 2, 1},
                {static_cast<uint64_t>(batch), static_cast<uint64_t>(s_b) * 2, 2}};
  uint64_t span = static_cast<uint64_t>(cols) * 2;
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
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), ax[0].size, ax[1].size, ax[2].size};
  const cuuint64_t strides[3] = {ax[0].stride, ax[1].stride, ax[2].stride};
  cuuint32_t box[4] = {PW, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    pos[ax[k].role] = k + 1;
    if (ax[k].role == 0) box[k + 1] = static_cast<cuuint32_t>(rows);
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

constexpr int kErrDriver = -2, kErrTensorMap = -3, kErrLayout = -4, kErrDirection = -5;
enum Operand { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };  // rows of MlaArgs::st

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success), or a negative
// code the wrapper names: -2 no cuTensorMapEncodeTiled in the CUDA driver,
// -3 a tensor map it refused, -4 a grid too large, -5 an unknown direction.
// direction 0: forward (o, lse); 1: backward (dq, dk, dv; delta as scratch),
// the dq kernel then the dkdv kernel on the one stream.
extern "C" int mla_attention_launch(const MlaArgs* a) {
  if (a->batch <= 0 || a->heads <= 0 || a->seqlen <= 0) return 0;
  if (a->direction != 0 && a->direction != 1) return kErrDirection;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrDriver;
  const int B = a->batch, S = a->seqlen, H = a->heads;
  auto map = [&](CUtensorMap* m, const void* ptr, int which, int cols, int rows, int* pos) {
    return make_map(encode, m, ptr, cols, rows, B, H, S, a->st[which][0], a->st[which][1], a->st[which][2], pos);
  };
  KArgs k{};
  k.batch = B;
  k.heads = H;
  k.seqlen = S;
  k.s_pad = a->s_pad;
  k.scale = a->scale;
  k.scale_log2 = a->scale * kLog2e;
  k.lse = static_cast<float*>(a->lse);
  k.delta = static_cast<float*>(a->delta);
  const int64_t n_bh = static_cast<int64_t>(B) * H;
  const int n128 = (S + 127) / 128;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  auto out = [&](int which, __nv_bfloat16*& ptr, void* p, int64_t& sb, int64_t& ss, int64_t& sh) {
    ptr = static_cast<__nv_bfloat16*>(p);
    sb = a->st[which][0];
    ss = a->st[which][1];
    sh = a->st[which][2];
  };
  CUtensorMap mq, mk, mv, mdo;
  if (a->direction == 0) {
    if (!map(&mq, a->q, kQ, DK, 128, k.pos_q) || !map(&mk, a->k, kK, DK, 128, k.pos_k) ||
        !map(&mv, a->v, kV, DV, 128, k.pos_v)) {
      return kErrTensorMap;
    }
    k.n_tiles = n128;
    out(kO, k.out0, a->o, k.s0_b, k.s0_s, k.s0_h);
    const int smem = 1024 + Tile<128, DK>::BYTES + kStages * (Tile<128, DK>::BYTES + Tile<128, DV>::BYTES);
    if (n128 * n_bh >= (int64_t{1} << 31)) return kErrLayout;
    cudaError_t err = cudaFuncSetAttribute(mla_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mla_fwd_kernel<<<static_cast<unsigned>(n128 * n_bh), kThreads, smem, stream>>>(mq, mk, mv, k);
    return static_cast<int>(cudaGetLastError());
  }

  // backward: dQ (and D) over query tiles of 128 ...
  k.o = static_cast<const __nv_bfloat16*>(a->o);
  k.dout = static_cast<const __nv_bfloat16*>(a->dout);
  k.so_b = a->st[kO][0];
  k.so_s = a->st[kO][1];
  k.so_h = a->st[kO][2];
  k.sdo_b = a->st[kDO][0];
  k.sdo_s = a->st[kDO][1];
  k.sdo_h = a->st[kDO][2];
  if (n128 * n_bh >= (int64_t{1} << 31)) return kErrLayout;
  if (!map(&mq, a->q, kQ, DK, 128, k.pos_q) || !map(&mk, a->k, kK, DK, 64, k.pos_k) ||
      !map(&mv, a->v, kV, DV, 64, k.pos_v) || !map(&mdo, a->dout, kDO, DV, 128, k.pos_do)) {
    return kErrTensorMap;
  }
  k.n_tiles = n128;
  out(kDQ, k.out0, a->dq, k.s0_b, k.s0_s, k.s0_h);
  int smem =
      1024 + Tile<128, DK>::BYTES + Tile<128, DV>::BYTES + kStages * (Tile<64, DK>::BYTES + Tile<64, DV>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(mla_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_dq_kernel<<<static_cast<unsigned>(n128 * n_bh), kThreads, smem, stream>>>(mq, mk, mv, mdo, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // ... then dK and dV over key tiles of 128, reading D
  CUtensorMap mq2, mk2, mv2, mdo2;
  if (!map(&mq2, a->q, kQ, DK, 64, k.pos_q) || !map(&mk2, a->k, kK, DK, 128, k.pos_k) ||
      !map(&mv2, a->v, kV, DV, 128, k.pos_v) || !map(&mdo2, a->dout, kDO, DV, 64, k.pos_do)) {
    return kErrTensorMap;
  }
  out(kDK, k.out0, a->dk, k.s0_b, k.s0_s, k.s0_h);
  out(kDV, k.out1, a->dv, k.s1_b, k.s1_s, k.s1_h);
  smem = 1024 + Tile<128, DK>::BYTES + Tile<128, DV>::BYTES +
         kStages * (Tile<64, DK>::BYTES + Tile<64, DV>::BYTES + 512);
  err = cudaFuncSetAttribute(mla_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_dkdv_kernel<<<static_cast<unsigned>(n128 * n_bh), kThreads, smem, stream>>>(mq2, mk2, mv2, mdo2, k);
  return static_cast<int>(cudaGetLastError());
}
