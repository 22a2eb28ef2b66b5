// Lane-batched 3x3 convolution, stride 1, padding 1, fp32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its CNN's convolutions to
// XLA (src/repro/models/cnn.py, jax.lax.conv_general_dilated), and the
// port's plain route is cuDNN's.  It serves local training, where
// torch.func.vmap batches a client's forward and backward over lanes that
// each hold their own weights.  There vmap turns every F.conv2d and its
// backward into a cuDNN grouped convolution with groups = lanes, whose fp32
// engines loop over the lanes (about 47 kernels a lane and SGD step) and
// reshuffle layouts.  Here one launch covers every lane, per layer and
// direction, each lane an implicit GEMM with its own weights:
//   forward      y[p][n]       = b[n] + sum_{tap,c} x[p + tap][c] * w[n][c][tap]
//   input grad   dx[p][c]      = sum_{tap,n} dy[p - tap][n] * w[n][c][tap]
//   weight grad  dw[n][c][tap] = sum_p dy[p][n] * x[p + tap][c],  db[n] = sum_p dy[p][n]
// Activations are NHWC within a lane, (B, H, W, C); weights OIHW,
// (Cout, Cin, 3, 3), as the model stores them.  Strict fp32: every product
// is an fmaf in fp32, nothing in TF32 or lower; only the order of the sums
// differs from cuDNN's.  Bound: operations over the fp32 peak without
// tensor cores (67 TFLOP/s); at the paper's widths every layer but the first
// does about 70 FLOP a byte it must move.
//
// Forward and input gradient (conv_mn_kernel): a direct convolution.  A
// block owns a pixel tile (whole rows of one or more images, at most BM
// pixels) and BN output channels, and walks the summed channels CK at a
// time.  Each step copies by cp.async, into a two-stage ring, the tile's
// input patch with its one-pixel halo (zeros outside the image) and the
// step's 9 x CK x BN weights; the 9 taps then read the patch at 9 offsets.
// So an input pixel comes from memory once a tile, not 9 times as an im2col
// reads it, and no im2col buffer is ever written.  A thread keeps TM pixels
// x TN channels in registers and reads 16 bytes at a time: 4 channels of a
// patch pixel, 4 output channels of a weight row.  The weights are stored
// transposed, [tap][k][n], by 4-byte copies from the OIHW rows; the 4-float
// groups of a row are XOR-swizzled by its tap so that those copies, and the
// reads, fall on distinct banks.
//
// Weight gradient (conv_wgrad_kernel): a block owns 32 output channels x
// 8 * CQ input channels x the 9 taps, and sums over the lane's pixels, one
// pixel tile a step (dy's tile and x's haloed patch).  Thread (tap, nq, cq)
// keeps 4 x 8 sums; the 9 taps read the one patch.  The blocks of the first
// input-channel tile also sum db from the same dy tiles, in a fixed order.
// Few lanes leave few blocks, so the sum over pixels is split over the
// `split` blocks of a thread-block cluster, and rank r adds slice r of the
// tile from every rank's shared memory in rank order: the same bits every
// run, no scratch memory, no atomics.
//
// The wrapper (kernels/conv_lanes.py, plan) chooses the tiles and the split
// from the shapes and passes them in ConvArgs; the launcher checks them
// against the instances compiled here and refuses the rest.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// The launcher's one argument (struct.Struct("6Q3q12i") in kernels/conv_lanes.py: change both together).
struct ConvArgs {
  const float* src;   // forward: x; input grad: dy; weight grad: dy.  (L, B, H, W, C), each lane dense
  const float* aux;   // forward, input grad: w (L, Cout, Cin, 3, 3); weight grad: x (L, B, H, W, Cin)
  const float* bias;  // forward: (L, Cout), or null
  float* out;         // forward: y (L, B, H, W, Cout); input grad: dx (L, B, H, W, Cin); weight grad: dw
  float* out_bias;    // weight grad: db (L, Cout)
  void* stream;
  int64_t src_lane, aux_lane, bias_lane;  // lane strides in elements (0: one tensor for every lane)
  int lanes, batch, height, width, cin, cout;
  int direction;  // 0 forward, 1 input gradient, 2 weight gradient
  int bn;         // forward, input grad: output channels a block (32, 64, 128); weight grad: 8 * CQ (8, 32)
  int ck;         // forward, input grad: summed channels a step (4, 8, 16)
  int imgs, rows; // the pixel tile: `imgs` images of `rows` rows, whole width
  int split;      // weight grad: blocks of a cluster sharing one tile's sum (1, 2, 4, 8)
};

namespace {

constexpr int kThreads = 256;        // forward and input grad
constexpr int kMaxSmem = 232448;     // bytes a block may use on sm_90
constexpr int kMaxDevices = 64;
constexpr int kWgradN = 32;          // output channels a weight-grad block (NQ = 8 groups of 4)
constexpr int kWgradPixels = 128;    // pixels a weight-grad tile

struct Geom {
  int B, H, W;
  int kc;    // channels summed: forward Cin, input grad Cout; weight grad: Cin
  int n;     // channels out: forward Cout, input grad Cin; weight grad: Cout
  int cin;   // the weights' Cin
  int imgs, rows, row_tiles;
  int pw;    // patch width, W + 2
  int ppx;   // patch pixels, imgs * (rows + 2) * (W + 2)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The 4-float group that group q of a weight row of tap `tap` lands on is
// q ^ swizzle(tap).  A warp step copies 8 consecutive (k, tap) of 4 output
// channels (forward) or 32 consecutive (n, tap) of one summed channel (input
// grad): consecutive taps, so distinct groups, but for tap 8 beside tap 0.
__device__ __forceinline__ int swizzle(int tap) { return tap & 7; }

// Copies one pixel tile's haloed patch, channels [c0, c0 + 4 * Q) of every
// pixel at `stride` floats a pixel, zeros outside the image and past C.
template <int Q, int kBlock>
__device__ __forceinline__ void load_patch(float* patch, int stride, const float* src, const Geom& g, int C,
                                           int b0, int row0, int c0, bool vec, int tid) {
  const int plane = (g.rows + 2) * g.pw;
  for (int e = tid; e < g.ppx * Q; e += kBlock) {
    const int px = e / Q, q = e - px * Q;
    const int img = px / plane, rem = px - img * plane;
    const int pr = rem / g.pw, pc = rem - pr * g.pw;
    const int b = b0 + img, y = row0 + pr - 1, x = pc - 1, c = c0 + 4 * q;
    const bool inside = b < g.B && y >= 0 && y < g.H && x >= 0 && x < g.W;
    const float* from = inside ? src + ((static_cast<int64_t>(b) * g.H + y) * g.W + x) * C + c : src;
    float* to = patch + px * stride + 4 * q;
    if (vec) {
      cp_async16(to, from, inside && c < C);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = inside && c + u < C;
        cp_async4(to + u, ok ? from + u : src, ok);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward (kDir 0) and input gradient (kDir 1).  Grid: (pixel tiles of a
// lane, ceil(n / BN), lanes); kThreads a block, thread (tm, tn) owns pixels
// tm + i * MT and output channels 4 * (tn + j * NT) + 0..3.
template <int kDir, int BM, int BN, int TM, int TN, int CK>
__global__ void __launch_bounds__(kThreads, 2)
    conv_mn_kernel(const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int64_t src_lane, int64_t w_lane, int64_t bias_lane, Geom g) {
  constexpr int NT = BN / TN, MT = BM / TM, CKP = CK + 4, KROWS = 9 * CK;
  static_assert(NT * MT == kThreads, "one thread a TM x TN tile");
  static_assert(TN % 4 == 0 && CK % 4 == 0 && NT % 8 == 0, "16-byte reads; the swizzle spans 8 groups of 4");
  extern __shared__ __align__(16) float smem[];
  const int patch_floats = g.ppx * CKP;
  const int stage_floats = patch_floats + KROWS * BN;

  const int64_t lane = blockIdx.z;
  src += lane * src_lane;
  w += lane * w_lane;
  const int b0 = (blockIdx.x / g.row_tiles) * g.imgs;
  const int row0 = (blockIdx.x % g.row_tiles) * g.rows;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tn = tid % NT, tm = tid / NT;
  const int warp = tid / 32, ln = tid % 32;

  // each pixel's patch offset at tap (0, 0); pixels past the tile read pixel 0 and are not stored
  const int tile_px = g.imgs * g.rows * g.W;
  int base[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tm + i * MT;
    base[i] = 0;
    if (m < tile_px) {
      const int img = m / (g.rows * g.W), rem = m - img * g.rows * g.W;
      const int rr = rem / g.W, cc = rem - rr * g.W;
      base[i] = ((img * (g.rows + 2) + rr) * g.pw + cc) * CKP;
    }
  }

  const bool vec = g.kc % 4 == 0;
  auto load = [&](int stage, int step) {
    float* patch = smem + stage * stage_floats;
    float* bt = patch + patch_floats;
    const int k0 = step * CK;
    load_patch<CK / 4, kThreads>(patch, CKP, src, g, g.kc, b0, row0, k0, vec, tid);
    if (kDir == 0) {
      // rows w[n][k0 .. k0 + CK)[9]: 9 * CK contiguous floats; a warp step copies RW of them from 32 / RW rows
      constexpr int RW = KROWS % 8 == 0 ? 8 : 4, NPW = 32 / RW;
      const int nsub = ln / RW, rsub = ln % RW;
#pragma unroll 1
      for (int rb = 0; rb < KROWS / RW; ++rb) {
        const int r = rb * RW + rsub, kc = r / 9, tap = r - 9 * kc;
        const int sw = swizzle(tap) << 2;
        float* to = bt + (tap * CK + kc) * BN;
        const bool kvalid = k0 + kc < g.kc;
        const float* from = w + static_cast<int64_t>(k0) * 9 + r;
        for (int nb = warp; nb < BN / NPW; nb += kThreads / 32) {
          const int n = nb * NPW + nsub;
          const bool ok = kvalid && n0 + n < g.n;
          cp_async4(to + (n ^ sw), ok ? from + static_cast<int64_t>(n0 + n) * g.cin * 9 : w, ok);
        }
      }
    } else {
      // rows w[k0 + kc][n0 .. n0 + BN)[9]: 9 * BN contiguous floats; a warp step copies 32 of one row
      for (int rb = warp; rb < 9 * BN / 32; rb += kThreads / 32) {
        const int r = rb * 32 + ln, j = r / 9, tap = r - 9 * j;
        const int col = j ^ (swizzle(tap) << 2);
        const bool jvalid = n0 + j < g.n;
        const float* from = w + static_cast<int64_t>(k0) * g.cin * 9 + static_cast<int64_t>(n0) * 9 + r;
#pragma unroll 4
        for (int kc = 0; kc < CK; ++kc) {
          const bool ok = jvalid && k0 + kc < g.kc;
          cp_async4(bt + (tap * CK + kc) * BN + col, ok ? from + static_cast<int64_t>(kc) * g.cin * 9 : w, ok);
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int steps = (g.kc + CK - 1) / CK;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      load((t + 1) & 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* patch = smem + (t & 1) * stage_floats;
    const float* bt = patch + patch_floats;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int r = tap / 3, s = tap - 3 * r;
      // forward: input pixel (y + r - 1, x + s - 1); input grad: dy pixel (y + 1 - r, x + 1 - s)
      const float* pt = patch + (kDir == 0 ? r * g.pw + s : (2 - r) * g.pw + (2 - s)) * CKP;
      // NT is a multiple of 8, so (tn + j * NT) ^ sw = (tn ^ sw) + j * NT
      const float* brow = bt + tap * CK * BN + 4 * (tn ^ swizzle(tap));
#pragma unroll
      for (int kq = 0; kq < CK / 4; ++kq) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(pt + base[i] + 4 * kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kc = 4 * kq + kk;
          float4 b[TN / 4];
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) b[j] = *reinterpret_cast<const float4*>(brow + kc * BN + 4 * j * NT);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = part(a[i], kk);
#pragma unroll
            for (int j = 0; j < TN / 4; ++j) {
              acc[i][4 * j + 0] = fmaf(av, b[j].x, acc[i][4 * j + 0]);
              acc[i][4 * j + 1] = fmaf(av, b[j].y, acc[i][4 * j + 1]);
              acc[i][4 * j + 2] = fmaf(av, b[j].z, acc[i][4 * j + 2]);
              acc[i][4 * j + 3] = fmaf(av, b[j].w, acc[i][4 * j + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: (+ bias), NHWC rows of n channels
  float* o = out + lane * static_cast<int64_t>(g.B) * g.H * g.W * g.n;
  const float* bl = (kDir == 0 && bias != nullptr) ? bias + lane * bias_lane : nullptr;
  const bool vec_out = g.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tm + i * MT;
    if (m >= tile_px) continue;
    const int img = m / (g.rows * g.W), rem = m - img * g.rows * g.W;
    const int rr = rem / g.W, cc = rem - rr * g.W;
    const int b = b0 + img, y = row0 + rr;
    if (b >= g.B || y >= g.H) continue;
    float* orow = o + ((static_cast<int64_t>(b) * g.H + y) * g.W + cc) * g.n;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int n = n0 + 4 * (tn + j * NT);
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = acc[i][4 * j + u] + (bl != nullptr && n + u < g.n ? bl[n + u] : 0.f);
      if (vec_out && n + 3 < g.n) {
        *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < g.n) orow[n + u] = v[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient.  Grid: (split, tiles of 32 output x 8 * CQ input channels,
// lanes), clusters of `split` along x; 9 * 8 * CQ threads, thread (tap, nq,
// cq) owns dw[n0 + 4 nq + 0..3][c0 + 8 cq + 0..7][tap].
template <int CQ>
__global__ void __launch_bounds__(9 * 8 * CQ)
    conv_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x, float* __restrict__ dw,
                      float* __restrict__ db, int64_t dy_lane, int64_t x_lane, Geom g, int split) {
  constexpr int NQ = kWgradN / 4, BC = 8 * CQ, THREADS = 9 * NQ * CQ;
  constexpr int DYP = kWgradN + 4, XP = BC + 4;
  constexpr int BIAS_ITEMS = 9 * kWgradN, BIAS_PER = (BIAS_ITEMS + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) float smem[];
  const int tile_px = g.imgs * g.rows * g.W;
  const int dy_floats = tile_px * DYP;
  const int stage_floats = dy_floats + g.ppx * XP;

  const int64_t lane = blockIdx.z;
  dy += lane * dy_lane;
  x += lane * x_lane;
  const int tiles_n = (g.n + kWgradN - 1) / kWgradN;
  const int n0 = (blockIdx.y % tiles_n) * kWgradN, c0 = (blockIdx.y / tiles_n) * BC;
  const bool with_bias = blockIdx.y < tiles_n;  // the first input-channel tile sums db
  const int tid = threadIdx.x, tap = tid / (NQ * CQ), nq = (tid / CQ) % NQ, cq = tid % CQ;
  const int r = tap / 3, s = tap - 3 * r;
  const int ktiles = ((g.B + g.imgs - 1) / g.imgs) * g.row_tiles;
  const int rank = blockIdx.x;
  const int kt0 = rank * ktiles / split, kt1 = (rank + 1) * ktiles / split;
  const bool vec_dy = g.n % 4 == 0, vec_x = g.kc % 4 == 0;

  auto load = [&](int stage, int kt) {
    float* dyt = smem + stage * stage_floats;
    float* pt = dyt + dy_floats;
    const int b0 = (kt / g.row_tiles) * g.imgs, row0 = (kt % g.row_tiles) * g.rows;
    for (int e = tid; e < tile_px * (kWgradN / 4); e += THREADS) {
      const int m = e / (kWgradN / 4), q = e - m * (kWgradN / 4);
      const int img = m / (g.rows * g.W), rem = m - img * g.rows * g.W;
      const int rr = rem / g.W, cc = rem - rr * g.W;
      const int b = b0 + img, y = row0 + rr, n = n0 + 4 * q;
      const bool inside = b < g.B && y < g.H;
      const float* from = inside ? dy + ((static_cast<int64_t>(b) * g.H + y) * g.W + cc) * g.n + n : dy;
      float* to = dyt + m * DYP + 4 * q;
      if (vec_dy) {
        cp_async16(to, from, inside && n < g.n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = inside && n + u < g.n;
          cp_async4(to + u, ok ? from + u : dy, ok);
        }
      }
    }
    load_patch<BC / 4, THREADS>(pt, XP, x, g, g.kc, b0, row0, c0, vec_x, tid);
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum[BIAS_PER];
#pragma unroll
  for (int u = 0; u < BIAS_PER; ++u) bsum[u] = 0.f;

  if (kt0 < kt1) {
    load(0, kt0);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load(stage ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* dyt = smem + stage * stage_floats;
    const float* pt = dyt + dy_floats;
    const int b0 = (kt / g.row_tiles) * g.imgs, row0 = (kt % g.row_tiles) * g.rows;
    const int n_img = min(g.imgs, g.B - b0), n_rows = min(g.rows, g.H - row0);
    for (int img = 0; img < n_img; ++img) {
      for (int rr = 0; rr < n_rows; ++rr) {
        const float* arow = dyt + ((img * g.rows + rr) * g.W) * DYP + 4 * nq;
        const float* brow = pt + ((img * (g.rows + 2) + rr + r) * g.pw + s) * XP + 8 * cq;
#pragma unroll 4
        for (int cc = 0; cc < g.W; ++cc) {
          const float4 a = *reinterpret_cast<const float4*>(arow + cc * DYP);
          const float4 p0 = *reinterpret_cast<const float4*>(brow + cc * XP);
          const float4 p1 = *reinterpret_cast<const float4*>(brow + cc * XP + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], pv[j], acc[i][j]);
        }
      }
    }
    if (with_bias) {
      // item (part, col): the tile's pixels part, part + 9, ... of column col, kept by one thread
#pragma unroll
      for (int u = 0; u < BIAS_PER; ++u) {
        const int item = tid + u * THREADS;
        if (item < BIAS_ITEMS) {
          const int part = item / kWgradN, col = item - part * kWgradN;
          for (int m = part; m < tile_px; m += 9) bsum[u] += dyt[m * DYP + col];
        }
      }
    }
    __syncthreads();
  }

  // the block's sums into shared memory: red[tap][n][c], then db's 9 parts and their total
  float* red = smem;
  float* bparts = red + 9 * kWgradN * BC;
  float* btotal = bparts + BIAS_ITEMS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[(tap * kWgradN + 4 * nq + i) * BC + 8 * cq + j] = acc[i][j];
  if (with_bias) {
#pragma unroll
    for (int u = 0; u < BIAS_PER; ++u)
      if (tid + u * THREADS < BIAS_ITEMS) bparts[tid + u * THREADS] = bsum[u];
  }
  __syncthreads();
  if (with_bias && tid < kWgradN) {
    float t = 0.f;
    for (int part = 0; part < 9; ++part) t += bparts[part * kWgradN + tid];
    btotal[tid] = t;
  }
  // rank r writes slice r of the tile: dw in OIHW order, then db; each element the ranks' sums in rank order
  const int64_t w_elems = static_cast<int64_t>(g.n) * g.kc * 9;
  float* dwl = dw + lane * w_elems;
  float* dbl = db + lane * g.n;
  const int tile_elems = 9 * kWgradN * BC, elems = tile_elems + (with_bias ? kWgradN : 0);
  const int e0 = rank * elems / split, e1 = (rank + 1) * elems / split;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  for (int e = e0 + tid; e < e1; e += THREADS) {
    int idx, nl, cl = 0, tp = 0;
    if (e < tile_elems) {
      nl = e / (BC * 9);
      const int rem = e - nl * BC * 9;
      cl = rem / 9;
      tp = rem - cl * 9;
      idx = (tp * kWgradN + nl) * BC + cl;
    } else {
      nl = e - tile_elems;
      idx = tile_elems + BIAS_ITEMS + nl;  // btotal[nl]
    }
    float v = red[idx];
    if (split > 1) {
      v = cluster.map_shared_rank(red, 0)[idx];
      for (int q = 1; q < split; ++q) v += cluster.map_shared_rank(red, q)[idx];
    }
    const int n = n0 + nl, c = c0 + cl;
    if (n >= g.n) continue;
    if (e < tile_elems) {
      if (c < g.kc) dwl[(static_cast<int64_t>(n) * g.kc + c) * 9 + tp] = v;
    } else {
      dbl[n] = v;
    }
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// Launching.

template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

Geom geom_of(const ConvArgs* a) {
  Geom g;
  g.B = a->batch;
  g.H = a->height;
  g.W = a->width;
  g.kc = a->direction == 1 ? a->cout : a->cin;
  g.n = a->direction == 0 ? a->cout : a->direction == 1 ? a->cin : a->cout;
  g.cin = a->cin;
  g.imgs = a->imgs;
  g.rows = a->rows;
  g.row_tiles = (a->height + a->rows - 1) / a->rows;
  g.pw = a->width + 2;
  g.ppx = a->imgs * (a->rows + 2) * (a->width + 2);
  return g;
}

// A tile is whole rows of one image, or whole images.
bool tile_ok(const ConvArgs* a, int bm) {
  return a->imgs >= 1 && a->rows >= 1 && a->rows <= a->height && a->imgs * a->rows * a->width <= bm &&
         (a->imgs == 1 || a->rows == a->height);
}

template <int kDir, int BN, int CK>
cudaError_t launch_mn(const ConvArgs* a) {
  constexpr int BM = BN == 32 ? 256 : 128, TM = 8, TN = BN == 128 ? 8 : 4;
  constexpr auto kernel = conv_mn_kernel<kDir, BM, BN, TM, TN, CK>;
  if (!tile_ok(a, BM)) return cudaErrorInvalidValue;
  const Geom g = geom_of(a);
  const size_t smem = 2 * (static_cast<size_t>(g.ppx) * (CK + 4) + 9 * CK * BN) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  const dim3 grid(((g.B + g.imgs - 1) / g.imgs) * g.row_tiles, (g.n + BN - 1) / BN, a->lanes);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a->stream)>>>(
      a->src, a->aux, a->bias, a->out, a->src_lane, a->aux_lane, a->bias_lane, g);
  return cudaSuccess;
}

template <int CQ>
cudaError_t launch_wgrad(const ConvArgs* a) {
  constexpr int BC = 8 * CQ, THREADS = 9 * 8 * CQ;
  constexpr auto kernel = conv_wgrad_kernel<CQ>;
  const int split = a->split;
  if (!tile_ok(a, kWgradPixels) || !(split == 1 || split == 2 || split == 4 || split == 8))
    return cudaErrorInvalidValue;
  const Geom g = geom_of(a);
  const size_t tile_px = static_cast<size_t>(a->imgs) * a->rows * a->width;
  const size_t stages = 2 * (tile_px * (kWgradN + 4) + static_cast<size_t>(g.ppx) * (BC + 4));
  const size_t reduce = 9 * kWgradN * BC + 10 * kWgradN;
  const size_t smem = (stages > reduce ? stages : reduce) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<kernel>();
  if (e != cudaSuccess) return e;
  const int tiles = ((g.n + kWgradN - 1) / kWgradN) * ((g.kc + BC - 1) / BC);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles, a->lanes);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(a->stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a->src, a->aux, a->out, a->out_bias, a->src_lane, a->aux_lane, g, split);
}

template <int kDir>
cudaError_t launch_dir(const ConvArgs* a) {
  switch (a->bn * 100 + a->ck) {
    case 3204: return launch_mn<kDir, 32, 4>(a);
    case 3216: return launch_mn<kDir, 32, 16>(a);
    case 6404: return launch_mn<kDir, 64, 4>(a);
    case 6408: return launch_mn<kDir, 64, 8>(a);
    case 12804: return launch_mn<kDir, 128, 4>(a);
    case 12808: return launch_mn<kDir, 128, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

// A launch's own error, else cudaGetLastError(); either way the error state is cleared.
int result_of(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

// Returns the launch's error: 0 on success, cudaErrorInvalidValue for a plan
// no instance here takes.  Nothing falls back: a refused launch is an error.
extern "C" int conv_lanes_launch(const ConvArgs* a) {
  if (a->lanes <= 0 || a->batch <= 0) return 0;
  if (a->height <= 0 || a->width <= 0 || a->cin <= 0 || a->cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->direction) {
    case 0: return result_of(launch_dir<0>(a));
    case 1: return result_of(launch_dir<1>(a));
    case 2:
      if (a->bn == 8) return result_of(launch_wgrad<1>(a));
      if (a->bn == 32) return result_of(launch_wgrad<4>(a));
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
