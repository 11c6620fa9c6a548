// Deep first block of the lower LRP chain (the 6s model's block 0: conv 0,
// relu, conv 3, relu, max-pool (2,kw)): the pool backward, the relu gate and
// gamma rule of conv 3, then the wsquare/flat rule of conv 0 (one input
// channel), for every relevance clone.
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_chain.py
// _first_block_deep_kernel (:668, launched :1237), including its mm_taps
// flag variant (the same function).
//
// Math (f32, NHWC; C0 = conv 3's input channels, C = its output channels):
//   s   = upsample_(kh,kw)(R) * route(relu(apre))      fine level [H, W, C]
//   Rn  = relu(a1) * convT(s * G, w + g*w+)            [H, W, C0]
//   s0  = Rn * relu_gate(a1) / stab(z0)
//   heat[h, w] = sum_{dy,dx,c} s0[h+dy-1, w+dx-1, c] * taps[dy, dx, c]
// route is the first maximum of each pool window in row-major order (strict
// >, so an all-tied window routes to its first position). G = [z_true > 0] /
// stab(z1 + b2) is the clone-shared multiplier of the gamma rule. Both are
// clone-shared, so chain_gamma_prep (csrc/chain_block.cu, on the tensor
// cores) writes their product M = G * route once per instance, from relu(a1)
// and apre. The relu gate on s and the gamma rule's convT(s * m3) term
// cancel as in chain_block.cu (m3 != 0 only where the gate is 0), so
// neither is formed.
//
// One thread block (2 warpgroups, 256 threads) per (16x8 output tile,
// clone, instance), a tile's K clones neighbours in the grid (M and a1 come
// from L2 for all but the first); two blocks an SM, so that one block's
// staging, split and epilogue overlap the other's products. The transposed
// conv runs on wgmma through conv3x3_wgmma.cuh (3xTF32 implicit GEMM, A
// from registers, pre-split K-major taps by bulk copy): per slice of 8 of
// the C channels, cp.async stages R at its coarse level (10 x 4 or 10 x 6
// pixels) and M over the tile plus a 1-pixel halo (18x10), and one bulk
// copy the slice's taps (hi and lo, 9 x 8 x C0 each), while the previous
// slice multiplies; R * M is formed at each fine pixel from its coarse R
// and split once. The GEMM's M runs over the tile's 128 pixels only (no
// halo is recomputed): warpgroup i takes tile rows 8i .. 8i + 7 (one m64
// tile) by all C0 <= 64 channels (N = BN >= C0), 32 accumulators a
// thread, three wgmma groups in flight. The epilogue works on the
// accumulator fragments: relu(a1) * acc, s0, the 9 tail taps summed over
// the thread's 16 channels, a shuffle across the 4 threads of a fragment
// row (all 64 channels), then, per pixel of the tile and its 1-pixel rim,
// the tile's share of the 3x3 neighbourhood sum. A pixel of the tile's 14x6
// interior has all of its sum and is written to the heatmaps. The other 96
// shares (the tile's outer ring and the rim around it) go to a scratch
// array, and a second launch (first_block_deep_rim) adds, for each ring
// pixel, the shares of the tiles around it in a fixed order: the heatmaps
// are the same bits from run to run. Zeros outside the image reproduce
// SAME padding. The fine relevance Rn never reaches device memory.
//
// Shared memory at C0 = 64: the tail taps (9 x 64), the split's lo (180 x
// 12) and two stages of the taps (2 x 9 x 8 x 64), coarse R and M: 108 KB.
//
// Bound on an H100: operations. Per instance the K transposed convs at the
// fine level are 2*K*H*W*C*C0*9 flops and the prep's two forward convs
// 2*2*H*W*C0*C*9, against ~4*(K*H*W*C/(kh*kw) + 2*H*W*C + H*W*C0) bytes: at
// the 6s shapes (128x256, 64 -> 64, K=4, b=64) 928 GFLOP, 5.63 ms on the
// tensor cores in 3xTF32 (495 / 3 TFLOP/s, the least time for f32-accurate
// products; 13.99 ms on the FMA units at 67 TFLOP/s). The design puts both
// the prep and the transposed conv on wgmma, the only instruction at the
// dense TF32 rate, and trades the 1.5x halo recompute of a 16x8 tile for a
// scratch of 96 floats a tile and clone (25 MB at b=64, K=4) and a short
// second launch. What it leaves: a 16x8 tile reads each slice's 36.9 KB of
// taps for 128 pixels (19 GB from L2 a 6s request), and a 16x16 tile, which
// halves that, does not fit two blocks an SM (a 16x16 tile at one block an
// SM measured slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_wgmma.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256;
constexpr int TH = 16, TW = 8;                       // output tile = the GEMM's 128 rows
constexpr int SW = TW + 2, NS = (TH + 2) * SW;       // R*M region: tile + 1 halo
constexpr int TP = 9 * 64;                           // tail taps, floats
constexpr int CRH = TH / 2 + 2, CRW = TW / 2 + 2;    // coarse R region (kh = 2, kw >= 2)
constexpr int A = NS * SP, AC = CRH * CRW * SP;
constexpr int BARS = 4;                              // floats: two mbarriers
constexpr int NT = TH * TW;
constexpr int NR = 4 * SW + 4 * (TH - 2);            // shares kept for the rim pass
constexpr int NRING = 2 * TW + 2 * (TH - 2);         // a tile's outer ring
static_assert(THREADS / 128 * 64 == NT, "the warpgroups' m64 tiles cover the tile");

// A stage: the slice's taps, coarse R, M (then hi).
template <int BN>
__host__ __device__ constexpr int stage_floats() { return wg::taps_floats<BN>() + AC + A; }
static_assert(9 * NT <= 2 * stage_floats<8>(), "the tail sums reuse the staging buffers");

// The rim slot of position (oy, ox) of a tile's (TH + 2) x (TW + 2) region
// (pixel (h0 - 1 + oy, w0 - 1 + ox)): rows 0, 1, TH, TH + 1 whole, then
// columns 0, 1, TW, TW + 1 of the rows between; -1 for the 14x6 interior,
// whose 3x3 neighbourhoods lie in the tile.
__device__ __forceinline__ int rim_slot(int oy, int ox) {
  if (oy < 2) return oy * SW + ox;
  if (oy >= TH) return (oy - TH + 2) * SW + ox;
  if (ox >= 2 && ox < TW) return -1;
  return 4 * SW + (oy - 2) * 4 + (ox < 2 ? ox : ox - TW + 2);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
first_block_deep_kernel(const float* __restrict__ R,      // [b, K, H/kh, W/kw, C]
                        const float* __restrict__ M,      // [b, H, W, C]
                        const float* __restrict__ a1,     // [b, H, W, C0]
                        const float* __restrict__ wt,     // [ceil(C/8), 2, 9, 2, BN, 4]
                        const float* __restrict__ z0,     // [H, W, C0]
                        const float* __restrict__ taps,   // [9, C0]
                        float* __restrict__ heat,         // [b, K, H, W]
                        float* __restrict__ rim,          // [b, K, tiles, NR]
                        int K, int H, int W, int C0, int C, int kw, float stab0) {
  constexpr int TAPS = wg::taps_floats<BN>(), STAGE = stage_floats<BN>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* tp = smem + BARS;            // [9][C0]
  float* lo = tp + TP;                // the split's lo [NS][SP]
  float* stg = lo + A;                // 2 stages
  float* u = stg;                     // [9][NT], after the main loop
  const int n = blockIdx.y, k = blockIdx.x % K, tile = blockIdx.x / K;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool live = h0 + wgi * (64 / TW) < H;        // the m64 tile holds image rows
  // kh = 2, kw = 2 or 4: coarse indices by shifts (floor; at the image's
  // upper-left edge M is 0 and the index stays inside the region)
  const int kws = kw == 4 ? 2 : 1, crw = (TW >> kws) + 2;
  const int Hc = H >> 1, Wc = W >> kws, cy0 = (h0 >> 1) - 1, cx0 = (w0 >> kws) - 1;
  const float* Rk = R + ((size_t)n * K + k) * Hc * Wc * C;
  const float* Mn = M + (size_t)n * H * W * C;
  for (int e = threadIdx.x; e < 9 * C0; e += THREADS) tp[e] = taps[e];
  if (threadIdx.x == 0) {
    wg::bar_init(&bars[0]);
    wg::bar_init(&bars[1]);
    wg::bar_init_fence();
  }
  __syncthreads();

  // ldmatrix rows: tile pixel m at (m / TW, m % TW), offset in the R*M region
  const int lrow[1] = {tc::lane_row([&](int r) {
    const int m = wgi * 64 + wq * 16 + r;
    return (m / TW) * SW + m % TW;
  })};
  float acc[1][BN / 2] = {};

  tc::pipeline(
      (C + CC - 1) / CC,
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;
        tc::stage_region(buf + TAPS, Rk, CRH, crw, cy0, cx0, Hc, Wc, C, s * CC);
        tc::stage_region(buf + TAPS + AC, Mn, TH + 2, SW, h0 - 1, w0 - 1, H, W, C, s * CC);
        tc::cp_commit();
        if (threadIdx.x == 0) wg::bulk_load(buf, wt + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
      },
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;
        float* rc = buf + TAPS;             // coarse R
        float* mh = rc + AC;                // M, then hi
        // R * M at each fine pixel, R read from its coarse pixel
        tc::split_region(mh, lo, NS, [&](int q, int c4) {
          const int cy = ((h0 - 1 + q / SW) >> 1) - cy0, cx = ((w0 - 1 + q % SW) >> kws) - cx0;
          return tc::mul4(*reinterpret_cast<const float4*>(rc + (cy * crw + cx) * SP + c4),
                          *reinterpret_cast<const float4*>(mh + q * SP + c4));
        });
        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
        __syncthreads();
        if (live)
          wg::slice<BN, false, 3, 1>(acc, wg::saddr(mh), wg::saddr(lo), lrow, SW, wg::saddr(buf));
      });
  // the pipeline ends with a barrier: u may reuse the staging buffers

  // relu(a1) and the tail multiplier, then this thread's 16 channels against
  // the 9 tail taps, per pixel; the 4 threads of a fragment row hold its 64
  // channels between them
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = wgi * 64 + wq * 16 + g + hf * 8;
    const int h = h0 + m / TW, w = w0 + m % TW;
    float part[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) part[t] = 0.f;
    if (h < H && w < W) {
      const float* ap = a1 + (((size_t)n * H + h) * W + w) * C0;
      const float* zp = z0 + ((size_t)h * W + w) * C0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + t4 * 2;
        if (c >= C0) continue;
        const float2 a2 = *reinterpret_cast<const float2*>(ap + c);
        const float2 z2 = *reinterpret_cast<const float2*>(zp + c);
        float s0[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = e ? a2.y : a2.x, z = e ? z2.y : z2.x;
          const float rn = __fmul_rn(fmaxf(a, 0.f), acc[0][4 * j + 2 * hf + e]);
          // relu_gate(a) / stab(z) as the gate (0, 0.5 or 1) times 1 / stab(z):
          // the same bits, without a division
          s0[e] = __fmul_rn(rn, __fmul_rn(lrp::relu_gate(a), __frcp_rn(lrp::stabilize(z, stab0))));
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float2 tv = *reinterpret_cast<const float2*>(tp + t * C0 + c);
          part[t] = fmaf(s0[1], tv.y, fmaf(s0[0], tv.x, part[t]));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      part[t] += __shfl_xor_sync(0xffffffffu, part[t], 1);
      part[t] += __shfl_xor_sync(0xffffffffu, part[t], 2);
    }
    if (t4 == 0)
#pragma unroll
      for (int t = 0; t < 9; ++t) u[t * NT + m] = part[t];
  }
  __syncthreads();
  // heat[h, w] = sum_{dy, dx} u[dy * 3 + dx][h + dy - 1, w + dx - 1]: this
  // tile's share of the tile and its 1-pixel rim; the interior's is the
  // whole sum, the rest goes to the rim pass
  const size_t nk = (size_t)n * K + k;
  float* rim_t = rim + (nk * (gridDim.x / K) + tile) * NR;
  for (int o = threadIdx.x; o < (TH + 2) * SW; o += THREADS) {
    const int oy = o / SW, ox = o % SW;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int py = oy + t / 3 - 2, px = ox + t % 3 - 2;
      if (py >= 0 && py < TH && px >= 0 && px < TW) sum += u[t * NT + py * TW + px];
    }
    const int r = rim_slot(oy, ox);
    const int h = h0 - 1 + oy, w = w0 - 1 + ox;
    if (r >= 0)
      rim_t[r] = sum;
    else if (h < H && w < W)
      heat[(nk * H + h) * W + w] = sum;
  }
}

template <int BN>
constexpr size_t smem_bytes() { return sizeof(float) * (BARS + TP + A + 2 * stage_floats<BN>()); }

// f(BN) for taps BN columns wide (the width of the host's layout,
// xai/lrp/taps.py wg_cols); no for a width without an instance.
template <class F, class R>
R deep_tile(int BN, F f, R no) {
  switch (BN) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return no;
  }
}

template <int BN>
cudaError_t launch(int b, cudaStream_t st, const float* R, const float* M, const float* a1,
                   const float* wt, const float* z0, const float* taps, float* heat, float* rim,
                   int K, int H, int W, int C0, int C, int kw, float stab0, int n_tiles) {
  const dim3 grid(n_tiles * K, b);
  cudaError_t err = lrp::set_smem(first_block_deep_kernel<BN>, smem_bytes<BN>());
  if (err != cudaSuccess) return err;
  first_block_deep_kernel<BN><<<grid, THREADS, smem_bytes<BN>(), st>>>(
      R, M, a1, wt, z0, taps, heat, rim, K, H, W, C0, C, kw, stab0);
  return cudaGetLastError();
}

// Each pixel of a tile's outer ring: the shares of the (up to 4) tiles
// whose region holds it, added in the fixed order of the tiles' offsets.
__global__ void __launch_bounds__(256)
first_block_deep_rim(const float* __restrict__ rim, float* __restrict__ heat, int H, int W,
                     int tiles_w, int n_tiles, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int r = (int)(e % NRING), tile = (int)((e / NRING) % n_tiles);
  const long long nk = e / NRING / n_tiles;
  const int ty = tile / tiles_w, tx = tile % tiles_w;
  int py, px;
  if (r < 2 * TW) {
    py = r < TW ? 0 : TH - 1;
    px = r % TW;
  } else {
    py = 1 + ((r - 2 * TW) >> 1);
    px = (r & 1) * (TW - 1);
  }
  const int h = ty * TH + py, w = tx * TW + px;
  if (h >= H || w >= W) return;
  const int tiles_h = n_tiles / tiles_w;
  float sum = 0.f;
  for (int uy = ty - 1; uy <= ty + 1; ++uy)
    for (int ux = tx - 1; ux <= tx + 1; ++ux) {
      const int oy = h - uy * TH + 1, ox = w - ux * TW + 1;
      if (uy < 0 || uy >= tiles_h || ux < 0 || ux >= tiles_w || oy < 0 || oy > TH + 1 ||
          ox < 0 || ox > TW + 1)
        continue;
      sum += rim[(nk * n_tiles + uy * tiles_w + ux) * NR + rim_slot(oy, ox)];
    }
  heat[(nk * H + h) * W + w] = sum;
}

}  // namespace

extern "C" {

// R [b,K,H/kh,W/kw,C], M [b,H,W,C] (chain_gamma_prep of relu(a1), masked by
// the pool route of relu(apre)), a1 [b,H,W,C0], wt [ceil(C/8),2,9,2,BN,4]
// (the transposed w + g*w+, pre-split in one chunk of BN >= C0 columns, 8,
// 16, 32 or 64: xai/lrp/taps.py GammaConv.w_apply_wg, whose layout chooses
// BN), z0 [H,W,C0], taps [9,C0], heat [b,K,H,W], rim a scratch of
// b*K*ceil(H/16)*ceil(W/8)*96 floats. Two launches: the tiles, then the rim
// pass. Needs C0 in {8, 16, ..., 64}, C a count chain_block.cu takes (a
// multiple of 4 up to 128), H % kh == 0, W % kw == 0, 16-byte aligned R, M
// and wt (8-byte a1 and z0); returns cudaErrorInvalidValue, before any
// launch, otherwise or for a BN the kernel does not take. Else
// cudaGetLastError().
int first_block_deep(const float* R, const float* M, const float* a1,
                     const float* wt, const float* z0, const float* taps,
                     float* heat, float* rim, int b, int K, int H, int W, int C0, int C,
                     int BN, int kh, int kw, float stab0, void* stream) {
  if (C0 % 8 != 0 || C0 > 64 || C0 <= 0 || C % 4 != 0 || C <= 0 || C > 128 || kh != 2 ||
      (kw != 2 && kw != 4) || BN < C0 ||
      !tc::aligned16(R) || !tc::aligned16(M) || !tc::aligned16(wt) ||
      ((uintptr_t)a1 & 7) != 0 || ((uintptr_t)z0 & 7) != 0)
    return cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW, n_tiles = ((H + TH - 1) / TH) * tiles_w;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = deep_tile(BN, [&](auto bn) {
    return launch<decltype(bn)::value>(b, st, R, M, a1, wt, z0, taps, heat, rim, K, H, W, C0, C,
                                       kw, stab0, n_tiles);
  }, cudaErrorInvalidValue);
  if (err != cudaSuccess) return err;
  const long long total = (long long)b * K * n_tiles * NRING;
  first_block_deep_rim<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      rim, heat, H, W, tiles_w, n_tiles, total);
  return cudaGetLastError();
}

// The dynamic shared memory, bytes, a block of the tiles' launch takes for
// taps BN columns wide; 0 for a BN the kernel does not take.
size_t first_block_deep_smem(int BN) {
  return deep_tile(BN, [](auto bn) { return smem_bytes<decltype(bn)::value>(); }, size_t{0});
}

}  // extern "C"
