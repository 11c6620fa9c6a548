// The two launches of gamma_nonneg.cu (the shared-denominator walk's gamma
// rule of a 3x3 SAME conv, both transposed terms) on the tensor cores
// (conv3x3_tc.cuh: 3xTF32 implicit GEMMs on mma.sync, cp.async double
// buffering). chain_block.cu's rule runs on wgmma (conv3x3_wgmma.cuh).
//
//   prep   once per (instance, tile, column block): one GEMM with N = 2*Co
//          over the interleaved forward pair (column 2j the taps of
//          w + g*w+, 2j + 1 those of w + g*w-), so a thread's accumulator
//          pair is (z1, z3) of one channel; the epilogue forms z_true and
//          the clone-shared multipliers in registers. It accumulates FRESH
//          (conv3x3_tc.cuh): the multipliers are sign decisions. It reads x
//          [b, Ci, H, W] (NCHW) as it is and writes M = (m1, m3)
//          interleaved [b, H, W, 2*Co], m1 = [z_true > 0] / stab(z1 + b2),
//          m3 = [z_true < 0] / stab(z3).
//   apply  once per (instance, clone, tile, column block): the transposed
//          conv over R * M, 2*Co channels interleaved as M, channel 2o + s
//          the product R[o] * M[2o + s] and taps of w + g*w+ (s = 0) or
//          w + g*w- (s = 1), times x. m1 and m3 are disjoint, so half of
//          these products multiply zeros: a per-entry choice of weight set
//          is not a GEMM. R, x and the result are NCHW with the clones
//          folded clone-major into the batch ([K*b, C, H, W], the walk's
//          layout): R and x are staged one float a copy, the result written
//          as 8-pixel row pieces of a channel. A tile's K clones are
//          neighbours in the grid, so that M and x come from L2 for all but
//          the first.
//
// Tiles. A block is 8 warps; a warp holds MF m-fragments of 16 pixels x 32
// channels (MF x 4 mma tiles). WN = 4, 2 or 1 warps over the GEMM's N
// (N > 64, > 32, else), the other 8 / WN over pixels, BN = 32 * WN channels
// a block: an 8-wide tile of 2 * MF * 8 / WN rows. MF = 4 (a 64-pixel warp
// tile, which loads each B fragment for 4 m-fragments) where WN > 1 and the
// level is at least that tall, else 2, so that small levels are not
// over-tiled; with WN = 1 a 4-fragment tile (64x8) would fit one block an
// SM. Two blocks fit an SM (at most 113 KB of shared memory and 128
// registers each).
//
// The reduction runs in slices of 8 channels (a short last slice is
// zero-filled) and the apply's N pads to a multiple of 8 with zero taps
// (100 -> 104). Tensors must be 16-byte aligned (cp.async).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tc.cuh"
#include "lrp_common.cuh"

namespace gtc {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256, TW = 8;

inline int warps_n(int N) { return N > 64 ? 4 : (N > 32 ? 2 : 1); }

// Rows of the tall tile (4 m-fragments a warp) for WN warps over the
// columns: a level at least that tall takes it, a shorter one the 2-fragment
// tile, so that no tile hangs far past the image. One warp over all the
// columns always takes 2 fragments (a 64x8 tile would fit one block an SM).
inline int tall_rows(int WN) { return 16 * 4 * (8 / WN) / TW; }

// WN warps over the columns, MF m-fragments (16 pixels each) a warp.
template <int WN, int MF_>
struct Tile {
  static constexpr int MF = MF_;
  static constexpr int BM = 16 * MF * (8 / WN), TH = BM / TW, BN = 32 * WN;
  static constexpr int RW = TW + 2, NQ = (TH + 2) * RW;  // staged: tile + 1-pixel halo
  static constexpr int WS = BN + 8;
  static constexpr int A = NQ * SP, B = 9 * CC * WS;      // floats per region / taps
  // a stage: two regions (x and the split's lo, or R and G; split in place
  // into hi and lo) and the taps
  static constexpr int STAGE = 2 * A + B;
};

// This lane's ldmatrix rows of the warp's MF m-fragments; pixel m of the
// tile sits at (m / TW, m % TW), region offset (m / TW) * RW + m % TW.
template <class T>
__device__ __forceinline__ void tile_rows(int (&lrow)[T::MF], int wm) {
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
    lrow[i] = tc::lane_row([&](int r) {
      const int m = (wm * T::MF + i) * 16 + r;
      return (m / TW) * T::RW + m % TW;
    });
}

template <int WN, int MF>
__global__ void __launch_bounds__(THREADS, 2)
gamma_prep_kernel(const float* __restrict__ x,     // [b, Ci, H, W]
                  const float* __restrict__ w,     // [nsl, 9, CC, 2*Co]
                  const float* __restrict__ bias,  // [3, Co]: b1, b0, b2
                  float* __restrict__ G,           // [b, H, W, 2*Co]
                  int H, int W, int Ci, int Co, float inv, float stab) {
  using T = Tile<WN, MF>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = 2 * Co, n = blockIdx.z, n0 = blockIdx.y * T::BN;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * T::TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, ncol = (warp % WN) * 32;
  const int nfr = min(4, max(0, (N - n0 - ncol) / 8));
  const float* xn = x + (size_t)n * H * W * Ci;
  int lrow[T::MF];
  tile_rows<T>(lrow, wm);
  float acc[T::MF][4][4] = {};

  tc::pipeline(
      (Ci + CC - 1) / CC,
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;
        tc::stage_region_nchw(buf, xn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, Ci, s * CC);
        tc::stage_taps<T::BN>(buf + 2 * T::A, w, s, N, n0);
        tc::cp_commit();
      },
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;     // x, then hi; lo
        tc::split_region(buf, buf + T::A, T::NQ, [&](int q, int c4) {
          return *reinterpret_cast<const float4*>(buf + q * SP + c4);
        });
        __syncthreads();
        tc::slice_mma<T::MF, 4, true>(acc, buf, buf + T::A, lrow, T::RW, buf + 2 * T::A, T::WS,
                                      ncol, nfr);
      });

#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wm * T::MF + i) * 16 + g + hf * 8;
      const int h = h0 + m / TW, ww = w0 + m % TW;
      if (h >= H || ww >= W) continue;
      float* gp = G + (((size_t)n * H + h) * W + ww) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nfr) continue;
        const int col = n0 + ncol + j * 8 + t4 * 2, o = col >> 1;
        const float b1 = bias[o], b0 = bias[Co + o], b2 = bias[2 * Co + o];
        const float z1 = __fadd_rn(acc[i][j][2 * hf], b1), z3 = acc[i][j][2 * hf + 1];
        const float zt = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(z1, z3), b1), inv), b0);
        const float v1 = zt > 0.f ? __fdiv_rn(1.0f, lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
        const float v3 = zt < 0.f ? __fdiv_rn(1.0f, lrp::stabilize(z3, stab)) : 0.f;
        *reinterpret_cast<float2*>(gp + col) = make_float2(v1, v3);
      }
    }
}

template <int WN, int MF>
__global__ void __launch_bounds__(THREADS, 2)
gamma_apply_kernel(const float* __restrict__ R,     // [K*b, Co, H, W]
                   const float* __restrict__ G,     // [b, H, W, 2*Co]
                   const float* __restrict__ x,     // [b, Ci, H, W]
                   const float* __restrict__ wt,    // [nsl, 9, CC, Np]
                   float* __restrict__ out,         // [K*b, Ci, H, W]
                   int K, int H, int W, int Ci, int Co) {
  using T = Tile<WN, MF>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Np = (Ci + 7) & ~7, nblk = (Np + T::BN - 1) / T::BN;
  const int NG = 2 * Co;                         // the reduction's channels
  const int n = blockIdx.y, k = blockIdx.x % K, col = blockIdx.x / K;
  const int n0 = (col % nblk) * T::BN, tile = col / nblk;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (tile / tiles_w) * T::TH, w0 = (tile % tiles_w) * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, ncol = (warp % WN) * 32;
  const int nfr = min(4, max(0, (Np - n0 - ncol) / 8));
  const size_t img = (size_t)k * gridDim.y + n;
  const float* Rn = R + img * H * W * Co;
  const float* Gn = G + (size_t)n * H * W * NG;
  int lrow[T::MF];
  tile_rows<T>(lrow, wm);
  float acc[T::MF][4][4] = {};

  tc::pipeline(
      (NG + CC - 1) / CC,
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;
        // R channels [4s, 4s + 4) meet M channels [8s, 8s + 8)
        tc::stage_region_nchw<1>(buf, Rn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, Co, s * CC / 2);
        tc::stage_region(buf + T::A, Gn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, NG, s * CC);
        tc::stage_taps<T::BN>(buf + 2 * T::A, wt, s, Np, n0);
        tc::cp_commit();
      },
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;     // R, then hi; G, then lo
        // one thread a pixel: it reads the pixel's 4 R and 8 M values
        // before it writes the 8 hi and 8 lo values over them
        for (int q = threadIdx.x; q < T::NQ; q += blockDim.x) {
          const float4 r = *reinterpret_cast<const float4*>(buf + q * SP);
          const float4 ma = *reinterpret_cast<const float4*>(buf + T::A + q * SP);
          const float4 mb = *reinterpret_cast<const float4*>(buf + T::A + q * SP + 4);
          const float v[8] = {__fmul_rn(r.x, ma.x), __fmul_rn(r.x, ma.y),
                              __fmul_rn(r.y, ma.z), __fmul_rn(r.y, ma.w),
                              __fmul_rn(r.z, mb.x), __fmul_rn(r.z, mb.y),
                              __fmul_rn(r.w, mb.z), __fmul_rn(r.w, mb.w)};
          uint32_t hi[8], lo[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) tc::split(v[c], hi[c], lo[c]);
          uint4* ph = reinterpret_cast<uint4*>(buf + q * SP);
          uint4* pl = reinterpret_cast<uint4*>(buf + T::A + q * SP);
          ph[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          ph[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
          pl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          pl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        }
        __syncthreads();
        tc::slice_mma<T::MF, 4, false>(acc, buf, buf + T::A, lrow, T::RW, buf + 2 * T::A, T::WS,
                                       ncol, nfr);
      });

  float* on = out + img * H * W * Ci;
  const size_t HW = (size_t)H * W;
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wm * T::MF + i) * 16 + g + hf * 8;
      const int h = h0 + m / TW, ww = w0 + m % TW;
      if (h >= H || ww >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = n0 + ncol + j * 8 + t4 * 2;
        if (j >= nfr || ci >= Ci) continue;
        // 8 lanes (g) write 8 neighbouring pixels of a channel
        const size_t at = (size_t)h * W + ww;
        const float* xc = x + ((size_t)n * Ci + ci) * HW + at;
        on[ci * HW + at] = __fmul_rn(xc[0], acc[i][j][2 * hf]);
        on[(ci + 1) * HW + at] = __fmul_rn(xc[HW], acc[i][j][2 * hf + 1]);
      }
    }
}

template <int WN, int MF>
cudaError_t launch_prep(int b, cudaStream_t st, const float* x, const float* w,
                        const float* bias, float* G, int H, int W, int Ci, int Co, float inv,
                        float stab) {
  using T = Tile<WN, MF>;
  const dim3 grid(((H + T::TH - 1) / T::TH) * ((W + TW - 1) / TW),
                  (2 * Co + T::BN - 1) / T::BN, b);
  const size_t bytes = sizeof(float) * 2 * T::STAGE;
  cudaError_t err = lrp::set_smem(gamma_prep_kernel<WN, MF>, bytes);
  if (err != cudaSuccess) return err;
  gamma_prep_kernel<WN, MF><<<grid, THREADS, bytes, st>>>(x, w, bias, G, H, W, Ci, Co, inv, stab);
  return cudaGetLastError();
}

template <int WN, int MF>
cudaError_t launch_apply(int b, cudaStream_t st, const float* R, const float* G,
                         const float* x, const float* wt, float* out, int K, int H, int W,
                         int Ci, int Co) {
  using T = Tile<WN, MF>;
  const int nblk = (((Ci + 7) & ~7) + T::BN - 1) / T::BN;
  const dim3 grid(((H + T::TH - 1) / T::TH) * ((W + TW - 1) / TW) * nblk * K, b);
  const size_t bytes = sizeof(float) * 2 * T::STAGE;
  cudaError_t err = lrp::set_smem(gamma_apply_kernel<WN, MF>, bytes);
  if (err != cudaSuccess) return err;
  gamma_apply_kernel<WN, MF><<<grid, THREADS, bytes, st>>>(R, G, x, wt, out, K, H, W, Ci, Co);
  return cudaGetLastError();
}

// The prep with the tile for its N = 2*Co columns and the level's height.
inline cudaError_t prep(int b, cudaStream_t s, const float* x, const float* w, const float* bias,
                        float* G, int H, int W, int Ci, int Co, float inv, float stab) {
#define PREP(WN, MF) launch_prep<WN, MF>(b, s, x, w, bias, G, H, W, Ci, Co, inv, stab)
  switch (warps_n(2 * Co)) {
    case 4: return H >= tall_rows(4) ? PREP(4, 4) : PREP(4, 2);
    case 2: return H >= tall_rows(2) ? PREP(2, 4) : PREP(2, 2);
    default: return PREP(1, 2);
  }
#undef PREP
}

// The apply with the tile for its N = Ci rounded up to 8 and the level's
// height.
inline cudaError_t apply(int b, cudaStream_t s, const float* R, const float* G, const float* x,
                         const float* wt, float* out, int K, int H, int W, int Ci, int Co) {
#define APPLY(WN, MF) launch_apply<WN, MF>(b, s, R, G, x, wt, out, K, H, W, Ci, Co)
  switch (warps_n((Ci + 7) & ~7)) {
    case 4: return H >= tall_rows(4) ? APPLY(4, 4) : APPLY(4, 2);
    case 2: return H >= tall_rows(2) ? APPLY(2, 4) : APPLY(2, 2);
    default: return APPLY(1, 2);
  }
#undef APPLY
}

}  // namespace gtc
