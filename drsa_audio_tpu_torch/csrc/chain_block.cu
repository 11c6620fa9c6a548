// One block of the lower LRP chain: relu gate + gamma rule of a 3x3 SAME
// conv on non-negative input, all K relevance clones, then optionally the
// (kh, kw) max-pool backward to the finer level below.
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_chain.py
// _chain_block_kernel (:624, launched :1108) for one conv; the Python wrapper
// (xai/lrp/chain.py chain_block) walks a block's convs top-down.
//
// Math (f32, NHWC):
//   z1 = conv(x, w + g*w+) + b1,  z3 = conv(x, w + g*w-)
//   z_true = (z1 + z3 - b1) * (1/(2+g)) + b0        (derived, as the TPU kernel)
//   G = [z_true > 0] / stab(z1 + b2)                 (= relu_gate(z_true) * m1)
//   R_in = x * convT(R * G, w + g*w+)
// The TPU kernel also forms convT(R * relu_gate(z_true) * m3, w + g*w-) with
// m3 = [z_true < 0] / stab(z3). Where z_true < 0 the relu gate is 0, and
// elsewhere m3 is 0, so that term is identically zero and is not computed.
//
// Two launches per conv, both through the tensor-core core of
// conv3x3_tc.cuh (3xTF32 implicit GEMM, cp.async double buffering):
//   gamma_prep   once per (instance, tile, column block): one GEMM with
//                N = 2*Co over the interleaved forward pair (column 2j the
//                taps of w + g*w+, 2j + 1 those of w + g*w-), so a thread's
//                accumulator pair is (z1, z3) of one channel; the epilogue
//                forms z_true and G in registers and writes G [b, H, W, Co].
//                It reads relu(x): a chain conv's input is a relu output
//                already, and the deep first block (first_block_deep.cu)
//                passes the pre-relu a1; for that block it also zeroes G off
//                the first-argmax route of the (kh, kw) pool above the conv
//                (strict >, row-major: an all-tied window routes to position
//                0), so that the clone-shared route is taken once per
//                instance. merged_tail.cu's preps are this launch too.
//   gamma_apply  once per (instance, clone, tile, column block): the
//                transposed conv of R * G (both staged as they are, formed
//                and split once per slice), times x, written or routed
//                through the pool backward to the finer level. A tile's K
//                clones are neighbours in the grid, so that G, x and apre
//                come from L2 for all but the first.
// The prep adds each k-step's products into its accumulators in f32
// (conv3x3_tc.cuh FRESH): accumulated in the tensor core, the sum drifted
// enough on the card to flip a z_true at 6e-7 of the map's maximum.
//
// Tiles. A block is 8 warps; a warp holds MF m-fragments of 16 pixels x 32
// channels (MF x 4 mma tiles). WN = 4, 2 or 1 warps over the GEMM's N
// (N > 64, > 32, else), the other 8 / WN over pixels, BN = 32 * WN channels
// a block: an 8-wide tile of 2 * MF * 8 / WN rows. MF = 4 (a 64-pixel warp
// tile, which loads each B fragment for 4 m-fragments) where WN > 1 and the
// level is at least that tall, else 2, so that small levels are not
// over-tiled; with WN = 1 a 4-fragment tile (64x8) would fit one block an
// SM. Tiles and grids (prep: tiles x column blocks x b; apply: tiles x
// column blocks x K, b) at the main path's shapes:
//   3s b=256   16^2 64->64:  prep 16x8, 2x1x256 = 512;   apply 16x8, (2x1x4)x256 = 2048
//              32^2 32->64:  prep 16x8, 8x1x256 = 2048;  apply 32x8, (4x1x4)x256 = 4096
//              64^2 32->32:  prep 32x8, 16x1x256 = 4096; apply 32x8, (16x1x4)x256 = 16384
//   6s b=64    8^2 128->128: prep 8x8, 1x2x64 = 128;     apply 8x8, (1x1x4)x64 = 256
//              16^2 ->128:   prep 16x8, 2x2x64 = 256;    apply 16x8, (2x1x4)x64 = 512
//              32^2 ->100:   prep 16x8, 8x2x64 = 1024;   apply 16x8, (8x1x4)x64 = 2048 (Ci 100)
//              64^2 64->64:  prep 16x8, 32x1x64 = 2048;  apply 32x8, (16x1x4)x64 = 4096
//   deep prep  128x256 64->64 (first_block_deep.cu): 16x8, 256x1x64 = 16384
// Two blocks fit an SM (at most 113 KB of shared memory and 128 registers
// each), so the 8^2 level (4% of the 6s chain's work) is one wave.
//
// Channel counts: multiples of 8 or of 20 up to 128 (8, 16, 32, 64, 100,
// 128 in the repo's models); others are refused before any launch. The
// reduction runs in slices of 8 (a short last slice is zero-filled) and the
// apply's N pads to a multiple of 8 with zero taps (100 -> 104). Tensors
// must be 16-byte aligned (cp.async).
//
// Bound on an H100: operations. Per instance the two forward convs and the
// K transposed convs are 2*(2+K)*H*W*Ci*Co*9 flops: 203 GFLOP per 3s request
// at b=256, 414 GFLOP per 6s request at b=64, against a few hundred MB of
// relevance and activations. On the tensor cores in 3xTF32 (495 / 3
// TFLOP/s, the least time for f32-accurate products) that is 1.23 and
// 2.51 ms; on the FMA units (67 TFLOP/s) 3.03 and 6.18 ms.
// The design moves every product to the tensor cores and keeps their
// feeding cheap: asynchronous staging, conflict-free ldmatrix loads of an
// A operand split once per slice, 64-pixel warp tiles. mma.sync does not
// reach the dense TF32 rate on Hopper (only wgmma does), so that rate, and
// the instructions that feed it, bound these kernels; wgmma is the next
// step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tc.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256, TW = 8;

// The channel counts the kernels take.
inline bool takes(int C) { return C > 0 && C <= 128 && (C % 8 == 0 || C % 20 == 0); }

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
gamma_prep_kernel(const float* __restrict__ x,     // [b, H, W, Ci]
                  const float* __restrict__ w,     // [nsl, 9, CC, 2*Co]
                  const float* __restrict__ bias,  // [3, Co]
                  const float* __restrict__ apre,  // [b, H, W, Co] or null
                  float* __restrict__ G,           // [b, H, W, Co]
                  int H, int W, int Ci, int Co, int kh, int kw, float inv, float stab) {
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
        tc::stage_region(buf, xn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, Ci, s * CC);
        tc::stage_taps<T::BN>(buf + 2 * T::A, w, s, N, n0);
        tc::cp_commit();
      },
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;     // x, then hi; lo
        tc::split_region(buf, buf + T::A, T::NQ, [&](int q, int c4) {
          return tc::relu4(*reinterpret_cast<const float4*>(buf + q * SP + c4));
        });
        __syncthreads();
        tc::slice_mma<T::MF, 4, true>(acc, buf, buf + T::A, lrow, T::RW, buf + 2 * T::A, T::WS,
                                      ncol, nfr);
      });

  const float* an = apre != nullptr ? apre + (size_t)n * H * W * Co : nullptr;
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wm * T::MF + i) * 16 + g + hf * 8;
      const int h = h0 + m / TW, ww = w0 + m % TW;
      if (h >= H || ww >= W) continue;
      const int wh = h - h % kh, wv = ww - ww % kw, me = (h - wh) * kw + (ww - wv);
      float* gp = G + (((size_t)n * H + h) * W + ww) * Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nfr) continue;
        const int o = (n0 + ncol + j * 8 + t4 * 2) >> 1;
        const float b1 = bias[o], b0 = bias[Co + o], b2 = bias[2 * Co + o];
        const float z1 = __fadd_rn(acc[i][j][2 * hf], b1);
        const float zt = __fadd_rn(
            __fmul_rn(__fsub_rn(__fadd_rn(z1, acc[i][j][2 * hf + 1]), b1), inv), b0);
        float v = zt > 0.f ? __fdiv_rn(1.0f, lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
        if (an != nullptr && v != 0.f &&
            lrp::route(an + ((size_t)wh * W + wv) * Co + o, kh, kw, W * Co, Co) != me)
          v = 0.f;
        gp[o] = v;
      }
    }
}

template <int WN, int MF>
__global__ void __launch_bounds__(THREADS, 2)
gamma_apply_kernel(const float* __restrict__ R,     // [b, K, H, W, Co]
                   const float* __restrict__ G,     // [b, H, W, Co]
                   const float* __restrict__ x,     // [b, H, W, Ci]
                   const float* __restrict__ wt,    // [nsl, 9, CC, Np]
                   const float* __restrict__ apre,  // [b, H*kh, W*kw, Ci] or null
                   float* __restrict__ out, int K, int H, int W, int Ci, int Co, int kh,
                   int kw) {
  using T = Tile<WN, MF>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Np = (Ci + 7) & ~7, nblk = (Np + T::BN - 1) / T::BN;
  // the K clones of a (tile, column block) are neighbours in the grid, so
  // that G, x and apre come from L2 for all but the first
  const int n = blockIdx.y, k = blockIdx.x % K, col = blockIdx.x / K;
  const int n0 = (col % nblk) * T::BN, tile = col / nblk;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (tile / tiles_w) * T::TH, w0 = (tile % tiles_w) * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, ncol = (warp % WN) * 32;
  const int nfr = min(4, max(0, (Np - n0 - ncol) / 8));
  const float* Rn = R + ((size_t)n * K + k) * H * W * Co;
  const float* Gn = G + (size_t)n * H * W * Co;
  int lrow[T::MF];
  tile_rows<T>(lrow, wm);
  float acc[T::MF][4][4] = {};

  tc::pipeline(
      (Co + CC - 1) / CC,
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;
        tc::stage_region(buf, Rn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, Co, s * CC);
        tc::stage_region(buf + T::A, Gn, T::TH + 2, T::RW, h0 - 1, w0 - 1, H, W, Co, s * CC);
        tc::stage_taps<T::BN>(buf + 2 * T::A, wt, s, Np, n0);
        tc::cp_commit();
      },
      [&](int s) {
        float* buf = smem + (s & 1) * T::STAGE;     // R, then hi; G, then lo
        tc::split_region(buf, buf + T::A, T::NQ, [&](int q, int c4) {
          return tc::mul4(*reinterpret_cast<const float4*>(buf + q * SP + c4),
                          *reinterpret_cast<const float4*>(buf + T::A + q * SP + c4));
        });
        __syncthreads();
        tc::slice_mma<T::MF, 4, false>(acc, buf, buf + T::A, lrow, T::RW, buf + 2 * T::A, T::WS,
                                       ncol, nfr);
      });

  const int Hf = H * kh, Wf = W * kw;
  const float* an = apre != nullptr ? apre + (size_t)n * Hf * Wf * Ci : nullptr;
  float* on = out + ((size_t)n * K + k) * Hf * Wf * Ci;
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
        const float2 xv = *reinterpret_cast<const float2*>(
            x + (((size_t)n * H + h) * W + ww) * Ci + ci);
        const float v0 = __fmul_rn(xv.x, acc[i][j][2 * hf]);
        const float v1 = __fmul_rn(xv.y, acc[i][j][2 * hf + 1]);
        if (an == nullptr) {
          *reinterpret_cast<float2*>(on + ((size_t)h * W + ww) * Ci + ci) = make_float2(v0, v1);
          continue;
        }
        // pool backward: the whole value goes to the first maximum of
        // relu(apre) in row-major window order; the other positions get 0
        const float* a = an + (((size_t)h * kh) * Wf + ww * kw) * Ci + ci;
        const int win0 = lrp::route(a, kh, kw, Wf * Ci, Ci);
        const int win1 = lrp::route(a + 1, kh, kw, Wf * Ci, Ci);
        for (int r = 0; r < kh; ++r)
          for (int s = 0; s < kw; ++s)
            *reinterpret_cast<float2*>(on + (((size_t)h * kh + r) * Wf + ww * kw + s) * Ci + ci) =
                make_float2(r * kw + s == win0 ? v0 : 0.f, r * kw + s == win1 ? v1 : 0.f);
      }
    }
}

template <int WN, int MF>
cudaError_t launch_prep(int b, cudaStream_t st, const float* x, const float* w,
                        const float* bias, const float* apre, float* G, int H, int W, int Ci,
                        int Co, int kh, int kw, float inv, float stab) {
  using T = Tile<WN, MF>;
  const dim3 grid(((H + T::TH - 1) / T::TH) * ((W + TW - 1) / TW),
                  (2 * Co + T::BN - 1) / T::BN, b);
  const size_t bytes = sizeof(float) * 2 * T::STAGE;
  cudaError_t err = lrp::set_smem(gamma_prep_kernel<WN, MF>, bytes);
  if (err != cudaSuccess) return err;
  gamma_prep_kernel<WN, MF><<<grid, THREADS, bytes, st>>>(x, w, bias, apre, G, H, W, Ci, Co, kh,
                                                      kw, inv, stab);
  return cudaGetLastError();
}

template <int WN, int MF>
cudaError_t launch_apply(int b, cudaStream_t st, const float* R, const float* G,
                         const float* x, const float* wt, const float* apre, float* out, int K,
                         int H, int W, int Ci, int Co, int kh, int kw) {
  using T = Tile<WN, MF>;
  const int nblk = (((Ci + 7) & ~7) + T::BN - 1) / T::BN;
  const dim3 grid(((H + T::TH - 1) / T::TH) * ((W + TW - 1) / TW) * nblk * K, b);
  const size_t bytes = sizeof(float) * 2 * T::STAGE;
  cudaError_t err = lrp::set_smem(gamma_apply_kernel<WN, MF>, bytes);
  if (err != cudaSuccess) return err;
  gamma_apply_kernel<WN, MF><<<grid, THREADS, bytes, st>>>(R, G, x, wt, apre, out, K, H, W, Ci, Co,
                                                       kh, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Phase 1. x [b,H,W,Ci] (read as relu(x)), w [ceil(Ci/8),9,8,2Co] (the
// interleaved forward pair, xai/lrp/chain.py GammaConv.w_prep), bias [3,Co],
// G [b,H,W,Co]; apre [b,H,W,Co] or NULL: G is zeroed off the first-argmax
// route of relu(apre) over (kh, kw) windows (H % kh == W % kw == 0).
// Returns cudaErrorInvalidValue, before any launch, for channel counts the
// kernel does not take or unaligned tensors; else cudaGetLastError().
int chain_gamma_prep(const float* x, const float* w, const float* bias,
                     const float* apre, float* G, int b, int H, int W, int Ci,
                     int Co, int kh, int kw, float inv, float stab, void* stream) {
  if (!takes(Ci) || !takes(Co) || !tc::aligned16(x) || !tc::aligned16(w))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PREP(WN, MF) launch_prep<WN, MF>(b, s, x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab)
  switch (warps_n(2 * Co)) {
    case 4: return H >= tall_rows(4) ? PREP(4, 4) : PREP(4, 2);
    case 2: return H >= tall_rows(2) ? PREP(2, 4) : PREP(2, 2);
    default: return PREP(1, 2);
  }
#undef PREP
}

// Phase 2. R [b,K,H,W,Co], G [b,H,W,Co], x [b,H,W,Ci], wt
// [ceil(Co/8),9,8,Np] (the transposed w + g*w+, Np = Ci rounded up to 8,
// GammaConv.w_apply_tc); apre [b,H*kh,W*kw,Ci] or NULL; out [b,K,H,W,Ci]
// (no pool) or [b,K,H*kh,W*kw,Ci]. Refusals as phase 1.
int chain_gamma_apply(const float* R, const float* G, const float* x,
                      const float* wt, const float* apre, float* out, int b,
                      int K, int H, int W, int Ci, int Co, int kh, int kw,
                      void* stream) {
  if (!takes(Ci) || !takes(Co) || !tc::aligned16(R) || !tc::aligned16(G) ||
      !tc::aligned16(wt) || !tc::aligned16(x) || !tc::aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define APPLY(WN, MF) launch_apply<WN, MF>(b, s, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw)
  switch (warps_n((Ci + 7) & ~7)) {
    case 4: return H >= tall_rows(4) ? APPLY(4, 4) : APPLY(4, 2);
    case 2: return H >= tall_rows(2) ? APPLY(2, 4) : APPLY(2, 2);
    default: return APPLY(1, 2);
  }
#undef APPLY
}

}  // extern "C"
