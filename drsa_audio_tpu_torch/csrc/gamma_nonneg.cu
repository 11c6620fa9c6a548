// The gamma rule on non-negative input for one 3x3 SAME conv, with the K
// relevance clones of each instance: the shared-denominator LRP walk's hot
// rule (xai/lrp/rules.py shared_gamma_nonneg).
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_gamma.py
// _gamma_nonneg_kernel (:49, launched :135); the Python wrapper is
// xai/lrp/fused_gamma.py gamma_nonneg_folded.
//
// Math (f32; x, R and the result NCHW, as the walk holds them, the K clones
// folded clone-major into the batch of R):
//   z1 = conv(x, w + g*w+) + b1,  z3 = conv(x, w + g*w-)
//   z_true = (z1 + z3 - b1) * f32(1/(2+g)) + b0      (the TPU kernel's form)
//   m1 = [z_true > 0] / stab(z1 + b2),  m3 = [z_true < 0] / stab(z3)
//   R_in[k] = x * (convT(R[k] * m1, w + g*w+) + convT(R[k] * m3, w + g*w-))
// with b1 = b + g*b+, b2 = b + g*b-, b0 = b. x is used as given (no relu).
// Unlike chain_block.cu, no relu gate multiplies R here, so the m3 term is
// not zero and both transposed terms are formed.
//
// Two launches, both 3xTF32 implicit GEMMs on Hopper's wgmma through
// conv3x3_wgmma.cuh (A from registers, loaded with ldmatrix from the split
// region; B the taps pre-split on the host and staged by one bulk copy a
// slice; two stages in flight), in the tiles of chain_block.cu (two
// warpgroups over a TH x 8 pixel tile, MT m64 tiles each):
//   gamma_nonneg_prep   once per (instance, tile, column chunk): one GEMM
//          over the interleaved forward pair (column 2j the taps of
//          w + g*w+, 2j + 1 those of w + g*w-: GammaConv.w_prep_wg's layout,
//          in chunks of BN = 32 columns), so a thread's accumulator pair is
//          (z1, z3) of one channel. It sums FRESH, as chain_gamma_prep (the
//          multipliers are sign decisions), and writes M = (m1, m3)
//          interleaved [b, H, W, 2*Co] once per instance: the clone-shared
//          work is not repeated per clone.
//   gamma_nonneg_apply  once per (instance, clone, tile): the transposed
//          conv over the 2*Co channels R[o] * M[2o + s] against the stacked
//          flipped taps of the pair (reduction row 2o + s those of w + g*w+,
//          s = 0, or w + g*w-, s = 1), all of Ci in one tile of BN columns
//          (8 ... 64, 104, 128), times x. A tile's K clones are neighbours
//          in the grid, so that M and x come from L2 for all but the first.
// The host builds both layouts once per layer (fused_gamma.pair_taps) and
// passes their widths; the kernels refuse a width they have no instance for.
//
// Layouts. x and R are staged from NCHW as they lie, whole 16-byte pieces of
// the tile's rows (tc::stage_rows_nchw: 16 columns around the tile's 10),
// and the split, which reads every staged value once anyway, moves them into
// the pixel-major layout ldmatrix reads. M is channels last and staged 16
// bytes a copy. The apply's sums go to shared memory channel-major, and
// each thread writes four neighbouring pixels of a channel of the NCHW
// result (one float4 of x read, one written). Where W % 4 != 0 (rows not
// 16-byte aligned) the staging copies, and the epilogue writes, one float
// at a time. So the wrapper moves no tensor between layouts.
//
// Bound on an H100: operations. The forward pair is 2*b*H*W*9*Ci*2*Co flops
// and the transposed conv 2*K*b*H*W*9*Co*Ci (m1 and m3 are disjoint, so
// each relevance entry meets one weight set), against ~4*(b*Ci + K*b*Co +
// K*b*Ci)*H*W bytes; the least time counts every product at 3xTF32 on the
// tensor cores (495 / 3 TFLOP/s). wgmma is the only instruction at that
// rate on Hopper. What the design leaves: a per-entry choice of weight set
// is not a GEMM, so the apply multiplies over all 2*Co channels, half of
// them zeros (twice the transposed conv's products that the bound counts);
// and the prep's FRESH groups are each waited for and added in f32.
//
// Channel counts: 0 < Ci, Co <= 128, Ci % 4 == 0, and Co a multiple of 8 or
// of 20 (the 6s model's 100 channels); b at most 65535. The apply's N pads
// with zero taps to its tile's width (100 -> 104). Other counts, a width
// without an instance, and taps or M that are not 16-byte aligned are
// refused before any launch with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256, TW = 8, RW = TW + 2;
constexpr int ROW = 16;                          // floats of a staged NCHW row piece
constexpr int OFF = 3;                           // its column of the region's first pixel
constexpr int BARS = 4;                          // floats before the rest: two mbarriers

// The counts and sizes both launches take (b is a grid dimension of both).
inline bool takes(int b, int K, int H, int W, int Ci, int Co) {
  return Co > 0 && Co <= 128 && (Co % 8 == 0 || Co % 20 == 0) && Ci > 0 && Ci <= 128 &&
         Ci % 4 == 0 && b > 0 && b <= 65535 && K > 0 && H > 0 && W > 0;
}

// A block's geometry for BN columns and MT m64 tiles a warpgroup.
template <int BN, int MT_>
struct Geo {
  static constexpr int MT = MT_;
  static constexpr int TH = 16 * MT, RH = TH + 2;          // two warpgroups of MT m64 tiles
  static constexpr int NQ = RH * RW, A = NQ * SP;          // the split region: tile + halo
  static constexpr int TAPS = wg::taps_floats<BN>();
  // prep: a stage holds the taps and x's rows (8 channels); hi and lo lie
  // before the stages. apply: the taps, R's rows (4 channels) and M's
  // region (8 channels, split in place into lo); hi before the stages.
  static constexpr int PREP_STAGE = TAPS + CC * RH * ROW;
  static constexpr int APPLY_STAGE = TAPS + CC / 2 * RH * ROW + A;
};

// The staged NCHW value of channel c at region pixel q: rows [c][RH][ROW].
template <int RH>
__device__ __forceinline__ float at_row(const float* rows, int c, int q) {
  return rows[(c * RH + q / RW) * ROW + q % RW + OFF];
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    wg::bar_init(&bars[0]);
    wg::bar_init(&bars[1]);
    wg::bar_init_fence();
  }
  __syncthreads();
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, 2)
gamma_nonneg_prep_wg(const float* __restrict__ x,     // [b, Ci, H, W]
                     const float* __restrict__ w,     // [chunks, nsl, 2, 9, 2, BN, 4]
                     const float* __restrict__ bias,  // [3, Co]: b1, b0, b2
                     float* __restrict__ M,           // [b, H, W, 2*Co]
                     int H, int W, int Ci, int Co, float inv, float stab, int vec) {
  using Gm = Geo<BN, MT>;
  constexpr int TH = Gm::TH, RH = Gm::RH, NQ = Gm::NQ, A = Gm::A, TAPS = Gm::TAPS;
  constexpr int STAGE = Gm::PREP_STAGE;
  // FRESH's scratch fragments leave room for two groups in flight at one
  // tile a warpgroup, one at two
  constexpr int DEPTH = MT == 1 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* hi = smem + BARS;
  float* lo = hi + A;
  float* stg = lo + A;
  const int N = 2 * Co, nsl = (Ci + CC - 1) / CC, n = blockIdx.z, n0 = blockIdx.y * BN;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* xn = x + (size_t)n * Ci * H * W;
  const float* wb = w + (size_t)blockIdx.y * nsl * TAPS;
  int lrow[MT];
  const int nt = wg::tile_rows<MT, TW, RW>(lrow, wgi, h0, H);
  float acc[MT][BN / 2] = {};
  init_bars(bars);

  tc::pipeline(
      nsl,
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;
        tc::stage_rows_nchw<CC>(buf + TAPS, xn, RH, h0 - 1, w0, H, W, Ci, s * CC, vec);
        tc::cp_commit();
        if (threadIdx.x == 0) wg::bulk_load(buf, wb + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
      },
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;   // taps; x's rows
        const float* rows = buf + TAPS;
        tc::split_region(hi, lo, NQ, [&](int q, int c4) {
          return make_float4(at_row<RH>(rows, c4, q), at_row<RH>(rows, c4 + 1, q),
                             at_row<RH>(rows, c4 + 2, q), at_row<RH>(rows, c4 + 3, q));
        });
        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
        __syncthreads();
        if (nt > 0)
          wg::slice<BN, true, DEPTH, MT>(acc, wg::saddr(hi), wg::saddr(lo), lrow, RW,
                                         wg::saddr(buf));
      });

  // (m1, m3) of the chunk's channels through shared memory (free after the
  // pipeline's last barrier): each fragment pair to its pixel's row, then
  // four columns a thread go out as one float4
  constexpr int GS = BN + 4;
  float* gs = smem + BARS;                        // [TH * TW][GS]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + g + hf * 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + t4 * 2, o = col >> 1;
        float2 v = make_float2(0.f, 0.f);
        if (col < N) {
          const float b1 = bias[o], b0 = bias[Co + o], b2 = bias[2 * Co + o];
          const float z1 = __fadd_rn(acc[i][4 * j + 2 * hf], b1), z3 = acc[i][4 * j + 2 * hf + 1];
          const float zt = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(z1, z3), b1), inv), b0);
          v.x = zt > 0.f ? __frcp_rn(lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
          v.y = zt < 0.f ? __frcp_rn(lrp::stabilize(z3, stab)) : 0.f;
        }
        *reinterpret_cast<float2*>(gs + m * GS + j * 8 + t4 * 2) = v;
      }
    }
  __syncthreads();
  float* Mn = M + (size_t)n * H * W * N + n0;
  for (int e = threadIdx.x; e < TH * TW * (BN / 4); e += THREADS) {
    const int m = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int h = h0 + m / TW, ww = w0 + m % TW;
    if (h < H && ww < W && n0 + c < N)
      *reinterpret_cast<float4*>(Mn + ((size_t)h * W + ww) * N + c) =
          *reinterpret_cast<const float4*>(gs + m * GS + c);
  }
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, BN <= 64 ? 2 : 1)
gamma_nonneg_apply_wg(const float* __restrict__ R,    // [K*b, Co, H, W]
                      const float* __restrict__ M,    // [b, H, W, 2*Co]
                      const float* __restrict__ x,    // [b, Ci, H, W]
                      const float* __restrict__ wt,   // [1, Co/4, 2, 9, 2, BN, 4]
                      float* __restrict__ out,        // [K*b, Ci, H, W]
                      int K, int H, int W, int Ci, int Co, int vec) {
  using Gm = Geo<BN, MT>;
  constexpr int TH = Gm::TH, RH = Gm::RH, NQ = Gm::NQ, A = Gm::A, TAPS = Gm::TAPS;
  constexpr int STAGE = Gm::APPLY_STAGE, RR = CC / 2 * RH * ROW;
  // wgmma groups in flight: as many as the registers allow beside the
  // accumulators (chain_block.cu's apply)
  constexpr int DEPTH = MT == 2 ? 2 : 3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* hi = smem + BARS;
  float* stg = hi + A;
  const int NG = 2 * Co;                          // the reduction's channels
  const int n = blockIdx.y, k = blockIdx.x % K, tile = blockIdx.x / K;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t HW = (size_t)H * W, img = (size_t)k * gridDim.y + n;
  const float* Rn = R + img * Co * HW;
  const float* Mn = M + (size_t)n * HW * NG;
  int lrow[MT];
  const int nt = wg::tile_rows<MT, TW, RW>(lrow, wgi, h0, H);
  float acc[MT][BN / 2] = {};
  init_bars(bars);

  tc::pipeline(
      NG / CC,
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;
        // R channels [4s, 4s + 4) meet M channels [8s, 8s + 8)
        tc::stage_rows_nchw<CC / 2>(buf + TAPS, Rn, RH, h0 - 1, w0, H, W, Co, s * CC / 2, vec);
        tc::stage_region(buf + TAPS + RR, Mn, RH, RW, h0 - 1, w0 - 1, H, W, NG, s * CC);
        tc::cp_commit();
        if (threadIdx.x == 0) wg::bulk_load(buf, wt + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
      },
      [&](int s) {
        float* buf = stg + (s & 1) * STAGE;   // taps; R's rows; M, then lo
        const float* rows = buf + TAPS;
        float* lo = buf + TAPS + RR;
        tc::split_region(hi, lo, NQ, [&](int q, int c4) {
          const float r0 = at_row<RH>(rows, c4 >> 1, q), r1 = at_row<RH>(rows, (c4 >> 1) + 1, q);
          const float4 mv = *reinterpret_cast<const float4*>(lo + q * SP + c4);
          return make_float4(__fmul_rn(r0, mv.x), __fmul_rn(r0, mv.y), __fmul_rn(r1, mv.z),
                             __fmul_rn(r1, mv.w));
        });
        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
        __syncthreads();
        if (nt > 0)
          wg::slice<BN, false, DEPTH, MT>(acc, wg::saddr(hi), wg::saddr(lo), lrow, RW,
                                          wg::saddr(buf));
      });

  // the sums through shared memory channel-major (free after the
  // pipeline's last barrier; S = 4 mod 32 keeps the fragment writes on
  // distinct banks), then four neighbouring pixels of a channel a thread:
  // times x, written NCHW
  constexpr int S = TH * TW + 4, Q = TH * TW / 4;
  float* as = smem + BARS;                        // [BN][S]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + g + hf * 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + t4 * 2;
        as[c * S + m] = acc[i][4 * j + 2 * hf];
        as[(c + 1) * S + m] = acc[i][4 * j + 2 * hf + 1];
      }
    }
  __syncthreads();
  const float* xn = x + (size_t)n * Ci * HW;
  float* on = out + img * Ci * HW;
  for (int e = threadIdx.x; e < Ci * Q; e += THREADS) {
    const int c = e / Q, p = (e % Q) * 4;
    const int h = h0 + p / TW, ww = w0 + p % TW;
    if (h >= H || ww >= W) continue;
    const float* a = as + c * S + p;
    const size_t at = c * HW + (size_t)h * W + ww;
    if (vec) {
      *reinterpret_cast<float4*>(on + at) =
          tc::mul4(*reinterpret_cast<const float4*>(xn + at), *reinterpret_cast<const float4*>(a));
      continue;
    }
    for (int i = 0; i < 4 && ww + i < W; ++i) on[at + i] = __fmul_rn(xn[at + i], a[i]);
  }
}

template <int BN, int MT>
constexpr size_t prep_smem() {
  using Gm = Geo<BN, MT>;
  return sizeof(float) * (BARS + 2 * Gm::A + 2 * Gm::PREP_STAGE);
}

template <int BN, int MT>
constexpr size_t apply_smem() {
  using Gm = Geo<BN, MT>;
  return sizeof(float) * (BARS + Gm::A + 2 * Gm::APPLY_STAGE);
}

// Whole 16-byte pieces of the NCHW rows: W % 4 == 0 and aligned tensors.
inline int vec_rows(int W, const float* a, const float* b) {
  return W % 4 == 0 && tc::aligned16(a) && tc::aligned16(b);
}

}  // namespace

extern "C" {

// x [b,Ci,H,W], w the interleaved forward pair, pre-split, in column chunks
// of BN (16 or 32) columns: [ceil(2Co/BN), ceil(Ci/8), 2, 9, 2, BN, 4]
// (xai/lrp/taps.py GammaConv.w_prep_wg, whose layout chooses BN),
// bias [3,Co] (b1, b0, b2), M [b,H,W,2Co]. Returns cudaErrorInvalidValue,
// before the launch, for counts, sizes, widths or alignments it does not
// take; else cudaGetLastError().
int gamma_nonneg_prep(const float* x, const float* w, const float* bias, float* M, int b,
                      int H, int W, int Ci, int Co, int BN, float inv, float stab,
                      void* stream) {
  if (!takes(b, 1, H, W, Ci, Co) || !tc::aligned16(w) || !tc::aligned16(M))
    return cudaErrorInvalidValue;
  const int vec = vec_rows(W, x, x);
  return wg::prep_tile(BN, H, [&](auto bn, auto mt) {
    constexpr int BN_ = decltype(bn)::value, MT_ = decltype(mt)::value;
    constexpr int TH = Geo<BN_, MT_>::TH;
    const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (2 * Co + BN_ - 1) / BN_, b);
    cudaError_t err = lrp::set_smem(gamma_nonneg_prep_wg<BN_, MT_>, prep_smem<BN_, MT_>());
    if (err != cudaSuccess) return err;
    gamma_nonneg_prep_wg<BN_, MT_><<<grid, THREADS, prep_smem<BN_, MT_>(), (cudaStream_t)stream>>>(
        x, w, bias, M, H, W, Ci, Co, inv, stab, vec);
    return cudaGetLastError();
  }, cudaErrorInvalidValue);
}

// R [K*b,Co,H,W] (clone-major), M [b,H,W,2Co] (from the prep), x
// [b,Ci,H,W], wt the pair flipped and transposed, rows interleaved as M,
// pre-split in one chunk of BN >= Ci columns (8 ... 64, 104 or 128):
// [1, Co/4, 2, 9, 2, BN, 4] (GammaConv.w_apply_pair_wg), out [K*b,Ci,H,W].
// Refusals as the prep, and for BN < Ci.
int gamma_nonneg_apply(const float* R, const float* M, const float* x, const float* wt,
                       float* out, int b, int K, int H, int W, int Ci, int Co, int BN,
                       void* stream) {
  if (!takes(b, K, H, W, Ci, Co) || BN < Ci || !tc::aligned16(M) || !tc::aligned16(wt))
    return cudaErrorInvalidValue;
  const int vec = vec_rows(W, R, x) && tc::aligned16(out);
  return wg::apply_tile(BN, H, [&](auto bn, auto mt) {
    constexpr int BN_ = decltype(bn)::value, MT_ = decltype(mt)::value;
    constexpr int TH = Geo<BN_, MT_>::TH;
    const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW) * K, b);
    cudaError_t err = lrp::set_smem(gamma_nonneg_apply_wg<BN_, MT_>, apply_smem<BN_, MT_>());
    if (err != cudaSuccess) return err;
    gamma_nonneg_apply_wg<BN_, MT_><<<grid, THREADS, apply_smem<BN_, MT_>(),
                                      (cudaStream_t)stream>>>(R, M, x, wt, out, K, H, W, Ci, Co,
                                                              vec);
    return cudaGetLastError();
  }, cudaErrorInvalidValue);
}

// The dynamic shared memory, bytes, a block of gamma_nonneg_prep (prep !=
// 0) or gamma_nonneg_apply takes for taps BN columns wide at a level of H
// rows; 0 for a BN the kernel does not take.
size_t gamma_nonneg_smem(int prep, int BN, int H) {
  if (prep)
    return wg::prep_tile(BN, H, [](auto bn, auto mt) {
      return prep_smem<decltype(bn)::value, decltype(mt)::value>();
    }, size_t{0});
  return wg::apply_tile(BN, H, [](auto bn, auto mt) {
    return apply_smem<decltype(bn)::value, decltype(mt)::value>();
  }, size_t{0});
}

}  // extern "C"
