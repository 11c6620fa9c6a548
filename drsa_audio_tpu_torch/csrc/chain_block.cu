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
// Two launches per conv, both 3xTF32 implicit GEMMs on wgmma through
// conv3x3_wgmma.cuh (A from registers, pre-split K-major taps by bulk copy):
//   chain_gamma_prep   once per (instance, tile, column chunk): one GEMM
//                over the interleaved forward pair (column 2j the taps of
//                w + g*w+, 2j + 1 those of w + g*w-), so a thread's
//                accumulator pair is (z1, z3) of one channel; the epilogue
//                forms z_true and G in registers and writes G [b, H, W, Co].
//                It reads relu(x): a chain conv's input is a relu output
//                already, and the deep first block (first_block_deep.cu)
//                passes the pre-relu a1; for that block it also zeroes G off
//                the first-argmax route of the (kh, kw) pool above the conv
//                (strict >, row-major: an all-tied window routes to position
//                0), so that the clone-shared route is taken once per
//                instance. merged_tail.cu's preps are this launch too. It
//                accumulates FRESH (conv3x3_wgmma.cuh): on the card, sums
//                accumulated in the tensor core drifted enough to flip a
//                z_true at 6e-7 of the map's maximum.
//   chain_gamma_apply  once per (instance, clone, tile): the transposed conv
//                of R * G (both staged as they are, formed and split once
//                per slice), times x, written or routed through the pool
//                backward to the finer level. A tile's K clones are
//                neighbours in the grid, so that G, x and apre come from L2
//                for all but the first.
//
// Tiles (Geo). A block is two warpgroups over a TH x 8 pixel tile, each
// warpgroup MT m64 tiles (8 rows of 8); a warpgroup whose tiles all lie
// below the image skips its products. MT = 2 (TH = 32) where the B tile is
// 32 columns or fewer and the level 32 rows or more, so that a wgmma group
// holds six products and each staged slice of taps serves 256 pixels;
// else MT = 1 (TH = 16). The
// prep's N = 2*Co runs in column chunks of BN = 32 (16 for Co = 8), so that
// its FRESH scratch fragments fit beside the accumulators; the apply takes
// all of Ci in one tile of BN columns (8 ... 64, 104, 128). The host lays
// the taps out at these widths (xai/lrp/chain.py prep_chunk, wg_cols) and
// passes BN; the kernels take it from there and refuse a width they lack.
// A stage holds the two staged regions and the taps (576 * BN bytes): two
// blocks an SM up to 64 columns, one for the apply's 104 and 128 (the 6s
// 8^2 and 16^2 levels and the 100-channel convs' applies). The epilogues go
// through shared memory and write four channels a thread (one float4),
// the pool route taken once per window and channel group. Grids (prep:
// tiles x chunks x b; apply: tiles x K, b) at the main path's shapes:
//   3s b=256   16^2 64->64:  prep 2x4x256;   apply (2x4)x256, BN 64
//              32^2 32->64:  prep 4x4x256;   apply (4x4)x256, BN 32
//              64^2 32->32:  prep 16x2x256;  apply (16x4)x256, BN 32
//   6s b=64    8^2 128->128: prep 1x8x64;    apply (1x4)x64, BN 128
//              16^2 ->128:   prep 2x8x64;    apply (2x4)x64, BN 104 / 128
//                            (the prep's tiles 16x8 on the 8^2 and 16^2 levels)
//              32^2 ->100:   prep 4x7x64;    apply (8x4)x64, BN 64 / 104
//              64^2 64->64:  prep 16x4x64;   apply (32x4)x64, BN 64
//   deep prep  128x256 64->64 (first_block_deep.cu): 128x4x64
//
// Channel counts: multiples of 8 or of 20 up to 128 (8, 16, 32, 64, 100,
// 128 in the repo's models); others are refused before any launch. The
// reduction runs in slices of 8 (a short last slice has zero taps and
// zero-filled activations) and N pads with zero taps to the tile's width.
// Tensors must be 16-byte aligned (cp.async, the bulk copies).
//
// Bound on an H100: operations. Per instance the two forward convs and the
// K transposed convs are 2*(2+K)*H*W*Ci*Co*9 flops: 203 GFLOP per 3s request
// at b=256, 414 GFLOP per 6s request at b=64, against a few hundred MB of
// relevance and activations. On the tensor cores in 3xTF32 (495 / 3
// TFLOP/s, the least time for f32-accurate products) that is 1.23 and
// 2.51 ms; on the FMA units (67 TFLOP/s) 3.03 and 6.18 ms. wgmma is the
// only instruction that reaches the dense TF32 rate on Hopper; the design
// feeds it from registers (A, split once per slice) and from bulk-copied
// pre-split taps (B, no conversion in the loop). What it leaves: each tap's
// three products are waited for before the next tap's A loads, and the
// split of a slice runs between the copies and the products, so the tensor
// cores wait unless the SM's other warpgroups fill in; and the pre-split
// taps double the bytes each block reads from L2 per slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_wgmma.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256, TW = 8, RW = TW + 2;
constexpr int BARS = 4;                          // floats before the stages: two mbarriers

// The channel counts the kernels take.
inline bool takes(int C) { return C > 0 && C <= 128 && (C % 8 == 0 || C % 20 == 0); }

// A block's geometry for BN columns and MT m64 tiles a warpgroup.
template <int BN, int MT_>
struct Geo {
  static constexpr int MT = MT_;
  static constexpr int TH = 16 * MT;                        // two warpgroups of MT m64 tiles
  static constexpr int NQ = (TH + 2) * RW, A = NQ * SP;     // staged region: tile + halo
  static constexpr int TAPS = wg::taps_floats<BN>();
  // a stage: the taps, then two regions (x and the split's lo, or R and G;
  // split in place into hi and lo)
  static constexpr int STAGE = TAPS + 2 * A;
};

// This lane's ldmatrix rows for its warp's 16 rows of each of warpgroup
// wgi's m64 tiles (tile wgi * MT + i holds tile rows 8 (wgi * MT + i) ..
// + 7): tile pixel m at (m / TW, m % TW), region offset (m / TW) * RW + m % TW.
// Returns how many of them hold image rows; a warpgroup with none skips its
// products.
template <int MT>
__device__ __forceinline__ int tile_rows(int (&lrow)[MT], int wgi, int h0, int H) {
  const int wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    lrow[i] = tc::lane_row([&](int r) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + r;
      return (m / TW) * RW + m % TW;
    });
  return min(MT, max(0, (H - h0 - 8 * MT * wgi + 7) / 8));
}

// lrp::route for four neighbouring channels: the first maximum of relu(a)
// over a kh x kw pool window in row-major order (strict >, an all-tied
// window routes to position 0). a points at the window's first pixel and
// channel, rs and cs are its row and pixel strides; 16-byte aligned.
__device__ __forceinline__ int4 route4(const float* a, int kh, int kw, int rs, int cs) {
  float4 best = make_float4(-1.f, -1.f, -1.f, -1.f);
  int4 win = make_int4(0, 0, 0, 0);
  for (int r = 0; r < kh; ++r)
    for (int s = 0; s < kw; ++s) {
      const float4 v = tc::relu4(*reinterpret_cast<const float4*>(a + r * rs + s * cs));
      const int p = r * kw + s;
      if (v.x > best.x) { best.x = v.x; win.x = p; }
      if (v.y > best.y) { best.y = v.y; win.y = p; }
      if (v.z > best.z) { best.z = v.z; win.z = p; }
      if (v.w > best.w) { best.w = v.w; win.w = p; }
    }
  return win;
}

// v where this window position p is the channel's route, else 0.
__device__ __forceinline__ float4 routed(float4 v, int4 win, int p) {
  return make_float4(win.x == p ? v.x : 0.f, win.y == p ? v.y : 0.f, win.z == p ? v.z : 0.f,
                     win.w == p ? v.w : 0.f);
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, 2)
gamma_prep_wg(const float* __restrict__ x,     // [b, H, W, Ci]
              const float* __restrict__ w,     // [chunks, nsl, 2, 9, 2, BN, 4]
              const float* __restrict__ bias,  // [3, Co]: b1, b0, b2
              const float* __restrict__ apre,  // [b, H, W, Co] or null
              float* __restrict__ G,           // [b, H, W, Co]
              int H, int W, int Ci, int Co, int kh, int kw, float inv, float stab) {
  using Gm = Geo<BN, MT>;
  constexpr int TH = Gm::TH, NQ = Gm::NQ, A = Gm::A, TAPS = Gm::TAPS, STAGE = Gm::STAGE;
  // FRESH's scratch fragments leave room for two groups in flight at one
  // tile a warpgroup, one at two
  constexpr int DEPTH = MT == 1 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int N = 2 * Co, nsl = (Ci + CC - 1) / CC, n = blockIdx.z, n0 = blockIdx.y * BN;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* xn = x + (size_t)n * H * W * Ci;
  const float* wb = w + (size_t)blockIdx.y * nsl * TAPS;
  int lrow[MT];
  const int nt = tile_rows(lrow, wgi, h0, H);
  float acc[MT][BN / 2] = {};
  if (threadIdx.x == 0) {
    wg::bar_init(&bars[0]);
    wg::bar_init(&bars[1]);
    wg::bar_init_fence();
  }
  __syncthreads();

  tc::pipeline(
      nsl,
      [&](int s) {
        float* buf = smem + BARS + (s & 1) * STAGE;
        tc::stage_region(buf + TAPS, xn, TH + 2, RW, h0 - 1, w0 - 1, H, W, Ci, s * CC);
        tc::cp_commit();
        if (threadIdx.x == 0) wg::bulk_load(buf, wb + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
      },
      [&](int s) {
        float* buf = smem + BARS + (s & 1) * STAGE;   // taps; x, then hi; lo
        float* hi = buf + TAPS;
        tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {
          return tc::relu4(*reinterpret_cast<const float4*>(hi + q * SP + c4));
        });
        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
        __syncthreads();
        if (nt > 0)
          wg::slice<BN, true, DEPTH, MT>(acc, wg::saddr(hi), wg::saddr(hi + A), lrow, RW,
                                     wg::saddr(buf));
      });

  // G of the chunk's channels through shared memory (the stages are free
  // after the pipeline's last barrier): each fragment value goes to its
  // pixel's row, then four channels a thread go out as one float4, routed
  // once per pool window and channel group where apre is given
  constexpr int CH = BN / 2, GS = CH + 4;
  float* gs = smem + BARS;                        // [TH * TW][GS]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + g + hf * 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + t4 * 2, o = col >> 1;
        float v = 0.f;
        if (col < N) {
          const float b1 = bias[o], b0 = bias[Co + o], b2 = bias[2 * Co + o];
          const float z1 = __fadd_rn(acc[i][4 * j + 2 * hf], b1), z3 = acc[i][4 * j + 2 * hf + 1];
          const float zt = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(z1, z3), b1), inv), b0);
          v = zt > 0.f ? __frcp_rn(lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
        }
        gs[m * GS + 4 * j + t4] = v;
      }
    }
  __syncthreads();
  const int o0 = n0 >> 1;
  float* Gn = G + (size_t)n * H * W * Co + o0;
  if (apre == nullptr) {
    for (int e = threadIdx.x; e < TH * TW * (CH / 4); e += THREADS) {
      const int m = e / (CH / 4), c = (e % (CH / 4)) * 4;
      const int h = h0 + m / TW, ww = w0 + m % TW;
      if (h < H && ww < W && o0 + c < Co)
        *reinterpret_cast<float4*>(Gn + ((size_t)h * W + ww) * Co + c) =
            *reinterpret_cast<const float4*>(gs + m * GS + c);
    }
    return;
  }
  // (kh, kw) windows lie in the tile (kh | TH, kw | TW) and in the image or
  // out of it whole (H % kh == W % kw == 0)
  const float* an = apre + (size_t)n * H * W * Co + o0;
  const int wx = TW / kw;
  for (int e = threadIdx.x; e < (TH / kh) * wx * (CH / 4); e += THREADS) {
    const int q = e / (CH / 4), c = (e % (CH / 4)) * 4;
    const int y = (q / wx) * kh, xx = (q % wx) * kw;
    const int h = h0 + y, ww = w0 + xx;
    if (h >= H || ww >= W || o0 + c >= Co) continue;
    const int4 win = route4(an + ((size_t)h * W + ww) * Co + c, kh, kw, W * Co, Co);
    for (int r = 0; r < kh; ++r)
      for (int s2 = 0; s2 < kw; ++s2)
        *reinterpret_cast<float4*>(Gn + ((size_t)(h + r) * W + ww + s2) * Co + c) = routed(
            *reinterpret_cast<const float4*>(gs + ((y + r) * TW + xx + s2) * GS + c), win,
            r * kw + s2);
  }
}

template <int BN, int MT>
__global__ void __launch_bounds__(THREADS, BN <= 64 ? 2 : 1)
gamma_apply_wg(const float* __restrict__ R,     // [b, K, H, W, Co]
               const float* __restrict__ G,     // [b, H, W, Co]
               const float* __restrict__ x,     // [b, H, W, Ci]
               const float* __restrict__ wt,    // [nsl, 2, 9, 2, BN, 4]
               const float* __restrict__ apre,  // [b, H*kh, W*kw, Ci] or null
               float* __restrict__ out,         // [b, K, H*kh, W*kw, Ci]
               int K, int H, int W, int Ci, int Co, int kh, int kw) {
  using Gm = Geo<BN, MT>;
  constexpr int TH = Gm::TH, NQ = Gm::NQ, A = Gm::A, TAPS = Gm::TAPS, STAGE = Gm::STAGE;
  // wgmma groups in flight: as many as the registers allow beside the
  // accumulators at two blocks an SM (one past 64 columns)
  constexpr int DEPTH = MT == 2 ? 2 : 3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int n = blockIdx.y, k = blockIdx.x % K, tile = blockIdx.x / K;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t img = (size_t)n * K + k;
  const float* Rn = R + img * H * W * Co;
  const float* Gn = G + (size_t)n * H * W * Co;
  int lrow[MT];
  const int nt = tile_rows(lrow, wgi, h0, H);
  float acc[MT][BN / 2] = {};
  if (threadIdx.x == 0) {
    wg::bar_init(&bars[0]);
    wg::bar_init(&bars[1]);
    wg::bar_init_fence();
  }
  __syncthreads();

  tc::pipeline(
      (Co + CC - 1) / CC,
      [&](int s) {
        float* buf = smem + BARS + (s & 1) * STAGE;
        tc::stage_region(buf + TAPS, Rn, TH + 2, RW, h0 - 1, w0 - 1, H, W, Co, s * CC);
        tc::stage_region(buf + TAPS + A, Gn, TH + 2, RW, h0 - 1, w0 - 1, H, W, Co, s * CC);
        tc::cp_commit();
        if (threadIdx.x == 0) wg::bulk_load(buf, wt + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
      },
      [&](int s) {
        float* buf = smem + BARS + (s & 1) * STAGE;   // taps; R, then hi; G, then lo
        float* hi = buf + TAPS;
        tc::split_region(hi, hi + A, NQ, [&](int q, int c4) {
          return tc::mul4(*reinterpret_cast<const float4*>(hi + q * SP + c4),
                          *reinterpret_cast<const float4*>(hi + A + q * SP + c4));
        });
        wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
        __syncthreads();
        if (nt > 0)
          wg::slice<BN, false, DEPTH, MT>(acc, wg::saddr(hi), wg::saddr(hi + A), lrow, RW,
                                          wg::saddr(buf));
      });

  // the sums through shared memory (the stages are free after the
  // pipeline's last barrier), then four channels a thread: times x, and
  // written, or routed through the pool backward once per window (the
  // whole value to the first maximum of relu(apre) in row-major order)
  constexpr int AS = BN + 8;
  float* as = smem + BARS;                        // [TH * TW][AS]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + g + hf * 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(as + m * AS + j * 8 + t4 * 2) =
            make_float2(acc[i][4 * j + 2 * hf], acc[i][4 * j + 2 * hf + 1]);
    }
  __syncthreads();
  const int nc = Ci / 4, Hf = H * kh, Wf = W * kw;
  const float* xn = x + (size_t)n * H * W * Ci;
  const float* an = apre != nullptr ? apre + (size_t)n * Hf * Wf * Ci : nullptr;
  float* on = out + img * Hf * Wf * Ci;
  for (int e = threadIdx.x; e < TH * TW * nc; e += THREADS) {
    const int m = e / nc, c = (e % nc) * 4;
    const int h = h0 + m / TW, ww = w0 + m % TW;
    if (h >= H || ww >= W) continue;
    const float4 v = tc::mul4(*reinterpret_cast<const float4*>(xn + ((size_t)h * W + ww) * Ci + c),
                              *reinterpret_cast<const float4*>(as + m * AS + c));
    const size_t at = ((size_t)h * kh * Wf + ww * kw) * Ci + c;    // the window's first pixel
    if (an == nullptr) {
      *reinterpret_cast<float4*>(on + at) = v;
      continue;
    }
    const int4 win = route4(an + at, kh, kw, Wf * Ci, Ci);
    for (int r = 0; r < kh; ++r)
      for (int s2 = 0; s2 < kw; ++s2)
        *reinterpret_cast<float4*>(on + at + ((size_t)r * Wf + s2) * Ci) =
            routed(v, win, r * kw + s2);
  }
}

template <int BN, int MT>
constexpr size_t smem_bytes() { return sizeof(float) * (BARS + 2 * Geo<BN, MT>::STAGE); }

template <int N>
using ic = std::integral_constant<int, N>;

// f(BN, MT) for the prep's column chunk of BN columns (the width the host
// laid the taps out in, xai/lrp/chain.py prep_chunk) at a level of H rows;
// no for a width without an instance.
template <class F, class R>
R prep_tile(int BN, int H, F f, R no) {
  const bool tall = H >= 32;
  switch (BN) {
    case 16: return tall ? f(ic<16>{}, ic<2>{}) : f(ic<16>{}, ic<1>{});
    case 32: return tall ? f(ic<32>{}, ic<2>{}) : f(ic<32>{}, ic<1>{});
    default: return no;
  }
}

// f(BN, MT) for the apply's one tile of BN columns (the width of the host's
// layout, chain.py wg_cols) at a level of H rows; no for a width without an
// instance.
template <class F, class R>
R apply_tile(int BN, int H, F f, R no) {
  const bool tall = H >= 32;
  switch (BN) {
    case 8: return tall ? f(ic<8>{}, ic<2>{}) : f(ic<8>{}, ic<1>{});
    case 16: return tall ? f(ic<16>{}, ic<2>{}) : f(ic<16>{}, ic<1>{});
    case 32: return tall ? f(ic<32>{}, ic<2>{}) : f(ic<32>{}, ic<1>{});
    case 64: return f(ic<64>{}, ic<1>{});
    case 104: return f(ic<104>{}, ic<1>{});
    case 128: return f(ic<128>{}, ic<1>{});
    default: return no;
  }
}

template <int BN, int MT>
cudaError_t launch_prep(int b, cudaStream_t st, const float* x, const float* w,
                        const float* bias, const float* apre, float* G, int H, int W, int Ci,
                        int Co, int kh, int kw, float inv, float stab) {
  constexpr int TH = Geo<BN, MT>::TH;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (2 * Co + BN - 1) / BN, b);
  cudaError_t err = lrp::set_smem(gamma_prep_wg<BN, MT>, smem_bytes<BN, MT>());
  if (err != cudaSuccess) return err;
  gamma_prep_wg<BN, MT><<<grid, THREADS, smem_bytes<BN, MT>(), st>>>(
      x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab);
  return cudaGetLastError();
}

template <int BN, int MT>
cudaError_t launch_apply(int b, cudaStream_t st, const float* R, const float* G,
                         const float* x, const float* wt, const float* apre, float* out, int K,
                         int H, int W, int Ci, int Co, int kh, int kw) {
  constexpr int TH = Geo<BN, MT>::TH;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW) * K, b);
  cudaError_t err = lrp::set_smem(gamma_apply_wg<BN, MT>, smem_bytes<BN, MT>());
  if (err != cudaSuccess) return err;
  gamma_apply_wg<BN, MT><<<grid, THREADS, smem_bytes<BN, MT>(), st>>>(
      R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Phase 1. x [b,H,W,Ci] (read as relu(x)), w the interleaved forward pair,
// pre-split, in column chunks of BN (16 or 32) columns: [ceil(2Co/BN),
// ceil(Ci/8), 2, 9, 2, BN, 4] (xai/lrp/chain.py GammaConv.w_prep_wg, whose
// layout chooses BN), bias [3,Co], G [b,H,W,Co]; apre [b,H,W,Co] or NULL: G
// is zeroed off the first-argmax route of relu(apre) over (kh, kw) windows
// (H % kh == W % kw == 0). Returns cudaErrorInvalidValue, before any launch,
// for channel counts or a BN the kernel does not take, or unaligned tensors;
// else cudaGetLastError().
int chain_gamma_prep(const float* x, const float* w, const float* bias,
                     const float* apre, float* G, int b, int H, int W, int Ci,
                     int Co, int BN, int kh, int kw, float inv, float stab, void* stream) {
  if (!takes(Ci) || !takes(Co) || !tc::aligned16(x) || !tc::aligned16(w))
    return cudaErrorInvalidValue;
  return prep_tile(BN, H, [&](auto bn, auto mt) {
    return launch_prep<decltype(bn)::value, decltype(mt)::value>(
        b, (cudaStream_t)stream, x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab);
  }, cudaErrorInvalidValue);
}

// Phase 2. R [b,K,H,W,Co], G [b,H,W,Co], x [b,H,W,Ci], wt the transposed
// w + g*w+, pre-split in one chunk of BN >= Ci columns (8 ... 64, 104 or
// 128): [ceil(Co/8), 2, 9, 2, BN, 4] (GammaConv.w_apply_wg); apre
// [b,H*kh,W*kw,Ci] or NULL; out [b,K,H,W,Ci] (no pool) or [b,K,H*kh,W*kw,Ci].
// Refusals as phase 1, and for BN < Ci.
int chain_gamma_apply(const float* R, const float* G, const float* x,
                      const float* wt, const float* apre, float* out, int b,
                      int K, int H, int W, int Ci, int Co, int BN, int kh, int kw,
                      void* stream) {
  if (!takes(Ci) || !takes(Co) || BN < Ci || !tc::aligned16(R) || !tc::aligned16(G) ||
      !tc::aligned16(wt) || !tc::aligned16(x) || !tc::aligned16(out))
    return cudaErrorInvalidValue;
  return apply_tile(BN, H, [&](auto bn, auto mt) {
    return launch_apply<decltype(bn)::value, decltype(mt)::value>(
        b, (cudaStream_t)stream, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw);
  }, cudaErrorInvalidValue);
}

// The dynamic shared memory, bytes, a block of chain_gamma_prep (prep != 0)
// or chain_gamma_apply takes for taps BN columns wide at a level of H rows;
// 0 for a BN the kernel does not take.
size_t chain_gamma_smem(int prep, int BN, int H) {
  const auto bytes = [](auto bn, auto mt) {
    return smem_bytes<decltype(bn)::value, decltype(mt)::value>();
  };
  return prep ? prep_tile(BN, H, bytes, size_t{0}) : apply_tile(BN, H, bytes, size_t{0});
}

}  // extern "C"
