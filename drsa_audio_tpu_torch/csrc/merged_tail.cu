// Merged tail of the lower LRP chain (the 3s and toy models, with the
// merged-tail switch on): blocks nb-2 .. 0 in one kernel. For the 3s model
// at DRSA layer 10 that is conv 6's gamma rule, the (2,2) max-pool 5
// backward, conv 3's gamma rule, then the first-layer tail (pool 2 route,
// relu gate, wsquare/flat rule of conv 0), for every relevance clone.
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_chain.py
// _merged_tail_kernel (:746, launched :1155), including its mm_taps flag
// variant (the same function).
//
// Math (f32, NHWC; C = conv 3's input and output channels = conv 6's input
// channels = the first conv's output channels, C6 = conv 6's output):
//   R6 = x6 * convT(R * G6, w6 + g*w6+)                   [h, w, C]
//   R3 = x3 * convT(upsample2(R6) * M3, w3 + g*w3+)       [2h, 2w, C]
//   s0 = upsample2(R3) * route(relu(a1)) * relu_gate(a1) / stab(z0)
//   heat[y, x] = sum_{dy,dx,c} s0[y+dy-1, x+dx-1, c] * taps[dy, dx, c]
// G6 = [z_true > 0] / stab(z1 + b2) is conv 6's clone-shared multiplier and
// M3 = G3 * route(relu(apre5)) conv 3's with the pool-5 route folded in;
// chain_gamma_prep (csrc/chain_block.cu, on the tensor cores) writes both
// once per instance. The gamma rule's convT(R * m3) term vanishes under the
// relu gate, as in chain_block.cu. With one merged conv (DRSA layer 7) the
// first line is absent and R enters at conv 3's output, M3 = G3.
//
// One thread block (7 warps) per (32x32 heatmap tile, clone, instance),
// clones the fastest grid index so that the K blocks of a tile share the
// instance's maps in L2. Walking up from the tile, each level's region grows
// by the one-pixel halo its transposed conv needs: R3 over the tile's 16x16
// parent + 1 (18x18), the staged R6 * M3 + 2 (20x20), R6 over its 8x8 parent
// + 1 (10x10), the staged R * G6 + 2 (12x12). The block computes R6 and R3
// over those regions, recomputing the overlap with its neighbours, and keeps
// both in shared memory: no per-clone relevance below the kernel's input
// reaches device memory.
//   phase 1  R6: a 3xTF32 implicit GEMM on the tensor cores
//            (conv3x3_tc.cuh): M over the 100 pixels of the R6 region (7
//            m-fragments, two a warp on 4 of the 7 warps, so that a warp
//            splits each B fragment for twice the products), N over the C
//            channels, the reduction over C6 channels x 9 taps in 8-channel
//            slices. cp.async stages
//            R and G6 over the 12x12 region and the slice's taps (the
//            GammaConv.w_apply_tc layout) while the previous slice
//            multiplies; R * G6 is formed and split into hi and lo once per
//            slice and loaded with ldmatrix. The epilogue writes x6 * acc
//            from the accumulator fragments into R6 in shared memory.
//   phase 2  R3: the same over upsample2(R6) * M3 (M3 staged over 20x20, R6
//            read from shared memory at each pixel's coarse parent; with one
//            merged conv R staged beside M3), M over the 324 pixels of the R3
//            region (21 m-fragments, three a warp).
//   phase 3  the tail, as first_layer.cu: the route is one-hot, so per
//            coarse pixel and channel F is one factor at the window's winner
//            (f = gate / stab(z0) there), formed once from float4 loads of a1
//            and z0; each coarse R3 pixel's channels are scattered onto its
//            4x4 heatmap patch in registers (C / 4 lanes a pixel, 4 channels
//            a lane, added by shuffles), the patches go to shared memory, and
//            each heatmap pixel adds its four patches' cells in a fixed order
//            (the maps are the same bits from run to run).
// Zeros outside the image reproduce SAME padding.
//
// Bound on an H100: operations. At the 3s shapes (b=256, K=4) the two
// convs' forward pairs and K transposed convs are 174 GFLOP and the tail
// 9.7 GFLOP: 1.11 ms on the tensor cores in 3xTF32 (495 / 3 TFLOP/s, the
// least time for f32-accurate products), 2.74 ms at 67 TFLOP/s on the FMA
// units, against ~1.4 GB read and written once (0.41 ms at 3.35 TB/s). The
// halos cost, in mma rows a block over the pixels the tile needs: 128 / 64 =
// 2x for conv 6 (100 / 64 = 1.56x of them real pixels), 336 / 256 = 1.31x
// for conv 3 (1.27x real); a 64x64 tile would need 185 KB for R3 alone,
// past two blocks an SM. The tail forms F once per clone, not once per
// instance as first_layer.cu does: a block holds one clone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tc.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int WARPS = 7, THREADS = 32 * WARPS;
constexpr int T = 32;                              // heatmap tile
constexpr int R3W = T / 2 + 2, NR3 = R3W * R3W;    // R3 region (18)
constexpr int BW = T / 2 + 4, NB = BW * BW;        // staged R6 * M3 (20)
constexpr int R6W = T / 4 + 2, NR6 = R6W * R6W;    // R6 region (10)
constexpr int AW = T / 4 + 4, NA = AW * AW;        // staged R * G6 (12)
constexpr int MF1 = 2, MF2 = 3;                    // m-fragments a warp, phase 1 / 2
constexpr int WM1 = (NR6 + 16 * MF1 - 1) / (16 * MF1);  // warps with phase-1 fragments
constexpr int PS = 16;                             // a patch's stride, floats
constexpr int cmax(int a, int b) { return a > b ? a : b; }
static_assert(WM1 <= WARPS && (WARPS - 1) * MF2 * 16 < NR3 && WARPS * MF2 * 16 >= NR3,
              "the warps' fragments cover the regions, every warp's in phase 2");

template <int C, bool TOP>
struct Layout {
  static constexpr int NF = C / 8;                 // n-fragments: all C output channels
  static constexpr int RS = C + 8;                 // R6 / R3 pixel stride
  static constexpr int WS = C + 8;                 // tap row stride
  static constexpr int B = 9 * CC * WS;            // one slice's taps
  static constexpr int A1 = NA * SP, A2 = NB * SP;
  static constexpr int STAGE1 = 2 * A1 + B;        // R, G6 (hi, lo in place), taps
  // phase 2: TOP stages M3 (hi in place) and the taps, one lo for both
  // stages; otherwise R and M3 (hi, lo in place) and the taps
  static constexpr int STAGE2 = TOP ? A2 + B : 2 * A2 + B;
  static constexpr int P2 = TOP ? A2 + 2 * STAGE2 : 2 * STAGE2;
  static constexpr int TAIL = NR3 * RS + NR3 * PS; // R3, then the patches
  static constexpr int tq = 0, r6 = 9 * C, stg = r6 + (TOP ? NR6 * RS : 0);
  static constexpr int floats =
      stg + cmax(cmax(TOP ? 2 * STAGE1 : 0, P2), TAIL);
};

// This lane's ldmatrix row for m-fragment f of a GEMM whose output pixel m
// (row-major in a region of width OW, n pixels) reads the staged region of
// width SW from its own position (rows past n repeat the last pixel).
__device__ __forceinline__ int region_row(int f, int OW, int n, int SW) {
  return tc::lane_row([&](int r) {
    const int m = min(f * 16 + r, n - 1);
    return (m / OW) * SW + m % OW;
  });
}

template <int C, bool TOP>
__global__ void __launch_bounds__(THREADS, 2)
merged_tail_kernel(const float* __restrict__ R,     // [b,K,H/4,W/4,C6] (TOP) or [b,K,H/2,W/2,C]
                   const float* __restrict__ G6,    // [b,H/4,W/4,C6] (TOP)
                   const float* __restrict__ x6,    // [b,H/4,W/4,C] (TOP)
                   const float* __restrict__ wt6,   // [C6/8,9,8,C] (TOP)
                   const float* __restrict__ M3,    // [b,H/2,W/2,C]
                   const float* __restrict__ x3,    // [b,H/2,W/2,C]
                   const float* __restrict__ wt3,   // [C/8,9,8,C]
                   const float* __restrict__ a1,    // [b,H,W,C]
                   const float* __restrict__ z0,    // [H,W,C]
                   const float* __restrict__ taps,  // [9,C]
                   float* __restrict__ heat,        // [b,K,H,W]
                   int K, int H, int W, int C6, float stab0) {
  using L = Layout<C, TOP>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tq = smem + L::tq;                        // the tail taps [9][C]
  float* r6 = smem + L::r6;                        // [NR6][RS] (TOP)
  float* stg = smem + L::stg;                      // staging; then R3 [NR3][RS], patches
  float* r3 = stg;
  float* pt = stg + NR3 * L::RS;                   // [NR3][PS]
  const int k = blockIdx.x, n = blockIdx.z;
  const int tiles_w = (W + T - 1) / T;
  const int h0 = (blockIdx.y / tiles_w) * T, w0 = (blockIdx.y % tiles_w) * T;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int r3y = h0 / 2 - 1, r3x = w0 / 2 - 1;   // R3 region origin
  const int r6y = h0 / 4 - 1, r6x = w0 / 4 - 1;   // R6 region origin
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int e = threadIdx.x; e < 9 * C; e += THREADS) tq[e] = taps[e];

  // ---- phase 1: R6 over its 10x10 region
  if constexpr (TOP) {
    const float* Rk = R + ((size_t)n * K + k) * H4 * W4 * C6;
    const float* Gn = G6 + (size_t)n * H4 * W4 * C6;
    int lrow[MF1];
#pragma unroll
    for (int i = 0; i < MF1; ++i) lrow[i] = region_row(warp * MF1 + i, R6W, NR6, AW);
    float acc[MF1][L::NF][4] = {};
    tc::pipeline(
        C6 / CC,
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE1;
          tc::stage_region(buf, Rk, AW, AW, r6y - 1, r6x - 1, H4, W4, C6, s * CC);
          tc::stage_region(buf + L::A1, Gn, AW, AW, r6y - 1, r6x - 1, H4, W4, C6, s * CC);
          tc::stage_taps<C>(buf + 2 * L::A1, wt6, s, C, 0);
          tc::cp_commit();
        },
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE1;   // R, then hi; G6, then lo
          tc::split_region(buf, buf + L::A1, NA, [&](int q, int c4) {
            return tc::mul4(*reinterpret_cast<const float4*>(buf + q * SP + c4),
                            *reinterpret_cast<const float4*>(buf + L::A1 + q * SP + c4));
          });
          __syncthreads();
          if (warp < WM1)
            tc::slice_mma<MF1, L::NF, false>(acc, buf, buf + L::A1, lrow, AW, buf + 2 * L::A1,
                                             L::WS, 0, L::NF);
        });
    // x6 * acc into R6, zero outside the image
#pragma unroll
    for (int f = 0; f < MF1 * 2; ++f) {
      const int i = f >> 1, hf = f & 1, m = (warp * MF1 + i) * 16 + g + hf * 8;
      if (warp >= WM1 || m >= NR6) continue;
      const int hh = r6y + m / R6W, ww = r6x + m % R6W;
      const bool in = hh >= 0 && hh < H4 && ww >= 0 && ww < W4;
      const float* xp = x6 + (((size_t)n * H4 + hh) * W4 + ww) * C;
#pragma unroll
      for (int j = 0; j < L::NF; ++j) {
        const int c = j * 8 + t4 * 2;
        const float2 xv = in ? *reinterpret_cast<const float2*>(xp + c) : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(r6 + m * L::RS + c) =
            make_float2(__fmul_rn(xv.x, acc[i][j][2 * hf]), __fmul_rn(xv.y, acc[i][j][2 * hf + 1]));
      }
    }
  }

  // ---- phase 2: R3 over its 18x18 region
  {
    const float* Mn = M3 + (size_t)n * H2 * W2 * C;
    const float* Rk = R + ((size_t)n * K + k) * H2 * W2 * C;   // one merged conv
    float* lo = stg + 2 * L::STAGE2;                             // TOP
    int lrow[MF2];
#pragma unroll
    for (int i = 0; i < MF2; ++i) lrow[i] = region_row(warp * MF2 + i, R3W, NR3, BW);
    float acc[MF2][L::NF][4] = {};
    tc::pipeline(
        C / CC,
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE2;
          if constexpr (TOP) {
            tc::stage_region(buf, Mn, BW, BW, r3y - 1, r3x - 1, H2, W2, C, s * CC);
            tc::stage_taps<C>(buf + L::A2, wt3, s, C, 0);
          } else {
            tc::stage_region(buf, Rk, BW, BW, r3y - 1, r3x - 1, H2, W2, C, s * CC);
            tc::stage_region(buf + L::A2, Mn, BW, BW, r3y - 1, r3x - 1, H2, W2, C, s * CC);
            tc::stage_taps<C>(buf + 2 * L::A2, wt3, s, C, 0);
          }
          tc::cp_commit();
        },
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE2;
          if constexpr (TOP) {                       // M3, then hi; R6 at the coarse parent
            tc::split_region(buf, lo, NB, [&](int q, int c4) {
              const int cy = ((r3y - 1 + q / BW) >> 1) - r6y;
              const int cx = ((r3x - 1 + q % BW) >> 1) - r6x;
              return tc::mul4(
                  *reinterpret_cast<const float4*>(r6 + (cy * R6W + cx) * L::RS + s * CC + c4),
                  *reinterpret_cast<const float4*>(buf + q * SP + c4));
            });
            __syncthreads();
            tc::slice_mma<MF2, L::NF, false>(acc, buf, lo, lrow, BW, buf + L::A2, L::WS, 0,
                                             L::NF);
          } else {                                   // R, then hi; M3, then lo
            tc::split_region(buf, buf + L::A2, NB, [&](int q, int c4) {
              return tc::mul4(*reinterpret_cast<const float4*>(buf + q * SP + c4),
                              *reinterpret_cast<const float4*>(buf + L::A2 + q * SP + c4));
            });
            __syncthreads();
            tc::slice_mma<MF2, L::NF, false>(acc, buf, buf + L::A2, lrow, BW, buf + 2 * L::A2,
                                             L::WS, 0, L::NF);
          }
        });
    // the pipeline ends with a barrier: R3 may reuse the staging buffers
#pragma unroll
    for (int i = 0; i < MF2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = (warp * MF2 + i) * 16 + g + hf * 8;
        if (m >= NR3) continue;
        const int hh = r3y + m / R3W, ww = r3x + m % R3W;
        const bool in = hh >= 0 && hh < H2 && ww >= 0 && ww < W2;
        const float* xp = x3 + (((size_t)n * H2 + hh) * W2 + ww) * C;
#pragma unroll
        for (int j = 0; j < L::NF; ++j) {
          const int c = j * 8 + t4 * 2;
          const float2 xv = in ? *reinterpret_cast<const float2*>(xp + c) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(r3 + m * L::RS + c) = make_float2(
              __fmul_rn(xv.x, acc[i][j][2 * hf]), __fmul_rn(xv.y, acc[i][j][2 * hf + 1]));
        }
      }
  }
  __syncthreads();

  // ---- phase 3: each coarse R3 pixel's 4x4 heatmap patch: cell
  // (py + 2 - dy) * 4 + (px + 2 - dx) takes tap (dy, dx) of the winner at
  // (py, px) of its 2x2 window; the patch's origin is one pixel up and left
  // of the window. A group of G = C / 4 neighbouring lanes takes a coarse
  // pixel, a lane 4 channels (whole pixels of a1 and z0 a group load), and
  // the group adds its lanes' patches by shuffles in a fixed order.
  constexpr int G = C / 4;
  const float* an = a1 + (size_t)n * H * W * C;
  const int c0 = (threadIdx.x % G) * 4;
  for (int e0 = 0; e0 < NR3 * G; e0 += THREADS) {
    const int q = (e0 + threadIdx.x) / G;
    const int cy = r3y + q / R3W, cx = r3x + q % R3W;
    float p[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) p[s] = 0.f;
    if (q < NR3 && cy >= 0 && cy < H2 && cx >= 0 && cx < W2) {
      const size_t o = ((size_t)(2 * cy) * W + 2 * cx) * C + c0, dn = (size_t)W * C;
      const float4 v4[4] = {__ldg(reinterpret_cast<const float4*>(an + o)),
                            __ldg(reinterpret_cast<const float4*>(an + o + C)),
                            __ldg(reinterpret_cast<const float4*>(an + o + dn)),
                            __ldg(reinterpret_cast<const float4*>(an + o + dn + C))};
      const float4 zq[4] = {__ldg(reinterpret_cast<const float4*>(z0 + o)),
                            __ldg(reinterpret_cast<const float4*>(z0 + o + C)),
                            __ldg(reinterpret_cast<const float4*>(z0 + o + dn)),
                            __ldg(reinterpret_cast<const float4*>(z0 + o + dn + C))};
      const float4 r4 = *reinterpret_cast<const float4*>(r3 + q * L::RS + c0);
      float4 tv[9];                      // this lane's 4 channels, tap by tap
#pragma unroll
      for (int t = 0; t < 9; ++t) tv[t] = *reinterpret_cast<const float4*>(tq + t * C + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned win;
        const float f = lrp::route_factor(
            lrp::comp(v4[0], e), lrp::comp(v4[1], e), lrp::comp(v4[2], e), lrp::comp(v4[3], e),
            lrp::comp(zq[0], e), lrp::comp(zq[1], e), lrp::comp(zq[2], e), lrp::comp(zq[3], e),
            stab0, win);
        const float v = __fmul_rn(lrp::comp(r4, e), f);
#pragma unroll
        for (int pos = 0; pos < 4; ++pos) {
          const float sv = win == (unsigned)pos ? v : 0.f;
          const int py = pos >> 1, px = pos & 1;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int cell = (py + 2 - t / 3) * 4 + (px + 2 - t % 3);
            p[cell] = fmaf(sv, lrp::comp(tv[t], e), p[cell]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int d = 1; d < G; d <<= 1) p[s] += __shfl_xor_sync(0xffffffffu, p[s], d);
    if (q < NR3 && c0 == 0)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        *reinterpret_cast<float4*>(pt + q * PS + 4 * s) =
            make_float4(p[4 * s], p[4 * s + 1], p[4 * s + 2], p[4 * s + 3]);
  }
  __syncthreads();
  // heatmap pixel (h, w): the cells of the patches of coarse rows
  // (h - 1) >> 1 (cell row ra) and the one below (row ra - 2), the same
  // across, added in that order
  float* hk = heat + ((size_t)n * K + k) * H * W;
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int h = h0 + e / T, w = w0 + e % T;
    if (h >= H || w >= W) continue;
    const int qy = ((h - 1) >> 1) - r3y, qx = ((w - 1) >> 1) - r3x;
    const int ra = h - 2 * ((h - 1) >> 1) + 1, ca = w - 2 * ((w - 1) >> 1) + 1;
    const float* pa = pt + (qy * R3W + qx) * PS;
    const float* pb = pa + R3W * PS;
    float sum = __fadd_rn(pa[ra * 4 + ca], pa[PS + ra * 4 + ca - 2]);
    sum = __fadd_rn(sum, pb[(ra - 2) * 4 + ca]);
    hk[(size_t)h * W + w] = __fadd_rn(sum, pb[PS + (ra - 2) * 4 + ca - 2]);
  }
}

template <int C, bool TOP>
cudaError_t launch(const float* R, const float* G6, const float* x6, const float* wt6,
                   const float* M3, const float* x3, const float* wt3, const float* a1,
                   const float* z0, const float* taps, float* heat, int b, int K, int H,
                   int W, int C6, float stab0, cudaStream_t s) {
  const size_t bytes = sizeof(float) * Layout<C, TOP>::floats;
  cudaError_t err = lrp::set_smem(merged_tail_kernel<C, TOP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(K, ((H + T - 1) / T) * ((W + T - 1) / T), b);
  merged_tail_kernel<C, TOP><<<grid, THREADS, bytes, s>>>(R, G6, x6, wt6, M3, x3, wt3, a1, z0,
                                                          taps, heat, K, H, W, C6, stab0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// merged = 2: R [b,K,H/4,W/4,C6] at conv 6's output, G6 [b,H/4,W/4,C6] and
// x6 [b,H/4,W/4,C] its multiplier and input, wt6 [C6/8,9,8,C] its transposed
// w + g*w+ (xai/lrp/chain.py GammaConv.w_apply_tc). merged = 1: R
// [b,K,H/2,W/2,C] at conv 3's output; G6, x6, wt6 are not read. Both: M3
// [b,H/2,W/2,C] conv 3's multiplier (with the pool-5 route for merged = 2),
// x3 [b,H/2,W/2,C] its input, wt3 [C/8,9,8,C3] (w_apply_tc), a1 [b,H,W,C]
// the first conv's pre-relu output, z0 [H,W,C], taps [9,C], heat [b,K,H,W].
// Takes (C, C3, C6) = (32, 32, 64) and (8, 8, 16) (C6 only read for
// merged = 2), H and W divisible by 2 * merged, 16-byte aligned tensors;
// returns cudaErrorInvalidValue for others before any launch, else
// cudaGetLastError().
int merged_tail(const float* R, const float* G6, const float* x6, const float* wt6,
                const float* M3, const float* x3, const float* wt3, const float* a1,
                const float* z0, const float* taps, float* heat, int b, int K, int H,
                int W, int C, int C3, int C6, int merged, float stab0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((merged != 1 && merged != 2) || C3 != C || H % (2 * merged) != 0 ||
      W % (2 * merged) != 0 || !tc::aligned16(R) || !tc::aligned16(M3) ||
      !tc::aligned16(x3) || !tc::aligned16(wt3) || !tc::aligned16(a1) || !tc::aligned16(z0) ||
      (merged == 2 && (!tc::aligned16(G6) || !tc::aligned16(x6) || !tc::aligned16(wt6))))
    return cudaErrorInvalidValue;
  if (merged == 2 && C == 32 && C6 == 64)
    return launch<32, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, C6, stab0, s);
  if (merged == 2 && C == 8 && C6 == 16)
    return launch<8, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, C6, stab0, s);
  if (merged == 1 && C == 32)
    return launch<32, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, C6, stab0, s);
  if (merged == 1 && C == 8)
    return launch<8, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, C6, stab0, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
