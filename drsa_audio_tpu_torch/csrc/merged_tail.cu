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
// One thread block (two warpgroups, 256 threads) per (32x32 heatmap tile,
// clone, instance), clones the fastest grid index so that the K blocks of a
// tile share the instance's maps in L2. Walking up from the tile, each
// level's region grows by the one-pixel halo its transposed conv needs: R3
// over the tile's 16x16 parent + 1 (18x18), the staged R6 * M3 + 2 (20x20),
// R6 over its 8x8 parent + 1 (10x10), the staged R * G6 + 2 (12x12). The
// block computes R6 and R3 over those regions, recomputing the overlap with
// its neighbours, and keeps both in shared memory: no per-clone relevance
// below the kernel's input reaches device memory.
//   phase 1  R6: a 3xTF32 implicit GEMM on Hopper's wgmma
//            (conv3x3_wgmma.cuh: A from registers, loaded with ldmatrix from
//            the split region; B the taps pre-split on the host,
//            GammaConv.w_apply_wg, staged by one bulk copy a slice): M over
//            the 100 pixels of the R6 region as two m64 tiles, one a
//            warpgroup, N over the C channels, the reduction over C6
//            channels x 9 taps in 8-channel slices. cp.async stages R and G6
//            over the 12x12 region while the previous slice multiplies;
//            R * G6 is formed and split into hi and lo once per slice. The
//            epilogue writes x6 * acc from the accumulator fragments into R6
//            in shared memory.
//   phase 2  R3: the same over upsample2(R6) * M3 (M3 staged over 20x20, R6
//            read from shared memory at each pixel's coarse parent; with one
//            merged conv R staged beside M3), M over the 324 pixels of the R3
//            region as six m64 tiles, three a warpgroup, one wgmma group in
//            flight (two spill at the 128 registers of two blocks an SM).
//   phase 3  the tail, as first_layer.cu: the route is one-hot, so per
//            coarse pixel and channel F is one factor at the window's winner
//            (f = gate / stab(z0) there), which a short pass before the main
//            kernel (merged_tail_factor) forms once per instance from a1 and
//            z0 and writes compactly (f, and the winner in a byte); each
//            coarse R3 pixel's channels are scattered onto its
//            4x4 heatmap patch in registers (16 channels a lane, the toy's 8
//            one lane; C / 16 lanes a pixel added by shuffles), the patches
//            go to shared memory, and
//            each heatmap pixel adds its four patches' cells in a fixed order
//            (the maps are the same bits from run to run).
// Zeros outside the image reproduce SAME padding.
//
// Bound on an H100: operations. At the 3s shapes (b=256, K=4) the two
// convs' forward pairs and K transposed convs are 174 GFLOP and the tail
// 9.7 GFLOP: 1.11 ms on the tensor cores in 3xTF32 (495 / 3 TFLOP/s, the
// least time for f32-accurate products), 2.74 ms at 67 TFLOP/s on the FMA
// units, against ~1.4 GB read and written once (0.41 ms at 3.35 TB/s).
// wgmma is the only instruction at the dense TF32 rate on Hopper. What the
// design leaves: the halos cost, in GEMM rows a block over the pixels the
// tile needs, 128 / 64 = 2x for conv 6 (100 / 64 = 1.56x of them real
// pixels) and 384 / 256 = 1.5x for conv 3 (324 / 256 = 1.27x real); a 64x64
// tile would need 185 KB for R3 alone, past two blocks an SM. A block holds
// one clone (K clones a block would not fit two blocks an SM: 111.6 KB a
// block at C = 32 with two merged convs, 114.8 KB with one), so F is formed
// once per instance before the main kernel: its blocks read 5 bytes a
// coarse pixel and channel in place of the 2x2 windows of a1 and z0 (32
// bytes, and each clone's block would read them again).

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"
#include "lrp_common.cuh"

namespace {

using tc::CC;
using tc::SP;

constexpr int THREADS = 256;                       // two warpgroups
constexpr int T = 32;                              // heatmap tile
constexpr int R3W = T / 2 + 2, NR3 = R3W * R3W;    // R3 region (18)
constexpr int BW = T / 2 + 4, NB = BW * BW;        // staged R6 * M3 (20)
constexpr int R6W = T / 4 + 2, NR6 = R6W * R6W;    // R6 region (10)
constexpr int AW = T / 4 + 4, NA = AW * AW;        // staged R * G6 (12)
constexpr int MT1 = 1, MT2 = 3;                    // m64 tiles a warpgroup, phase 1 / 2
constexpr int BARS = 8;                            // floats: four mbarriers, two a phase
constexpr int PS = 16;                             // a patch's stride, floats
constexpr int cmax(int a, int b) { return a > b ? a : b; }
static_assert(2 * MT1 * 64 >= NR6 && 2 * MT2 * 64 >= NR3 && (2 * MT2 - 1) * 64 < NR3,
              "the warpgroups' m64 tiles cover the regions, every warpgroup's in phase 2");

template <int C, bool TOP>
struct Layout {
  static constexpr int RS = C + 8;                 // R6 / R3 pixel stride
  static constexpr int TAPS = wg::taps_floats<C>();  // one slice's pre-split taps
  static constexpr int A1 = NA * SP, A2 = NB * SP;
  static constexpr int STAGE1 = TAPS + 2 * A1;     // taps, R, G6 (hi, lo in place)
  // phase 2: TOP stages the taps and M3 (hi in place), one lo for both
  // stages; otherwise the taps, R and M3 (hi, lo in place)
  static constexpr int STAGE2 = TOP ? TAPS + A2 : TAPS + 2 * A2;
  static constexpr int P2 = TOP ? A2 + 2 * STAGE2 : 2 * STAGE2;
  static constexpr int TAIL = NR3 * RS + NR3 * PS; // R3, then the patches
  static constexpr int tq = BARS, r6 = tq + 9 * C, stg = r6 + (TOP ? NR6 * RS : 0);
  static constexpr int floats =
      stg + cmax(cmax(TOP ? 2 * STAGE1 : 0, P2), TAIL);
};

// This lane's ldmatrix row for its warp's 16 rows of m64 tile f of a GEMM
// whose output pixel m (row-major in a region of width OW, n pixels) reads
// the staged region of width SW from its own position (rows past n repeat
// the last pixel).
__device__ __forceinline__ int region_row(int f, int OW, int n, int SW) {
  const int wq = (threadIdx.x >> 5) & 3;
  return tc::lane_row([&](int r) {
    const int m = min(f * 64 + wq * 16 + r, n - 1);
    return (m / OW) * SW + m % OW;
  });
}

template <int C, bool TOP>
__global__ void __launch_bounds__(THREADS, 2)
merged_tail_kernel(const float* __restrict__ R,     // [b,K,H/4,W/4,C6] (TOP) or [b,K,H/2,W/2,C]
                   const float* __restrict__ G6,    // [b,H/4,W/4,C6] (TOP)
                   const float* __restrict__ x6,    // [b,H/4,W/4,C] (TOP)
                   const float* __restrict__ wt6,   // [1,C6/8,2,9,2,C,4] (TOP)
                   const float* __restrict__ M3,    // [b,H/2,W/2,C]
                   const float* __restrict__ x3,    // [b,H/2,W/2,C]
                   const float* __restrict__ wt3,   // [1,C/8,2,9,2,C,4]
                   const float* __restrict__ fq,    // [b,H/2,W/2,C] (merged_tail_factor)
                   const uint32_t* __restrict__ wins,  // [b,H/2,W/2,C/4]
                   const float* __restrict__ taps,  // [9,C]
                   float* __restrict__ heat,        // [b,K,H,W]
                   int K, int H, int W, int C6) {
  using L = Layout<C, TOP>;
  constexpr int TAPS = L::TAPS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // phase 1: 0, 1; phase 2: 2, 3
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
  const int wgi = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int e = threadIdx.x; e < 9 * C; e += THREADS) tq[e] = taps[e];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) wg::bar_init(&bars[i]);
    wg::bar_init_fence();
  }
  __syncthreads();

  // ---- phase 1: R6 over its 10x10 region
  if constexpr (TOP) {
    const float* Rk = R + ((size_t)n * K + k) * H4 * W4 * C6;
    const float* Gn = G6 + (size_t)n * H4 * W4 * C6;
    int lrow[MT1];
#pragma unroll
    for (int i = 0; i < MT1; ++i) lrow[i] = region_row(wgi * MT1 + i, R6W, NR6, AW);
    float acc[MT1][C / 2] = {};
    tc::pipeline(
        C6 / CC,
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE1;
          tc::stage_region(buf + TAPS, Rk, AW, AW, r6y - 1, r6x - 1, H4, W4, C6, s * CC);
          tc::stage_region(buf + TAPS + L::A1, Gn, AW, AW, r6y - 1, r6x - 1, H4, W4, C6, s * CC);
          tc::cp_commit();
          if (threadIdx.x == 0)
            wg::bulk_load(buf, wt6 + (size_t)s * TAPS, TAPS * 4, &bars[s & 1]);
        },
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE1;   // taps; R, then hi; G6, then lo
          float* hi = buf + TAPS;
          tc::split_region(hi, hi + L::A1, NA, [&](int q, int c4) {
            return tc::mul4(*reinterpret_cast<const float4*>(hi + q * SP + c4),
                            *reinterpret_cast<const float4*>(hi + L::A1 + q * SP + c4));
          });
          wg::bar_wait(&bars[s & 1], (s >> 1) & 1);
          __syncthreads();
          wg::slice<C, false, 3, MT1>(acc, wg::saddr(hi), wg::saddr(hi + L::A1), lrow, AW,
                                      wg::saddr(buf));
        });
    // x6 * acc into R6, zero outside the image
#pragma unroll
    for (int f = 0; f < MT1 * 2; ++f) {
      const int i = f >> 1, hf = f & 1, m = (wgi * MT1 + i) * 64 + wq * 16 + g + hf * 8;
      if (m >= NR6) continue;
      const int hh = r6y + m / R6W, ww = r6x + m % R6W;
      const bool in = hh >= 0 && hh < H4 && ww >= 0 && ww < W4;
      const float* xp = x6 + (((size_t)n * H4 + hh) * W4 + ww) * C;
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int c = j * 8 + t4 * 2;
        const float2 xv = in ? *reinterpret_cast<const float2*>(xp + c) : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(r6 + m * L::RS + c) =
            make_float2(__fmul_rn(xv.x, acc[i][4 * j + 2 * hf]),
                        __fmul_rn(xv.y, acc[i][4 * j + 2 * hf + 1]));
      }
    }
    // phase 2's bulk copies refill bytes that phase 1's split wrote
    wg::fence_proxy_async();
    __syncthreads();
  }

  // ---- phase 2: R3 over its 18x18 region
  {
    const float* Mn = M3 + (size_t)n * H2 * W2 * C;
    const float* Rk = R + ((size_t)n * K + k) * H2 * W2 * C;   // one merged conv
    float* lo = stg + 2 * L::STAGE2;                             // TOP
    int lrow[MT2];
#pragma unroll
    for (int i = 0; i < MT2; ++i) lrow[i] = region_row(wgi * MT2 + i, R3W, NR3, BW);
    float acc[MT2][C / 2] = {};
    tc::pipeline(
        C / CC,
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE2;
          tc::stage_region(buf + TAPS, TOP ? Mn : Rk, BW, BW, r3y - 1, r3x - 1, H2, W2, C,
                           s * CC);
          if constexpr (!TOP)
            tc::stage_region(buf + TAPS + L::A2, Mn, BW, BW, r3y - 1, r3x - 1, H2, W2, C, s * CC);
          tc::cp_commit();
          if (threadIdx.x == 0)
            wg::bulk_load(buf, wt3 + (size_t)s * TAPS, TAPS * 4, &bars[2 + (s & 1)]);
        },
        [&](int s) {
          float* buf = stg + (s & 1) * L::STAGE2;
          float* hi = buf + TAPS;
          float* lo_s = TOP ? lo : hi + L::A2;
          if constexpr (TOP) {                       // M3, then hi; R6 at the coarse parent
            tc::split_region(hi, lo, NB, [&](int q, int c4) {
              const int cy = ((r3y - 1 + q / BW) >> 1) - r6y;
              const int cx = ((r3x - 1 + q % BW) >> 1) - r6x;
              return tc::mul4(
                  *reinterpret_cast<const float4*>(r6 + (cy * R6W + cx) * L::RS + s * CC + c4),
                  *reinterpret_cast<const float4*>(hi + q * SP + c4));
            });
          } else {                                   // R, then hi; M3, then lo
            tc::split_region(hi, lo_s, NB, [&](int q, int c4) {
              return tc::mul4(*reinterpret_cast<const float4*>(hi + q * SP + c4),
                              *reinterpret_cast<const float4*>(lo_s + q * SP + c4));
            });
          }
          wg::bar_wait(&bars[2 + (s & 1)], (s >> 1) & 1);
          __syncthreads();
          wg::slice<C, false, 1, MT2>(acc, wg::saddr(hi), wg::saddr(lo_s), lrow, BW,
                                      wg::saddr(buf));
        });
    // the pipeline ends with a barrier and no product in flight: R3 may
    // reuse the staging buffers
#pragma unroll
    for (int i = 0; i < MT2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = (wgi * MT2 + i) * 64 + wq * 16 + g + hf * 8;
        if (m >= NR3) continue;
        const int hh = r3y + m / R3W, ww = r3x + m % R3W;
        const bool in = hh >= 0 && hh < H2 && ww >= 0 && ww < W2;
        const float* xp = x3 + (((size_t)n * H2 + hh) * W2 + ww) * C;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int c = j * 8 + t4 * 2;
          const float2 xv = in ? *reinterpret_cast<const float2*>(xp + c) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(r3 + m * L::RS + c) =
              make_float2(__fmul_rn(xv.x, acc[i][4 * j + 2 * hf]),
                          __fmul_rn(xv.y, acc[i][4 * j + 2 * hf + 1]));
        }
      }
  }
  __syncthreads();

  // ---- phase 3: each coarse R3 pixel's 4x4 heatmap patch: cell
  // (py + 2 - dy) * 4 + (px + 2 - dx) takes tap (dy, dx) of the winner at
  // (py, px) of its 2x2 window; the patch's origin is one pixel up and left
  // of the window. A group of G = C / CPL neighbouring lanes takes a coarse
  // pixel, a lane CPL channels four at a time (one float4 of F and their
  // four winners), and the group adds its lanes' patches by shuffles in a
  // fixed order (16 channels a lane: one shuffle round a cell at C = 32).
  constexpr int CPL = C < 16 ? C : 16, G = C / CPL;
  const float* fn = fq + (size_t)n * H2 * W2 * C;
  const uint32_t* wn = wins + (size_t)n * H2 * W2 * (C / 4);
  const int c0 = (threadIdx.x % G) * CPL;
  for (int e0 = 0; e0 < NR3 * G; e0 += THREADS) {
    const int q = (e0 + threadIdx.x) / G;
    const int cy = r3y + q / R3W, cx = r3x + q % R3W;
    float p[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) p[s] = 0.f;
    if (q < NR3 && cy >= 0 && cy < H2 && cx >= 0 && cx < W2) {
      const size_t pc = (size_t)cy * W2 + cx;
#pragma unroll
      for (int c4 = c0; c4 < c0 + CPL; c4 += 4) {
        const float4 f4 = __ldg(reinterpret_cast<const float4*>(fn + pc * C + c4));
        const uint32_t w4 = __ldg(wn + pc * (C / 4) + c4 / 4);
        const float4 r4 = *reinterpret_cast<const float4*>(r3 + q * L::RS + c4);
        float4 tv[9];                    // these 4 channels, tap by tap
#pragma unroll
        for (int t = 0; t < 9; ++t) tv[t] = *reinterpret_cast<const float4*>(tq + t * C + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned win = (w4 >> (8 * e)) & 3u;
          const float v = __fmul_rn(lrp::comp(r4, e), lrp::comp(f4, e));
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

// The first-layer tail's factor, once per instance: for each coarse pixel
// (a 2x2 window of the first conv's output) and channel, the window's first
// maximum of relu(a1) in row-major order, win, and f = relu_gate(a1) /
// stab(z0) there (lrp::route_factor), four channels a thread: f to fq,
// the four winners one byte each to wins.
__global__ void __launch_bounds__(256)
merged_tail_factor(const float* __restrict__ a1, const float* __restrict__ z0,
                   float* __restrict__ fq, uint32_t* __restrict__ wins, int H, int W, int C,
                   float stab0, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int G = C / 4, H2 = H / 2, W2 = W / 2;
  const int c0 = (int)(e % G) * 4;
  const long long pc = e / G;                      // (n * H2 + cy) * W2 + cx
  const int cx = (int)(pc % W2), cy = (int)(pc / W2 % H2);
  const long long n = pc / ((long long)H2 * W2);
  const size_t o = ((size_t)(2 * cy) * W + 2 * cx) * C + c0, dn = (size_t)W * C;
  const float* an = a1 + (size_t)n * H * W * C;
  const float4 v4[4] = {__ldg(reinterpret_cast<const float4*>(an + o)),
                        __ldg(reinterpret_cast<const float4*>(an + o + C)),
                        __ldg(reinterpret_cast<const float4*>(an + o + dn)),
                        __ldg(reinterpret_cast<const float4*>(an + o + dn + C))};
  const float4 zq[4] = {__ldg(reinterpret_cast<const float4*>(z0 + o)),
                        __ldg(reinterpret_cast<const float4*>(z0 + o + C)),
                        __ldg(reinterpret_cast<const float4*>(z0 + o + dn)),
                        __ldg(reinterpret_cast<const float4*>(z0 + o + dn + C))};
  float f[4];
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned win;
    f[j] = lrp::route_factor(
        lrp::comp(v4[0], j), lrp::comp(v4[1], j), lrp::comp(v4[2], j), lrp::comp(v4[3], j),
        lrp::comp(zq[0], j), lrp::comp(zq[1], j), lrp::comp(zq[2], j), lrp::comp(zq[3], j),
        stab0, win);
    packed |= win << (8 * j);
  }
  *reinterpret_cast<float4*>(fq + pc * C + c0) = make_float4(f[0], f[1], f[2], f[3]);
  wins[pc * G + c0 / 4] = packed;
}

template <int C, bool TOP>
cudaError_t launch(const float* R, const float* G6, const float* x6, const float* wt6,
                   const float* M3, const float* x3, const float* wt3, const float* a1,
                   const float* z0, const float* taps, float* heat, float* fq, uint32_t* wins,
                   int b, int K, int H, int W, int C6, float stab0, cudaStream_t s) {
  const size_t bytes = sizeof(float) * Layout<C, TOP>::floats;
  cudaError_t err = lrp::set_smem(merged_tail_kernel<C, TOP>, bytes);
  if (err != cudaSuccess) return err;
  const long long total = (long long)b * (H / 2) * (W / 2) * (C / 4);
  merged_tail_factor<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a1, z0, fq, wins, H, W, C,
                                                                     stab0, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(K, ((H + T - 1) / T) * ((W + T - 1) / T), b);
  merged_tail_kernel<C, TOP><<<grid, THREADS, bytes, s>>>(R, G6, x6, wt6, M3, x3, wt3, fq, wins,
                                                          taps, heat, K, H, W, C6);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// merged = 2: R [b,K,H/4,W/4,C6] at conv 6's output, G6 [b,H/4,W/4,C6] and
// x6 [b,H/4,W/4,C] its multiplier and input, wt6 its transposed w + g*w+,
// pre-split in one chunk of BN6 columns [1,C6/8,2,9,2,BN6,4]
// (xai/lrp/taps.py GammaConv.w_apply_wg). merged = 1: R [b,K,H/2,W/2,C] at
// conv 3's output; G6, x6, wt6 are not read. Both: M3 [b,H/2,W/2,C] conv 3's
// multiplier (with the pool-5 route for merged = 2), x3 [b,H/2,W/2,C] its
// input, wt3 [1,C/8,2,9,2,BN3,4] (w_apply_wg), a1 [b,H,W,C] the first conv's
// pre-relu output, z0 [H,W,C], taps [9,C], heat [b,K,H,W]; fq [b,H/2,W/2,C]
// and wins [b,H/2,W/2,C/4] scratch for the tail's factor. Two launches: the
// factor pass, then the main kernel. Takes (C, C3,
// C6) = (32, 32, 64) and (8, 8, 16) (C6 only read for merged = 2), taps laid
// out C columns wide (BN3 == C, and BN6 == C for merged = 2), H and W
// divisible by 2 * merged, 16-byte aligned tensors; returns
// cudaErrorInvalidValue for others before any launch, else
// cudaGetLastError().
int merged_tail(const float* R, const float* G6, const float* x6, const float* wt6,
                const float* M3, const float* x3, const float* wt3, const float* a1,
                const float* z0, const float* taps, float* heat, float* fq, uint32_t* wins, int b,
                int K, int H, int W, int C, int C3, int C6, int merged, int BN6, int BN3,
                float stab0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((merged != 1 && merged != 2) || C3 != C || BN3 != C || (merged == 2 && BN6 != C) ||
      H % (2 * merged) != 0 || W % (2 * merged) != 0 || !tc::aligned16(R) ||
      !tc::aligned16(M3) || !tc::aligned16(x3) || !tc::aligned16(wt3) || !tc::aligned16(a1) ||
      !tc::aligned16(z0) || !tc::aligned16(fq) ||
      (merged == 2 && (!tc::aligned16(G6) || !tc::aligned16(x6) || !tc::aligned16(wt6))))
    return cudaErrorInvalidValue;
  if (merged == 2 && C == 32 && C6 == 64)
    return launch<32, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, fq, wins, b, K, H, W, C6, stab0, s);
  if (merged == 2 && C == 8 && C6 == 16)
    return launch<8, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, fq, wins, b, K, H, W, C6, stab0, s);
  if (merged == 1 && C == 32)
    return launch<32, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, fq, wins, b, K, H, W, C6, stab0, s);
  if (merged == 1 && C == 8)
    return launch<8, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, fq, wins, b, K, H, W, C6, stab0, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory, bytes, a block of the main kernel takes at C
// channels with two merged convs (top != 0) or one; 0 for a C it does not
// take.
size_t merged_tail_smem(int C, int top) {
  if (C == 32) return sizeof(float) * (top ? Layout<32, true>::floats : Layout<32, false>::floats);
  if (C == 8) return sizeof(float) * (top ? Layout<8, true>::floats : Layout<8, false>::floats);
  return 0;
}

}  // extern "C"
