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
// chain_gamma_prep (csrc/chain_block.cu) writes both once per instance. The
// gamma rule's convT(R * m3) term vanishes under the relu gate, as in
// chain_block.cu. With one merged conv (DRSA layer 7) the first line is
// absent and R enters at conv 3's output, M3 = G3.
//
// One thread block per (32x32 heatmap tile, clone, instance), clones the
// fastest grid index so that the K blocks of a tile share the instance's
// maps in L2. Walking up from the tile, each level's region grows by the
// one-pixel halo its transposed conv needs: s0 over the tile + 1 (34x34),
// R3 over its 16x16 parent + 1 (18x18), the staged R6 * M3 + 2 (20x20), R6
// over its 8x8 parent + 1 (10x10), the staged R * G6 + 2 (12x12). The
// block computes R6 and R3 over those regions, recomputing the overlap with
// its neighbours, and keeps both in shared memory: no per-clone relevance
// below the kernel's input reaches device memory.
//   phase 1  R6: the CC-channel slices of R * G6 and of conv 6's taps are
//            staged in turn; each thread accumulates a column of 2 pixels x
//            8 channels (lrp::convt_column), 200 of the 216 threads (3s).
//   phase 2  R3: the same over upsample2(R6) * M3, 6 pixels x 8 channels a
//            thread, as first_block_deep.cu.
//   phase 3  the tail: per CC-channel slice each pool window of a1 forms
//            its routed s0 value in shared memory, then each thread sums
//            the 9 taps for its heatmap pixels, as first_layer.cu.
// Zeros outside the image reproduce SAME padding.
//
// Bound on an H100: operations. At the 3s shapes (b=256, K=4) the two
// convs' forward pairs and K transposed convs are 174 GFLOP and the tail
// 9.7 GFLOP: 1.11 ms on the tensor cores in 3xTF32 (495 / 3 TFLOP/s, the
// least time for f32-accurate products), 2.74 ms at 67 TFLOP/s on the FMA
// units, against ~1.4 GB read and written once (0.41 ms at 3.35 TB/s). Its
// main loop runs on the FMA units
// (LRP stays f32) and pays 1.56x conv 6's and 1.27x conv 3's transposed
// work for the halos.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

constexpr int T = 32;                              // heatmap tile
constexpr int CC = 8;                              // channels per staged slice
constexpr int PY3 = 6, PY6 = 2;                    // pixels per thread, conv 3 / conv 6
constexpr int S0W = T + 2, NS0 = S0W * S0W;        // s0 region (34)
constexpr int NWIN = T / 2 + 2;                    // pool windows across it (18)
constexpr int R3W = T / 2 + 2, NR3 = R3W * R3W;    // R3 region (18)
constexpr int BW = T / 2 + 4, NB = BW * BW;        // staged R6 * M3 (20)
constexpr int R6W = T / 4 + 2, NR6 = R6W * R6W;    // R6 region (10)
constexpr int AW = T / 4 + 4, NA = AW * AW;        // staged R * G6 (12)
constexpr int TPG3 = R3W * (R3W / PY3);            // threads per 8-channel group (54)
constexpr int TPG6 = R6W * (R6W / PY6);            // the same for conv 6 (50)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C, int C6, bool TOP>
struct Layout {
  static constexpr int threads = TPG3 * C / 8;
  static constexpr int pixels = (T * T + threads - 1) / threads;  // heat pixels a thread
  static constexpr int r6 = TOP ? C * NR6 : 0;
  static constexpr int stage = cmax(TOP ? CC * NA + 9 * CC * C : 0, CC * NB + 9 * CC * C);
  // [R3 C*NR3][taps 9*C][ R6 + stage | s0 CC*NS0 ]
  static constexpr int floats = C * NR3 + 9 * C + cmax(r6 + stage, CC * NS0);
  static_assert((C * NR3 + 9 * C) % 4 == 0 && r6 % 4 == 0 && (CC * NA) % 4 == 0 &&
                    (CC * NB) % 4 == 0,
                "the tap slices are read as float4");
};

template <int C, int C6, bool TOP>
__global__ void __launch_bounds__(Layout<C, C6, TOP>::threads, 2)
merged_tail_kernel(const float* __restrict__ R,     // [b,K,H/4,W/4,C6] (TOP) or [b,K,H/2,W/2,C]
                   const float* __restrict__ G6,    // [b,H/4,W/4,C6] (TOP)
                   const float* __restrict__ x6,    // [b,H/4,W/4,C] (TOP)
                   const float* __restrict__ wt6,   // [9,C6,C] (TOP)
                   const float* __restrict__ M3,    // [b,H/2,W/2,C]
                   const float* __restrict__ x3,    // [b,H/2,W/2,C]
                   const float* __restrict__ wt3,   // [9,C,C]
                   const float* __restrict__ a1,    // [b,H,W,C]
                   const float* __restrict__ z0,    // [H,W,C]
                   const float* __restrict__ taps,  // [9,C]
                   float* __restrict__ heat,        // [b,K,H,W]
                   int K, int H, int W, float stab0) {
  using L = Layout<C, C6, TOP>;
  extern __shared__ float4 smem4[];
  float* r3 = reinterpret_cast<float*>(smem4);   // [C][NR3]
  float* tp = r3 + C * NR3;                       // [9][C]
  float* r6 = tp + 9 * C;                         // [C][NR6] (TOP)
  float* st = r6 + L::r6;                         // staged slice, then its taps
  float* s0 = tp + 9 * C;                         // [CC][NS0], phase 3
  const int k = blockIdx.x, n = blockIdx.z;
  const int tiles_w = (W + T - 1) / T;
  const int h0 = (blockIdx.y / tiles_w) * T, w0 = (blockIdx.y % tiles_w) * T;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int r3y = h0 / 2 - 1, r3x = w0 / 2 - 1;   // R3 region origin
  const int r6y = h0 / 4 - 1, r6x = w0 / 4 - 1;   // R6 region origin
  for (int e = threadIdx.x; e < 9 * C; e += blockDim.x) tp[e] = taps[e];

  // ---- phase 1: R6 over its 10x10 region
  if constexpr (TOP) {
    const int g = threadIdx.x / TPG6, l = threadIdx.x % TPG6;
    const bool active = g < C / 8;
    const int x = l % R6W, y0 = (l / R6W) * PY6, o0 = g * 8;
    const float* Rk = R + ((size_t)n * K + k) * H4 * W4 * C6;
    const float* Gn = G6 + (size_t)n * H4 * W4 * C6;
    float* ws = st + CC * NA;
    float acc[PY6][8];
#pragma unroll
    for (int i = 0; i < PY6; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < C6; c0 += CC) {
      __syncthreads();
      for (int e = threadIdx.x; e < CC * NA; e += blockDim.x) {
        const int c = e % CC, q = e / CC;
        const int hh = r6y - 1 + q / AW, ww = r6x - 1 + q % AW;
        float v = 0.f;
        if (hh >= 0 && hh < H4 && ww >= 0 && ww < W4) {
          const size_t i = ((size_t)hh * W4 + ww) * C6 + c0 + c;
          v = __fmul_rn(Rk[i], Gn[i]);
        }
        st[c * NA + q] = v;
      }
      lrp::stage_taps<CC>(ws, wt6, c0, C6, C);
      __syncthreads();
      if (active) lrp::convt_column<PY6, CC, AW, NA>(acc, st, ws, C, y0, x, o0);
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < PY6; ++i) {
        const int hh = r6y + y0 + i, ww = r6x + x;
        const bool in = hh >= 0 && hh < H4 && ww >= 0 && ww < W4;
        const float* xp = x6 + (((size_t)n * H4 + hh) * W4 + ww) * C + o0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r6[(o0 + j) * NR6 + (y0 + i) * R6W + x] = in ? __fmul_rn(xp[j], acc[i][j]) : 0.f;
      }
    }
  }

  // ---- phase 2: R3 over its 18x18 region
  {
    const int g = threadIdx.x / TPG3, l = threadIdx.x % TPG3;
    const int x = l % R3W, y0 = (l / R3W) * PY3, o0 = g * 8;
    const float* Mn = M3 + (size_t)n * H2 * W2 * C;
    float* ws = st + CC * NB;
    float acc[PY3][8];
#pragma unroll
    for (int i = 0; i < PY3; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += CC) {
      __syncthreads();
      for (int e = threadIdx.x; e < CC * NB; e += blockDim.x) {
        const int c = e % CC, q = e / CC;
        const int hh = r3y - 1 + q / BW, ww = r3x - 1 + q % BW;
        float v = 0.f;
        if (hh >= 0 && hh < H2 && ww >= 0 && ww < W2) {
          const size_t i = ((size_t)hh * W2 + ww) * C + c0 + c;
          const float m = Mn[i];
          if (m != 0.f) {
            float rv;
            if constexpr (TOP)
              rv = r6[(c0 + c) * NR6 + ((hh >> 1) - r6y) * R6W + (ww >> 1) - r6x];
            else                                   // one merged conv: R at this level
              rv = R[((size_t)n * K + k) * H2 * W2 * C + i];
            v = __fmul_rn(rv, m);
          }
        }
        st[c * NB + q] = v;
      }
      lrp::stage_taps<CC>(ws, wt3, c0, C, C);
      __syncthreads();
      lrp::convt_column<PY3, CC, BW, NB>(acc, st, ws, C, y0, x, o0);
    }
#pragma unroll
    for (int i = 0; i < PY3; ++i) {
      const int hh = r3y + y0 + i, ww = r3x + x;
      const bool in = hh >= 0 && hh < H2 && ww >= 0 && ww < W2;
      const float* xp = x3 + (((size_t)n * H2 + hh) * W2 + ww) * C + o0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r3[(o0 + j) * NR3 + (y0 + i) * R3W + x] = in ? __fmul_rn(xp[j], acc[i][j]) : 0.f;
    }
  }

  // ---- phase 3: the first-layer tail over the 32x32 tile
  const int sy = h0 - 1, sx = w0 - 1;              // s0 region origin
  const float* an = a1 + (size_t)n * H * W * C;
  const int rs = W * C;
  float hacc[L::pixels];
#pragma unroll
  for (int i = 0; i < L::pixels; ++i) hacc[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();                               // s0 reuses the staging space
    for (int e = threadIdx.x; e < CC * NWIN * NWIN; e += blockDim.x) {
      const int c = e % CC, q = e / CC;
      const int hh = h0 - 2 + 2 * (q / NWIN), ww = w0 - 2 + 2 * (q % NWIN);
      int me = 0;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        float am;
        me = lrp::route2x2(an + ((size_t)hh * W + ww) * C + c0 + c, rs, C, &am);
        const int dy = me >> 1, dx = me & 1;
        const float f = __fdiv_rn(
            lrp::relu_gate(am),
            lrp::stabilize(z0[((size_t)(hh + dy) * W + ww + dx) * C + c0 + c], stab0));
        v = __fmul_rn(r3[(c0 + c) * NR3 + ((hh >> 1) - r3y) * R3W + (ww >> 1) - r3x], f);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ly = hh + (p >> 1) - sy, lx = ww + (p & 1) - sx;
        if (ly >= 0 && ly < S0W && lx >= 0 && lx < S0W)
          s0[c * NS0 + ly * S0W + lx] = p == me ? v : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::pixels; ++i) {
      const int p = threadIdx.x + i * L::threads;
      if (p < T * T)
        hacc[i] = lrp::tail_taps<CC>(hacc[i], s0 + (p / T) * S0W + p % T, NS0, S0W, tp, C, c0);
    }
  }
  float* hk = heat + ((size_t)n * K + k) * H * W;
#pragma unroll
  for (int i = 0; i < L::pixels; ++i) {
    const int p = threadIdx.x + i * L::threads;
    const int y = h0 + p / T, x = w0 + p % T;
    if (p < T * T && y < H && x < W) hk[(size_t)y * W + x] = hacc[i];
  }
}

template <int C, int C6, bool TOP>
cudaError_t launch(const float* R, const float* G6, const float* x6, const float* wt6,
                   const float* M3, const float* x3, const float* wt3, const float* a1,
                   const float* z0, const float* taps, float* heat, int b, int K, int H,
                   int W, float stab0, cudaStream_t s) {
  using L = Layout<C, C6, TOP>;
  const size_t bytes = sizeof(float) * L::floats;
  cudaError_t err = lrp::set_smem(merged_tail_kernel<C, C6, TOP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(K, ((H + T - 1) / T) * ((W + T - 1) / T), b);
  merged_tail_kernel<C, C6, TOP><<<grid, L::threads, bytes, s>>>(
      R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, K, H, W, stab0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// merged = 2: R [b,K,H/4,W/4,C6] at conv 6's output, G6 [b,H/4,W/4,C6] and
// x6 [b,H/4,W/4,C] its multiplier and input, wt6 [9,C6,C] its transposed
// w + g*w+. merged = 1: R [b,K,H/2,W/2,C] at conv 3's output; G6, x6, wt6
// are not read. Both: M3 [b,H/2,W/2,C] conv 3's multiplier (with the pool-5
// route for merged = 2), x3 [b,H/2,W/2,C] its input, wt3 [9,C,C3], a1
// [b,H,W,C] the first conv's pre-relu output, z0 [H,W,C], taps [9,C], heat
// [b,K,H,W]. Takes (C, C3, C6) = (32, 32, 64) and (8, 8, 16) (C6 only read
// for merged = 2), H and W divisible by 2 * merged; returns
// cudaErrorInvalidValue for other counts before any launch, else
// cudaGetLastError().
int merged_tail(const float* R, const float* G6, const float* x6, const float* wt6,
                const float* M3, const float* x3, const float* wt3, const float* a1,
                const float* z0, const float* taps, float* heat, int b, int K, int H,
                int W, int C, int C3, int C6, int merged, float stab0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((merged != 1 && merged != 2) || C3 != C || H % (2 * merged) != 0 ||
      W % (2 * merged) != 0)
    return cudaErrorInvalidValue;
  if (merged == 2 && C == 32 && C6 == 64)
    return launch<32, 64, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, stab0, s);
  if (merged == 2 && C == 8 && C6 == 16)
    return launch<8, 16, true>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, stab0, s);
  if (merged == 1 && C == 32)
    return launch<32, 0, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, stab0, s);
  if (merged == 1 && C == 8)
    return launch<8, 0, false>(R, G6, x6, wt6, M3, x3, wt3, a1, z0, taps, heat, b, K, H, W, stab0, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
