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
// clone-shared, so chain_gamma_prep (csrc/chain_block.cu) writes their
// product M = G * route once per instance, from relu(a1) and apre. The relu
// gate on s and the gamma rule's convT(s * m3) term cancel as in
// chain_block.cu (m3 != 0 only where the gate is 0), so neither is formed.
//
// One thread block per (16x16 output tile, clone, instance). Per C-channel
// slice of CC, the block stages R * M over the tile plus a 2-pixel halo in
// shared memory; each thread accumulates OG output channels of a column of
// PY pixels of the tile plus a 1-pixel halo (18x18 pixels: 18 columns x 3
// strips x C0/OG channel groups), so every staged value and every weight it
// loads feeds PY*OG or 3*PY multiply-adds (lrp::convt_column). Then each
// thread forms s0 for its pixels and channels and reduces them against the 9
// tail taps into shared
// memory, and the tile's pixels sum the 3x3 neighbourhood over the groups.
// Zeros outside the image reproduce SAME padding. The fine relevance Rn
// never reaches device memory.
//
// Bound on an H100: operations. Per instance the K transposed convs at the
// fine level are 2*K*H*W*C*C0*9 flops (the prep's two forward convs add
// 2*2*H*W*C0*C*9), against ~4*(K*H*W*C/(kh*kw) + 2*H*W*C + H*W*C0) bytes:
// at the 6s shapes (128x256, 64 -> 64, K=4) ~14.6 GFLOP against ~26 MB per
// clip, far above f32's 67 TFLOP/s / 3.35 TB/s balance. This version runs
// on the f32 FMA units (no tensor cores: LRP stays full f32) and pays
// (18*18)/(16*16) = 1.27x the transposed conv's work for the halo.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

constexpr int TH = 16, TW = 16;                 // output tile
constexpr int RW = TW + 2, NR = (TH + 2) * RW;  // Rn region: tile + 1 halo
constexpr int PY = 6;                           // Rn pixels per thread (a column)
constexpr int TPG = RW * (TH + 2) / PY;         // threads per channel group (54)
constexpr int SW = TW + 4, NS = (TH + 4) * SW;  // R*M region: tile + 2 halo
constexpr int CC = 8;                           // C channels per slice
constexpr int OG = 8;                           // output channels per thread
constexpr int MAX_THREADS = TPG * 64 / OG;

__global__ void __launch_bounds__(MAX_THREADS)
first_block_deep_kernel(const float* __restrict__ R,      // [b, K, H/kh, W/kw, C]
                        const float* __restrict__ M,      // [b, H, W, C]
                        const float* __restrict__ a1,     // [b, H, W, C0]
                        const float* __restrict__ wt,     // [9, C, C0]
                        const float* __restrict__ z0,     // [H, W, C0]
                        const float* __restrict__ taps,   // [9, C0]
                        float* __restrict__ heat,         // [b, K, H, W]
                        int K, int H, int W, int C0, int C, int kh, int kw,
                        float stab0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ng = C0 / OG;
  float* tp = smem;                   // [9][C0]
  float* ss = tp + 9 * C0;            // [CC][NS]
  float* ws = ss + CC * NS;           // [9][CC][C0]
  float* u = ss;                      // [ng][9][NR], after the main loop
  const int n = blockIdx.z, k = blockIdx.y;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int g = threadIdx.x / TPG, l = threadIdx.x % TPG;
  const int x = l % RW, y0 = (l / RW) * PY, o0 = g * OG;
  const int Hc = H / kh, Wc = W / kw;
  const float* Rk = R + ((size_t)n * K + k) * Hc * Wc * C;
  const float* Mn = M + (size_t)n * H * W * C;
  for (int e = threadIdx.x; e < 9 * C0; e += blockDim.x) tp[e] = taps[e];
  float acc[PY][OG];
#pragma unroll
  for (int i = 0; i < PY; ++i)
#pragma unroll
    for (int j = 0; j < OG; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * NS; e += blockDim.x) {
      const int c = e % CC, r = e / CC;
      const int hh = h0 - 2 + r / SW, ww = w0 - 2 + r % SW;
      const int ch = c0 + c;
      float v = 0.f;
      if (ch < C && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const float m = Mn[((size_t)hh * W + ww) * C + ch];
        if (m != 0.f) v = __fmul_rn(Rk[((size_t)(hh / kh) * Wc + ww / kw) * C + ch], m);
      }
      ss[c * NS + r] = v;
    }
    lrp::stage_taps<CC>(ws, wt, c0, C, C0);
    __syncthreads();
    lrp::convt_column<PY, CC, SW, NS>(acc, ss, ws, C0, y0, x, o0);
  }
  __syncthreads();                    // u reuses the staging buffers

  // relu(a1) and the tail multiplier, then this thread's channels against
  // the 9 tail taps, per pixel
  const int w = w0 - 1 + x;
#pragma unroll
  for (int i = 0; i < PY; ++i) {
    float part[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) part[t] = 0.f;
    const int h = h0 - 1 + y0 + i;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const float* ap = a1 + (((size_t)n * H + h) * W + w) * C0 + o0;
      const float* zp = z0 + ((size_t)h * W + w) * C0 + o0;
#pragma unroll
      for (int j = 0; j < OG; ++j) {
        const float a = ap[j];
        const float rn = __fmul_rn(fmaxf(a, 0.f), acc[i][j]);
        const float s0 =
            __fmul_rn(rn, __fdiv_rn(lrp::relu_gate(a), lrp::stabilize(zp[j], stab0)));
#pragma unroll
        for (int t = 0; t < 9; ++t) part[t] = fmaf(s0, tp[t * C0 + o0 + j], part[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) u[(g * 9 + t) * NR + (y0 + i) * RW + x] = part[t];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < TH * TW; p += blockDim.x) {
    const int oy = p / TW, ox = p % TW;
    if (h0 + oy >= H || w0 + ox >= W) continue;
    float sum = 0.f;
    for (int gg = 0; gg < ng; ++gg)
      for (int t = 0; t < 9; ++t)
        sum += u[(gg * 9 + t) * NR + (oy + t / 3) * RW + ox + t % 3];
    heat[(((size_t)n * K + k) * H + h0 + oy) * W + w0 + ox] = sum;
  }
}

}  // namespace

extern "C" {

// R [b,K,H/kh,W/kw,C], M [b,H,W,C] (chain_gamma_prep of relu(a1), masked by
// the pool route of relu(apre)), a1 [b,H,W,C0], wt [9,C,C0] (the transposed
// w + g*w+), z0 [H,W,C0], taps [9,C0], heat [b,K,H,W]. Needs C0 in
// {8, 16, ..., 64} (a multiple of 8), H % kh == 0, W % kw == 0. Returns
// cudaGetLastError().
int first_block_deep(const float* R, const float* M, const float* a1,
                     const float* wt, const float* z0, const float* taps,
                     float* heat, int b, int K, int H, int W, int C0, int C,
                     int kh, int kw, float stab0, void* stream) {
  if (C0 % OG != 0 || C0 > 64 || C0 <= 0) return cudaErrorInvalidValue;
  const int ng = C0 / OG;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), K, b);
  const size_t stage = CC * NS + 9 * CC * C0, red = ng * 9 * NR;
  const size_t bytes = sizeof(float) * (9 * C0 + (stage > red ? stage : red));
  cudaError_t err = lrp::set_smem(first_block_deep_kernel, bytes);
  if (err != cudaSuccess) return err;
  first_block_deep_kernel<<<grid, TPG * ng, bytes, (cudaStream_t)stream>>>(
      R, M, a1, wt, z0, taps, heat, K, H, W, C0, C, kh, kw, stab0);
  return cudaGetLastError();
}

}  // extern "C"
