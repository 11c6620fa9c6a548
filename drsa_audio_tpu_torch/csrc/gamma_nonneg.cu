// The gamma rule on non-negative input for one 3x3 SAME conv, with the K
// relevance clones folded clone-major into the batch of R: the shared-
// denominator LRP walk's hot rule (xai/lrp/rules.py shared_gamma_nonneg).
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_gamma.py
// _gamma_nonneg_kernel (:49, launched :135); the Python wrapper is
// xai/lrp/fused_gamma.py gamma_nonneg_folded.
//
// Math (f32, NCHW at the interface and inside):
//   z1 = conv(x, w + g*w+) + b1,  z3 = conv(x, w + g*w-)
//   z_true = (z1 + z3 - b1) * f32(1/(2+g)) + b0      (the TPU kernel's form)
//   m1 = [z_true > 0] / stab(z1 + b2),  m3 = [z_true < 0] / stab(z3)
//   R_in[k] = x * (convT(R[k] * m1, w + g*w+) + convT(R[k] * m3, w + g*w-))
// with b1 = b + g*b+, b2 = b + g*b-, b0 = b. x is used as given (no relu).
// Unlike chain_block.cu, no relu gate multiplies R here, so the m3 term is
// not zero and both transposed terms are formed: the apply launch runs one
// transposed conv over the 2*Co channels of [R * m1 | R * m3] with the
// stacked weights.
//
// Two launches:
//   prep   once per (instance, 8x8 tile): both forward convs over all output
//          channels (one pixel and OG channels a thread, as chain_block.cu),
//          writes M = [m1 | m3] [b, 2*Co, H, W] once per instance, so the
//          clone-shared work is not repeated per clone.
//   apply  once per (16x16 tile, folded clone and instance, channel chunk):
//          stages R * M over the tile plus a 1-pixel halo, 8 channels at a
//          time, and accumulates 4 pixels x 8 output channels a thread in
//          registers (lrp::convt_column), then multiplies by x.
//
// Bound on an H100: operations. The forward pair is 2*b*H*W*9*Ci*2*Co flops
// and the transposed conv 2*K*b*H*W*9*2*Co*Ci, against ~4*(b*Ci + 2*K*b*Co
// + K*b*Ci + 2*b*Co)*H*W bytes. The least time counts every product at
// 3xTF32 on the tensor cores (495 / 3 TFLOP/s); this kernel stays full f32
// on the FMA units (67 TFLOP/s).
//
// Channel counts: 0 < Ci, Co <= 128, Ci % 4 == 0, and Co a multiple of 8 or
// of 20 (the 6s model's 100 channels). The apply taps are padded to a
// multiple of 8 output channels (CI8) with zeros, which convt_column's float4
// loads need (CO % 4 == 0, o0 % 8 == 0). Other counts are refused before any
// launch with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

// ---------------------------------------------------------------- prep
constexpr int PTH = 8, PTW = 8, PTP = PTH * PTW;
constexpr int PHW = PTW + 2, PHALO = (PTH + 2) * (PTW + 2);
constexpr int CC = 8;

// ---------------------------------------------------------------- apply
constexpr int TH = 16, TW = 16;                 // output tile
constexpr int SW = TW + 2, NS = (TH + 2) * SW;  // staged region: tile + 1 halo
constexpr int PY = 4;                           // pixels per thread (a column)
constexpr int TPG = TW * (TH / PY);             // threads per channel group (64)
constexpr int MAXG = 8;                         // channel groups per block

inline int group_of(int C) {
  if (C <= 0 || C > 128) return 0;
  if (C % 16 == 0) return 16;
  if (C % 20 == 0) return 20;
  if (C % 8 == 0) return 8;
  return 0;
}

template <int OG>
__global__ void prep_kernel(const float* __restrict__ x,      // [b, Ci, H, W]
                            const float* __restrict__ w,      // [9, Ci, 2*Co]
                            const float* __restrict__ bias,   // [3, Co]: b1, b2, b0
                            float* __restrict__ M,            // [b, 2*Co, H, W]
                            int H, int W, int Ci, int Co, float inv, float stab) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [CC][PHALO]
  float* ws = xs + CC * PHALO;                   // [9][CC][2*Co]
  const int n = blockIdx.y;
  const int tiles_w = (W + PTW - 1) / PTW;
  const int h0 = (blockIdx.x / tiles_w) * PTH, w0 = (blockIdx.x % tiles_w) * PTW;
  const int p = threadIdx.x % PTP, o0 = (threadIdx.x / PTP) * OG;
  const int py = p / PTW, px = p % PTW;
  const int Co2 = 2 * Co;
  const size_t HW = (size_t)H * W;
  const float* xn = x + (size_t)n * Ci * HW;
  float acc1[OG], acc3[OG];
#pragma unroll
  for (int j = 0; j < OG; ++j) acc1[j] = acc3[j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * PHALO; e += blockDim.x) {
      const int c = e / PHALO, q = e % PHALO;
      const int hh = h0 + q / PHW - 1, ww = w0 + q % PHW - 1;
      float v = 0.f;
      if (c0 + c < Ci && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = xn[(size_t)(c0 + c) * HW + (size_t)hh * W + ww];
      xs[c * PHALO + q] = v;
    }
    lrp::stage_taps<CC>(ws, w, c0, Ci, Co2);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const float* xr = xs + (py + t / 3) * PHW + px + t % 3;
      for (int c = 0; c < CC; ++c) {
        const float v = xr[c * PHALO];
        const float* wr = ws + (t * CC + c) * Co2 + o0;
#pragma unroll
        for (int j = 0; j < OG; ++j) {
          acc1[j] = fmaf(v, wr[j], acc1[j]);
          acc3[j] = fmaf(v, wr[Co + j], acc3[j]);
        }
      }
    }
  }
  const int h = h0 + py, ww = w0 + px;
  if (h >= H || ww >= W) return;
  float* m = M + (size_t)n * Co2 * HW + (size_t)h * W + ww;
#pragma unroll
  for (int j = 0; j < OG; ++j) {
    const int o = o0 + j;
    const float b1 = bias[o], b2 = bias[Co + o], b0 = bias[2 * Co + o];
    const float z1 = __fadd_rn(acc1[j], b1);
    const float zt = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(z1, acc3[j]), b1), inv), b0);
    m[(size_t)o * HW] = zt > 0.f ? __fdiv_rn(1.0f, lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
    m[(size_t)(Co + o) * HW] = zt < 0.f ? __fdiv_rn(1.0f, lrp::stabilize(acc3[j], stab)) : 0.f;
  }
}

__global__ void __launch_bounds__(TPG * MAXG)
apply_kernel(const float* __restrict__ R,    // [K*b, Co, H, W]
             const float* __restrict__ M,    // [b, 2*Co, H, W]
             const float* __restrict__ x,    // [b, Ci, H, W]
             const float* __restrict__ wt,   // [9, 2*Co, CI8]
             float* __restrict__ out,        // [K*b, Ci, H, W]
             int b, int H, int W, int Ci, int CI8, int Co, int groups_per_block) {
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);  // [CC][NS]
  float* ws = ss + CC * NS;                      // [9][CC][CI8]
  const int kn = blockIdx.y, n = kn % b;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int g = blockIdx.z * groups_per_block + threadIdx.x / TPG;
  const int l = threadIdx.x % TPG;
  const int xc = l % TW, y0 = (l / TW) * PY, o0 = g * 8;
  const bool active = o0 < CI8;
  const int Co2 = 2 * Co;
  const size_t HW = (size_t)H * W;
  const float* Rk = R + (size_t)kn * Co * HW;
  const float* Mn = M + (size_t)n * Co2 * HW;
  float acc[PY][8];
#pragma unroll
  for (int i = 0; i < PY; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Co2; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * NS; e += blockDim.x) {
      const int c = e / NS, r = e % NS;
      const int hh = h0 - 1 + r / SW, ww = w0 - 1 + r % SW;
      const int ch = c0 + c;
      float v = 0.f;
      if (ch < Co2 && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const size_t pix = (size_t)hh * W + ww;
        const float m = Mn[(size_t)ch * HW + pix];
        if (m != 0.f) v = __fmul_rn(Rk[(size_t)(ch < Co ? ch : ch - Co) * HW + pix], m);
      }
      ss[c * NS + r] = v;
    }
    lrp::stage_taps<CC>(ws, wt, c0, Co2, CI8);
    __syncthreads();
    if (active) lrp::convt_column<PY, CC, SW, NS>(acc, ss, ws, CI8, y0, xc, o0);
  }
  if (!active) return;
  const int w = w0 + xc;
  if (w >= W) return;
  const float* xn = x + (size_t)n * Ci * HW;
  float* on = out + (size_t)kn * Ci * HW;
#pragma unroll
  for (int i = 0; i < PY; ++i) {
    const int h = h0 + y0 + i;
    if (h >= H) break;
    const size_t pix = (size_t)h * W + w;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = o0 + j;
      if (ci < Ci) on[(size_t)ci * HW + pix] = __fmul_rn(xn[(size_t)ci * HW + pix], acc[i][j]);
    }
  }
}

template <int OG>
cudaError_t launch_prep(int b, int H, int W, int Ci, int Co, cudaStream_t s,
                        const float* x, const float* w, const float* bias, float* M,
                        float inv, float stab) {
  const dim3 grid(((H + PTH - 1) / PTH) * ((W + PTW - 1) / PTW), b);
  const size_t bytes = sizeof(float) * (CC * PHALO + 9 * CC * 2 * Co);
  cudaError_t err = lrp::set_smem(prep_kernel<OG>, bytes);
  if (err != cudaSuccess) return err;
  prep_kernel<OG><<<grid, PTP * (Co / OG), bytes, s>>>(x, w, bias, M, H, W, Ci, Co, inv, stab);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [b,Ci,H,W], R [K*b,Co,H,W] (clone-major), wf [9,Ci,2Co] (the forward
// pair w + g*w+ | w + g*w- by tap), wt [9,2Co,CI8] (the same pair flipped and
// transposed, output channels padded to CI8 = Ci rounded up to 8 with zeros),
// bias [3,Co] (b1, b2, b0), scratch M [b,2Co,H,W], out [K*b,Ci,H,W].
// Returns cudaErrorInvalidValue, before any launch, for counts or sizes it
// does not take; else cudaGetLastError() after the two launches.
int gamma_nonneg(const float* x, const float* R, const float* wf, const float* wt,
                 const float* bias, float* M, float* out, int b, int K, int H, int W,
                 int Ci, int Co, float inv, float stab, void* stream) {
  const int og = group_of(Co);
  if (og == 0 || Ci <= 0 || Ci > 128 || Ci % 4 != 0 || b <= 0 || K <= 0 || H <= 0 ||
      W <= 0 || b > 65535 || (long long)K * b > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      og == 16 ? launch_prep<16>(b, H, W, Ci, Co, s, x, wf, bias, M, inv, stab)
      : og == 20 ? launch_prep<20>(b, H, W, Ci, Co, s, x, wf, bias, M, inv, stab)
                 : launch_prep<8>(b, H, W, Ci, Co, s, x, wf, bias, M, inv, stab);
  if (err != cudaSuccess) return err;

  const int CI8 = (Ci + 7) / 8 * 8, ng = CI8 / 8;
  const int chunks = (ng + MAXG - 1) / MAXG, gpb = (ng + chunks - 1) / chunks;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), K * b, chunks);
  const size_t bytes = sizeof(float) * (CC * NS + 9 * CC * CI8);
  err = lrp::set_smem(apply_kernel, bytes);
  if (err != cudaSuccess) return err;
  apply_kernel<<<grid, TPG * gpb, bytes, s>>>(R, M, x, wt, out, b, H, W, Ci, CI8, Co, gpb);
  return cudaGetLastError();
}

}  // extern "C"
