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
// Two launches per conv:
//   gamma_prep   once per (instance, 8x8 tile): both forward convs over all
//                output channels, writes G to scratch [b, H, W, Co]. It reads
//                relu(x): a chain conv's input is a relu output already, and
//                the deep first block (csrc/first_block_deep.cu) passes the
//                pre-relu a1. For that block it also zeroes G off the
//                first-argmax route of the (kh, kw) pool above the conv, so
//                that the clone-shared route is taken once per instance.
//   gamma_apply  once per (instance, clone, 8x8 tile): the transposed conv of
//                R * G over the tile plus a 1-pixel halo, times x, and the
//                first-argmax pool route of relu(apre) when a pool is below.
//
// Bound on an H100: operations. Per instance the two forward convs and the
// K transposed convs are 2*(2+K)*H*W*Ci*Co*9 flops against ~4*(K+1)*H*W*C
// bytes of relevance, far above f32's 67 TFLOP/s / 3.35 TB/s balance. This
// first version runs on the f32 FMA units (no tensor cores: LRP stays full
// f32); each thread keeps OG output channels of one pixel in registers, the
// input tile (with halo) and a CC-channel slice of the weights sit in shared
// memory, and the weights are read as warp-wide broadcasts.
//
// Channel counts: OG is 16 where it divides the output count, else 20 (the
// 6s model's 100-channel level: 5 groups, 320 threads), else 8; a block has
// 64 * C/OG <= 1024 threads. The input channels are staged CC at a time and
// a short last slice (4 of 100) is zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

constexpr int TH = 8, TW = 8, TP = TH * TW;
constexpr int HW_ = TW + 2, HALO = (TH + 2) * (TW + 2);
constexpr int CC = 8;

// OG for a level of C channels, or 0 where the kernels take no such count.
inline int group_of(int C) {
  if (C > 128) return 0;
  if (C % 16 == 0) return 16;
  if (C % 20 == 0) return 20;
  if (C % 8 == 0) return 8;
  return 0;
}

template <int OG>
__global__ void gamma_prep_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,     // [9, Ci, 2*Co]
                                  const float* __restrict__ bias,  // [3, Co]
                                  const float* __restrict__ apre,  // [b, H, W, Co] or null
                                  float* __restrict__ G,           // [b, H, W, Co]
                                  int H, int W, int Ci, int Co, int kh, int kw,
                                  float inv, float stab) {
  extern __shared__ float smem[];
  float* xs = smem;               // [CC][HALO]
  float* ws = smem + CC * HALO;   // [9][CC][2*Co]
  const int n = blockIdx.y;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int p = threadIdx.x % TP, o0 = (threadIdx.x / TP) * OG;
  const int py = p / TW, px = p % TW;
  const int Co2 = 2 * Co;
  const float* xn = x + (size_t)n * H * W * Ci;
  float acc1[OG], acc3[OG];
#pragma unroll
  for (int j = 0; j < OG; ++j) acc1[j] = acc3[j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * HALO; e += blockDim.x) {
      const int c = e % CC, q = e / CC;
      const int hh = h0 + q / HW_ - 1, ww = w0 + q % HW_ - 1;
      float v = 0.f;
      if (c0 + c < Ci && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = fmaxf(xn[((size_t)hh * W + ww) * Ci + c0 + c], 0.f);
      xs[c * HALO + q] = v;
    }
    lrp::stage_taps<CC>(ws, w, c0, Ci, Co2);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const float* xr = xs + (py + t / 3) * HW_ + px + t % 3;
      for (int c = 0; c < CC; ++c) {
        const float v = xr[c * HALO];
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
  float* g = G + (((size_t)n * H + h) * W + ww) * Co + o0;
  const int wh = h - h % kh, wv = ww - ww % kw, me = (h - wh) * kw + (ww - wv);
  const float* an = apre != nullptr ? apre + (size_t)n * H * W * Co + o0 : nullptr;
#pragma unroll
  for (int j = 0; j < OG; ++j) {
    const float b1 = bias[o0 + j], b0 = bias[Co + o0 + j], b2 = bias[2 * Co + o0 + j];
    const float z1 = __fadd_rn(acc1[j], b1);
    const float zt = __fadd_rn(
        __fmul_rn(__fsub_rn(__fadd_rn(z1, acc3[j]), b1), inv), b0);
    float v = zt > 0.f ? __fdiv_rn(1.0f, lrp::stabilize(__fadd_rn(z1, b2), stab)) : 0.f;
    if (apre != nullptr && v != 0.f &&
        lrp::route(an + ((size_t)wh * W + wv) * Co + j, kh, kw, W * Co, Co) != me)
      v = 0.f;
    g[j] = v;
  }
}

template <int OG>
__global__ void gamma_apply_kernel(const float* __restrict__ R,     // [b, K, H, W, Co]
                                   const float* __restrict__ G,     // [b, H, W, Co]
                                   const float* __restrict__ x,     // [b, H, W, Ci]
                                   const float* __restrict__ wt,    // [9, Co, Ci]
                                   const float* __restrict__ apre,  // [b, H*kh, W*kw, Ci] or null
                                   float* __restrict__ out,
                                   int K, int H, int W, int Ci, int Co, int kh,
                                   int kw) {
  extern __shared__ float smem[];
  float* ss = smem;               // [CC][HALO]
  float* ws = smem + CC * HALO;   // [9][CC][Ci]
  const int n = blockIdx.z, k = blockIdx.y;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int p = threadIdx.x % TP, o0 = (threadIdx.x / TP) * OG;
  const int py = p / TW, px = p % TW;
  const float* Rn = R + ((size_t)n * K + k) * H * W * Co;
  const float* Gn = G + (size_t)n * H * W * Co;
  float acc[OG];
#pragma unroll
  for (int j = 0; j < OG; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < Co; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * HALO; e += blockDim.x) {
      const int c = e % CC, q = e / CC;
      const int hh = h0 + q / HW_ - 1, ww = w0 + q % HW_ - 1;
      float v = 0.f;
      if (c0 + c < Co && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const size_t i = ((size_t)hh * W + ww) * Co + c0 + c;
        v = __fmul_rn(Rn[i], Gn[i]);
      }
      ss[c * HALO + q] = v;
    }
    lrp::stage_taps<CC>(ws, wt, c0, Co, Ci);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const float* sr = ss + (py + t / 3) * HW_ + px + t % 3;
      for (int c = 0; c < CC; ++c) {
        const float v = sr[c * HALO];
        const float* wr = ws + (t * CC + c) * Ci + o0;
#pragma unroll
        for (int j = 0; j < OG; ++j) acc[j] = fmaf(v, wr[j], acc[j]);
      }
    }
  }
  const int h = h0 + py, ww = w0 + px;
  if (h >= H || ww >= W) return;
  const float* xp = x + (((size_t)n * H + h) * W + ww) * Ci + o0;
  if (apre == nullptr) {
    float* o = out + ((((size_t)n * K + k) * H + h) * W + ww) * Ci + o0;
#pragma unroll
    for (int j = 0; j < OG; ++j) o[j] = __fmul_rn(xp[j], acc[j]);
    return;
  }
  // pool backward: the whole value goes to the first maximum of relu(apre)
  // in row-major window order; the other window positions get 0
  const int Hf = H * kh, Wf = W * kw;
  const float* an = apre + (size_t)n * Hf * Wf * Ci;
  float* on = out + ((size_t)n * K + k) * Hf * Wf * Ci;
#pragma unroll
  for (int j = 0; j < OG; ++j) {
    const float val = __fmul_rn(xp[j], acc[j]);
    const int win =
        lrp::route(an + (((size_t)h * kh) * Wf + ww * kw) * Ci + o0 + j, kh, kw, Wf * Ci, Ci);
    for (int r = 0; r < kh; ++r)
      for (int s = 0; s < kw; ++s)
        on[(((size_t)h * kh + r) * Wf + ww * kw + s) * Ci + o0 + j] =
            (r * kw + s == win) ? val : 0.f;
  }
}

template <int OG>
cudaError_t launch_prep(dim3 grid, int threads, size_t bytes, cudaStream_t s,
                        const float* x, const float* w, const float* bias,
                        const float* apre, float* G, int H, int W, int Ci, int Co,
                        int kh, int kw, float inv, float stab) {
  cudaError_t err = lrp::set_smem(gamma_prep_kernel<OG>, bytes);
  if (err != cudaSuccess) return err;
  gamma_prep_kernel<OG><<<grid, threads, bytes, s>>>(x, w, bias, apre, G, H, W, Ci, Co,
                                                     kh, kw, inv, stab);
  return cudaGetLastError();
}

template <int OG>
cudaError_t launch_apply(dim3 grid, int threads, size_t bytes, cudaStream_t s,
                         const float* R, const float* G, const float* x,
                         const float* wt, const float* apre, float* out, int K,
                         int H, int W, int Ci, int Co, int kh, int kw) {
  cudaError_t err = lrp::set_smem(gamma_apply_kernel<OG>, bytes);
  if (err != cudaSuccess) return err;
  gamma_apply_kernel<OG><<<grid, threads, bytes, s>>>(R, G, x, wt, apre, out, K, H,
                                                      W, Ci, Co, kh, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Phase 1. x [b,H,W,Ci] (read as relu(x)), w [9,Ci,2Co], bias [3,Co],
// G [b,H,W,Co]; apre [b,H,W,Co] or NULL: G is zeroed off the first-argmax
// route of relu(apre) over (kh, kw) windows (H % kh == W % kw == 0). Needs
// group_of(Co) != 0. Returns cudaGetLastError().
int chain_gamma_prep(const float* x, const float* w, const float* bias,
                     const float* apre, float* G, int b, int H, int W, int Ci,
                     int Co, int kh, int kw, float inv, float stab, void* stream) {
  const int og = group_of(Co);
  if (og == 0) return cudaErrorInvalidValue;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), b);
  const int threads = TP * (Co / og);
  const size_t bytes = sizeof(float) * (CC * HALO + 9 * CC * 2 * Co);
  cudaStream_t s = (cudaStream_t)stream;
  if (og == 16)
    return launch_prep<16>(grid, threads, bytes, s, x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab);
  if (og == 20)
    return launch_prep<20>(grid, threads, bytes, s, x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab);
  return launch_prep<8>(grid, threads, bytes, s, x, w, bias, apre, G, H, W, Ci, Co, kh, kw, inv, stab);
}

// Phase 2. R [b,K,H,W,Co], G [b,H,W,Co], x [b,H,W,Ci], wt [9,Co,Ci];
// apre [b,H*kh,W*kw,Ci] or NULL; out [b,K,H,W,Ci] (no pool) or
// [b,K,H*kh,W*kw,Ci]. Needs group_of(Ci) != 0.
int chain_gamma_apply(const float* R, const float* G, const float* x,
                      const float* wt, const float* apre, float* out, int b,
                      int K, int H, int W, int Ci, int Co, int kh, int kw,
                      void* stream) {
  const int og = group_of(Ci);
  if (og == 0) return cudaErrorInvalidValue;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), K, b);
  const int threads = TP * (Ci / og);
  const size_t bytes = sizeof(float) * (CC * HALO + 9 * CC * Ci);
  cudaStream_t s = (cudaStream_t)stream;
  if (og == 16)
    return launch_apply<16>(grid, threads, bytes, s, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw);
  if (og == 20)
    return launch_apply<20>(grid, threads, bytes, s, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw);
  return launch_apply<8>(grid, threads, bytes, s, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh, kw);
}

}  // extern "C"
