// First-layer tail of the lower LRP chain: the (2,2) max-pool backward, the
// relu gate and the wsquare/flat rule of the first conv (one input channel),
// for every relevance clone.
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_chain.py
// _first_layer_kernel (:709, launched :1192), including its flag variants
// (mm_taps, recompute), which compute the same function.
//
// Math (f32, NHWC):
//   F   = route(relu(a1)) * relu_gate(a1) / stab(z0)   at the fine level
//   s0  = upsample2(R) * F
//   heat[h, w] = sum_{dy,dx,c} s0[h+dy-1, w+dx-1, c] * taps[dy, dx, c]
// route is the first maximum in row-major order of each 2x2 window; z0 is
// the input-independent wsquare/flat denominator (SAME zero padding, so the
// border differs); taps[dy, dx, c] = wm[c, 0, 2-dy, 2-dx].
//
// One thread block per (clone, band of FB output rows, instance); clones are
// the fastest grid index so the K blocks of one band read a1 from L2. For each
// CC-channel slice the block builds s0 over its band plus a 1-row/1-column
// halo in shared memory (F is formed in-kernel, never stored), then every
// thread accumulates its output pixels over the 9 taps.
//
// Bound on an H100: bytes. It reads R and a1 once (2 x 512 KB per instance
// at the 3s shapes) and writes K single-channel maps, for ~18 flops per
// input element; 3.35 TB/s caps it long before 67 TFLOP/s does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

constexpr int FB = 8;   // output rows per block
constexpr int CC = 8;   // channels per shared-memory slice
constexpr int PX = 4;   // output pixels per thread

__global__ void first_layer_kernel(const float* __restrict__ R,     // [b,K,H/2,W/2,C]
                                   const float* __restrict__ a1,    // [b,H,W,C]
                                   const float* __restrict__ z0,    // [H,W,C]
                                   const float* __restrict__ taps,  // [9,C]
                                   float* __restrict__ heat,        // [b,K,H,W]
                                   int K, int H, int W, int C, float stab0) {
  extern __shared__ float smem[];
  const int SW = W + 2, SH = FB + 2;
  float* s = smem;                  // [CC][SH][SW]
  float* tp = smem + CC * SH * SW;  // [9][C]
  const int k = blockIdx.x, h0 = blockIdx.y * FB, n = blockIdx.z;
  const int Hc = H / 2, Wc = W / 2;
  const float* an = a1 + (size_t)n * H * W * C;
  const float* Rn = R + ((size_t)n * K + k) * Hc * Wc * C;
  for (int e = threadIdx.x; e < 9 * C; e += blockDim.x) tp[e] = taps[e];
  float acc[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CC * SH * SW; e += blockDim.x) {
      const int c = e % CC, q = e / CC;
      const int row = q / SW, col = q % SW;
      const int hh = h0 + row - 1, ww = col - 1;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const float* base = an + ((size_t)(hh & ~1) * W + (ww & ~1)) * C + c0 + c;
        float am;
        if (lrp::route2x2(base, W * C, C, &am) == (hh & 1) * 2 + (ww & 1)) {
          const float f = __fdiv_rn(
              lrp::relu_gate(am), lrp::stabilize(z0[((size_t)hh * W + ww) * C + c0 + c], stab0));
          v = __fmul_rn(Rn[((size_t)(hh >> 1) * Wc + (ww >> 1)) * C + c0 + c], f);
        }
      }
      s[(c * SH + row) * SW + col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int p = threadIdx.x + i * blockDim.x;
      acc[i] = lrp::tail_taps<CC>(acc[i], s + (p / W) * SW + p % W, SH * SW, SW, tp, C, c0);
    }
  }
  float* hn = heat + (((size_t)n * K + k) * H + h0) * W;
#pragma unroll
  for (int i = 0; i < PX; ++i) hn[threadIdx.x + i * blockDim.x] = acc[i];
}

}  // namespace

extern "C" {

// R [b,K,H/2,W/2,C], a1 [b,H,W,C], z0 [H,W,C], taps [9,C], heat [b,K,H,W].
// Needs H % 8 == 0, W even, (8*W) % 4 == 0 with 8*W/4 <= 1024, C % 8 == 0.
// Returns cudaGetLastError().
int first_layer(const float* R, const float* a1, const float* z0,
                const float* taps, float* heat, int b, int K, int H, int W,
                int C, float stab0, void* stream) {
  const dim3 grid(K, H / FB, b);
  const int threads = FB * W / PX;
  const size_t bytes = sizeof(float) * (CC * (FB + 2) * (W + 2) + 9 * C);
  cudaError_t err = lrp::set_smem(first_layer_kernel, bytes);
  if (err != cudaSuccess) return err;
  first_layer_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      R, a1, z0, taps, heat, K, H, W, C, stab0);
  return cudaGetLastError();
}

}  // extern "C"
