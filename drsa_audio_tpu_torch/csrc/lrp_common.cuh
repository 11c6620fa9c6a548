// Device code shared by the lower LRP chain kernels (chain_block.cu,
// first_layer.cu, first_block_deep.cu, merged_tail.cu): the rule's
// stabilizer, the relu gate, the first-argmax pool route, the staging of a
// weight slice, the register-blocked transposed 3x3 conv and the
// first-layer tail's 3x3 taps.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lrp {

__device__ __forceinline__ float stabilize(float z, float eps) {
  return __fadd_rn(z, z >= 0.f ? eps : -eps);
}

// The vjp of max(a, 0) as JAX takes it: 1 above 0, 0.5 at 0, 0 below.
__device__ __forceinline__ float relu_gate(float a) {
  return a > 0.f ? 1.f : (a == 0.f ? 0.5f : 0.f);
}

// Row-major position of the first maximum of relu(a) over a kh x kw pool
// window (strict >, so an all-tied window routes to position 0, as JAX's
// reduce_window vjp). a points at the window's first element; rs and cs are
// its row and column strides.
__device__ __forceinline__ int route(const float* a, int kh, int kw, int rs, int cs) {
  int win = 0;
  float best = -1.f;
  for (int r = 0; r < kh; ++r)
    for (int s = 0; s < kw; ++s) {
      const float v = fmaxf(a[r * rs + s * cs], 0.f);
      if (v > best) { best = v; win = r * kw + s; }
    }
  return win;
}

// The same for a 2x2 window, from its four values loaded at once; *v gets
// the winner's own (pre-relu) value.
__device__ __forceinline__ int route2x2(const float* a, int rs, int cs, float* v) {
  const float w[4] = {a[0], a[cs], a[rs], a[rs + cs]};
  int win = 0;
  float best = fmaxf(w[0], 0.f);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float r = fmaxf(w[i], 0.f);
    if (r > best) { best = r; win = i; }
  }
  *v = w[win];
  return win;
}

// Stage input channels [c0, c0 + CC) of the taps wt [9][C][CO] into
// ws [9][CC][CO], zero past C. All threads of the block take part.
template <int CC>
__device__ __forceinline__ void stage_taps(float* ws, const float* __restrict__ wt,
                                           int c0, int C, int CO) {
  for (int e = threadIdx.x; e < 9 * CC * CO; e += blockDim.x) {
    const int o = e % CO, q = e / CO;
    const int c = c0 + q % CC;
    ws[e] = c < C ? wt[((size_t)(q / CC) * C + c) * CO + o] : 0.f;
  }
}

// One staged CC-channel slice of a transposed 3x3 conv, register-blocked:
// the thread holds a column of PY output pixels x 8 output channels,
//   acc[i][j] += sum_{c, dy, dx} ss[c][(y0 + i + dy) * SW + x + dx]
//                                * ws[dy * 3 + dx][c][o0 + j],
// where ss [CC][NS] holds the slice over the output region plus a 1-pixel
// halo (row stride SW) and ws [9][CC][CO] its taps (16-byte aligned,
// CO % 4 == 0, o0 % 8 == 0). Every staged value feeds 3 * 8 multiply-adds
// per dy, every weight PY.
template <int PY, int CC, int SW, int NS>
__device__ __forceinline__ void convt_column(float (&acc)[PY][8], const float* ss,
                                             const float* ws, int CO, int y0, int x,
                                             int o0) {
#pragma unroll 2
  for (int c = 0; c < CC; ++c) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float sv[PY + 2];
#pragma unroll
      for (int r = 0; r < PY + 2; ++r) sv[r] = ss[c * NS + (y0 + r) * SW + x + dx];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4* wr =
            reinterpret_cast<const float4*>(ws + ((dy * 3 + dx) * CC + c) * CO + o0);
        const float4 wa = wr[0], wb = wr[1];
        const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < PY; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(sv[i + dy], w8[j], acc[i][j]);
      }
    }
  }
}

// One CC-channel slice of the first-layer tail at one heatmap pixel:
//   acc + sum_{c, dy, dx} s[c * cs + dy * sw + dx] * tp[(dy * 3 + dx) * C + c0 + c],
// with s at the pixel's upper-left neighbour in a staged s0 slice (channel
// stride cs, row stride sw) and tp the taps [9][C].
template <int CC>
__device__ __forceinline__ float tail_taps(float acc, const float* s, int cs, int sw,
                                           const float* tp, int C, int c0) {
  for (int c = 0; c < CC; ++c) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc = fmaf(s[c * cs + (t / 3) * sw + t % 3], tp[t * C + c0 + c], acc);
  }
  return acc;
}

// Dynamic shared memory above 48 KB needs the opt-in.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace lrp
