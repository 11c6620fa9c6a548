// Device code shared by the lower LRP chain kernels (chain_block.cu,
// first_layer.cu, first_block_deep.cu, merged_tail.cu, gamma_nonneg.cu): the
// rule's stabilizer, the relu gate, the first-argmax pool route and the
// first-layer tail's route factor.
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

// The first maximum of relu over a 2x2 window's four values (row-major; the
// same decisions as route), and f = relu_gate(a) / stab(z0) at it: the
// first-layer tail's factor. win gets the winner's position.
__device__ __forceinline__ float route_factor(float a0, float a1, float a2, float a3,
                                              float z0, float z1, float z2, float z3,
                                              float stab0, unsigned& win) {
  float best = fmaxf(a0, 0.f), am = a0, z = z0, r;
  win = 0;
  r = fmaxf(a1, 0.f);
  if (r > best) { best = r; am = a1; z = z1; win = 1; }
  r = fmaxf(a2, 0.f);
  if (r > best) { best = r; am = a2; z = z2; win = 2; }
  r = fmaxf(a3, 0.f);
  if (r > best) { am = a3; z = z3; win = 3; }
  return __fdiv_rn(relu_gate(am), stabilize(z, stab0));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Dynamic shared memory above 48 KB needs the opt-in.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace lrp
