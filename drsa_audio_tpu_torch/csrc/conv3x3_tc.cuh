// The staging and A-operand pieces of the wgmma kernels (conv3x3_wgmma.cuh:
// chain_block.cu, first_block_deep.cu, merged_tail.cu, gamma_nonneg.cu): a
// 3x3 SAME conv, or its transpose, as an implicit GEMM in 3xTF32, fed by
// asynchronous, double-buffered staging of channel slices.
//
// Product. out[m, n] = sum_{tap, c} A[m + off(tap), c] * w[tap][c][n], m a
// pixel of the block's tile, n an output channel; the reduction runs over
// the 9 taps and the input channels, CC = 8 channels per staged slice. The
// transposed conv is the same product with the flipped, transposed taps.
//
// 3xTF32. Each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), A once per staged value (split_region), B once on the host
// (xai/lrp/taps.py wgmma_taps), and the product is summed as lo*hi + hi*lo
// + hi*hi in an f32 accumulator: about 2^-21 relative error per product
// against f32's 2^-24, at three tensor-core products per f32 product (495 /
// 3 = 165 TFLOP/s on an H100 SXM, 2.5x the FMA units' 67). LRP stays
// f32-accurate: bf16 or plain TF32 would not.
//
// Staging. cp.async (16 bytes, .cg, zero-fill outside the image and past the
// channel count) brings slice s + 1 of the input regions while slice s
// multiplies (two buffers, pipeline). A pixel's slice sits at a stride of SP
// = CC + 4 floats, so the 8 rows of 16 bytes of an ldmatrix phase hit 32
// distinct banks. Channel-major (NCHW) images are staged as they lie, whole
// 16-byte pieces of rows (stage_rows_nchw), and moved into that layout by
// the split.
//
// Elementwise factors and the split. The A element is relu(a), a as it is,
// or the f32 product a * b of two staged factors (R * G, R * M): the same
// value the plain version convolves. Once a slice has landed, one pass forms
// it and splits it into hi and lo regions (split_region), so the products
// load each A fragment with one ldmatrix per part and convert nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int CC = 8;        // reduction channels per staged slice
constexpr int SP = CC + 4;   // shared-memory pixel stride, floats

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative, both exact in TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, through L1 (.ca: the only class that copies fewer than 16).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Channels [c0, c0 + CC) (one slice) of an RH x RW pixel region whose
// upper-left pixel is (y0, x0) of the image src [H, W, C], into dst
// [RH * RW][SP]; zero outside the image and past C. C % 4 == 0; all threads
// of the block take part.
__device__ __forceinline__ void stage_region(float* dst, const float* __restrict__ src, int RH,
                                             int RW, int y0, int x0, int H, int W, int C,
                                             int c0) {
  constexpr int NCH = CC / 4;
  for (int e = threadIdx.x; e < RH * RW * NCH; e += blockDim.x) {
    const int q = (unsigned)e / NCH, r = (unsigned)e % NCH, c = c0 + r * 4;
    const int h = y0 + q / RW, w = x0 + q % RW;
    const bool ok = c < C && h >= 0 && h < H && w >= 0 && w < W;
    const float* s = ok ? src + ((size_t)h * W + w) * C + c : src;
    cp16(dst + q * SP + r * 4, s, ok);
  }
}

// Channels [c0, c0 + NCH) of the channel-major image src [C, H, W] (NCHW)
// around a tile of 8 columns from x0 (a multiple of 8): for each channel
// and each of the RH rows from y0, the 16 columns x0 - 4 .. x0 + 11 as they
// lie in memory, into dst [NCH][RH][16]; zero outside the image and past C.
// A 3x3 conv of the tile reads columns x0 - 1 .. x0 + 8 (dst columns 3 ..
// 12). vec (W % 4 == 0, src 16-byte aligned): four 16-byte copies a row,
// whole pieces of the row in or out of the image; else one float a copy of
// the ten columns read. All threads of the block take part.
template <int NCH>
__device__ __forceinline__ void stage_rows_nchw(float* dst, const float* __restrict__ src, int RH,
                                                int y0, int x0, int H, int W, int C, int c0,
                                                bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < NCH * RH * 4; e += blockDim.x) {
      const int k = e & 3, r = (e >> 2) % RH, c = (e >> 2) / RH;
      const int h = y0 + r, w = x0 - 4 + 4 * k;
      const bool ok = c0 + c < C && h >= 0 && h < H && w >= 0 && w < W;
      cp16(dst + (c * RH + r) * 16 + 4 * k, ok ? src + ((size_t)(c0 + c) * H + h) * W + w : src,
           ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < NCH * RH * 10; e += blockDim.x) {
    const int j = e % 10, r = (e / 10) % RH, c = e / 10 / RH;
    const int h = y0 + r, w = x0 - 1 + j;
    const bool ok = c0 + c < C && h >= 0 && h < H && w >= 0 && w < W;
    cp4(dst + (c * RH + r) * 16 + 3 + j, ok ? src + ((size_t)(c0 + c) * H + h) * W + w : src, ok);
  }
}

// The double-buffered walk over nsl slices: stage(s) issues slice s's
// copies into buffer s & 1 and commits them; compute(s) multiplies it.
// Slice s + 1 is in flight while slice s multiplies.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int nsl, Stage stage, Compute compute) {
  stage(0);
  for (int s = 0; s < nsl; ++s) {
    if (s + 1 < nsl) {
      stage(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    compute(s);
    __syncthreads();
  }
}

// The A operand of one slice, split once: hi[q * SP + c] = tf32(v),
// lo[q * SP + c] = tf32(v - hi) for the n pixels q of a staged region and
// its CC channels, v = value(q, c4) (a float4 of channels c4 .. c4 + 3).
// Every staged value then feeds its 9 taps and all the block's output
// channels from two ldmatrix loads, with no conversion in the product loop.
// hi and lo may be the staged factors themselves, where value(q, c4) reads
// only element (q, c4) of them: the thread that reads it writes it.
template <class Value>
__device__ __forceinline__ void split_region(float* hi, float* lo, int n, Value value) {
  for (int e = threadIdx.x; e < n * (CC / 4); e += blockDim.x) {
    const int q = e / (CC / 4), c4 = (e % (CC / 4)) * 4;
    const float4 v = value(q, c4);
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + q * SP + c4) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + q * SP + c4) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// An m16n8k8 A fragment (16 pixels x 8 channels) from a split region: lane
// l gives row (l & 7) + 8 * ((l >> 3) & 1), columns 4 * (l >> 4) .. + 3, and
// receives the fragment in mma order (a0 rows 0-7 / cols 0-3, a1 rows 8-15,
// a2 and a3 columns 4-7).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The offset, in floats of a split region, of the row this lane gives to
// ldsm_a for the m-fragment whose 16 rows sit at pixel offsets
// pix(0 .. 15) (pix(r) = the region offset of fragment row r).
template <class Pix>
__device__ __forceinline__ int lane_row(Pix pix) {
  const int lane = threadIdx.x & 31;
  return pix((lane & 7) + 8 * ((lane >> 3) & 1)) * SP + 4 * (lane >> 4);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace tc
