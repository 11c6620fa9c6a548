// The mma.sync core of merged_tail.cu and gamma_nonneg.cu: a 3x3 SAME
// conv, or its transpose, as an implicit GEMM in 3xTF32, fed by
// asynchronous, double-buffered staging of channel slices. Its staging and
// A-operand pieces (stage_region, split_region, lane_row, ldsm_a, pipeline)
// also feed the wgmma core of chain_block.cu and first_block_deep.cu
// (conv3x3_wgmma.cuh).
//
// Product. out[m, n] = sum_{tap, c} A[m + off(tap), c] * w[tap][c][n], m a
// pixel of the block's tile, n an output channel; the reduction runs over
// the 9 taps and the input channels, CC = 8 channels (one mma k-step) per
// staged slice. The transposed conv is the same product with the flipped,
// transposed taps (GammaConv.w_apply_tc).
//
// 3xTF32. Each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), A once per staged value, B once per fragment element, and the
// product is summed as
// lo*hi + hi*lo + hi*hi in an f32 accumulator: about 2^-21 relative error
// per product against f32's 2^-24, at three tensor-core products per f32
// product (495 / 3 = 165 TFLOP/s on an H100 SXM, 2.5x the FMA units' 67).
// LRP stays f32-accurate: bf16 or plain TF32 would not.
//
// Instruction. mma.sync m16n8k8 (row.col, f32 += tf32 * tf32). A 3x3 conv's
// A operand is the staged tile shifted by one pixel per tap; mma.sync
// fragments loaded from padded shared memory take that shift as a constant
// offset. mma.sync does not reach the dense TF32 rate on Hopper; the
// kernels on it are bound by its issue rate and the instructions that feed
// it. wgmma with A from registers keeps the same constant-offset loads
// (conv3x3_wgmma.cuh).
//
// Staging. cp.async (16 bytes, .cg, zero-fill outside the image and past the
// channel count) brings slice s + 1 of the input region and of the taps
// while slice s multiplies (two buffers). A pixel's slice sits at a stride
// of SP = CC + 4 floats, so the 8 rows of 16 bytes of an ldmatrix phase hit
// 32 distinct banks; a tap row of BN weights sits at BN + 8 floats (BN a
// multiple of 32), so a B fragment's 4 rows x 8 columns do too. The host
// lays the taps out as [ceil(K/CC)][9][CC][N] (xai/lrp/chain.py
// slice_taps), one contiguous block per slice.
//
// Elementwise factors and the split. The A element is relu(a) (a forward
// conv of a relu output, or of the deep block's pre-relu a1) or the f32
// product a * b of two factors staged as they are (R * G, R * M): the same
// value the plain version convolves. Once a slice has landed, one pass forms
// it and splits it into hi and lo regions (split_region), so the mma loop
// loads each A fragment with one ldmatrix per part and converts nothing;
// the B fragments (one per 8 output channels, reused over the warp's
// m-fragments) are split as they are loaded.
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

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Channels [c0, c0 + 4 * NCH) (NCH = 2: one slice of CC) of an RH x RW
// pixel region whose upper-left pixel is (y0, x0) of the image src
// [H, W, C], into dst [RH * RW][SP]; zero outside the image and past C.
// C % 4 == 0; all threads of the block take part.
template <int NCH = 2>
__device__ __forceinline__ void stage_region(float* dst, const float* __restrict__ src,
                                             int RH, int RW, int y0, int x0, int H, int W,
                                             int C, int c0) {
  for (int e = threadIdx.x; e < RH * RW * NCH; e += blockDim.x) {
    const int q = (unsigned)e / NCH, r = (unsigned)e % NCH, c = c0 + r * 4;
    const int h = y0 + q / RW, w = x0 + q % RW;
    const bool ok = c < C && h >= 0 && h < H && w >= 0 && w < W;
    const float* s = ok ? src + ((size_t)h * W + w) * C + c : src;
    cp16(dst + q * SP + r * 4, s, ok);
  }
}

// The same from a channel-major image src [C, H, W] (NCHW), one float a
// copy, neighbouring threads on neighbouring pixels of a row.
template <int NCH = 2>
__device__ __forceinline__ void stage_region_nchw(float* dst, const float* __restrict__ src,
                                                  int RH, int RW, int y0, int x0, int H, int W,
                                                  int C, int c0) {
  const int n = RH * RW;
  for (int e = threadIdx.x; e < n * 4 * NCH; e += blockDim.x) {
    const int q = e % n, c = e / n;
    const int h = y0 + q / RW, w = x0 + q % RW;
    const bool ok = c0 + c < C && h >= 0 && h < H && w >= 0 && w < W;
    cp4(dst + q * SP + c, ok ? src + ((size_t)(c0 + c) * H + h) * W + w : src, ok);
  }
}

// Columns [n0, n0 + BN) of slice s of the taps w [nsl][9][CC][N] into
// dst [9 * CC][BN + 8], zero past N (N % 4 == 0).
template <int BN>
__device__ __forceinline__ void stage_taps(float* dst, const float* __restrict__ w, int s,
                                           int N, int n0) {
  constexpr int Q = BN / 4;
  const float* blk = w + (size_t)s * 9 * CC * N;
  for (int e = threadIdx.x; e < 9 * CC * Q; e += blockDim.x) {
    const int r = e / Q, c = (e % Q) * 4;
    const bool ok = n0 + c < N;
    cp16(dst + r * (BN + 8) + c, ok ? blk + (size_t)r * N + n0 + c : w, ok);
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
// channels from two ldmatrix loads, with no conversion in the mma loop.
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

// One split slice for one warp: MF m-fragments of 16 pixels by NF
// n-fragments of 8 channels (the first nfr active),
//   acc[i][j] += sum_{tap, c} A(pixel + off(tap), c) * ws[tap * CC + c][ncol + 8j + .],
// off(tap) = (tap / 3) * RW + tap % 3 in the region of row stride RW. hi and
// lo are the region split by split_region, lrow[i] this lane's ldsm_a row
// for m-fragment i (lane_row); WS is the tap rows' stride.
//
// FRESH: each k-step's three products go into a zeroed fragment, which is
// then added to acc in f32 with round-to-nearest. The tensor core adds a
// product to its accumulator with truncation, so accumulating 27 products a
// slice in it drifts by up to ~2^-23 of the running sum per mma, one way;
// on the card that flipped the sign of a z_true at 6e-7 of the map's
// maximum. The prep's sign decisions take FRESH, at 4 adds per 3 mma; the
// transposed convs, linear in R, decide nothing and accumulate in the core.
template <int MF, int NF, bool FRESH, int NB = (NF < 4 ? NF : 4)>
__device__ __forceinline__ void slice_mma(float (&acc)[MF][NF][4], const float* hi,
                                          const float* lo, const int (&lrow)[MF], int RW,
                                          const float* ws, int WS, int ncol, int nfr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t shi = (uint32_t)__cvta_generic_to_shared(hi);
  const uint32_t slo = (uint32_t)__cvta_generic_to_shared(lo);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * RW + tap % 3) * SP;
    // the n-fragments in groups of NB, so that a group's split B fragments
    // and the accumulators stay in registers (the A fragments are reloaded
    // per group: two ldmatrix)
#pragma unroll
    for (int j0 = 0; j0 < NF; j0 += NB) {
      uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) {
        if (j0 + jj < nfr) {
          const float* wp = ws + (tap * CC + t4) * WS + ncol + (j0 + jj) * 8 + g;
          split(wp[0], bh[jj][0], bl[jj][0]);
          split(wp[4 * WS], bh[jj][1], bl[jj][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        uint32_t ah[4], al[4];
        ldsm_a(ah, shi + 4 * (lrow[i] + off));
        ldsm_a(al, slo + 4 * (lrow[i] + off));
        // the three products of each n-fragment, small cross terms first,
        // issued pass by pass so that consecutive mma are independent
        float d[NB][4];
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[jj][e] = FRESH ? 0.f : acc[i][j0 + jj][e];
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
          if (j0 + jj < nfr) mma(d[jj], al, bh[jj][0], bh[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
          if (j0 + jj < nfr) mma(d[jj], ah, bl[jj][0], bl[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
          if (j0 + jj < nfr) mma(d[jj], ah, bh[jj][0], bh[jj][1]);
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j0 + jj][e] = FRESH ? __fadd_rn(acc[i][j0 + jj][e], d[jj][e]) : d[jj][e];
      }
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace tc
