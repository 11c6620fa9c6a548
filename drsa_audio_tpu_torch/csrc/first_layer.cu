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
// route is the first maximum in row-major order of each 2x2 window (strict
// >, so an all-tied window routes to position 0); z0 is the input-
// independent wsquare/flat denominator (SAME zero padding, so the border
// differs); taps[dy, dx, c] = wm[c, 0, 2-dy, 2-dx].
//
// Bound on an H100: bytes. It reads R and a1 once (2 x 2 MB per instance at
// the 3s shapes, K=4) and writes K single-channel maps, for ~18 flops per
// input element; 3.35 TB/s caps it long before 67 TFLOP/s does.
//
// Design. The route is one-hot in each window, so F is kept compactly: per
// coarse pixel and channel the winner's position and f = gate / stab(z0)
// there. A clone's s0 is then R_k * f at the winner and zero elsewhere, and
// the 3x3 transposed conv of one coarse pixel's window lands on a 4x4 patch
// of heatmap pixels (its 2x2 window and a 1-pixel ring). So:
//   - one block per (band of BH coarse rows, instance, group of clones)
//     walks the band row by row, one coarse row above and below included;
//   - per row, the block forms (f, winner) once for every pixel and channel
//     into shared memory, reading a1 and z0 as float4 along C (whole
//     128-byte pixels per 8 threads), for all its clones at once;
//   - each thread owns one coarse column of one clone: it reads R_k as
//     float4 along C and accumulates its 16-pixel patch in registers, the
//     winner choosing by a select which 9 of the 16 cells each tap meets
//     (the 3x3 taps come from shared memory, one broadcast per channel);
//   - patches overlap by one pixel on every side. The vertical overlap is
//     carried in registers from one row to the next; the horizontal one goes
//     through shared memory to the neighbouring columns. Every heatmap pixel
//     is the sum of its four patches' cells in a fixed order, so the maps
//     are the same from run to run.
// Each band recomputes the patches of the coarse row above and below it
// (2 / BH extra work, read from L2). Every a1, z0 and R element is loaded
// once per band, and the heatmaps are written once, as float2 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lrp_common.cuh"

namespace {

constexpr int BH = 16;      // coarse rows per band (32 heatmap rows)
constexpr int MAXT = 512;   // threads a block: coarse columns x clones
constexpr int TQ = 12;      // shared-memory stride of one channel's 9 taps

// Shared memory, in floats: the taps [C][TQ], (f, winner) of two coarse rows
// ([2][Wc][C + 4] floats, [2][Wc][C/4 + 1] packed winners, 16-byte aligned)
// and one float4 of patch edges per thread.
__host__ __device__ inline int fs_at(int C) { return C * TQ; }
__host__ __device__ inline int ws_at(int C, int Wc) { return fs_at(C) + 2 * Wc * (C + 4); }
__host__ __device__ inline int es_at(int C, int Wc) {
  return ws_at(C, Wc) + ((2 * Wc * (C / 4 + 1) + 3) & ~3);
}

__global__ void __launch_bounds__(MAXT)
first_layer_kernel(const float* __restrict__ R,     // [b,K,H/2,W/2,C]
                   const float* __restrict__ a1,    // [b,H,W,C]
                   const float* __restrict__ z0,    // [H,W,C]
                   const float* __restrict__ taps,  // [9,C]
                   float* __restrict__ heat,        // [b,K,H,W]
                   int K, int KC, int H, int W, int C, float stab0) {
  extern __shared__ float4 smem4[];
  const int Hc = H / 2, Wc = W / 2, CP = C + 4, WP = C / 4 + 1;
  float* tq = reinterpret_cast<float*>(smem4);                          // [C][TQ]
  float* fs = tq + fs_at(C);                                             // [2][Wc][CP]
  unsigned* ws = reinterpret_cast<unsigned*>(tq + ws_at(C, Wc));         // [2][Wc][WP]
  float4* es = reinterpret_cast<float4*>(tq + es_at(C, Wc));             // [KC][Wc]
  const int r0 = blockIdx.x * BH, rend = min(r0 + BH, Hc), n = blockIdx.y;
  const int j = threadIdx.x % Wc, kk = threadIdx.x / Wc, k = blockIdx.z * KC + kk;
  const bool live = kk < KC && k < K;
  const float* an = a1 + (size_t)n * H * W * C;
  const float* Rk = R + ((size_t)n * K + (live ? k : 0)) * Hc * Wc * C + (size_t)j * C;
  float* hk = heat + ((size_t)n * K + (live ? k : 0)) * H * W;

  for (int e = threadIdx.x; e < C * TQ; e += blockDim.x) {
    const int c = e / TQ, t = e % TQ;
    tq[e] = t < 9 ? taps[t * C + c] : 0.f;
  }
  // the patch rows still open from the row before: row 2 (heatmap row 2i-1)
  // and row 3 (heatmap row 2i), cells 0..3 each
  float pend[4] = {0.f, 0.f, 0.f, 0.f}, prev3[4] = {0.f, 0.f, 0.f, 0.f};

  for (int i = r0 - 1; i <= rend; ++i) {
    const bool row = i >= 0 && i < Hc;
    float* f = fs + (i & 1) * Wc * CP;
    unsigned* wn = ws + (i & 1) * Wc * WP;
    // (f, winner) of every coarse pixel and channel of row i, once
    if (row) {
      for (int e = threadIdx.x; e < Wc * (C / 4); e += blockDim.x) {
        const int jj = e / (C / 4), c4 = (e % (C / 4)) * 4;
        const size_t o = ((size_t)(2 * i) * W + 2 * jj) * C + c4;
        const float4 p0 = __ldg(reinterpret_cast<const float4*>(an + o));
        const float4 p1 = __ldg(reinterpret_cast<const float4*>(an + o + C));
        const float4 p2 = __ldg(reinterpret_cast<const float4*>(an + o + (size_t)W * C));
        const float4 p3 = __ldg(reinterpret_cast<const float4*>(an + o + (size_t)W * C + C));
        const float4 q0 = __ldg(reinterpret_cast<const float4*>(z0 + o));
        const float4 q1 = __ldg(reinterpret_cast<const float4*>(z0 + o + C));
        const float4 q2 = __ldg(reinterpret_cast<const float4*>(z0 + o + (size_t)W * C));
        const float4 q3 = __ldg(reinterpret_cast<const float4*>(z0 + o + (size_t)W * C + C));
        unsigned w0, w1, w2, w3;
        float4 fv;
        fv.x = lrp::route_factor(p0.x, p1.x, p2.x, p3.x, q0.x, q1.x, q2.x, q3.x, stab0, w0);
        fv.y = lrp::route_factor(p0.y, p1.y, p2.y, p3.y, q0.y, q1.y, q2.y, q3.y, stab0, w1);
        fv.z = lrp::route_factor(p0.z, p1.z, p2.z, p3.z, q0.z, q1.z, q2.z, q3.z, stab0, w2);
        fv.w = lrp::route_factor(p0.w, p1.w, p2.w, p3.w, q0.w, q1.w, q2.w, q3.w, stab0, w3);
        *reinterpret_cast<float4*>(f + jj * CP + c4) = fv;
        wn[jj * WP + c4 / 4] = w0 | (w1 << 8) | (w2 << 16) | (w3 << 24);
      }
    }
    __syncthreads();

    // this thread's 4x4 patch: cell (py + 2 - dy) * 4 + (px + 2 - dx) takes
    // tap (dy, dx) of the winner at (py, px)
    float q[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) q[s] = 0.f;
    if (row && live) {
      const float* Rr = Rk + (size_t)i * Wc * C;
#pragma unroll 1
      for (int c0 = 0; c0 < C; c0 += 4) {
        const float4 r4 = __ldg(reinterpret_cast<const float4*>(Rr + c0));
        const float4 f4 = *reinterpret_cast<const float4*>(f + j * CP + c0);
        const unsigned wp = wn[j * WP + c0 / 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fmul_rn(lrp::comp(r4, e), lrp::comp(f4, e));
          const unsigned win = (wp >> (8 * e)) & 3u;
          const float4 t0 = *reinterpret_cast<const float4*>(tq + (c0 + e) * TQ);
          const float4 t1 = *reinterpret_cast<const float4*>(tq + (c0 + e) * TQ + 4);
          const float t8 = tq[(c0 + e) * TQ + 8];
          const float tp[9] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w, t8};
#pragma unroll
          for (int pos = 0; pos < 4; ++pos) {
            const float sv = win == (unsigned)pos ? v : 0.f;
            const int py = pos >> 1, px = pos & 1;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const int cell = (py + 2 - t / 3) * 4 + (px + 2 - t % 3);
              q[cell] = fmaf(sv, tp[t], q[cell]);
            }
          }
        }
      }
    }
    // heatmap rows 2i-1 (top) and 2i (bottom) over this column's four patch
    // columns, the rows above closed by the carry
    float top[4], bot[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      top[s] = __fadd_rn(pend[s], q[s]);
      bot[s] = __fadd_rn(q[4 + s], prev3[s]);
      pend[s] = q[8 + s];
      prev3[s] = q[12 + s];
    }
    if (kk < KC) es[kk * Wc + j] = make_float4(top[0], bot[0], top[3], bot[3]);
    __syncthreads();
    if (!live) continue;
    const float4 lf = j > 0 ? es[kk * Wc + j - 1] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 rt = j < Wc - 1 ? es[kk * Wc + j + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (i > r0 && i <= rend)           // heatmap row 2i-1 belongs to the band
      *reinterpret_cast<float2*>(hk + (size_t)(2 * i - 1) * W + 2 * j) =
          make_float2(__fadd_rn(top[1], lf.z), __fadd_rn(top[2], rt.x));
    if (i >= r0 && i < rend)           // heatmap row 2i
      *reinterpret_cast<float2*>(hk + (size_t)(2 * i) * W + 2 * j) =
          make_float2(__fadd_rn(bot[1], lf.w), __fadd_rn(bot[2], rt.y));
  }
}

}  // namespace

extern "C" {

// R [b,K,H/2,W/2,C], a1 [b,H,W,C], z0 [H,W,C], taps [9,C], heat [b,K,H,W].
// Needs H and W even, W <= 1024, C % 8 == 0, b <= 65535 and 16-byte aligned
// R, a1 and z0; returns cudaErrorInvalidValue, before any launch, for
// others. Else cudaGetLastError().
int first_layer(const float* R, const float* a1, const float* z0,
                const float* taps, float* heat, int b, int K, int H, int W,
                int C, float stab0, void* stream) {
  const int Wc = W / 2;
  if (b <= 0 || b > 65535 || K <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || Wc > MAXT ||
      C <= 0 || C % 8 || ((uintptr_t)R & 15) || ((uintptr_t)a1 & 15) || ((uintptr_t)z0 & 15))
    return cudaErrorInvalidValue;
  const int KC = K < MAXT / Wc ? K : MAXT / Wc;   // clones a block
  const dim3 grid((H / 2 + BH - 1) / BH, b, (K + KC - 1) / KC);
  const size_t bytes = sizeof(float) * (es_at(C, Wc) + 4 * KC * Wc);
  cudaError_t err = lrp::set_smem(first_layer_kernel, bytes);
  if (err != cudaSuccess) return err;
  first_layer_kernel<<<grid, Wc * KC, bytes, (cudaStream_t)stream>>>(R, a1, z0, taps, heat, K,
                                                                     KC, H, W, C, stab0);
  return cudaGetLastError();
}

}  // extern "C"
