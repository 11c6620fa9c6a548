// Fused log-mel front-end: reflect-padded, Hann-windowed frames of the
// waveform -> one-sided DFT as cos/sin products -> magnitude -> mel product
// -> ln(x + 1e-7) * f32(1/ln 10), clamped at -4, for the frames that the
// [1 : width + 1] crop keeps.
//
// Replaces the TPU kernel drsa_audio_tpu/ops/pallas_frontend.py
// _logmel_kernel (:34, launched :83); the Python wrapper is
// ops/fused_frontend.py fused_logmel.
//
// One thread block per (tile of FT = 64 output frames, clip), 256 threads.
// No frames tensor is written: each K step stages KC = 32 samples of the
// tile's 64 frames from the waveform (reflect padding by n_fft/2 and the
// window applied on the fly) and the matching rows of the cos and sin bases
// (held in L2), and every thread accumulates re and im for 4 frames x 4
// frequencies in registers. Per chunk of FC = 64 frequencies the block forms
// the magnitudes in shared memory and adds their product with the chunk's
// mel-filterbank rows into a [64 frames x 128 mels] accumulator (4 frames x
// 8 mels a thread), which stays in registers across the chunks. The
// epilogue takes the log and writes [clip, n_mels, width] directly.
//
// Full f32 FMAs (no TF32). The host pads the basis to NK = n_fft rounded up
// to KC rows and NFP = n_freq rounded up to FC columns, and the filterbank to
// NFP x 128, with zeros, so that padded terms add exact zeros.
//
// Bound on an H100: operations, (2 * n_fft * n_freq * 2 + 2 * n_freq *
// n_mels) flops per output frame against ~4 * (hop + n_mels) bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 64;                 // output frames per block
constexpr int FC = 64;                 // frequencies per chunk
constexpr int KC = 32;                 // samples per K step
constexpr int MP = 128;                // mel columns (padded)
constexpr int THREADS = 256;
constexpr int AS = FT + 4;             // row stride of the staged frames
constexpr int MS = FC + 4;             // row stride of the staged magnitudes

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ wav,    // [B, L]
              const float* __restrict__ win,    // [n_fft]
              const float* __restrict__ cosb,   // [NK, NFP]
              const float* __restrict__ sinb,   // [NK, NFP]
              const float* __restrict__ fb,     // [NFP, MP]
              float* __restrict__ out,          // [B, n_mels, width]
              int L, int n_fft, int hop, int NK, int NFP, int n_mels, int width,
              float inv_ln10) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [KC][AS]  frames, sample-major
  float* Bc = As + KC * AS;                      // [KC][FC]
  float* Bs = Bc + KC * FC;                      // [KC][FC]
  float* Ms = Bs + KC * FC;                      // [FT][MS]  magnitudes
  float* Fs = Ms + FT * MS;                      // [FC][MP]  filterbank rows
  const int tid = threadIdx.x;
  const int clip = blockIdx.y, f0 = blockIdx.x * FT;
  const int pad = n_fft / 2;
  const float* x = wav + (size_t)clip * L;
  // DFT tile: frames fy*4 .. +3, frequencies fx*4 .. +3 of the chunk
  const int fy = tid / 16, fx = tid % 16;
  // mel tile: frames mf*4 .. +3, mels my*8 .. +7
  const int mf = tid / 16, my = tid % 16;
  float mel[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mel[i][j] = 0.f;

  for (int c0 = 0; c0 < NFP; c0 += FC) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < NK; k0 += KC) {
      __syncthreads();
      for (int e = tid; e < KC * FT; e += THREADS) {
        const int k = e % KC, f = e / KC;
        const int s = k0 + k, fr = f0 + f;
        float v = 0.f;
        if (s < n_fft && fr < width) {
          // output frame fr is STFT frame fr + 1 (the crop drops frame 0)
          int j = (fr + 1) * hop + s - pad;
          if (j < 0) j = -j;
          if (j >= L) j = 2 * (L - 1) - j;
          v = __fmul_rn(x[j], win[s]);
        }
        As[k * AS + f] = v;
      }
      for (int e = tid; e < KC * FC; e += THREADS) {
        const int c = e % FC, k = e / FC;
        const size_t g = (size_t)(k0 + k) * NFP + c0 + c;
        Bc[e] = cosb[g];
        Bs[e] = sinb[g];
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(As + k * AS + fy * 4);
        const float4 c = *reinterpret_cast<const float4*>(Bc + k * FC + fx * 4);
        const float4 s = *reinterpret_cast<const float4*>(Bs + k * FC + fx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(av[i], cv[j], re[i][j]);
            im[i][j] = fmaf(av[i], sv[j], im[i][j]);
          }
      }
    }
    // magnitudes of this chunk, and its filterbank rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 m;
      m.x = sqrtf(__fadd_rn(__fmul_rn(re[i][0], re[i][0]), __fmul_rn(im[i][0], im[i][0])));
      m.y = sqrtf(__fadd_rn(__fmul_rn(re[i][1], re[i][1]), __fmul_rn(im[i][1], im[i][1])));
      m.z = sqrtf(__fadd_rn(__fmul_rn(re[i][2], re[i][2]), __fmul_rn(im[i][2], im[i][2])));
      m.w = sqrtf(__fadd_rn(__fmul_rn(re[i][3], re[i][3]), __fmul_rn(im[i][3], im[i][3])));
      *reinterpret_cast<float4*>(Ms + (fy * 4 + i) * MS + fx * 4) = m;
    }
    for (int e = tid; e < FC * MP; e += THREADS) Fs[e] = fb[(size_t)c0 * MP + e];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FC; ++c) {
      const float4 wa = *reinterpret_cast<const float4*>(Fs + c * MP + my * 8);
      const float4 wb = *reinterpret_cast<const float4*>(Fs + c * MP + my * 8 + 4);
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m = Ms[(mf * 4 + i) * MS + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) mel[i][j] = fmaf(m, w8[j], mel[i][j]);
      }
    }
  }

  float* o = out + (size_t)clip * n_mels * width;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = my * 8 + j;
    if (m >= n_mels) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int fr = f0 + mf * 4 + i;
      if (fr < width)
        o[(size_t)m * width + fr] =
            fmaxf(__fmul_rn(logf(__fadd_rn(mel[i][j], 1e-7f)), inv_ln10), -4.f);
    }
  }
}

}  // namespace

extern "C" {

// wav [B,L], win [n_fft], cosb / sinb [NK,NFP], fb [NFP,128], out
// [B,n_mels,width]. NK is n_fft rounded up to 32 and NFP n_fft/2+1 rounded
// up to 64, both zero-padded. Returns cudaErrorInvalidValue, before the
// launch, where the sizes do not fit (n_mels > 128, a reflect pad of L or
// more, fewer than width + 1 frames, B > 65535); else cudaGetLastError().
int logmel(const float* wav, const float* win, const float* cosb, const float* sinb,
           const float* fb, float* out, int B, int L, int n_fft, int hop, int NK,
           int NFP, int n_mels, int width, float inv_ln10, void* stream) {
  const int n_frames = n_fft > 0 && hop > 0 ? 1 + (L + 2 * (n_fft / 2) - n_fft) / hop : 0;
  if (B <= 0 || B > 65535 || n_fft <= 0 || n_fft % 2 != 0 || hop <= 0 || n_fft / 2 >= L ||
      NK % KC != 0 || NK < n_fft || NFP % FC != 0 || NFP < n_fft / 2 + 1 || n_mels <= 0 ||
      n_mels > MP || width <= 0 || width + 1 > n_frames)
    return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (KC * AS + 2 * KC * FC + FT * MS + FC * MP);
  cudaError_t err = cudaFuncSetAttribute(logmel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((width + FT - 1) / FT, B);
  logmel_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      wav, win, cosb, sinb, fb, out, L, n_fft, hop, NK, NFP, n_mels, width, inv_ln10);
  return cudaGetLastError();
}

}  // extern "C"
