// Fused log-mel front-end: reflect-padded, Hann-windowed frames of the
// waveform -> one-sided |DFT| -> HTK mel bands -> ln(x + 1e-7) * f32(1/ln 10),
// clamped at -4, for the frames that the [1 : width + 1] crop keeps.
//
// Replaces the TPU kernel drsa_audio_tpu/ops/pallas_frontend.py
// _logmel_kernel (:34, launched :83); the Python wrapper is
// ops/fused_frontend.py fused_logmel.
//
// Bound on an H100: bytes (the waveform read once, the log-mels written
// once); an FFT per kept frame and the filterbank's nonzeros are far less
// work than the card's f32 rate covers in that time.
//
// One thread block per (tile of FT = 16 output frames, clip), all in f32 on
// the FMA units:
//   stage   the tile's span of the waveform, (FT - 1) * hop + n_fft samples,
//           into shared memory once, reflect padding at the clip's edges
//           (frames overlap: no frames tensor, nothing re-read); the window
//           is applied as a frame's samples are read.
//   FFT     each frame x of N = n_fft samples as the complex sequence
//           z[m] = x[2m] + i x[2m+1] of length N/2 = n1 * n2, transformed in
//           four steps (ops/fused_frontend.py fft_tables): one thread per
//           (frame, m1) takes a dense DFT of length n2 over m2 and the
//           twiddle, one thread per (frame, k2) a dense DFT of length n1 over
//           m1, each from host tables built in float64 (N/2 * (n1 + n2)
//           complex products a frame, 4 FMA each: 64,000 FMA at n_fft 800 =
//           2 * 400 * 20 * 4, against the dense real DFT's 641,600). The
//           small DFTs' accumulators stay in registers; every thread of a
//           warp reads the same table entry at the same time.
//   post    the real-FFT post-twiddle gives X[k], k <= N/2, and |X[k]|.
//   mel     each mel sums only its band of bins (first bin, count, weights:
//           fused_frontend.mel_bands; 791 products a frame at n_fft 800
//           against the dense filterbank's 51,328), ascending bins, then the
//           log epilogue, written as [clip, n_mels, width].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 16;      // output frames per block
constexpr int MAXF = 32;    // longest small DFT (register accumulators)
constexpr int MP = 128;     // most mels

// Shared memory, in floats: Y [FT][n2][n1 + 1] complex (then Z [FT][N/2]),
// the tables t2, t1, tw, post (complex) and the window, the span (then the
// magnitudes [FT][N/2 + 1]), the band weights, the bands (ints).
struct Smem {
  int y, tables, span, weights, bands, total;
  __host__ __device__ Smem(int n_fft, int hop, int n1, int n2, int n_mels, int nnz) {
    const int half = n_fft / 2;
    y = 2 * FT * n2 * (n1 + 1);
    tables = 2 * (n2 * n2 + n1 * n1 + n1 * n2 + half + 1) + n_fft;
    const int sl = (FT - 1) * hop + n_fft, mags = FT * (half + 1);
    span = sl > mags ? sl : mags;
    weights = nnz;
    bands = 3 * n_mels;
    total = y + tables + span + weights + bands;
  }
};

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 w) {
  acc.x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc.x));
  acc.y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc.y));
}

__global__ void __launch_bounds__(512)
logmel_kernel(const float* __restrict__ wav,      // [B, L]
              const float* __restrict__ tables,   // [t2 | t1 | tw | post | win]
              const int* __restrict__ bands,      // [n_mels][3]: first, count, offset
              const float* __restrict__ weights,  // [nnz]
              float* __restrict__ out,            // [B, n_mels, width]
              int L, int n_fft, int hop, int n1, int n2, int n_mels, int nnz, int width,
              float inv_ln10) {
  extern __shared__ float4 smem4[];
  const Smem lay(n_fft, hop, n1, n2, n_mels, nnz);
  const int half = n_fft / 2, YS = n1 + 1, tid = threadIdx.x;
  float* base = reinterpret_cast<float*>(smem4);
  float2* Y = reinterpret_cast<float2*>(base);               // then Z [FT][half]
  float2* T2 = reinterpret_cast<float2*>(base + lay.y);      // [n2][n2]
  float2* T1 = T2 + n2 * n2;                                 // [n1][n1]
  float2* TW = T1 + n1 * n1;                                 // [n1][n2]
  float2* PO = TW + n1 * n2;                                 // [half + 1]
  const float* win = reinterpret_cast<const float*>(PO + half + 1);
  float* sp = base + lay.y + lay.tables;                     // span, then |X|
  float* wts = sp + lay.span;
  int* bd = reinterpret_cast<int*>(wts + lay.weights);
  const int clip = blockIdx.y, f0 = blockIdx.x * FT;
  const int nv = min(FT, width - f0);                        // frames kept
  const float* x = wav + (size_t)clip * L;

  for (int e = tid; e < lay.tables; e += blockDim.x) base[lay.y + e] = tables[e];
  for (int e = tid; e < nnz; e += blockDim.x) wts[e] = weights[e];
  for (int e = tid; e < 3 * n_mels; e += blockDim.x) bd[e] = bands[e];
  // output frame fr is STFT frame fr + 1 (the crop drops frame 0)
  const int j0 = (f0 + 1) * hop - half, used = (nv - 1) * hop + n_fft;
  for (int t = tid; t < lay.span; t += blockDim.x) {
    float v = 0.f;
    if (t < used) {
      int j = j0 + t;
      if (j < 0) j = -j;
      if (j >= L) j = 2 * (L - 1) - j;
      v = x[j];
    }
    sp[t] = v;
  }
  __syncthreads();

  float2 acc[MAXF];
  // step 1: Y[m1, k2] = tw[m1, k2] * sum_m2 z[m1 + n1 m2] * t2[m2, k2]
  if (tid < FT * n1) {
    const int f = tid / n1, m1 = tid % n1;
#pragma unroll
    for (int k = 0; k < MAXF; ++k) acc[k] = make_float2(0.f, 0.f);
    const float* s = sp + f * hop;
    for (int m2 = 0; m2 < n2; ++m2) {
      const int m = 2 * (m1 + n1 * m2);
      const float2 z = make_float2(__fmul_rn(s[m], win[m]), __fmul_rn(s[m + 1], win[m + 1]));
      const float2* t = T2 + m2 * n2;
#pragma unroll
      for (int k = 0; k < MAXF; ++k)
        if (k < n2) cfma(acc[k], z, t[k]);
    }
    float2* y = Y + f * n2 * YS + m1;
#pragma unroll
    for (int k = 0; k < MAXF; ++k) {
      if (k < n2) {
        float2 v = make_float2(0.f, 0.f);
        cfma(v, acc[k], TW[m1 * n2 + k]);
        y[k * YS] = v;
      }
    }
  }
  __syncthreads();
  // step 2: Z[k2 + n2 k1] = sum_m1 Y[m1, k2] * t1[m1, k1]
  const bool act = tid < FT * n2;
  if (act) {
    const float2* y = Y + tid * YS;                          // (f, k2) = tid / n2, tid % n2
#pragma unroll
    for (int k = 0; k < MAXF; ++k) acc[k] = make_float2(0.f, 0.f);
    for (int m1 = 0; m1 < n1; ++m1) {
      const float2 v = y[m1];
      const float2* t = T1 + m1 * n1;
#pragma unroll
      for (int k = 0; k < MAXF; ++k)
        if (k < n1) cfma(acc[k], v, t[k]);
    }
  }
  __syncthreads();                                           // Z overwrites Y
  if (act) {
    float2* z = Y + (tid / n2) * half + tid % n2;
#pragma unroll
    for (int k = 0; k < MAXF; ++k)
      if (k < n1) z[n2 * k] = acc[k];
  }
  __syncthreads();
  // post-twiddle: X[k] = (Z[k] + conj Z[h-k]) / 2 + post[k] (Z[k] - conj Z[h-k]) / 2i
  for (int e = tid; e < FT * (half + 1); e += blockDim.x) {
    const int f = e / (half + 1), k = e % (half + 1);
    const float2 a = Y[f * half + (k == half ? 0 : k)];
    const float2 b = Y[f * half + (k == 0 ? 0 : half - k)];
    const float2 ev = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 od = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    float2 X = ev;
    cfma(X, od, PO[k]);
    sp[e] = sqrtf(__fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y)));
  }
  __syncthreads();
  // mel bands, ascending bins, and the log epilogue
  float* o = out + (size_t)clip * n_mels * width + f0;
  for (int e = tid; e < nv * n_mels; e += blockDim.x) {
    const int mel = e / nv, f = e % nv;
    const int first = bd[3 * mel], count = bd[3 * mel + 1], off = bd[3 * mel + 2];
    const float* mg = sp + f * (half + 1) + first;
    float s = 0.f;
    for (int j = 0; j < count; ++j) s = fmaf(mg[j], wts[off + j], s);
    o[(size_t)mel * width + f] = fmaxf(__fmul_rn(logf(__fadd_rn(s, 1e-7f)), inv_ln10), -4.f);
  }
}

}  // namespace

extern "C" {

// wav [B,L], tables [t2 | t1 | tw | post | win] (fused_frontend.fft_tables,
// n_fft / 2 = n1 * n2), bands [n_mels,3] and weights [nnz]
// (fused_frontend.mel_bands), out [B,n_mels,width]. Returns
// cudaErrorInvalidValue, before the launch, where the sizes do not fit (an
// odd n_fft, n1 * n2 != n_fft / 2 or either above 32, n_mels > 128, a
// reflect pad of L or more, fewer than width + 1 frames, B > 65535, shared
// memory past 227 KB); else cudaGetLastError().
int logmel(const float* wav, const float* tables, const int* bands, const float* weights,
           float* out, int B, int L, int n_fft, int hop, int n1, int n2, int n_mels, int nnz,
           int width, float inv_ln10, void* stream) {
  const int n_frames = n_fft > 0 && hop > 0 ? 1 + (L + 2 * (n_fft / 2) - n_fft) / hop : 0;
  if (B <= 0 || B > 65535 || n_fft <= 0 || n_fft % 2 != 0 || hop <= 0 || n_fft / 2 >= L ||
      n1 < 1 || n2 < 1 || n1 > MAXF || n2 > MAXF || n1 * n2 != n_fft / 2 || n_mels <= 0 ||
      n_mels > MP || nnz < 0 || width <= 0 || width + 1 > n_frames)
    return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)Smem(n_fft, hop, n1, n2, n_mels, nnz).total;
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(logmel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int threads = (FT * (n1 > n2 ? n1 : n2) + 31) / 32 * 32;
  const dim3 grid((width + FT - 1) / FT, B);
  logmel_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      wav, tables, bands, weights, out, L, n_fft, hop, n1, n2, n_mels, nnz, width, inv_ln10);
  return cudaGetLastError();
}

}  // extern "C"
