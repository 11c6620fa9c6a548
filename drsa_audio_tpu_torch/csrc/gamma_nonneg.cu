// The gamma rule on non-negative input for one 3x3 SAME conv, with the K
// relevance clones of each instance: the shared-denominator LRP walk's hot
// rule (xai/lrp/rules.py shared_gamma_nonneg).
//
// Replaces the TPU kernel drsa_audio_tpu/xai/lrp/pallas_gamma.py
// _gamma_nonneg_kernel (:49, launched :135); the Python wrapper is
// xai/lrp/fused_gamma.py gamma_nonneg_folded.
//
// Math (f32; x, R and the result NCHW, as the walk holds them, the K clones
// folded clone-major into the batch of R):
//   z1 = conv(x, w + g*w+) + b1,  z3 = conv(x, w + g*w-)
//   z_true = (z1 + z3 - b1) * f32(1/(2+g)) + b0      (the TPU kernel's form)
//   m1 = [z_true > 0] / stab(z1 + b2),  m3 = [z_true < 0] / stab(z3)
//   R_in[k] = x * (convT(R[k] * m1, w + g*w+) + convT(R[k] * m3, w + g*w-))
// with b1 = b + g*b+, b2 = b + g*b-, b0 = b. x is used as given (no relu).
// Unlike chain_block.cu, no relu gate multiplies R here, so the m3 term is
// not zero and both transposed terms are formed. The products stay on
// mma.sync (conv3x3_tc.cuh); chain_block.cu's run on wgmma.
//
// Two launches, both 3xTF32 implicit GEMMs on the tensor cores with
// cp.async double buffering (gamma_tc.cuh):
//   prep   once per (instance, tile, column block): the forward pair as one
//          GEMM over 2*Co interleaved columns, summed FRESH (the masks are
//          sign decisions), writes M = (m1, m3) interleaved [b, H, W, 2*Co]
//          (channels last, staged 16 bytes a copy by the apply) once per
//          instance, so the clone-shared work is not repeated per clone.
//   apply  once per (instance, clone, tile, column block): the transposed
//          conv over the 2*Co channels R[o] * M[2o + s] against the stacked
//          flipped taps of the pair, times x. A tile's K clones are
//          neighbours in the grid, so M and x come from L2 for all but the
//          first.
// x and R are staged from NCHW one float a copy (cp.async, 4 bytes), and
// the result is written NCHW, so the wrapper moves no tensor between
// layouts.
//
// Bound on an H100: operations. The forward pair is 2*b*H*W*9*Ci*2*Co flops
// and the transposed conv 2*K*b*H*W*9*Co*Ci (m1 and m3 are disjoint, so
// each relevance entry meets one weight set), against ~4*(b*Ci + K*b*Co +
// K*b*Ci)*H*W bytes; the least time counts every product at 3xTF32 on the
// tensor cores (495 / 3 TFLOP/s). A per-entry choice of weight set is not
// a GEMM, so the apply multiplies over all 2*Co channels, half of them
// zeros: twice the transposed conv's products that the bound counts.
//
// Channel counts: 0 < Ci, Co <= 128, Ci % 4 == 0, and Co a multiple of 8 or
// of 20 (the 6s model's 100 channels). The apply's N pads to a multiple of
// 8 with zero taps (100 -> 104). Other counts, and taps or M that are not
// 16-byte aligned, are refused before any launch with
// cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gamma_tc.cuh"

namespace {

// The counts and sizes both launches take (b is a grid dimension of both).
inline bool takes(int b, int K, int H, int W, int Ci, int Co) {
  return Co > 0 && Co <= 128 && (Co % 8 == 0 || Co % 20 == 0) && Ci > 0 && Ci <= 128 &&
         Ci % 4 == 0 && b > 0 && b <= 65535 && K > 0 && H > 0 && W > 0;
}

}  // namespace

extern "C" {

// x [b,Ci,H,W], wf [ceil(Ci/8),9,8,2Co] (the interleaved forward pair,
// xai/lrp/fused_gamma.py pair_weights), bias [3,Co] (b1, b0, b2), M
// [b,H,W,2Co]. Returns cudaErrorInvalidValue, before the launch, for
// counts, sizes or alignments it does not take; else cudaGetLastError().
int gamma_nonneg_prep(const float* x, const float* wf, const float* bias, float* M, int b,
                      int H, int W, int Ci, int Co, float inv, float stab, void* stream) {
  if (!takes(b, 1, H, W, Ci, Co) || !tc::aligned16(wf) || !tc::aligned16(M))
    return cudaErrorInvalidValue;
  return gtc::prep(b, (cudaStream_t)stream, x, wf, bias, M, H, W, Ci, Co, inv, stab);
}

// R [K*b,Co,H,W] (clone-major), M [b,H,W,2Co] (from the prep), x
// [b,Ci,H,W], wt [Co/4,9,8,Np] (the pair flipped and transposed, rows
// interleaved as M, Np = Ci rounded up to 8: fused_gamma.pair_weights),
// out [K*b,Ci,H,W].
// Refusals as the prep.
int gamma_nonneg_apply(const float* R, const float* M, const float* x, const float* wt,
                       float* out, int b, int K, int H, int W, int Ci, int Co, void* stream) {
  if (!takes(b, K, H, W, Ci, Co) || !tc::aligned16(M) || !tc::aligned16(wt))
    return cudaErrorInvalidValue;
  return gtc::apply(b, (cudaStream_t)stream, R, M, x, wt, out, K, H, W, Ci, Co);
}

}  // extern "C"
