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
// Two launches per conv, both through the tensor-core core of
// conv3x3_tc.cuh (3xTF32 implicit GEMM, cp.async double buffering), as
// gamma_tc.cuh writes them for this kernel and gamma_nonneg.cu:
//   gamma_prep   once per (instance, tile, column block): one GEMM with
//                N = 2*Co over the interleaved forward pair (column 2j the
//                taps of w + g*w+, 2j + 1 those of w + g*w-), so a thread's
//                accumulator pair is (z1, z3) of one channel; the epilogue
//                forms z_true and G in registers and writes G [b, H, W, Co].
//                It reads relu(x): a chain conv's input is a relu output
//                already, and the deep first block (first_block_deep.cu)
//                passes the pre-relu a1; for that block it also zeroes G off
//                the first-argmax route of the (kh, kw) pool above the conv
//                (strict >, row-major: an all-tied window routes to position
//                0), so that the clone-shared route is taken once per
//                instance. merged_tail.cu's preps are this launch too.
//   gamma_apply  once per (instance, clone, tile, column block): the
//                transposed conv of R * G (both staged as they are, formed
//                and split once per slice), times x, written or routed
//                through the pool backward to the finer level. A tile's K
//                clones are neighbours in the grid, so that G, x and apre
//                come from L2 for all but the first.
// The prep adds each k-step's products into its accumulators in f32
// (conv3x3_tc.cuh FRESH): accumulated in the tensor core, the sum drifted
// enough on the card to flip a z_true at 6e-7 of the map's maximum.
//
// Tiles (gamma_tc.cuh) and grids (prep: tiles x column blocks x b; apply: tiles x
// column blocks x K, b) at the main path's shapes:
//   3s b=256   16^2 64->64:  prep 16x8, 2x1x256 = 512;   apply 16x8, (2x1x4)x256 = 2048
//              32^2 32->64:  prep 16x8, 8x1x256 = 2048;  apply 32x8, (4x1x4)x256 = 4096
//              64^2 32->32:  prep 32x8, 16x1x256 = 4096; apply 32x8, (16x1x4)x256 = 16384
//   6s b=64    8^2 128->128: prep 8x8, 1x2x64 = 128;     apply 8x8, (1x1x4)x64 = 256
//              16^2 ->128:   prep 16x8, 2x2x64 = 256;    apply 16x8, (2x1x4)x64 = 512
//              32^2 ->100:   prep 16x8, 8x2x64 = 1024;   apply 16x8, (8x1x4)x64 = 2048 (Ci 100)
//              64^2 64->64:  prep 16x8, 32x1x64 = 2048;  apply 32x8, (16x1x4)x64 = 4096
//   deep prep  128x256 64->64 (first_block_deep.cu): 16x8, 256x1x64 = 16384
// Two blocks fit an SM (at most 113 KB of shared memory and 128 registers
// each), so the 8^2 level (4% of the 6s chain's work) is one wave.
//
// Channel counts: multiples of 8 or of 20 up to 128 (8, 16, 32, 64, 100,
// 128 in the repo's models); others are refused before any launch. The
// reduction runs in slices of 8 (a short last slice is zero-filled) and the
// apply's N pads to a multiple of 8 with zero taps (100 -> 104). Tensors
// must be 16-byte aligned (cp.async).
//
// Bound on an H100: operations. Per instance the two forward convs and the
// K transposed convs are 2*(2+K)*H*W*Ci*Co*9 flops: 203 GFLOP per 3s request
// at b=256, 414 GFLOP per 6s request at b=64, against a few hundred MB of
// relevance and activations. On the tensor cores in 3xTF32 (495 / 3
// TFLOP/s, the least time for f32-accurate products) that is 1.23 and
// 2.51 ms; on the FMA units (67 TFLOP/s) 3.03 and 6.18 ms.
// The design moves every product to the tensor cores and keeps their
// feeding cheap: asynchronous staging, conflict-free ldmatrix loads of an
// A operand split once per slice, 64-pixel warp tiles. mma.sync does not
// reach the dense TF32 rate on Hopper (only wgmma does), so that rate, and
// the instructions that feed it, bound these kernels; wgmma is the next
// step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gamma_tc.cuh"

namespace {

// The channel counts the kernels take.
inline bool takes(int C) { return C > 0 && C <= 128 && (C % 8 == 0 || C % 20 == 0); }

}  // namespace

extern "C" {

// Phase 1. x [b,H,W,Ci] (read as relu(x)), w [ceil(Ci/8),9,8,2Co] (the
// interleaved forward pair, xai/lrp/chain.py GammaConv.w_prep), bias [3,Co],
// G [b,H,W,Co]; apre [b,H,W,Co] or NULL: G is zeroed off the first-argmax
// route of relu(apre) over (kh, kw) windows (H % kh == W % kw == 0).
// Returns cudaErrorInvalidValue, before any launch, for channel counts the
// kernel does not take or unaligned tensors; else cudaGetLastError().
int chain_gamma_prep(const float* x, const float* w, const float* bias,
                     const float* apre, float* G, int b, int H, int W, int Ci,
                     int Co, int kh, int kw, float inv, float stab, void* stream) {
  if (!takes(Ci) || !takes(Co) || !tc::aligned16(x) || !tc::aligned16(w))
    return cudaErrorInvalidValue;
  return gtc::prep<false>(b, (cudaStream_t)stream, x, w, bias, apre, G, H, W, Ci, Co, kh, kw,
                          inv, stab);
}

// Phase 2. R [b,K,H,W,Co], G [b,H,W,Co], x [b,H,W,Ci], wt
// [ceil(Co/8),9,8,Np] (the transposed w + g*w+, Np = Ci rounded up to 8,
// GammaConv.w_apply_tc); apre [b,H*kh,W*kw,Ci] or NULL; out [b,K,H,W,Ci]
// (no pool) or [b,K,H*kh,W*kw,Ci]. Refusals as phase 1.
int chain_gamma_apply(const float* R, const float* G, const float* x,
                      const float* wt, const float* apre, float* out, int b,
                      int K, int H, int W, int Ci, int Co, int kh, int kw,
                      void* stream) {
  if (!takes(Ci) || !takes(Co) || !tc::aligned16(R) || !tc::aligned16(G) ||
      !tc::aligned16(wt) || !tc::aligned16(x) || !tc::aligned16(out))
    return cudaErrorInvalidValue;
  return gtc::apply<false>(b, (cudaStream_t)stream, R, G, x, wt, apre, out, K, H, W, Ci, Co, kh,
                           kw);
}

}  // extern "C"
