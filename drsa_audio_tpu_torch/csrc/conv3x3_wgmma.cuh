// The wgmma core of the chain's kernels (chain_block.cu, first_block_deep.cu,
// merged_tail.cu) and of gamma_nonneg.cu: a 3x3 SAME conv, or its
// transpose, as an implicit GEMM in 3xTF32 on Hopper's asynchronous
// warpgroup product (wgmma.mma_async m64nNk8.f32.tf32.tf32), fed by the
// staging and A-operand pieces of conv3x3_tc.cuh.
//
// Product. out[m, n] = sum_{tap, c} A[m + off(tap), c] * w[tap][c][n] as in
// conv3x3_tc.cuh; a warpgroup (4 warps, 128 threads) multiplies one m64
// tile of pixels by the block's N columns per instruction, k = 8 channels,
// one or two tiles (MT) a warpgroup.
//
// A from registers (the RS form). A warp's share of a TF32 wgmma A fragment
// is 16 rows of the m64 tile in the m16n8k8 A layout, so each tap's A is two
// ldmatrix loads (hi, lo) of the split region at the tap's constant offset
// (tc::lane_row, tc::ldsm_a): no copy of the region is staged per tap.
//
// B from shared memory, pre-split on the host (xai/lrp/taps.py
// wgmma_taps): hi = tf32(w), lo = tf32(w - hi), laid out K-major as one
// contiguous block per 8-channel slice, [part (hi, lo)][tap][kc][BN][4]
// (kc the slice's two 4-channel halves). A (part, tap) tile is the
// no-swizzle canonical K-major layout: core matrices of 8 columns x 16
// bytes (128 contiguous bytes), 128 bytes apart along N (the stride byte
// offset) and BN * 16 bytes apart along k (the leading byte offset). The
// kernels convert no weight.
//
// Staging. Per slice, one thread issues the taps as one 1-D bulk copy
// (cp.async.bulk, completing on the stage's mbarrier: no tensor map to
// encode on the host), while every thread stages the activation regions with
// cp.async and zero fill (tc::stage_region); two stages, slice s + 1 in
// flight while slice s multiplies (tc::pipeline).
//
// Per tap, a tile's three products (lo*hi, hi*lo, hi*hi, small cross terms
// first) go into one wgmma group; up to DEPTH groups are in flight while
// the next tap's A loads (slice below). FRESH (the prep, whose epilogue
// decides signs): a group writes a scratch fragment (scale-d = 0 on its
// first product), then added to the accumulator in f32 with round-to-
// nearest: the tensor core adds a product to its accumulator with
// truncation, so sums accumulated in it drift by up to ~2^-23 of the running
// sum per product, one way, and on the card that flipped the sign of a
// z_true at 6e-7 of the map's maximum. The transposed convs, linear in R,
// decide nothing and accumulate in the core. A branch between a group's
// fence and commit makes ptxas serialise every group of the kernel (its
// C7520 warning), so warpgroups skip whole slices, never single products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv3x3_tc.cuh"

namespace wg {

using tc::CC;
using tc::SP;

// Floats of one slice of pre-split taps for BN columns.
template <int BN>
__host__ __device__ constexpr int taps_floats() { return 2 * 9 * CC * BN; }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Matrix descriptor of a no-swizzle K-major tile at shared address a: the
// leading byte offset lbo between the two 4-channel core matrices along k,
// 128 bytes between core matrices along N.
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a fragment across the
// asynchronous product's fence and wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// asynchronous-proxy accesses (bulk copies, wgmma) of the same bytes, once
// a barrier has passed: for shared memory that a kernel reuses from one
// pipeline's regions for another's taps.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// This lane's ldmatrix rows for its warp's 16 rows of each of warpgroup
// wgi's MT m64 tiles over a tile TW pixels wide, staged with its halo at
// row stride RW (tile wgi * MT + i holds tile rows 64 (wgi * MT + i) / TW
// ..; tile pixel m at (m / TW, m % TW), region offset (m / TW) * RW + m %
// TW). Returns how many of the tiles hold image rows of a tile whose first
// row is h0 of H; a warpgroup with none skips its products.
template <int MT, int TW, int RW>
__device__ __forceinline__ int tile_rows(int (&lrow)[MT], int wgi, int h0, int H) {
  const int wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    lrow[i] = tc::lane_row([&](int r) {
      const int m = (wgi * MT + i) * 64 + wq * 16 + r;
      return (m / TW) * RW + m % TW;
    });
  constexpr int R64 = 64 / TW;                    // tile rows an m64 tile
  return min(MT, max(0, (H - h0 - R64 * MT * wgi + R64 - 1) / R64));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: bytes (a multiple of 16, both addresses 16-byte aligned) from
// src to dst as one bulk copy, completing on bar's current phase.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// ------------------------------------------------------------ the product

// d (+)= a * B for one m64 tile, N columns: N / 2 accumulators a thread, row
// g + 8 * (e / 2 % 2) of the warp's 16 and column 8 * (e / 4) + 2 * t4 + e % 2
// for register e (the m16n8 C layout per 8 columns). scale_d = 0 ignores d.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void fma(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void fma(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void fma(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void fma(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Mma<104> {
  static __device__ __forceinline__ void fma(float (&d)[52], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51"
        "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void fma(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
        : "memory");
  }
};

// One staged slice for one warpgroup's MT m64 tiles, 9 taps x 3 products:
//   acc[i][.] += sum_{tap, c} A(pixel + off(tap), c) * w[tap][c][.],
// off(tap) = (tap / 3) * RW + tap % 3 in the region of row stride RW. hi and
// lo are the split region's shared addresses, lrow[i] this lane's ldsm_a
// row (tc::lane_row) for its warp's 16 rows of tile i, b the shared address
// of the slice's pre-split taps [2][9][2][BN][4]. Every tile is multiplied
// (a tile below the image reads the zero-filled region): a branch between
// a group's fence and commit serialises the products.
//
// Each tap's products (three a tile) are one wgmma group, and up to DEPTH
// groups are in flight: after issuing tap t's group the warpgroup waits
// only for group t - DEPTH + 1 (wait_group DEPTH - 1), then loads tap t +
// 1's A fragments into the register buffer that group read, so the loads
// and the waits overlap the products. FRESH: each group writes its own
// scratch fragments (scale-d = 0 on a tile's first product), added to acc
// in f32 with round-to-nearest once the group has completed. Ends with no
// product in flight, so that the stage may be refilled after the block's
// next barrier.
template <int BN, bool FRESH, int DEPTH, int MT>
__device__ __forceinline__ void slice(float (&acc)[MT][BN / 2], uint32_t hi, uint32_t lo,
                                      const int (&lrow)[MT], int RW, uint32_t b) {
  constexpr uint32_t TAP = CC * BN * 4, LBO = 4 * BN * 4;   // bytes
  constexpr int DD = FRESH ? DEPTH : 1;
  uint32_t ah[DEPTH][MT][4], al[DEPTH][MT][4];
  float d[DD][MT][BN / 2] = {};
  auto load = [&](int tap) {
    const int off = ((tap / 3) * RW + tap % 3) * SP;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      tc::ldsm_a(ah[tap % DEPTH][i], hi + 4 * (lrow[i] + off));
      tc::ldsm_a(al[tap % DEPTH][i], lo + 4 * (lrow[i] + off));
    }
  };
  auto drain = [&](int j) {        // group j has completed: its scratch into acc
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      fence_operands(d[j % DD][i]);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = __fadd_rn(acc[i][e], d[j % DD][i][e]);
    }
  };
  load(0);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int buf = tap % DEPTH;
    const uint64_t bh = desc(b + tap * TAP, LBO), bl = desc(b + (9 + tap) * TAP, LBO);
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_operands(FRESH ? d[tap % DD][i] : acc[i]);
    fence();
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float(&dst)[BN / 2] = FRESH ? d[tap % DD][i] : acc[i];
      Mma<BN>::fma(dst, al[buf][i], bh, FRESH ? 0 : 1);
      Mma<BN>::fma(dst, ah[buf][i], bl, 1);
      Mma<BN>::fma(dst, ah[buf][i], bh, 1);
    }
    commit();
    wait<DEPTH - 1>();
    if (FRESH && tap >= DEPTH - 1) drain(tap - DEPTH + 1);
    if (tap + 1 < 9) load(tap + 1);
  }
  wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_operands(acc[i]);
  if (FRESH) {
#pragma unroll
    for (int j = 10 - DEPTH; j < 9; ++j) drain(j);
  }
}

// ------------------------------------------------------------- dispatch

template <int N>
using ic = std::integral_constant<int, N>;

// f(BN, MT) for a prep's column chunk of BN columns (the width the host
// laid the forward pair out in, xai/lrp/taps.py prep_chunk) at a level of
// H rows: two m64 tiles a warpgroup (a 32 x 8 pixel tile) where the level
// is 32 rows or more, else one; no for a width without an instance.
template <class F, class R>
R prep_tile(int BN, int H, F f, R no) {
  const bool tall = H >= 32;
  switch (BN) {
    case 16: return tall ? f(ic<16>{}, ic<2>{}) : f(ic<16>{}, ic<1>{});
    case 32: return tall ? f(ic<32>{}, ic<2>{}) : f(ic<32>{}, ic<1>{});
    default: return no;
  }
}

// f(BN, MT) for an apply's one tile of BN columns (taps.py wg_cols) at a
// level of H rows: two m64 tiles a warpgroup up to 32 columns on a level of
// 32 rows or more, else one; no for a width without an instance.
template <class F, class R>
R apply_tile(int BN, int H, F f, R no) {
  const bool tall = H >= 32;
  switch (BN) {
    case 8: return tall ? f(ic<8>{}, ic<2>{}) : f(ic<8>{}, ic<1>{});
    case 16: return tall ? f(ic<16>{}, ic<2>{}) : f(ic<16>{}, ic<1>{});
    case 32: return tall ? f(ic<32>{}, ic<2>{}) : f(ic<32>{}, ic<1>{});
    case 64: return f(ic<64>{}, ic<1>{});
    case 104: return f(ic<104>{}, ic<1>{});
    case 128: return f(ic<128>{}, ic<1>{});
    default: return no;
  }
}

}  // namespace wg
