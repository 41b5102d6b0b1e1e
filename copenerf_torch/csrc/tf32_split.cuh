// The 3xTF32 split the tensor-core kernels share: the wgmma core
// (wgmma_tile.cuh: K1-K7's row kernels) and the weight-gradient reduction
// (wgrad.cu `wgrad_wg_partial_kernel`), and the zero-filling cp.async of
// the reduction's staged rows.
//
// 3xTF32: each f32 operand x splits into hi = tf32(x) (cvt.rna: 10 explicit
// mantissa bits, nearest, ties away) and lo = tf32(x - hi); a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (lo lo dropped), ~21-22 bits of each
// product, at a third of the card's TF32 rate (495 / 3 TFLOP/s, 2.5x the
// f32 FFMA rate). Hopper's tensor cores add each product into the f32
// accumulator with their own rounding, so the cores sum a few k8 steps'
// products into a zeroed partial and add that to the f32 sum with FADD
// (kTf32x3; kTf32x1, one TF32 product, is the accuracy trial's control:
// tc_check.cu, PERF.md).
#pragma once

#include "mlp_tile.cuh"

namespace copenerf {

constexpr int kTcLd = 272;  // activation row stride of the tensor-core kernels

enum TcVariant { kTf32x1 = 1, kTf32x3 = 2 };
// What the tensor-core kernels ship.
constexpr TcVariant kTcVariant = kTf32x3;

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// 16-byte global -> shared copy of `bytes` (0..16) bytes, the rest zeroed.
__device__ __forceinline__ void cp_async_zfill(float* smem, const float* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

}  // namespace copenerf
