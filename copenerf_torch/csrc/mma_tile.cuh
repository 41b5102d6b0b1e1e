// The 3xTF32 tensor-core GEMM of the render-core kernels (K1 and K6): the
// 64-row tile product of mlp_tile.cuh `gemm` on `mma.sync` m16n8k8 TF32,
// and the helpers the wgmma core (wgmma_tile.cuh) and the weight-gradient
// reduction (wgrad.cu `wgrad_wg_partial_kernel`) share with it.
//
// 3xTF32: each f32 operand x splits into hi = tf32(x) (cvt.rna: 10 explicit
// mantissa bits, nearest, ties away) and lo = tf32(x - hi); a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (lo lo dropped), ~21-22 bits of each
// product, at a third of the card's TF32 rate (495 / 3 TFLOP/s, 2.5x the
// f32 FFMA rate). Hopper's tensor cores add each m16n8k8 result into the
// f32 accumulator with their own rounding, so the three products of one
// k8 step go into a zeroed fragment, small terms first, and that fragment
// is added to the f32 sum with FADD (kTf32x3; kTf32x3Acc adds all three
// into the sum on the tensor core, kTf32x1 is one TF32 product): the
// accuracy trial in PERF.md chose the variant (tc_check.cu).
//
// `TcGemm::run` keeps the contract of `gemm<KS>` (mlp_tile.cuh): rows of f32
// activations in shared memory times a weight matrix W (K x N, row-major,
// streamed from L2 through two KS x 256 cp.async slices), the epilogue
// called as epi(r, c, value) after the last barrier, so `out` may be `in`.
// The split happens in registers as each fragment is loaded: pre-split
// weights would double the ~5 MB a tile streams from L2.
// Layout:
//  * Warp w owns output columns [32 w, 32 w + 32) of all 64 rows: 4 m16 x 4
//    n8 tiles, 64 accumulators a thread. Each weight element is loaded and
//    split by one warp; each activation by all eight (A is 64 x 8 per k8,
//    B 8 x 256). Warps whose columns start at or past N skip the products.
//  * The k order inside a k16 step is permuted (any permutation shared by A
//    and B gives the same sum): lane (g, t) takes A columns 4t .. 4t + 3 of
//    its rows g and g + 8 as one float4 (two k8 products: columns 4t, 4t + 1
//    as its k = t, t + 4 of the first, 4t + 2, 4t + 3 of the second), and
//    B rows 4t .. 4t + 3 of its column g, split per k8 product.
//  * Issue order: the three products of a tile depend on each other, and an
//    `mma.sync` waits for its accumulator, so each term goes to the four n8
//    tiles in turn (`mma_f32x3`), and `mma_tf32` is not volatile (the
//    compiler may interleave further). Issued tile by tile, the core ran at 24
//    TFLOP/s of f32 products on the card, below the FFMA GEMM's 30.
//  * Banks: the activation row stride is kTcLd = 272 floats (16 mod 32), so
//    the two rows of one 8-lane phase of a float4 load fall in the two
//    halves of the banks (256 put all 8 rows of a fragment on one bank
//    group: 2x the wavefronts). The weight slice keeps rows of 256 and
//    XORs bits 3-4 of the column with bits 2-3 of the row (`tc_swz`), so
//    the four t-lanes of a B fragment load hit four 8-bank groups.
//  * Tails: A columns at or past K read as 0 (a float4 is in or out: K is
//    a multiple of 4), and the slice zero-fills rows past K and columns past
//    N, so nothing past a buffer is read and no stale value meets a zero.
#pragma once

#include "mlp_tile.cuh"

namespace copenerf {

constexpr int kTcLd = 272;  // activation row stride of the tensor-core kernels

enum TcVariant { kTf32x1 = 1, kTf32x3 = 2, kTf32x3Acc = 3 };
// What the tensor-core kernels ship (K1, K6 on `mma.sync`; the wgmma core).
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

// d = a b + d on one m16n8k8 tile (row-major A 16 x 8, column-major B 8 x 8;
// lane (g, t) = (lane / 4, lane % 4) holds A (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), B (t, g), (t + 4, g), D (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += a b[n] for one m16 tile, four n8 tiles and one k8 step of f32
// operands given as (hi, lo) pairs. A tile's three products depend on each
// other, so each term is issued for the four tiles in turn.
template <TcVariant V>
__device__ __forceinline__ void mma_f32x3(float (&acc)[4][4], const unsigned (&ah)[4],
                                          const unsigned (&al)[4], const unsigned (&bh)[4][2],
                                          const unsigned (&bl)[4][2]) {
  if constexpr (V == kTf32x1) {
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(acc[n], ah, bh[n]);
  } else if constexpr (V == kTf32x3Acc) {
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(acc[n], ah, bh[n]);
  } else {
    float d[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[n][i] = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], al, bh[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], ah, bl[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], ah, bh[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += d[n][i];
  }
}

// 16-byte global -> shared copy of `bytes` (0..16) bytes, the rest zeroed.
__device__ __forceinline__ void cp_async_zfill(float* smem, const float* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

// Swizzled column of weight-slice row kk.
__device__ __forceinline__ int tc_swz(int kk, int c) { return c ^ (((kk >> 2) & 3) << 3); }

// Start the copy of W rows [k0, k0 + KS) x the columns the warps read
// (N rounded up to 32) into a swizzled KS x kSliceCols slice, rows >= K and
// columns >= N zero-filled; one cp.async group.
template <int KS>
__device__ __forceinline__ void tc_load_slice(const float* __restrict__ W, int ldw, int N,
                                              int K, int k0, float* dst) {
  const int chunks = ((N + 31) & ~31) >> 2;  // float4 chunks per slice row
  for (int idx = threadIdx.x; idx < KS * chunks; idx += kThreads) {
    const int kk = idx / chunks;
    const int c = (idx - kk * chunks) * 4;
    const bool ok = (k0 + kk < K) && (c < N);
    cp_async16(dst + kk * kSliceCols + tc_swz(kk, c),
               ok ? W + (long long)(k0 + kk) * ldw + c : W, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out[r][c] = epi(r, c, sum_k in[r][k] * W[k * ldw + c]) for r < 64, c < N
// <= 256: `gemm`'s contract (mlp_tile.cuh) on the tensor cores.
template <int KS, TcVariant V, class Epi>
__device__ __forceinline__ void tc_gemm(const float* in, int ld_in, int K,
                                        const float* __restrict__ W, int ldw, int N,
                                        float* __restrict__ w_s, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
  const bool active = n0 < N;
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

  const int n_slices = (K + KS - 1) / KS;
  tc_load_slice<KS>(W, ldw, N, K, 0, w_s);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      tc_load_slice<KS>(W, ldw, N, K, (s + 1) * KS, w_s + ((s + 1) & 1) * KS * kSliceCols);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s (and writes made to `in`) visible to all
    if (active) {
      const float* ws = w_s + (s & 1) * KS * kSliceCols;
      const int k0 = s * KS;
      const int kn = min(KS, K - k0);
      for (int kk = 0; kk < kn; kk += 16) {
        const bool kok = kk + 4 * t < kn;
        const float* arow = in + g * ld_in + k0 + kk + 4 * t;
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // slice rows kk + 4t + 2q, + 1 as k = t, t + 4
          unsigned bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kr = kk + 4 * t + 2 * q + j;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              split_tf32(ws[kr * kSliceCols + tc_swz(kr, n0 + 8 * nt + g)], bh[nt][j],
                         bl[nt][j]);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;  // rows 16 mt + g, + 8
            if (kok) {
              u = *reinterpret_cast<const float4*>(arow + 16 * mt * ld_in);
              v = *reinterpret_cast<const float4*>(arow + (16 * mt + 8) * ld_in);
            }
            unsigned ah[4], al[4];
            split_tf32(q ? u.z : u.x, ah[0], al[0]);
            split_tf32(q ? v.z : v.x, ah[1], al[1]);
            split_tf32(q ? u.w : u.y, ah[2], al[2]);
            split_tf32(q ? v.w : v.y, ah[3], al[3]);
            mma_f32x3<V>(acc[mt], ah, al, bh, bl);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refilling
  }
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n0 + 8 * nt + 2 * t + (i & 1);
        if (c < N) epi(16 * mt + g + (i >= 2 ? 8 : 0), c, acc[mt][nt][i]);
      }
}

// The GEMM policy of the sweeps (mlp_tile.cuh) for K1 and K6.
// It reads the weights where FfmaGemm does (`w`, `wt`).
struct TcGemm : FfmaGemm {
  static constexpr int kLd = kTcLd;
  template <int KS, class Epi>
  __device__ static __forceinline__ void run(const float* in, int ld_in, int K,
                                             const float* __restrict__ W, int ldw, int N,
                                             float* __restrict__ w_s, Epi epi) {
    tc_gemm<KS, kTcVariant>(in, ld_in, K, W, ldw, N, w_s, epi);
  }
};

}  // namespace copenerf
