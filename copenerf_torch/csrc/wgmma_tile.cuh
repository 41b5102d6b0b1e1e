// The wgmma 3xTF32 GEMM core of every row kernel: K1-fwd and K6-fwd
// (rendercore_fwd.cuh), K1-bwd and K6-bwd (rendercore_bwd.cuh), K2
// (sdf_value.cu, also K3-fwd), K3-bwd (sdf_value_bwd.cu), K4-fwd
// (sdf_outgrad_fwd.cu, also K7-fwd), K4-bwd (sdf_outgrad_bwd.cu), K5-fwd
// (color_fwd.cu) and K5-bwd (color_bwd.cu): the sweeps' 64-row tile product
// (mlp_tile.cuh, the GEMM policy contract) on Hopper's asynchronous
// warpgroup matrix multiply, with the weight slices brought in by bulk
// copies that complete on mbarriers.
//
// Bound: these kernels do ~0.9 MFLOP a row against 20-36 bytes, so the
// operations bound them; 3xTF32 on the tensor cores (495 / 3 TFLOP/s of f32
// products) is 2.5x the f32 FFMA rate. A core on the synchronous warp-level
// m16n8k8 product reached only 34 TFLOP/s of f32 products (PERF.md): one
// 8-warp block an SM left each scheduler two warps to hide every
// synchronous product, shared load and split.
// `wgmma` is asynchronous: a warpgroup issues a slice's products and waits
// once, and the weight operand never passes through registers.
// Design:
//  * Warpgroup w (threads 128 w ..) owns output columns [128 w, 128 w + 128)
//    of all 64 rows: one m64n128k8 accumulator, 64 floats a thread. Thread
//    (warp q of the group, lane (g, t)) holds columns 8 j + 2 t, + 1 of rows
//    16 q + g and 16 q + g + 8 (j < 16). A warpgroup whose columns start at
//    or past N only joins the barriers.
//  * B (the weights, K-major as tf32 requires) is packed by the host
//    (ops/kernels/pack.py `wg_pack_b`): per 32-deep slice the hi and lo
//    TF32 parts (hi = tf32(w), lo = tf32(w - hi)) of N rows (N rounded up
//    to 128, zero past N and past K) of 128 bytes, in the canonical 128-byte
//    swizzle (16-byte chunk c of row n stored at c ^ (n % 8)), so a slice
//    is one contiguous 1-D bulk copy and its reads are free of bank
//    conflicts. That doubles the bytes a tile streams from L2 (3.7 MB a K2
//    tile; the L2's feed, ~4.5 TB/s, holds the core at ~70 TFLOP/s of f32
//    products), but splitting the f32 slice in shared memory instead (half
//    the bytes, a split pass and a second block barrier a slice) measured
//    33-37% slower (PERF.md §6).
//  * A (the activations) stays row-major f32 in shared memory (rows of
//    kTcLd = 272 floats, so every h[r * ld + c] of the sweeps holds). Each
//    thread loads its slice of A as float4s (columns 4t .. 4t + 3 of each
//    16-column block: two k8 products, columns 4t, 4t + 1 as k = t, t + 4
//    of the first and 4t + 2, 4t + 3 of the second (any order shared by A
//    and B gives the same sum), the packed B permuted to match), splits
//    them in registers, and keeps the slice's fragments (32 registers) live
//    until the products that read them are done, so ptxas need not
//    serialize the pipeline.
//  * Ring: kStages stages of one slice (hi + lo, 64 KB at N = 256), each
//    with a full mbarrier. Thread 0 arms a barrier with the slice's bytes
//    and issues its bulk copy; all threads wait on the barrier's phase
//    (slice s: stage s % kStages, parity (s / kStages) & 1). After a
//    slice's products are done a block barrier frees the stage, and thread
//    0 refills it with the slice kStages ahead. The barriers are
//    initialized at each call and invalidated at its end. Two stages (128
//    KB, as the FFMA GEMM's two 64 x 256 slices) overlap a slice's copy
//    with the previous slice's products: K1-fwd, K2, K3, K4-fwd, K5-fwd,
//    K6-fwd and K7. One stage (64 KB) exposes each copy's latency but
//    leaves room for the two row buffers of K1-bwd, K6-bwd, K4-bwd and
//    K5-bwd (two stages would need 297,024, 287,040 and 280,640 bytes of
//    the 232,448 a block may have).
//  * Accuracy: Hopper's tensor cores add into the accumulator with their
//    own rounding; summed over K = 256 on them, 3xTF32 was 6-13x the FFMA
//    error (PERF.md). Each group of kWgRowGroup k8 steps (small terms
//    first: lo hi, hi lo, hi hi) goes into a partial accumulator that the
//    first product overwrites (scale-d 0), and the partial is added to the
//    f32 sum with FADD: 128 accumulator registers in all. The group was
//    chosen by accuracy trials whose readings PERF.md keeps.
//  * Tails: A float4s at or past K read as 0 (K is a multiple of 4); the
//    packed B is zero past K and past N, so nothing past a buffer is read
//    and no stale value meets a zero.
#pragma once

#include "tf32_split.cuh"

namespace copenerf {

constexpr int kWgSliceK = 32;                            // K depth of a ring stage
constexpr int kWgStageFloats = 2 * kSliceCols * kWgSliceK;  // hi + lo at N = 256
// k8 steps summed on the tensor core before each FADD into the f32 sum.
// The accuracy trial (PERF.md §6) put 4 at 1.87-1.95x the FFMA GEMM's
// error against f64 at K = 52 and 2 at 1.04-1.08x, for 2.7% of the GEMM's
// time; the weight reduction (wgrad.cu) keeps 2. The row kernels take 1:
// with 2, K1-bwd at the whole-pipeline head-to-head's small nets (SDF
// 52->64x4->33) missed the checks' bound (2x the plain f32 version's error
// against f64) on the weight-norm gain of the 12-wide layer before the
// skip; one step a partial brought it within, for 1-7% of each row
// kernel's time (PERF.md §6).
constexpr int kWgGroup = 2;
constexpr int kWgRowGroup = 1;
// Shared floats a ring of kStages stages needs at w_s: the stages,
// 1024-byte alignment slack and the mbarriers.
__host__ __device__ constexpr int wg_ws_floats(int stages) {
  return stages * kWgStageFloats + 256 + 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)));
}

// Arrive on the barrier and add `bytes` to the transactions it waits for.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Make the barriers' initialization visible to the async proxy (the bulk
// copies' complete_tx).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of v across the asynchronous
// products (which write it behind its back until wg_wait).
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (between groups of 8 rows of 128 bytes).
__device__ __forceinline__ unsigned long long wg_desc(const float* p) {
  return (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// d = a b (scale_d 0) or d + a b (1) for one m64n128k8 TF32 product: A
// (64 x 8) from the warpgroup's registers (per warp the m16n8k8 layout:
// lane (g, t) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its 16
// rows), B (8 x 128) through its descriptor, d as the accumulator layout
// above.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4],
                                           unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Issue the products of k8 steps J0 .. J0 + NG - 1 of a slice for
// this thread's warpgroup into the partial d (the first overwrites it;
// small terms first: lo hi, hi lo, hi hi), a (ah, al) times b (hi at dh,
// lo at dl), and commit them as one group; V = kTf32x1 (the trial's
// control) takes a's and b's hi parts alone.
template <TcVariant V, int J0, int NG = kWgGroup>
__device__ __forceinline__ void wg_group(float (&d)[64], const unsigned (&ah)[4][4],
                                         const unsigned (&al)[4][4], unsigned long long dh,
                                         unsigned long long dl) {
  wg_fence();
#pragma unroll
  for (int j = J0; j < J0 + NG; ++j) {
    // step j reads bytes 32 j .. 32 j + 31 of each 128-byte row
    const unsigned long long oh = dh + 2 * j, ol = dl + 2 * j;
    if constexpr (V == kTf32x1) {
      wgmma_tf32(d, ah[j], oh, j > J0);
    } else {
      wgmma_tf32(d, al[j], oh, j > J0);
      wgmma_tf32(d, ah[j], ol, 1);
      wgmma_tf32(d, ah[j], oh, 1);
    }
  }
  wg_commit();
}

// Wait for the committed products and add the partial d to the f32 sum by
// FADD.
__device__ __forceinline__ void wg_group_add(float (&acc)[64], float (&d)[64]) {
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    fence_operand(d[i]);
    acc[i] += d[i];
  }
}

// One slice's products for this thread's warpgroup, kWgRowGroup k8 steps to
// a partial: acc += sum over the slice of a b.
template <TcVariant V, int J0 = 0>
__device__ __forceinline__ void wg_slice(float (&acc)[64], float (&d)[64],
                                         const unsigned (&ah)[4][4], const unsigned (&al)[4][4],
                                         unsigned long long dh, unsigned long long dl) {
  wg_group<V, J0, kWgRowGroup>(d, ah, al, dh, dl);
  wg_group_add(acc, d);
  if constexpr (J0 + kWgRowGroup < 4) wg_slice<V, J0 + kWgRowGroup>(acc, d, ah, al, dh, dl);
}

// out[r][c] = epi(r, c, sum_k in[r][k] * B[k][c]) for r < 64, c < N <= 256,
// with B as packed by `wg_pack_b` at Bp: the contract of `gemm<KS>`
// (mlp_tile.cuh): a __syncthreads() precedes the first load of `in`, and
// the epilogue runs after the last barrier, so `out` may be `in`. w_s holds
// wg_ws_floats(kStages) floats.
template <TcVariant V, int kStages, class Epi>
__device__ __forceinline__ void wg_gemm(const float* in, int ld_in, int K,
                                        const float* __restrict__ Bp, int N,
                                        float* __restrict__ w_s, Epi epi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, q = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (tid >> 7) * 128;
  const bool active = n0 < N;
  const int np = (N + 127) & ~127;
  const int n_slices = (K + kWgSliceK - 1) / kWgSliceK;
  const unsigned slice_floats = 2u * np * kWgSliceK;  // hi + lo
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<unsigned long long>(w_s) + 1023) & ~1023ull);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + kStages * kWgStageFloats);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_proxy_async();
  }
  __syncthreads();  // barriers initialized, writes made to `in` visible
  if (tid == 0) {
    for (int s = 0; s < kStages && s < n_slices; ++s) {
      mbar_expect_tx(&full[s], slice_floats * 4);
      bulk_g2s(ring + s * kWgStageFloats, Bp + (long long)s * slice_floats, slice_floats * 4,
               &full[s]);
    }
  }
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.0f;
  const float* arow = in + (16 * q + g) * ld_in + 4 * t;
  for (int s = 0; s < n_slices; ++s) {
    const int st = s % kStages;
    // This thread's A fragments of the slice: k8 step 2b + h takes columns
    // 4t + 2h, + 1 of the 16-column block b as its k = t, t + 4.
    unsigned ah[4][4], al[4][4];
    if (active) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int k = s * kWgSliceK + 16 * b + 4 * t;
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
        if (k < K) {
          u = *reinterpret_cast<const float4*>(arow + s * kWgSliceK + 16 * b);
          v = *reinterpret_cast<const float4*>(arow + 8 * ld_in + s * kWgSliceK + 16 * b);
        }
        split_tf32(u.x, ah[2 * b][0], al[2 * b][0]);
        split_tf32(v.x, ah[2 * b][1], al[2 * b][1]);
        split_tf32(u.y, ah[2 * b][2], al[2 * b][2]);
        split_tf32(v.y, ah[2 * b][3], al[2 * b][3]);
        split_tf32(u.z, ah[2 * b + 1][0], al[2 * b + 1][0]);
        split_tf32(v.z, ah[2 * b + 1][1], al[2 * b + 1][1]);
        split_tf32(u.w, ah[2 * b + 1][2], al[2 * b + 1][2]);
        split_tf32(v.w, ah[2 * b + 1][3], al[2 * b + 1][3]);
      }
    }
    mbar_wait(&full[st], (s / kStages) & 1);
    const float* hi = ring + st * kWgStageFloats + n0 * kWgSliceK;
    if (active) wg_slice<V>(acc, d, ah, al, wg_desc(hi), wg_desc(hi + np * kWgSliceK));
    __syncthreads();  // every warpgroup is done with this stage
    if (tid == 0 && s + kStages < n_slices) {
      mbar_expect_tx(&full[st], slice_floats * 4);
      bulk_g2s(ring + st * kWgStageFloats, Bp + (long long)(s + kStages) * slice_floats,
               slice_floats * 4, &full[st]);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_inval(&full[s]);
  }
  if (!active) return;
  const int r0 = 16 * q + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    if (c < N) {  // N is a multiple of 4, so c + 1 < N too
      epi(r0, c, acc[4 * j]);
      epi(r0, c + 1, acc[4 * j + 1]);
      epi(r0 + 8, c, acc[4 * j + 2]);
      epi(r0 + 8, c + 1, acc[4 * j + 3]);
    }
  }
}

// The GEMM policy of the sweeps (mlp_tile.cuh) on this core with a ring of
// kStages stages: the hidden layers' weights as packed B (Offsets wp, wtp),
// the SDF head's feature columns too (wfp, wftp), and the hidden color
// layers' (wcp, wctp; h0_bar's columns past 256 packed apart, wct0tp: an
// offset into a packed B does not select its columns).
template <int kStages>
struct WgGemmRing {
  static constexpr int kLd = kTcLd;
  static constexpr int kWsFloats = wg_ws_floats(kStages);
  static constexpr int kSliceK = kWgSliceK;  // the sweeps' KS with this policy
  __device__ static __forceinline__ const float* w(const float* P, const Offsets& off, int l) {
    return P + off.wp[l];
  }
  __device__ static __forceinline__ const float* wt(const float* P, const Offsets& off, int l) {
    return P + off.wtp[l];
  }
  __device__ static __forceinline__ const float* wf(const float* P, const Offsets& off) {
    return P + off.wfp;
  }
  __device__ static __forceinline__ const float* wft(const float* P, const Offsets& off) {
    return P + off.wftp;
  }
  __device__ static __forceinline__ const float* wc(const float* P, const Offsets& off, int l) {
    return P + off.wcp[l];
  }
  __device__ static __forceinline__ const float* wct(const float* P, const Offsets& off, int l) {
    return P + off.wctp[l];
  }
  __device__ static __forceinline__ const float* wct0_tail(const float* P, const Offsets& off) {
    return P + off.wct0tp;
  }
  template <int KS, class Epi>
  __device__ static __forceinline__ void run(const float* in, int ld_in, int K,
                                             const float* __restrict__ Bp, int, int N,
                                             float* __restrict__ w_s, Epi epi) {
    static_assert(KS == kWgSliceK, "WgGemm streams kWgSliceK-deep slices");
    wg_gemm<kTcVariant, kStages>(in, ld_in, K, Bp, N, w_s, epi);
  }
};

using WgGemm = WgGemmRing<2>;   // K1-fwd, K6-fwd, K2, K3, K4-fwd (and K7-fwd), K5-fwd
using WgGemm1 = WgGemmRing<1>;  // K1-bwd, K6-bwd, K4-bwd, K5-bwd

}  // namespace copenerf
