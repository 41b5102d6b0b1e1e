// The accuracy trial and card check of the tensor-core cores: the 64-row
// tile GEMM of K1 and K6 (mma_tile.cuh, `mma.sync`) and of K2-K5 and K7
// (wgmma_tile.cuh, `wgmma`), and the weight-gradient reduction (wgrad.cu,
// `wgmma`), on operands the caller chooses, beside f32 FFMA versions.
// Nothing of the main path calls these entry points; the tests and
// PERF.md's trial hold their results against an f64 product
// (ops/kernels/tc_check.py).
#include "wgmma_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 32;
constexpr int kPresplit = 4;  // mode: 3xTF32, W split on the host
// Modes of the wgmma core (W packed by the host, pack.py wg_pack_b): the
// shipped WgGemm (two-stage ring), one TF32 product as the control that
// shows what the split buys, and WgGemm1 (K4-bwd's one-stage ring).
constexpr int kWg = 5, kWg1 = 6, kWgOneStage = 7;

// The alternative split, for its time: W's (hi, lo) split on the host (Wl
// the lo parts), both streamed from L2 into 16-deep slice pairs (the same
// shared memory as two 32-deep slices), no B split in registers.
template <class Epi>
__device__ __forceinline__ void tc_gemm_presplit(const float* in, int ld_in, int K,
                                                 const float* __restrict__ Wh,
                                                 const float* __restrict__ Wl, int N,
                                                 float* __restrict__ w_s, Epi epi) {
  constexpr int KS = 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
  const bool active = n0 < N;
  float acc[4][4][4] = {};
  const int n_slices = (K + KS - 1) / KS;
  auto load = [&](int s) {
    float* dst = w_s + (s & 1) * 2 * KS * kSliceCols;
    tc_load_slice<KS>(Wh, N, N, K, s * KS, dst);
    tc_load_slice<KS>(Wl, N, N, K, s * KS, dst + KS * kSliceCols);
  };
  load(0);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      load(s + 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* wh = w_s + (s & 1) * 2 * KS * kSliceCols;
      const float* wl = wh + KS * kSliceCols;
      const int k0 = s * KS;
      const int kn = min(KS, K - k0);
      const bool kok = 4 * t < kn;
      const float* arow = in + g * ld_in + k0 + 4 * t;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kr = 4 * t + 2 * q + j;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int idx = kr * kSliceCols + tc_swz(kr, n0 + 8 * nt + g);
            bh[nt][j] = __float_as_uint(wh[idx]);
            bl[nt][j] = __float_as_uint(wl[idx]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
          if (kok) {
            u = *reinterpret_cast<const float4*>(arow + 16 * mt * ld_in);
            v = *reinterpret_cast<const float4*>(arow + (16 * mt + 8) * ld_in);
          }
          unsigned ah[4], al[4];
          split_tf32(q ? u.z : u.x, ah[0], al[0]);
          split_tf32(q ? v.z : v.x, ah[1], al[1]);
          split_tf32(q ? u.w : u.y, ah[2], al[2]);
          split_tf32(q ? v.w : v.y, ah[3], al[3]);
          mma_f32x3<kTcVariant>(acc[mt], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();
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

// C (m, N) = A (m, K) W (K, N), 64 rows a block: the rows of A go to shared
// memory at the row stride the render-core kernels use (kTcLd, or K past
// it), columns past K filled with NaN (stale data in the kernels' buffers:
// a product that reads them shows), then one tile GEMM: kMode 0 is the
// FFMA `gemm`, the others the tensor-core core in that TcVariant.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
tile_gemm_check_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       const float* __restrict__ Wl, float* __restrict__ C, long long m,
                       int K, int N, int ld, int reps, float* aux) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);
  float* w_s = a_s + kRows * ld;
  const long long row0 = (long long)blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const int r = i / ld, c = i - r * ld;
    a_s[i] = c >= K ? __int_as_float(0x7fc00000) : row0 + r < m ? A[(row0 + r) * K + c] : 0.0f;
  }
  // With aux, each output also reads aux[i] and writes aux[m N + i] (to
  // the compiler, possibly the same memory), as the sweeps' epilogues read
  // the sigmoid scratch and write the staged rows: its cost per GEMM.
  auto epi = [&](int r, int c, float v) {
    const long long i = (row0 + r) * N + c;
    if (row0 + r >= m) return;
    if (aux) {
      v *= aux[i];
      aux[m * N + i] = v;
    }
    C[i] = v;
  };
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (kMode == kWg)
      WgGemm::run<WgGemm::kSliceK>(a_s, ld, K, W, N, N, w_s, epi);
    else if constexpr (kMode == kWg1)
      wg_gemm<kTf32x1, 2>(a_s, ld, K, W, N, w_s, epi);
    else if constexpr (kMode == kWgOneStage)
      WgGemm1::run<WgGemm1::kSliceK>(a_s, ld, K, W, N, N, w_s, epi);
    else if constexpr (kMode == 0)
      gemm<kSliceK>(a_s, ld, K, W, N, N, w_s, epi);
    else if constexpr (kMode == kPresplit)
      tc_gemm_presplit(a_s, ld, K, W, Wl, N, w_s, epi);
    else
      tc_gemm<kSliceK, (TcVariant)kMode>(a_s, ld, K, W, N, N, w_s, epi);
  }
}

template <int kMode>
int launch_tile(const float* A, const float* W, const float* Wl, float* C, long long m, int K,
                int N, int ld, int reps, float* aux, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRows * ld + (kMode == kWgOneStage ? WgGemm1::kWsFloats
                                     : kMode >= kWg       ? WgGemm::kWsFloats
                                                          : 2 * kSliceK * kSliceCols));
  cudaError_t err = cudaFuncSetAttribute(tile_gemm_check_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m + kRows - 1) / kRows;
  tile_gemm_check_kernel<kMode><<<(unsigned)tiles, kThreads, smem, stream>>>(A, W, Wl, C, m, K,
                                                                             N, ld, reps, aux);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// C (m, N) = A (m, K) W (K, N), all row-major f32, K and N multiples of 4,
// N <= 256. mode: 0 f32 FFMA, 1 one TF32 product, 2 3xTF32 (the render-core
// kernels' kTcVariant), 3 3xTF32 summed on the tensor core, 4 3xTF32 with W
// split on the host (W the hi parts as f32 bit patterns, Wl the lo parts);
// 5, 6 and 7 the wgmma core (kWg, kWg1, kWgOneStage above) with W as
// packed by wg_pack_b.
// Each block runs the GEMM `reps` times (for timing: the slope over reps is
// one tile GEMM and its epilogue); aux, if set, holds 2 m N floats that the
// epilogue reads and writes (see the kernel).
extern "C" int copenerf_tile_gemm_check(const float* A, const float* W, const float* Wl,
                                        float* C, long long m, int K, int N, int mode,
                                        int reps, float* aux, void* stream) {
  if (m <= 0) return 0;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  if (K < 4 || K % 4 || N < 4 || N % 4 || N > kSliceCols) return (int)cudaErrorInvalidValue;
  const int ld = K <= kTcLd ? kTcLd : K;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_tile<0>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kTf32x1: return launch_tile<kTf32x1>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kTf32x3: return launch_tile<kTf32x3>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kTf32x3Acc: return launch_tile<kTf32x3Acc>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kPresplit: return launch_tile<kPresplit>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kWg: return launch_tile<kWg>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kWg1: return launch_tile<kWg1>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    case kWgOneStage: return launch_tile<kWgOneStage>(A, W, Wl, C, m, K, N, ld, reps, aux, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w_out (O, I) = sum over pairs of z_p^T t_p and b_out (O,) = the column
// sums of z_0 through the weight-gradient reduction: mode 0 the FFMA
// `wgrad_launch`, else the `wgmma` one every backward kernel runs
// (`wgrad_tc_launch`) in that TcVariant: kTf32x3 as shipped, kTf32x1 its
// one-product control. n_pairs (1 or 2) pairs of n rows, both with row
// strides ldz and ldt (the staged rows' layout); z_p null: ones; rows_p:
// pair p stops at that row (0: all n). `partial` holds (O * I + O) *
// ceil(n / 1024) floats.
extern "C" int copenerf_wgrad_check(const float* z0, const float* t0, long long rows0,
                                    const float* z1, const float* t1, long long rows1,
                                    int n_pairs, float* w_out, float* b_out, float* partial,
                                    long long n, int O, int I, int ldz, int ldt, int mode,
                                    void* stream) {
  if (ldz % 4 || ldt % 4 || ldz < O || ldt < I || n_pairs < 1 || n_pairs > 2 ||
      (mode != 0 && mode != kTf32x3 && mode != kTf32x1))
    return (int)cudaErrorInvalidValue;
  WgradJob job;
  job.O = O;
  job.I = I;
  job.n_pairs = n_pairs;
  job.p[0] = WgradPair{z0, t0, ldz, ldt, rows0};
  job.p[1] = WgradPair{z1, t1, ldz, ldt, rows1};
  job.w_out = w_out;
  job.b_out = b_out;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(mode == 0 ? wgrad_launch(&job, 1, n, partial, s)
                         : wgrad_tc_launch(&job, 1, n, partial, s, mode));
}
