// The accuracy trial and card check of the tensor-core cores: the 64-row
// tile GEMM of every row kernel (wgmma_tile.cuh, `wgmma`) and the
// weight-gradient reduction (wgrad.cu, `wgmma`), on operands the caller
// chooses, beside f32 FFMA versions.
// Nothing of the main path calls these entry points; the tests and
// PERF.md's trial hold their results against an f64 product
// (ops/kernels/tc_check.py).
#include "wgmma_tile.cuh"
#include "wgrad.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 32;
// Modes of the wgmma core (W packed by the host, pack.py wg_pack_b): the
// two-stage ring WgGemm (K1-fwd, K6-fwd, K2, K3, K4-fwd, K5-fwd, K7), one
// TF32 product as the control that shows what the split buys, and the
// one-stage ring WgGemm1 (K1-bwd, K6-bwd, K4-bwd, K5-bwd).
constexpr int kWg = 5, kWg1 = 6, kWgOneStage = 7;

// C (m, N) = A (m, K) W (K, N), 64 rows a block: the rows of A go to shared
// memory at the row stride the render-core kernels use (kTcLd, or K past
// it), columns past K filled with NaN (stale data in the kernels' buffers:
// a product that reads them shows), then one tile GEMM: kMode 0 is the
// FFMA `gemm`, the others the wgmma core's modes above.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
tile_gemm_check_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       float* __restrict__ C, long long m, int K, int N, int ld, int reps,
                       float* aux) {
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
    else
      gemm<kSliceK>(a_s, ld, K, W, N, N, w_s, epi);
  }
}

template <int kMode>
int launch_tile(const float* A, const float* W, float* C, long long m, int K, int N, int ld,
                int reps, float* aux, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRows * ld + (kMode == kWgOneStage ? WgGemm1::kWsFloats
                                     : kMode >= kWg       ? WgGemm::kWsFloats
                                                          : 2 * kSliceK * kSliceCols));
  cudaError_t err = cudaFuncSetAttribute(tile_gemm_check_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m + kRows - 1) / kRows;
  tile_gemm_check_kernel<kMode><<<(unsigned)tiles, kThreads, smem, stream>>>(A, W, C, m, K, N,
                                                                             ld, reps, aux);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// C (m, N) = A (m, K) W (K, N), all row-major f32, K and N multiples of 4,
// N <= 256. mode: 0 f32 FFMA; 5, 6 and 7 the wgmma core (kWg, kWg1,
// kWgOneStage above) with W as packed by wg_pack_b.
// Each block runs the GEMM `reps` times (for timing: the slope over reps is
// one tile GEMM and its epilogue); aux, if set, holds 2 m N floats that the
// epilogue reads and writes (see the kernel).
extern "C" int copenerf_tile_gemm_check(const float* A, const float* W, float* C, long long m,
                                        int K, int N, int mode, int reps, float* aux,
                                        void* stream) {
  if (m <= 0) return 0;
  if (reps < 1) return (int)cudaErrorInvalidValue;
  if (K < 4 || K % 4 || N < 4 || N % 4 || N > kSliceCols) return (int)cudaErrorInvalidValue;
  const int ld = K <= kTcLd ? kTcLd : K;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_tile<0>(A, W, C, m, K, N, ld, reps, aux, s);
    case kWg: return launch_tile<kWg>(A, W, C, m, K, N, ld, reps, aux, s);
    case kWg1: return launch_tile<kWg1>(A, W, C, m, K, N, ld, reps, aux, s);
    case kWgOneStage: return launch_tile<kWgOneStage>(A, W, C, m, K, N, ld, reps, aux, s);
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
