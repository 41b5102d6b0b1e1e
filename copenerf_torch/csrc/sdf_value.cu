// K2 — the no-grad SDF value sweep of importance sampling.
//
// Replaces: copenerf_tpu/ops/pallas/sdf_kernels.py `_build` -> `value_kernel`
// (launched by `call_value`, exposed as `FusedOps.value`). Four launches per
// render chunk: 64 samples per ray, then 3 x 16.
//
// Computes, per row x = (x, y, z, t): PE(x * scale) -> hidden layers with
// softplus-100 (skip concat / sqrt(2)) -> column 0 of the last layer, / scale.
// Only column 0 of the last layer is computed (the TPU kernel computes all
// 257 and discards 256): the same function with 12% less work.
//
// Bound on an H100: operations. ~0.92 MFLOP against 20 bytes per row, so
// the f32 FFMA rate (67 TFLOP/s outside the tensor cores) is the limit by
// three orders of magnitude; tensor cores are off the table until a measured
// accuracy trial clears TF32/3xTF32.
// Design: activations never leave shared memory (64-row tile, one 64 x 256
// buffer that each layer overwrites in place, plus the PE); each thread
// accumulates an 8 x 8 register block per GEMM so the FFMA:shared-load ratio
// is 16:1 per k; the 2.1 MB of weights stream from L2 through two 64 x 256
// slices, the next one copied (cp.async) while the current one is multiplied
// (206 KB of shared memory in all). The kernel masks the ragged tail rows
// itself (the TPU path pads to the tile instead).
// It runs at under half of the f32 bound (times in PERF.md): 8 warps per SM
// (the 8 x 8 block needs ~170 registers a thread) leave each scheduler two
// warps to hide shared-memory and barrier latency, and the softplus
// epilogue and slice loads issue besides the FFMA.
#include "mlp_tile.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 64;

__global__ void __launch_bounds__(kThreads, 1)
sdf_value_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ P, Offsets off, long long n, SdfGeom g) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* e = h + kRows * kSliceCols;
  float* xs = e + kRows * g.d0;
  float* w_s = xs + kRows * g.d_in;  // d0 and d_in keep 16-byte alignment
  const long long row0 = (long long)blockIdx.x * kRows;

  load_and_encode(x, n, row0, g, xs, e);
  sdf_hidden_forward<kSliceK>(P, off, g, e, h, w_s, [](int, int, int, float) {},
                              [](int, int, int, float) {});
  __syncthreads();
  const float b0 = P[off.b_last0];
  rowdot(h, 256, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
    const long long gr = row0 + r;
    if (gr < n) out[gr] = (v + b0) / g.scale;
  });
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// out (n,) = sdf(x (n, d_in)). The off_* arguments are float offsets into
// `params`: per hidden layer (n_lin - 1 of them) W (in, out) and b, then
// the last layer's column 0 and its bias. Returns cudaGetLastError() after
// the launch.
extern "C" int copenerf_sdf_value(const float* x, float* out, const float* params,
                                  const long long* off_w, const long long* off_b,
                                  long long off_w_last0, long long off_b_last0,
                                  long long n, int n_lin, int d_in, int multires,
                                  int hidden, int skip, float scale, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_w, off_b, nullptr, off_w_last0, off_b_last0, 0, 0,
                    0, nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) *
      (kRows * kSliceCols + kRows * g.d0 + kRows * d_in + 2 * kSliceK * kSliceCols);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  sdf_value_kernel<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, params, off, n, g);
  return (int)cudaGetLastError();
}
