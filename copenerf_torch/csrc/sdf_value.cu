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
// Bound on an H100: operations. ~0.92 MFLOP against 20 bytes per row; in
// f32 FFMA (67 TFLOP/s) the bound is 28.7 ms at 2,097,152 rows, in 3xTF32 on
// the tensor cores (495 / 3 TFLOP/s of f32 products) 11.7 ms. The FFMA
// design that preceded it ran at under half of its bound (61 ms): 8 warps an SM
// (an 8 x 8 register block a thread) left each scheduler two warps to hide
// shared-memory and barrier latency.
// Design: the GEMMs run on wgmma in 3xTF32 (wgmma_tile.cuh, the WgGemm
// policy of the sweeps; its accuracy against f64 is held within 2x the
// FFMA GEMM's by kernel_times.py --trial). Activations never leave shared
// memory (a 64-row tile, one 64 x 272 buffer that each layer overwrites in
// place, plus the PE); the weights, pre-split into TF32 hi and lo parts by
// the host, stream from L2 through a two-stage ring of 32-deep slices (one
// bulk copy each, completing on an mbarrier): 3.7 MB a tile, the L2's rate
// the next limit (splitting f32 slices in shared memory halves the bytes
// but measured slower; a 2-CTA cluster multicasting each slice would halve
// them too; a 128-row tile would need twice the accumulators, past the
// register file). The head's column 0 is a per-row dot (256 MACs a row). The
// kernel masks the ragged tail rows itself (the TPU path pads to the tile
// instead).
#include "wgmma_tile.cuh"

namespace copenerf {
namespace {

using G = WgGemm;

__global__ void __launch_bounds__(kThreads, 1)
sdf_value_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ P, Offsets off, long long n, SdfGeom g) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  float* e = h + kRows * G::kLd;
  float* xs = e + kRows * g.d0;
  float* w_s = xs + kRows * g.d_in;  // d0 and d_in keep 16-byte alignment
  const long long row0 = (long long)blockIdx.x * kRows;

  load_and_encode(x, n, row0, g, xs, e);
  sdf_hidden_forward<G::kSliceK, G>(P, off, g, e, h, w_s, [](int, int, int, float) {},
                                    [](int, int, int, float) {});
  __syncthreads();
  const float b0 = P[off.b_last0];
  rowdot(h, G::kLd, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
    const long long gr = row0 + r;
    if (gr < n) out[gr] = (v + b0) / g.scale;
  });
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// out (n,) = sdf(x (n, d_in)). The off_* arguments are float offsets into
// `params`: per hidden layer (n_lin - 1 of them) b and W as wgmma B
// (pack.py `wg_pack_b`), then the last layer's column 0 and its bias.
// Returns cudaGetLastError() after the launch.
extern "C" int copenerf_sdf_value(const float* x, float* out, const float* params,
                                  const long long* off_b, const long long* off_wp,
                                  long long off_w_last0,
                                  long long off_b_last0, long long n, int n_lin, int d_in,
                                  int multires, int hidden, int skip, float scale,
                                  void* stream) {
  if (n <= 0) return 0;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_b, off_wp, nullptr, off_w_last0, off_b_last0, 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (kRows * G::kLd + kRows * g.d0 + kRows * d_in + G::kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  sdf_value_kernel<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, params, off, n, g);
  return (int)cudaGetLastError();
}
