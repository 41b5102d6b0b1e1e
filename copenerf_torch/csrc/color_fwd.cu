// K5-fwd — the IDR color MLP, forward only.
//
// Replaces: copenerf_tpu/ops/pallas/color_kernels.py `_build` -> `fwd_kernel`
// (launched by `call_fwd`, exposed through `get_fused_color`). In the port it
// runs the idr color of the composed render-core query, after K4-fwd
// (sdf_outgrad_fwd.cu): one launch per render chunk (4,194,304 rows) or train
// step (131,072 rows) of a config with the negative ray vector, whose
// negation of dirs and grad stays outside the kernel (as color_kernels.py
// :234 leaves it to the caller).
//
// Computes, per row x (4), dirs (3), grad (4), feature (d_feat): the MLP on
// [x, PE(dirs), grad, feature] (ReLU hidden layers, sigmoid head).
// Output color (n, 3).
//
// Bound on an H100: operations. ~0.54 MFLOP per row at the default config
// (8 ns of f32 FFMA) against 1,068 bytes in (the feature row: 0.3 ns).
// Design: the color part of K1-fwd (rendercore_fwd.cu), through the same
// color_forward (mlp_tile.cuh): the four inputs are concatenated in shared
// memory (the feature read straight from K4's 257-wide head at its row
// stride, so it is never copied), in the kernel's column order [feature, x,
// PE(dirs), grad, 0 pad]; 64-row tiles, one block per tile, 32-deep weight
// slices.
#include "mlp_tile.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 32;

__global__ void __launch_bounds__(kThreads, 1)
color_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                 const float* __restrict__ grad, const float* __restrict__ feat, long long ld_feat,
                 float* __restrict__ color_out, const float* __restrict__ P, Offsets off,
                 long long n, ColorGeom cg) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations, row stride 256
  float* cin = h + kRows * kSliceCols;         // color input, row stride cg.k0
  float* xr = cin + kRows * cg.k0;             // x
  float* dr = xr + kRows * 4;                  // dirs (3 used)
  float* gs = dr + kRows * 4;                  // grad
  float* w_s = gs + kRows * 4;
  const long long row0 = (long long)blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, j = i & 3;
    const long long gr = row0 + r;
    const bool ok = gr < n;
    xr[i] = ok ? x[gr * 4 + j] : 0.0f;
    dr[i] = (ok && j < 3) ? dirs[gr * 3 + j] : 0.0f;
    gs[i] = ok ? grad[gr * 4 + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * cg.d_feat; i += kThreads) {
    const int r = i / cg.d_feat, c = i - r * cg.d_feat;
    const long long gr = row0 + r;
    cin[r * cg.k0 + c] = gr < n ? feat[gr * ld_feat + c] : 0.0f;
  }
  __syncthreads();
  color_forward<kSliceK, false>(P, off, cg, cin, h, w_s, xr, dr, gs,
                                [](int, int, int, float) {}, [&](int r, int c, float v) {
                                  const long long gr = row0 + r;
                                  if (gr < n) color_out[gr * 3 + c] = v;
                                });
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// color (n, 3) of x (n, 4), dirs (n, 3), grad (n, 4) and the feature rows
// feat[r * ld_feat + c], c < d_feat. off_wc / off_bc: float offsets into
// `params` of each color layer's W (in, out; layer 0 with its input rows in
// the kernel's order, padded to c_k0) and b. Returns cudaGetLastError().
extern "C" int copenerf_color_fwd(const float* x, const float* dirs, const float* grad,
                                  const float* feat, long long ld_feat, float* color,
                                  const float* params, const long long* off_wc,
                                  const long long* off_bc, long long n, int d_feat, int c_n_lin,
                                  int c_hidden, int c_multires, int c_k0, int squeeze,
                                  void* stream) {
  if (n <= 0) return 0;
  if (c_k0 % 4 || d_feat > c_k0 || ld_feat < d_feat) return (int)cudaErrorInvalidValue;
  ColorGeom cg{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  Offsets off;
  if (!make_color_offsets(off, c_n_lin, off_wc, off_bc, nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kRows * kSliceCols + kRows * c_k0 + 3 * kRows * 4 +
                                       2 * kSliceK * kSliceCols);
  cudaError_t err = cudaFuncSetAttribute(color_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  color_fwd_kernel<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      x, dirs, grad, feat, ld_feat, color, params, off, n, cg);
  return (int)cudaGetLastError();
}
