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
// (8 ns of f32 FFMA, 3.3 ns in 3xTF32 on the tensor cores) against 1,068
// bytes in (the feature row: 0.3 ns).
// Design: the color part of K1-fwd (rendercore_fwd.cu) through the same
// color_forward (mlp_tile.cuh), with every hidden layer on the wgmma 3xTF32
// core (wgmma_tile.cuh WgGemm: the weights packed by the host as wgmma B,
// pack.py `pack_color`; a two-stage ring of 32-deep slices): the four inputs
// are concatenated in shared memory (the feature read straight from K4's
// 257-wide head at its row stride, so it is never copied), in the kernel's
// column order [feature, x, PE(dirs), grad, 0 pad] (layer 0's K = 292: nine
// slices and a tail of 4, read as zero past K); 64-row tiles, one block per
// tile. Shared memory: the activations (64 x 272) are written over the color
// input (64 x 292) by layer 0's epilogue, which runs after its last read of
// it (nothing reads the input again), so the two-stage ring fits: 209,984
// bytes, against 279,616 with the two apart (one stage measured 3-4% slower,
// PERF.md §6). The input's row stride stays 292 (4 mod 32 floats, so
// layer 0's A loads meet 2-way bank conflicts that kTcLd's 16 mod 32 avoids):
// a stride of 304 measured equal within 1% on K5-fwd and K5-bwd. The 3-wide
// head stays a per-row dot on the plain W: as a wgmma B it would be padded
// to N = 128, 42x its work.
#include "wgmma_tile.cuh"

namespace copenerf {
namespace {

using G = WgGemm;

__global__ void __launch_bounds__(kThreads, 1)
color_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                 const float* __restrict__ grad, const float* __restrict__ feat, long long ld_feat,
                 float* __restrict__ color_out, const float* __restrict__ P, Offsets off,
                 long long n, ColorGeom cg) {
  extern __shared__ float4 smem4[];
  float* cin = reinterpret_cast<float*>(smem4);  // color input, row stride cg.k0,
  float* h = cin;                                // then the activations, stride kLd
  float* xr = cin + kRows * max(cg.k0, G::kLd);  // x
  float* dr = xr + kRows * 4;                    // dirs (3 used)
  float* gs = dr + kRows * 4;                    // grad
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
  color_forward<G::kSliceK, false, G>(P, off, cg, cin, h, w_s, xr, dr, gs,
                                      [](int, int, int, float) {}, [&](int r, int c, float v) {
                                        const long long gr = row0 + r;
                                        if (gr < n) color_out[gr * 3 + c] = v;
                                      });
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// color (n, 3) of x (n, 4), dirs (n, 3), grad (n, 4) and the feature rows
// feat[r * ld_feat + c], c < d_feat. Float offsets into `params` (pack.py
// `pack_color`): off_wcp, each hidden color layer's W as wgmma B (layer 0
// with its input rows in the kernel's order, zero past c_k0); off_bc, every
// layer's b; off_wc_last, the head's W (hidden, 3). Returns
// cudaGetLastError().
extern "C" int copenerf_color_fwd(const float* x, const float* dirs, const float* grad,
                                  const float* feat, long long ld_feat, float* color,
                                  const float* params, const long long* off_wcp,
                                  const long long* off_bc, long long off_wc_last, long long n,
                                  int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0,
                                  int squeeze, void* stream) {
  if (n <= 0) return 0;
  if (c_k0 % 4 || d_feat > c_k0 || ld_feat < d_feat) return (int)cudaErrorInvalidValue;
  ColorGeom cg{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  Offsets off;
  if (!make_color_offsets(off, c_n_lin, off_wcp, nullptr, 0, off_bc, off_wc_last, 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (kRows * (c_k0 > G::kLd ? c_k0 : G::kLd) + 3 * kRows * 4 + G::kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(color_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  color_fwd_kernel<<<(unsigned)tiles, kThreads, smem, (cudaStream_t)stream>>>(
      x, dirs, grad, feat, ld_feat, color, params, off, n, cg);
  return (int)cudaGetLastError();
}
