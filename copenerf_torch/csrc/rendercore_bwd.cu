// K1-bwd — the render-core field query's backward, second order: the C
// entry points. Replaces copenerf_tpu/ops/pallas/rendercore_kernels.py
// `bwd_kernel` (with_cons=False); the kernel and its design are in
// rendercore_bwd.cuh.
#include "rendercore_bwd.cuh"

using namespace copenerf;

namespace {

// Floats of the frozen-fields kernel's per-block scratch: each SDF hidden
// layer's sigmoids and the inputs of color layers 1 .. c_n_lin - 2.
long long rc_bwd_frozen_scratch(int n_lin, int c_n_lin, int n_blocks) {
  return (long long)n_blocks * (n_lin - 1 + c_n_lin - 2) * kRows * 256;
}

// K1-bwd's frozen-fields launch: the row kernel alone, no stage, no
// reduction.
int rc_bwd_frozen_run(const float* x, const float* dirs, const float* sbar, const float* cbar,
                      float* xbar, float* dbar, const float* params, const long long* off_b,
                      const long long* off_wp, const long long* off_wtp, long long off_w_last0,
                      long long off_b_last0, long long off_wfp, long long off_wftp,
                      long long off_b_feat, const long long* off_wcp,
                      const long long* off_wctp, long long off_wct0tp, const long long* off_bc,
                      long long off_wc_last, long long off_wct_last, float* scratch,
                      long long n, int n_lin, int d_in, int multires, int hidden, int skip,
                      float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires,
                      int c_k0, int squeeze, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  SdfGeom g;
  ColorGeom cg;
  if (!rc_geometry(n, n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin, c_hidden,
                   c_multires, c_k0, squeeze, g, cg) ||
      (c_k0 > kSliceCols && off_wct0tp == 0))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  if (!make_rendercore_offsets(off, n_lin - 1, off_b, off_wp, off_wtp, off_w_last0,
                               off_b_last0, off_wfp, off_wftp, off_b_feat, c_n_lin, off_wcp,
                               off_wctp, off_wct0tp, off_bc, off_wc_last, off_wct_last))
    return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, const float*, const float*, float*,
                          float*, const float*, Offsets, float*, long long, SdfGeom, ColorGeom,
                          FrozenFields);
  const Kernel kernel = rendercore_bwd_kernel<false>;
  const size_t smem = rc_bwd_smem(g.d0, cg.k0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, dirs, sbar, cbar, xbar, dbar, params,
                                                         off, scratch, n, g, cg, FrozenFields{});
  return (int)cudaGetLastError();
}

}  // namespace

// Device floats the backward needs beside its inputs and outputs:
// out[0] staged rows, out[1] the reduction's partial sums, out[2] the
// per-block scratch (sigmoids and channel-B injections) of n_blocks blocks.
extern "C" int copenerf_rendercore_bwd_workspace(long long n, int n_lin, int d_in, int multires,
                                                 int hidden, int skip, int d_feat, int c_n_lin,
                                                 int c_hidden, int c_multires, int c_k0,
                                                 int n_blocks, long long* out) {
  return rc_bwd_workspace<false>(n, n_lin, d_in, multires, hidden, skip, d_feat, c_n_lin,
                                 c_hidden, c_multires, c_k0, n_blocks, out);
}

// The same for copenerf_rendercore_bwd_frozen: no stage, no partial sums,
// out[2] the scratch of n_blocks blocks.
extern "C" int copenerf_rendercore_bwd_frozen_workspace(int n_lin, int c_n_lin, int n_blocks,
                                                        long long* out) {
  if (n_lin < 2 || c_n_lin < 2 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  out[0] = out[1] = 0;
  out[2] = rc_bwd_frozen_scratch(n_lin, c_n_lin, n_blocks);
  return 0;
}

// x_bar (n, 4), dirs_bar (n, 3) and both nets' weight gradients (into
// `grads` at the off_g* offsets, pack.py `rendercore_grad_layout`) for the
// cotangents sbar (n,), gbar (n, 4), cbar (n, 3) of K1-fwd's outputs at
// x (n, 4), dirs (n, 3). The weight offsets are K1-fwd's plus off_wftp (the
// feature columns' transpose as wgmma B), off_wctp (per hidden color layer
// W^T as wgmma B; layer 0's columns < 256), off_wct0tp (layer 0's columns
// 256 .. c_k0 as wgmma B, 0 when c_k0 <= 256) and off_wct_last (the color
// head's W (3, hidden)). Returns the first CUDA error.
extern "C" int copenerf_rendercore_bwd(
    const float* x, const float* dirs, const float* sbar, const float* gbar,
    const float* cbar, float* xbar, float* dbar,
    const float* params, const long long* off_b, const long long* off_wp,
    const long long* off_wtp, long long off_w_last0, long long off_b_last0, long long off_wfp,
    long long off_wftp, long long off_b_feat, const long long* off_wcp,
    const long long* off_wctp, long long off_wct0tp, const long long* off_bc,
    long long off_wc_last, long long off_wct_last, float* grads, const long long* off_gw,
    const long long* off_gb, long long off_gw_last0, const long long* off_gwc,
    const long long* off_gbc, float* stage, float* partial, float* scratch, long long n,
    int n_lin, int d_in, int multires, int hidden, int skip, float scale, int d_feat,
    int c_n_lin, int c_hidden, int c_multires, int c_k0, int squeeze, int n_blocks,
    void* stream) {
  return rc_bwd_run<false>(
      x, dirs, nullptr, sbar, gbar, cbar, nullptr, xbar, dbar, nullptr, params,
      off_b, off_wp, off_wtp, off_w_last0, off_b_last0, off_wfp, off_wftp, off_b_feat, off_wcp,
      off_wctp, off_wct0tp, off_bc, off_wc_last, off_wct_last, grads, off_gw, off_gb,
      off_gw_last0, off_gwc, off_gbc, stage, partial, scratch, n, n_lin, d_in, multires,
      hidden, skip, scale, d_feat, c_n_lin, c_hidden, c_multires, c_k0, squeeze, n_blocks,
      stream);
}

// x_bar (n, 4) and dirs_bar (n, 3) alone, for frozen fields: the
// cotangents sbar (n,) and cbar (n, 3) (gbar's reaches no input: channel B
// is severed from x), the weight offsets as copenerf_rendercore_bwd takes
// them, the scratch of copenerf_rendercore_bwd_frozen_workspace. x_bar and
// dirs_bar are copenerf_rendercore_bwd's bit for bit. Returns the first
// CUDA error.
extern "C" int copenerf_rendercore_bwd_frozen(
    const float* x, const float* dirs, const float* sbar, const float* cbar, float* xbar,
    float* dbar, const float* params, const long long* off_b, const long long* off_wp,
    const long long* off_wtp, long long off_w_last0, long long off_b_last0, long long off_wfp,
    long long off_wftp, long long off_b_feat, const long long* off_wcp,
    const long long* off_wctp, long long off_wct0tp, const long long* off_bc,
    long long off_wc_last, long long off_wct_last, float* scratch, long long n, int n_lin,
    int d_in, int multires, int hidden, int skip, float scale, int d_feat, int c_n_lin,
    int c_hidden, int c_multires, int c_k0, int squeeze, int n_blocks, void* stream) {
  return rc_bwd_frozen_run(x, dirs, sbar, cbar, xbar, dbar, params, off_b, off_wp, off_wtp,
                           off_w_last0, off_b_last0, off_wfp, off_wftp, off_b_feat, off_wcp,
                           off_wctp, off_wct0tp, off_bc, off_wc_last, off_wct_last, scratch, n,
                           n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin,
                           c_hidden, c_multires, c_k0, squeeze, n_blocks, stream);
}
