// K1-bwd — the render-core field query's backward, second order: the C
// entry points. Replaces copenerf_tpu/ops/pallas/rendercore_kernels.py
// `bwd_kernel` (with_cons=False); the kernel and its design are in
// rendercore_bwd.cuh.
#include "rendercore_bwd.cuh"

using namespace copenerf;

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

// x_bar (n, 4), dirs_bar (n, 3) and both nets' weight gradients (into
// `grads` at the off_g* offsets, pack.py `rendercore_grad_layout`) for the
// cotangents sbar (n,), gbar (n, 4), cbar (n, 3) of K1-fwd's outputs at
// x (n, 4), dirs (n, 3). The weight offsets are K1-fwd's plus wct per color
// layer and w_feat_t. Returns the first CUDA error.
extern "C" int copenerf_rendercore_bwd(
    const float* x, const float* dirs, const float* sbar, const float* gbar,
    const float* cbar, float* xbar, float* dbar, const float* params, const long long* off_w,
    const long long* off_b, const long long* off_wt, long long off_w_last0,
    long long off_b_last0, long long off_w_feat, long long off_b_feat, long long off_w_feat_t,
    const long long* off_wc, const long long* off_bc, const long long* off_wct, float* grads,
    const long long* off_gw, const long long* off_gb, long long off_gw_last0,
    const long long* off_gwc, const long long* off_gbc, float* stage, float* partial,
    float* scratch, long long n, int n_lin, int d_in, int multires, int hidden, int skip,
    float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0, int squeeze,
    int n_blocks, void* stream) {
  return rc_bwd_run<false>(x, dirs, nullptr, sbar, gbar, cbar, nullptr, xbar, dbar, nullptr,
                           params, off_w, off_b, off_wt, off_w_last0, off_b_last0, off_w_feat,
                           off_b_feat, off_w_feat_t, off_wc, off_bc, off_wct, grads, off_gw,
                           off_gb, off_gw_last0, off_gwc, off_gbc, stage, partial, scratch, n,
                           n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin,
                           c_hidden, c_multires, c_k0, squeeze, n_blocks, stream);
}
