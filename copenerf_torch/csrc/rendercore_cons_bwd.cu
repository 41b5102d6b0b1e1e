// K6-bwd — the render-core backward with the sdf-consistency query's
// backward at y folded in: the C entry points. Replaces
// copenerf_tpu/ops/pallas/rendercore_kernels.py `bwd_kernel`
// (with_cons=True, including `_value_only_bwd`); the kernel and its design
// are in rendercore_bwd.cuh.
#include "rendercore_bwd.cuh"

using namespace copenerf;

// As copenerf_rendercore_bwd_workspace, for K6-bwd.
extern "C" int copenerf_rendercore_cons_bwd_workspace(long long n, int n_lin, int d_in,
                                                      int multires, int hidden, int skip,
                                                      int d_feat, int c_n_lin, int c_hidden,
                                                      int c_multires, int c_k0, int n_blocks,
                                                      long long* out) {
  return rc_bwd_workspace<true>(n, n_lin, d_in, multires, hidden, skip, d_feat, c_n_lin,
                                c_hidden, c_multires, c_k0, n_blocks, out);
}

// K6-bwd: copenerf_rendercore_bwd's outputs plus y_bar (n, 4), for the
// cotangent swbar (n,) of K6-fwd's sdf_w at y (n, 4) besides sbar, gbar,
// cbar; both row sets' weight gradients summed into the same buffer (the
// same layout). The other arguments as there.
extern "C" int copenerf_rendercore_cons_bwd(
    const float* x, const float* dirs, const float* y, const float* sbar, const float* gbar,
    const float* cbar, const float* swbar, float* xbar, float* dbar, float* ybar,
    const float* params, const long long* off_w, const long long* off_b,
    const long long* off_wt, long long off_w_last0, long long off_b_last0,
    long long off_w_feat, long long off_b_feat, long long off_w_feat_t,
    const long long* off_wc, const long long* off_bc, const long long* off_wct, float* grads,
    const long long* off_gw, const long long* off_gb, long long off_gw_last0,
    const long long* off_gwc, const long long* off_gbc, float* stage, float* partial,
    float* scratch, long long n, int n_lin, int d_in, int multires, int hidden, int skip,
    float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires, int c_k0, int squeeze,
    int n_blocks, void* stream) {
  return rc_bwd_run<true>(x, dirs, y, sbar, gbar, cbar, swbar, xbar, dbar, ybar, params, off_w,
                          off_b, off_wt, off_w_last0, off_b_last0, off_w_feat, off_b_feat,
                          off_w_feat_t, off_wc, off_bc, off_wct, grads, off_gw, off_gb,
                          off_gw_last0, off_gwc, off_gbc, stage, partial, scratch, n, n_lin,
                          d_in, multires, hidden, skip, scale, d_feat, c_n_lin, c_hidden,
                          c_multires, c_k0, squeeze, n_blocks, stream);
}
