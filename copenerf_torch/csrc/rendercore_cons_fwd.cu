// K6-fwd — the render-core field query with the sdf-consistency query at y
// folded into the same launch: the C entry point. Replaces
// copenerf_tpu/ops/pallas/rendercore_kernels.py `fwd_kernel`
// (with_cons=True); the kernel and its design are in rendercore_fwd.cuh.
#include "rendercore_fwd.cuh"

using namespace copenerf;

// K6-fwd: copenerf_rendercore_fwd's outputs plus sdf_w (n,), the SDF value
// of y (n, 4), the same rows of world-transformed samples; the other
// arguments as there.
extern "C" int copenerf_rendercore_cons_fwd(
    const float* x, const float* dirs, const float* y, float* sdf, float* grad, float* color,
    float* sdf_w,
    const float* params, const long long* off_b, const long long* off_wp,
    const long long* off_wtp, long long off_w_last0, long long off_b_last0, long long off_wfp,
    long long off_b_feat, const long long* off_wcp, const long long* off_bc,
    long long off_wc_last, float* scratch, long long n, int n_lin, int d_in, int multires,
    int hidden, int skip, float scale, int d_feat, int c_n_lin, int c_hidden, int c_multires,
    int c_k0, int squeeze, int n_blocks, void* stream) {
  return rendercore_fwd_run<true>(
      x, dirs, y, sdf, grad, color, sdf_w, params,
      off_b, off_wp, off_wtp, off_w_last0, off_b_last0, off_wfp, off_b_feat, off_wcp, off_bc,
      off_wc_last, scratch, n, n_lin, d_in, multires, hidden, skip, scale, d_feat, c_n_lin,
      c_hidden, c_multires, c_k0, squeeze, n_blocks, stream);
}
