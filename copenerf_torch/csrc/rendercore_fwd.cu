// K1-fwd — the render-core field query, forward only: the C entry point.
// Replaces copenerf_tpu/ops/pallas/rendercore_kernels.py `fwd_kernel`
// (with_cons=False); the kernel and its design are in rendercore_fwd.cuh.
#include "rendercore_fwd.cuh"

using namespace copenerf;

// sdf (n,), grad (n, 4), color (n, 3) of x (n, 4), dirs (n, 3). The off_*
// arguments are float offsets into `params`: per SDF hidden layer (n_lin - 1
// of them) W (in, out), b and W^T; the last SDF layer's column 0, its bias,
// its feature columns and their bias; per color layer (c_n_lin) W (in, out)
// and b. `scratch` holds n_blocks * (n_lin - 1) * 64 * 256 floats. Returns
// cudaGetLastError().
extern "C" int copenerf_rendercore_fwd(
    const float* x, const float* dirs, float* sdf, float* grad, float* color,
    const float* params, const long long* off_w, const long long* off_b,
    const long long* off_wt, long long off_w_last0, long long off_b_last0,
    long long off_w_feat, long long off_b_feat, const long long* off_wc,
    const long long* off_bc, float* scratch, long long n, int n_lin, int d_in,
    int multires, int hidden, int skip, float scale, int d_feat, int c_n_lin,
    int c_hidden, int c_multires, int c_k0, int squeeze, int n_blocks, void* stream) {
  return rendercore_fwd_run<false>(x, dirs, nullptr, sdf, grad, color, nullptr, params, off_w,
                                   off_b, off_wt, off_w_last0, off_b_last0, off_w_feat,
                                   off_b_feat, off_wc, off_bc, scratch, n, n_lin, d_in, multires,
                                   hidden, skip, scale, d_feat, c_n_lin, c_hidden, c_multires,
                                   c_k0, squeeze, n_blocks, stream);
}
