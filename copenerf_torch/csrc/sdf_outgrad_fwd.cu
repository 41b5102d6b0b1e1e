// K4-fwd — the SDF output and its input gradient, forward only — and
// K7-fwd — the SDF output alone.
//
// Replaces: copenerf_tpu/ops/pallas/sdf_kernels.py `_build` ->
// `make_fwd_kernel` (launched by `call_fwd`):
//   * K4-fwd (`with_grad=True`, exposed as `FusedOps.outgrad`): the composed
//     render-core query: every color config other than idr with a positive
//     ray vector runs it, then the color MLP on its outputs (K5 in the idr
//     mode, color_fwd.cu). One launch per render chunk (4,194,304 rows) or
//     train step (131,072 rows).
//   * K7-fwd (`with_grad=False`, exposed as `FusedOps.out`, reached through
//     `fields.sdf_output`): the same head without the gradient sweep; its
//     backward is K7-bwd (sdf_value_bwd.cu).
//
// Computes, per row x (4): the SDF forward PE(x * scale) -> hidden layers
// (softplus-100, skip / sqrt(2)) -> out = [(h . W_last[:, 0] + b) / scale,
// h @ W_last[:, 1:] + b] (d_out wide), and the input gradient by the reverse
// sweep (sdf_kernels.py `_grad_sweep_tile`) grad = J_pe^T ee.
// Outputs out (n, d_out), grad (n, 4) (K4 only).
//
// Bound on an H100: operations. K4: ~2.0 MFLOP per row at the default
// config (30 ns of f32 FFMA, 12 ns in 3xTF32 on the tensor cores) against
// 16 bytes in and 1,044 bytes out (the 257-wide head, 4.3 GB at a render
// chunk; 0.3 ns of device-memory traffic); K7: ~1.1 MFLOP against 16 bytes
// in and 1,028 out.
// Design: K2's tile (sdf_value.cu) with the head and the sweep. Every GEMM
// (the hidden layers, the head's feature columns, the sweep over W^T) runs
// on the wgmma 3xTF32 core (wgmma_tile.cuh WgGemm: activation rows of 272
// floats, the weights packed by the host as wgmma B, a two-stage ring of
// 32-deep slices; 216,128 bytes of shared memory). The feature GEMM's
// epilogue writes the head straight to device memory; column 0 stays a
// per-row dot. The sweep's per-layer sigmoids go to a per-block scratch in
// device memory (persistent grid, one block per SM), written and read in
// the row-major order of the FFMA design (the accumulator order measured
// 20% slower on K3-bwd). K7 is the kWithGrad = false instantiation: no
// sweep, no scratch.
#include "wgmma_tile.cuh"

namespace copenerf {
namespace {

using G = WgGemm;

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads, 1)
sdf_outgrad_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                       float* __restrict__ grad_out, const float* __restrict__ P, Offsets off,
                       float* __restrict__ scratch, long long n, SdfGeom g, int d_out) {
  extern __shared__ float4 smem4[];
  constexpr int ld = G::kLd;
  float* h = reinterpret_cast<float*>(smem4);  // activations, row stride ld
  float* e = h + kRows * ld;                   // PE, then the skip part of the sweep
  float* xs = e + kRows * g.d0;                // x * scale
  float* w_s = xs + kRows * 4;
  const int n_hidden = g.n_lin - 1;
  const int d_feat = d_out - 1;
  float* sig_s = scratch + (long long)blockIdx.x * n_hidden * kRows * 256;
  const long long tiles = (n + kRows - 1) / kRows;
  auto sig_at = [&](int l, int r, int c) { return sig_s[((long long)l * kRows + r) * 256 + c]; };
  auto none = [](int, int, int, float) {};

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    load_and_encode(x, n, row0, g, xs, e);
    sdf_hidden_forward<G::kSliceK, G>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) {
          if constexpr (kWithGrad) sig_s[((long long)l * kRows + r) * 256 + c] = sig;
        },
        none);
    __syncthreads();
    const float b0 = P[off.b_last0];
    rowdot(h, ld, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
      const long long gr = row0 + r;
      if (gr < n) out[gr * d_out] = (v + b0) / g.scale;
    });
    {
      const float* bf = P + off.b_feat;
      G::run<G::kSliceK>(h, ld, g.hidden, G::wf(P, off), d_feat, d_feat, w_s,
                         [&](int r, int c, float z) {
                           const long long gr = row0 + r;
                           if (gr < n) out[gr * d_out + 1 + c] = z + bf[c];
                         });
    }
    if constexpr (kWithGrad) {
      sdf_grad_sweep<G::kSliceK, G>(P, off, g, h, e, w_s, 0, sig_at, none);
      // h now holds ee (d0 wide): grad = J_pe^T ee.
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
        const int r = i >> 2, j = i & 3;
        const long long gr = row0 + r;
        if (gr < n) grad_out[gr * 4 + j] = pe4_jac_t(h + r * ld, xs + r * 4, g.multires, j);
      }
    }
  }
}

template <bool kWithGrad>
int outgrad_fwd_run(const float* x, float* out, float* grad, const float* params,
                    const long long* off_b, const long long* off_wp,
                    const long long* off_wtp, long long off_w_last0, long long off_b_last0,
                    long long off_wfp, long long off_b_feat, float* scratch, long long n,
                    int n_lin, int d_in, int multires, int hidden, int skip, float scale,
                    int d_out, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  if (d_in != 4 || d_out < 5 || (d_out - 1) % 4) return (int)cudaErrorInvalidValue;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_b, off_wp, off_wtp, off_w_last0, off_b_last0,
                    off_b_feat))
    return (int)cudaErrorInvalidValue;
  off.wfp = off_wfp;
  const size_t smem =
      sizeof(float) * (kRows * G::kLd + kRows * g.d0 + kRows * 4 + G::kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_outgrad_fwd_kernel<kWithGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  sdf_outgrad_fwd_kernel<kWithGrad><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, grad, params, off, scratch, n, g, d_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace copenerf

using namespace copenerf;

// out (n, d_out) = [sdf, feature] and grad (n, 4) = d(sdf)/dx of x (n, 4).
// The off_* arguments are float offsets into `params` (the outgrad pack,
// pack.py `pack_outgrad_layers`): per SDF hidden layer (n_lin - 1 of them)
// b, W as wgmma B and W^T as wgmma B (the sweep's; pack.py `wg_pack_b`);
// the last layer's column 0, its bias, its feature columns (hidden,
// d_out - 1) as wgmma B and their bias. `scratch`
// holds n_blocks * (n_lin - 1) * 64 * 256 floats. Returns cudaGetLastError().
extern "C" int copenerf_sdf_outgrad_fwd(
    const float* x, float* out, float* grad, const float* params, const long long* off_b,
    const long long* off_wp, const long long* off_wtp, long long off_w_last0,
    long long off_b_last0, long long off_wfp, long long off_b_feat,
    float* scratch, long long n, int n_lin, int d_in, int multires, int hidden, int skip,
    float scale, int d_out, int n_blocks, void* stream) {
  return outgrad_fwd_run<true>(x, out, grad, params, off_b, off_wp, off_wtp, off_w_last0,
                               off_b_last0, off_wfp, off_b_feat, scratch, n, n_lin, d_in,
                               multires, hidden, skip, scale, d_out, n_blocks, stream);
}

// K7-fwd: out (n, d_out) = [sdf, feature] of x (n, 4), the offsets as for
// copenerf_sdf_outgrad_fwd without the sweep's W^T; no scratch. Returns
// cudaGetLastError().
extern "C" int copenerf_sdf_out_fwd(const float* x, float* out, const float* params,
                                    const long long* off_b, const long long* off_wp,
                                    long long off_w_last0, long long off_b_last0,
                                    long long off_wfp, long long off_b_feat, long long n,
                                    int n_lin, int d_in, int multires, int hidden, int skip,
                                    float scale, int d_out, int n_blocks, void* stream) {
  return outgrad_fwd_run<false>(x, out, nullptr, params, off_b, off_wp, nullptr,
                                off_w_last0, off_b_last0, off_wfp, off_b_feat, nullptr, n, n_lin,
                                d_in, multires, hidden, skip, scale, d_out, n_blocks, stream);
}
