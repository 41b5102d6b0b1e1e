// The render-core forward row kernel, shared by K1-fwd (rendercore_fwd.cu)
// and K6-fwd (rendercore_cons_fwd.cu): one template, one instantiation in
// each, so the two build in parallel.
//
// K1-fwd — the render-core field query, forward only — and K6-fwd — the
// same with the sdf-consistency query folded in.
//
// Replaces: copenerf_tpu/ops/pallas/rendercore_kernels.py `_build` ->
// `fwd_kernel` (launched by `call_fwd`):
//   * K1-fwd (with_cons=False, exposed through `get_fused_rendercore`): one
//     launch per render chunk, 128 samples per ray;
//   * K6-fwd (with_cons=True, exposed through `get_fused_rendercore_cons`,
//     the JAX package's COPENERF_FOLD_CONS=1): one launch per train step
//     (131,072 rows); after each x tile the same block runs K2's value sweep
//     on the matching tile of y, the world-transformed samples, and writes
//     sdf_w = (h . W_last[:, 0] + b) / scale.
//
// Computes, per row (x (4), unit view dir (3)):
//   SDF forward: PE(x * scale) -> hidden layers (softplus-100, skip / sqrt(2))
//     -> sdf = (h . W_last[:, 0] + b) / scale and feature = h @ W_last[:, 1:];
//   input gradient, reverse sweep (sdf_kernels.py `_grad_sweep_tile`):
//     r = W_last[:, 0]; per hidden layer q = r * sigmoid(100 z), r = q @ W^T,
//     split at the skip (h | e) / sqrt(2); then grad = J_pe^T ee;
//   IDR color: MLP on [x, PE(dirs), grad, feature] (ReLU), sigmoid head.
// Outputs sdf (n, 1), grad (n, 4), color (n, 3).
//
// Bound on an H100: operations. ~2.5 MFLOP against ~60 bytes per row; the
// f32 FFMA rate (67 TFLOP/s) is the limit by more than 1000x.
// Design:
//  * The 256-wide feature never goes to device memory: it is written by the
//    feature GEMM straight into the shared-memory color-input buffer, where
//    it waits out the gradient sweep (the point of the TPU kernel).
//  * The sweep needs the 8 hidden layers' sigmoid(100 z): 8 KB per row, 512
//    KB per 64-row tile, far beyond 227 KB of shared memory. They go to a
//    per-block scratch in device memory (written once, read once), sized by
//    a persistent grid of one block per SM (about 69 MB on 132 SMs, so a
//    large part stays in the 50 MB L2) and never by n. The alternative, a
//    16-row tile holding them in shared memory, would cut the FFMA per
//    shared-memory load 4x and re-stream every weight 4x as often; per row
//    the scratch costs 16 KB of traffic against ~80 KB of weight streaming
//    from L2, so it is not what bounds the kernel.
//  * Shared memory: one 64 x 256 activation buffer that every GEMM of the
//    forward, the sweep and the color MLP overwrites in place (a warp owns
//    its rows), the 64 x 292 color-input buffer (feature, x, PE(dirs), grad,
//    pad), the PE / skip-gradient buffer and two 32 x 256 weight slices
//    (double-buffered cp.async): 223,232 of the 232,448 bytes a block may
//    use. Ping-pong activation buffers would leave room only for 4-deep
//    slices, i.e. two barriers per 4 k.
//  * The color input columns are permuted on the host (feature first) so the
//    feature GEMM writes columns 0..255 and the small parts follow.
//  * It runs at under half of the f32 bound (times in PERF.md), limited as
//    sdf_value.cu is by two warps per scheduler and the non-FFMA work.
//  * The sweeps are mlp_tile.cuh's, shared with K4-fwd (sdf_outgrad_fwd.cu)
//    and K5-fwd (color_fwd.cu).
//  * K6-fwd (kCons) reuses the x tile's buffers (h, e, xs) for the y tile
//    once the x tile's outputs are written: ~0.92 MFLOP a row more against
//    20 bytes (y in, sdf_w out), at K1-fwd's 32-deep weight slices.
#pragma once

#include "mlp_tile.cuh"

namespace copenerf {
namespace {

constexpr int kSliceK = 32;

template <bool kCons>
__global__ void __launch_bounds__(kThreads, 1)
rendercore_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dirs,
                      const float* __restrict__ y, float* __restrict__ sdf_out,
                      float* __restrict__ grad_out, float* __restrict__ color_out,
                      float* __restrict__ sdfw_out, const float* __restrict__ P,
                      Offsets off, float* __restrict__ scratch, long long n,
                      SdfGeom g, ColorGeom cg) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // activations, row stride 256
  float* cin = h + kRows * kSliceCols;  // color input, row stride cg.k0
  float* e = cin + kRows * cg.k0;    // PE, then the skip part of the sweep
  float* xs = e + kRows * g.d0;         // x * scale
  float* xr = xs + kRows * 4;           // raw x
  float* dr = xr + kRows * 4;           // dirs (3 used)
  float* gs = dr + kRows * 4;           // grad
  float* w_s = gs + kRows * 4;
  const int n_hidden = g.n_lin - 1;
  float* sig_s = scratch + (long long)blockIdx.x * n_hidden * kRows * 256;
  const long long tiles = (n + kRows - 1) / kRows;
  auto sig_at = [&](int l, int r, int c) { return sig_s[((long long)l * kRows + r) * 256 + c]; };
  auto none = [](int, int, int, float) {};

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const long long gr = row0 + r;
      const bool ok = gr < n;
      xr[i] = ok ? x[gr * 4 + j] : 0.0f;
      dr[i] = (ok && j < 3) ? dirs[gr * 3 + j] : 0.0f;
    }
    load_and_encode(x, n, row0, g, xs, e);

    // ---- SDF forward; sigmoids to the block's scratch ----
    sdf_hidden_forward<kSliceK>(
        P, off, g, e, h, w_s,
        [&](int l, int r, int c, float sig) {
          sig_s[((long long)l * kRows + r) * 256 + c] = sig;
        },
        none);
    __syncthreads();
    const float b0 = P[off.b_last0];
    rowdot(h, 256, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
      const long long gr = row0 + r;
      if (gr < n) sdf_out[gr] = (v + b0) / g.scale;
    });
    {
      const float* bf = P + off.b_feat;
      gemm<kSliceK>(h, 256, g.hidden, P + off.w_feat, cg.d_feat, cg.d_feat, w_s,
                    [&](int r, int c, float z) { cin[r * cg.k0 + c] = z + bf[c]; });
    }

    // ---- input-gradient sweep in h: q = W_last[:, 0] * sig, r = q @ W^T ----
    sdf_grad_sweep<kSliceK>(P, off, g, h, e, w_s, 0, sig_at, none);
    // h now holds ee (d0 wide): grad = J_pe^T ee.
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
      const int r = i >> 2, j = i & 3;
      const float acc = pe4_jac_t(h + r * 256, xs + r * 4, g.multires, j);
      gs[i] = acc;
      const long long gr = row0 + r;
      if (gr < n) grad_out[gr * 4 + j] = acc;
    }
    __syncthreads();

    // ---- color MLP on [feature, x, PE(dirs), grad, 0] ----
    color_forward<kSliceK, false>(P, off, cg, cin, h, w_s, xr, dr, gs, none,
                                  [&](int r, int c, float v) {
                                    const long long gr = row0 + r;
                                    if (gr < n) color_out[gr * 3 + c] = v;
                                  });

    if constexpr (kCons) {
      // ---- the consistency query: K2's value sweep on the tile of y ----
      __syncthreads();  // the x tile's readers of xs and e are done
      load_and_encode(y, n, row0, g, xs, e);
      sdf_hidden_forward<kSliceK>(P, off, g, e, h, w_s, none, none);
      __syncthreads();
      rowdot(h, 256, g.hidden, P + off.w_last0, 1, 1, [&](int r, int, float v) {
        const long long gr = row0 + r;
        if (gr < n) sdfw_out[gr] = (v + b0) / g.scale;
      });
    }
  }
}

// Shared memory of one block, in bytes.
size_t rendercore_smem(int d0, int k0) {
  return sizeof(float) *
         (kRows * kSliceCols + kRows * k0 + kRows * d0 + 4 * kRows * 4 +
          2 * kSliceK * kSliceCols);
}

template <bool kCons>
int rendercore_fwd_run(const float* x, const float* dirs, const float* y, float* sdf,
                       float* grad, float* color, float* sdf_w, const float* params,
                       const long long* off_w, const long long* off_b, const long long* off_wt,
                       long long off_w_last0, long long off_b_last0, long long off_w_feat,
                       long long off_b_feat, const long long* off_wc, const long long* off_bc,
                       float* scratch, long long n, int n_lin, int d_in, int multires,
                       int hidden, int skip, float scale, int d_feat, int c_n_lin, int c_hidden,
                       int c_multires, int c_k0, int squeeze, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  if (d_in != 4 || c_k0 % 4) return (int)cudaErrorInvalidValue;
  SdfGeom g{n_lin, d_in, multires, d_in * (1 + 2 * multires), hidden, skip, scale};
  ColorGeom cg{c_n_lin, c_hidden, c_multires, d_feat, c_k0, squeeze};
  Offsets off;
  if (!make_offsets(off, n_lin - 1, off_w, off_b, off_wt, off_w_last0, off_b_last0,
                    off_w_feat, off_b_feat, c_n_lin, off_wc, off_bc))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rendercore_smem(g.d0, cg.k0);
  cudaError_t err = cudaFuncSetAttribute(
      rendercore_fwd_kernel<kCons>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kRows - 1) / kRows;
  const int grid = (int)(tiles < n_blocks ? tiles : n_blocks);
  rendercore_fwd_kernel<kCons><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dirs, y, sdf, grad, color, sdf_w, params, off, scratch, n, g, cg);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace copenerf
